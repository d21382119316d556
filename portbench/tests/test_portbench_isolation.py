"""Nothing under portbench/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the yardstick (the reference, the generator, the trace reduction,
the metric readers) imports nothing of the port."""
import ast
import os
import subprocess
import sys

import tiny
from portbench.registry import HERE

JAX = {"jax", "jaxlib", "flax", "bionumpy_tpu"}
PORT = "bionumpy_tpu_torch"
YARDSTICK = ("reference.py", "traffic.py", "trace.py", "registry.py",
             "peaks.json", "metrics")


def imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def modules(under):
    for root, _, files in os.walk(under):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_jax_anywhere():
    found = {p: sorted(set(imports(p)) & JAX) for p in modules(HERE)}
    assert not {p: m for p, m in found.items() if m}


def test_yardstick_imports_nothing_of_the_port():
    paths = []
    for name in YARDSTICK:
        p = os.path.join(HERE, name)
        paths += list(modules(p)) if os.path.isdir(p) else \
            [p] if p.endswith(".py") else []
    assert len(paths) > 5
    for p in paths:
        assert PORT not in set(imports(p)), p


def test_scan_sees_a_planted_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom bionumpy_tpu import x\n"
                   "import bionumpy_tpu_torch\n")
    assert set(imports(str(bad))) == {"jax", "bionumpy_tpu",
                                      "bionumpy_tpu_torch"}


def test_run_refuses_without_a_card_and_spots_jax():
    sys.path.insert(0, os.path.dirname(HERE))
    import portbench.run as run
    sys.modules["bionumpy_tpu.fake"] = object()
    try:
        assert run.forbidden_modules() == ["bionumpy_tpu"]
    finally:
        del sys.modules["bionumpy_tpu.fake"]
    assert "bionumpy_tpu" not in run.forbidden_modules()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "minimizer21-genome", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
