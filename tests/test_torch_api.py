"""The port's top-level API against the JAX package's: the same names in
dir() and __all__, less the names only the port exports (each listed
with its reason), set_backend raising, and the module-level aliases.
dir() is read in a fresh interpreter, since importing a submodule
elsewhere in a test run adds it to the package's namespace."""
import json
import os
import subprocess
import sys

import pytest

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# names the port exports at its top level and the JAX package does not
PORT_ONLY = {
    # the pipeline's accumulator error, raised by count_kmers_fastq
    "AccOverflow",
    # JAX exports them from bionumpy_tpu.sequence only
    "SparseEncodedCounts", "count_minimizers", "count_minimizers_with_gc",
    "get_motif_matches",
    # ops/kmers.kmer_checksum_streamed, the streamed checksum entry point
    "kmer_checksum_streamed",
    # sequence/kmers.kmer_spectrum, the canonical k-mer spectrum (GenomeScope's
    # input), which the JAX package does not have
    "kmer_spectrum",
    # io/jaspar and io/motifs readers of the motif scans
    "read_jaspar_matrix", "read_motif",
}
# submodules the port's top level imports at load time (the pipeline
# imports ops/ and parallel/; JAX's imports them lazily)
PORT_ONLY_DIR = PORT_ONLY | {"ops", "parallel"}
# in both packages' dir(); only the port lists them in __all__
PORT_ONLY_ALL = PORT_ONLY | {"instrument", "datatypes", "genomic_data"}

_DIR = """
import json, sys
import {name} as m
print(json.dumps({{"dir": dir(m), "all": list(m.__all__),
                  "matplotlib": any(k.startswith("matplotlib")
                                    for k in sys.modules)}}))
"""


def _names(package):
    proc = subprocess.run(
        [sys.executable, "-c", _DIR.format(name=package)], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def names():
    return _names("bionumpy_tpu"), _names("bionumpy_tpu_torch")


def test_dir_matches_jax(names):
    jax_names, port_names = names
    assert set(jax_names["dir"]) - set(port_names["dir"]) == set()
    assert set(port_names["dir"]) - set(jax_names["dir"]) == PORT_ONLY_DIR


def test_all_matches_jax(names):
    jax_names, port_names = names
    assert set(jax_names["all"]) - set(port_names["all"]) == set()
    assert set(port_names["all"]) - set(jax_names["all"]) == PORT_ONLY_ALL
    assert all(hasattr(tbnp, n) for n in port_names["all"])


def test_import_loads_no_matplotlib(names):
    assert not names[1]["matplotlib"]


def test_set_backend_raises():
    for bnp in (jbnp, tbnp):
        with pytest.raises(NotImplementedError):
            bnp.set_backend(None)
    with pytest.raises(NotImplementedError, match="device="):
        tbnp.set_backend("cupy")


def test_aliases_and_version():
    from bionumpy_tpu import native as jnative
    from bionumpy_tpu import pipeline as jpipe
    from bionumpy_tpu_torch import native as tnative
    from bionumpy_tpu_torch import pipeline as tpipe
    import bionumpy_tpu_torch.ragged as tragged
    assert tbnp.nps is tragged
    assert tbnp.__version__ == jbnp.__version__
    assert tbnp.open is tbnp.bnp_open
    assert tpipe.FOLD_EVERY == tpipe.ACC_FOLD == jpipe.FOLD_EVERY
    assert tnative.has_native() is (tnative._load() is not None)
    assert tnative.has_native() == jnative.has_native()


@pytest.mark.parametrize("name", [
    "RaggedArray", "RaggedShape", "RaggedView", "ragged_slice",
    "Encoding", "OneToOneEncoding", "BaseEncoding", "EncodedLookup",
    "from_encoded_array", "AlphabetEncoding", "KmerEncoding",
    "KmerEncoder", "StrandEncoding", "RNAEncoding", "CigarEncoding",
])
def test_names_come_from_the_ports_submodules(name):
    """Each exported name is the port's own object, from the submodule of
    the JAX package's path, and not the JAX package's."""
    obj = getattr(tbnp, name)
    assert obj is not getattr(jbnp, name)
    module = getattr(obj, "__module__", None) or type(obj).__module__
    assert module.startswith("bionumpy_tpu_torch.")
