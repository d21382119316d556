#!/usr/bin/env python3
"""The loops of the CUDA kernels in built libraries, from cuobjdump -sass.

    python3 tools/torch_sass_loops.py LIB.so [LIB.so ...]

For every backward branch of every kernel, the instructions from its
target to it (NOPs left out) and how many of them are of each kind in
SASS_OPS.  Prints one JSON line per library:
{"library": path, "loops": {kernel: [{"instructions": n, "LDG": n, ...}]}}.
Needs the CUDA toolkit's cuobjdump (next to nvcc on PATH, else under
$CUDA_HOME, default /usr/local/cuda); a kernel template instance is named
with its first template argument, as kernel<N>.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

SASS_OPS = ("LDG", "POPC", "SHF", "IADD3", "LOP3", "IMAD", "SHFL", "ATOMG",
            "RED", "BRA")


def cuobjdump() -> str:
    nvcc = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    bin_dir = os.path.dirname(nvcc) if nvcc else os.path.join(home, "bin")
    path = os.path.join(bin_dir, "cuobjdump")
    if not os.path.exists(path):
        raise RuntimeError("cuobjdump not found: it comes with the CUDA "
                           "toolkit")
    return path


def parse_sass_loops(text: str) -> dict:
    loops = {}
    for block in text.split("Function : ")[1:]:
        name = re.match(r"\S*?([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?", block)
        if not name:
            continue
        key = name.group(1) + (f"<{name.group(2)}>" if name.group(2) else "")
        code, labels, pending = [], {}, []
        for line in block.splitlines():
            label = re.match(r"\s*(\.L_x_\d+):", line)
            if label:
                pending.append(label.group(1))
                continue
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if ins:
                at = int(ins.group(1), 16)
                for lab in pending:
                    labels[lab] = at
                pending = []
                code.append((at, ins.group(2)))
        found = []
        for at, ins in code:
            branch = re.search(r"\bBRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))",
                               ins)
            if not branch:
                continue
            target = labels.get(branch.group(1)) if branch.group(1) \
                else int(branch.group(2), 16)
            if target is None or target >= at:
                continue
            body = [op for a, op in code if target <= a <= at
                    and not re.search(r"\bNOP\b", op)]
            entry = {"instructions": len(body)}
            for kind in SASS_OPS:
                entry[kind] = sum(bool(re.search(rf"\b{kind}\b", op))
                                  for op in body)
            found.append(entry)
        loops.setdefault(key, []).extend(found)
    return loops


def main(paths) -> int:
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    tool = cuobjdump()
    for path in paths:
        text = subprocess.run([tool, "-sass", path], check=True,
                              capture_output=True, text=True).stdout
        print(json.dumps({"library": path, "loops": parse_sass_loops(text)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
