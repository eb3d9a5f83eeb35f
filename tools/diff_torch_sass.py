"""Compare the machine code (SASS) of the port's CUDA kernels between two
checkouts.

    python tools/diff_torch_sass.py OTHER_ROOT [--source fsm_scan.cu]
                                    [--map OLD=NEW ...]

Compiles tpujpeg_torch/csrc/SOURCE of this checkout and of OTHER_ROOT with
the port's nvcc flags (runtime/kernels.NVCC_FLAGS) into cubins, disassembles
both with cuobjdump -sass, and compares each kernel of OTHER_ROOT's cubin
with the kernel of the same mangled name in this one (the anonymous
namespace's per-file id left out), or with the name that `--map`'s
substring replacement turns it into (a template that gained a parameter:
for fsm_scan.cu, `EEEvPKh=ELi1EEEvPKh` pairs each kernel of three
template parameters with the same kernel at one byte a column).
Instructions are compared without their addresses and encodings.  Prints one line per
pair, "identical" or the count of instructions that differ and the
first eight differing pairs, and exits 1
if any pair differs or has no partner.  Needs nvcc and cuobjdump (a CUDA
toolkit; no card).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", name)


def sass(root: str, source: str, flags: list[str], tmp: str) -> dict:
    """{mangled kernel name: [instructions]} of one source of a checkout."""
    src = os.path.join(root, "tpujpeg_torch", "csrc", source)
    cubin = os.path.join(tmp, f"{abs(hash(root))}.cubin")
    subprocess.run([_tool("nvcc"), *flags, "-cubin", "-o", cubin, src],
                   check=True, capture_output=True, text=True)
    text = subprocess.run([_tool("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    kernels: dict = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_GLOBAL__N_",
                          m.group(1))
            kernels[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and m:
            kernels[name].append(m.group(1))
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--source", default="fsm_scan.cu")
    ap.add_argument("--map", action="append", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from tpujpeg_torch.runtime.kernels import NVCC_FLAGS

    with tempfile.TemporaryDirectory() as tmp:
        mine = sass(ROOT, args.source, NVCC_FLAGS, tmp)
        theirs = sass(os.path.abspath(args.other), args.source, NVCC_FLAGS,
                      tmp)
    bad = 0
    for name, code in sorted(theirs.items()):
        new = name
        for pair in args.map:
            old, repl = pair.split("=", 1)
            new = new.replace(old, repl, 1)
        if new not in mine:
            print(f"{name}: no kernel {new} here")
            bad += 1
            continue
        ours = mine[new]
        differ = sum(a != b for a, b in zip(code, ours)) \
            + abs(len(code) - len(ours))
        print(f"{name} -> {new}: {len(code)} and {len(ours)} instructions, "
              + ("identical" if differ == 0 else f"{differ} differ"))
        shown = [(i, a, b) for i, (a, b) in enumerate(zip(code, ours))
                 if a != b][:8]
        for i, a, b in shown:
            print(f"    {i}: {a}  |  {b}")
        bad += differ != 0
    print(f"{len(theirs)} kernels of {args.other} compared, {bad} differ; "
          f"this checkout has {len(mine)}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
