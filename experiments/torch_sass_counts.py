"""Instruction counts of the wavefront and column kernels' SASS, on the
machine with the CUDA toolkit.

    python experiments/torch_sass_counts.py [--root DIR] [--tag NAME]

Builds (or loads) the kernel library of the checkout at --root, runs
cuobjdump -sass on it and prints, for the instantiations of the main
shapes (the wavefront at rows 8 and 16, one-tile and chained, and the
column kernels at 8 rows a lane), the instruction count of each and the
counts of the opcodes the recurrences run on: the 32-bit and 16x2 integer
add, max and DPX add-max, the bfloat16 and float max and add, selects,
shuffles, byte permutes and logic ops.  A 16-bit state that runs its
cells two a register shows 16x2 and BF16_V2 opcodes and no scalar
conversions.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
from pathlib import Path

# the wavefront's state codes (stream_wavefront.cu StateMode) and modes
# (Mode), the column's state codes (ColumnState)
WAVE_STATES = {0: "int32", 1: "biased", 2: "float32", 3: "int16", 4: "uint16", 5: "bfloat16"}
WAVE_MODES = {0: "tail-acc", 1: "ripple-H", 2: "chained"}
COLUMN_STATES = {0: "int32", 1: "biased", 2: "float32", 3: "int16"}
OPCODES = ("VIADDMNMX", "VIADD", "VIMNMX", "IMNMX", "IADD3", "HMNMX2", "HFMA2", "HADD2",
           "FMNMX", "FADD", "SEL", "ISETP", "LOP3", "PRMT", "SHFL", "F2F", "I2F", "F2I")


def functions(sass: str):
    """(demangled name, [opcodes]) of each function in cuobjdump's output."""
    name, ops = None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                yield name, ops
            name, ops = m.group(1), []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)", line)
        if m and name:
            ops.append(m.group(1))
    if name:
        yield name, ops


def label(name: str):
    """A short label of a kernel instantiation of the main shapes, or None
    (cu++filt may print a template argument as (int)8 or (bool)1)."""
    name = re.sub(r"\((?:int|bool)\)", "", name)
    m = re.search(r"stream_wavefront_(x2_)?kernel<(\d+), (\d+), (\d+)>", name)
    if m:
        x2, (rows, mode, state) = m.group(1), map(int, m.groups()[1:])
        if rows in (8, 16) and mode != 1:
            return (f"wavefront rows={rows} {WAVE_MODES[mode]} {WAVE_STATES[state]}"
                    + (" (two streams a thread)" if x2 else ""))
    m = re.search(r"column_kernel<(\d+), (\d+), (true|false|1|0)>", name)
    if m and m.group(1) == "8":
        tile = "B5 tile" if m.group(3) in ("true", "1") else "B4"
        return f"column rpl=8 {tile} {COLUMN_STATES[int(m.group(2))]}"
    m = re.search(r"column_x2_kernel<(\d+), (true|false|1|0)>", name)
    if m and m.group(1) == "8":
        tile = "B5 tile" if m.group(2) in ("true", "1") else "B4"
        return f"column rpl=8 {tile} int16 (two pairs a warp)"
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose kernel library to read")
    ap.add_argument("--tag", default="this", help="label of every line")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    from swtpu_torch.ops import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    _build.load_library()
    cuda = Path(_build._nvcc()).parent
    sass = subprocess.run([str(cuda / "cuobjdump"), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    names = [n for n, _ in functions(sass)]
    demangled = subprocess.run([str(cuda / "cu++filt")], input="\n".join(names),
                               capture_output=True, text=True, check=True).stdout.splitlines()
    rows = []
    for (_, ops), name in zip(functions(sass), demangled):
        what = label(name)
        if what:
            rows.append((what, ops))
    if not rows:  # the names did not parse: show some
        print("no instantiation recognised among", len(names), "functions, e.g.",
              *demangled[:4], sep="\n  ")
    for what, ops in sorted(rows):
        count = collections.Counter(op.split(".")[0] for op in ops)
        wide = collections.Counter(op for op in ops if "16x2" in op or "BF16_V2" in op)
        print(f"{args.tag} {what} | {len(ops)} instructions | "
              + " ".join(f"{k}:{count[k]}" for k in OPCODES if count[k])
              + " | packed " + " ".join(f"{k}:{v}" for k, v in sorted(wide.items())),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
