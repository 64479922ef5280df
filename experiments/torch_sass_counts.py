"""Instruction counts of the wavefront and column kernels' SASS, on the
machine with the CUDA toolkit.

    python experiments/torch_sass_counts.py [--root DIR] [--tag NAME]

Builds (or loads) the kernel library of the checkout at --root, runs
cuobjdump -sass on it and prints, for the instantiations of the main
shapes (the wavefront at rows 8 and 16, one-tile and chained; the column
kernels: B4 at every geometry, B5's tile, int16 at 4 and 8 rows a lane),
the instruction count of each and the counts of the opcodes the
recurrences run on: the 32-bit and 16x2 integer add, max and DPX add-max,
the bfloat16 and float max and add, selects, shuffles, votes, byte
permutes and logic ops.  A 16-bit state that runs its cells two a register
shows 16x2 and BF16_V2 opcodes and no scalar conversions.  For a column
kernel also its run loop (the 32 unrolled columns between the outermost
backward branch and its target, B4's carry loop counted once a column,
the round a column that random reads take): its instructions, and those
over 32 columns x rows a lane x pairs a lane, the instructions a cell.
Prints the card's name and power limit first.
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
           "FMNMX", "FADD", "SEL", "ISETP", "LOP3", "PRMT", "SHFL", "VOTE", "BRA", "F2F",
           "I2F", "F2I")
RUN = 32  # columns a column kernel's run loop unrolls


def functions(sass: str):
    """(demangled name, [(address, opcode, branch target or None)]) of each
    function in cuobjdump's output."""
    name, ops = None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                yield name, ops
            name, ops = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)(.*)",
                     line)
        if m and name:
            target = re.match(r"\s+(?:\S+\s+)?(0x[0-9a-f]+)", m.group(3))
            ops.append((int(m.group(1), 16), m.group(2),
                        int(target.group(1), 16) if m.group(2).startswith("BRA") and target
                        else None))
    if name:
        yield name, ops


def label(name: str):
    """(a short label, cells an instruction of the run loop covers: rows a
    lane x pairs a lane, or None for a wavefront) of a kernel instantiation
    of the main shapes, or None (cu++filt may print a template argument as
    (int)8 or (bool)1)."""
    name = re.sub(r"\((?:int|bool)\)", "", name)
    m = re.search(r"stream_wavefront_(x2_)?kernel<(\d+), (\d+), (\d+)>", name)
    if m:
        x2, (rows, mode, state) = m.group(1), map(int, m.groups()[1:])
        if rows in (8, 16) and mode != 1:
            return (f"wavefront rows={rows} {WAVE_MODES[mode]} {WAVE_STATES[state]}"
                    + (" (two streams a thread)" if x2 else "")), None
    m = re.search(r"column_scores_kernel<(\d+), (\d+)>", name)
    if m:
        lanes, state = map(int, m.groups())
        return f"column B4 lanes={lanes:2d} rows=8 {COLUMN_STATES[state]}", 8
    m = re.search(r"column_tile_kernel<(\d+)>", name)
    if m:
        return f"column B5 tile rows=8 {COLUMN_STATES[int(m.group(1))]}", 8
    # the warp-wide B4/B5 template of older trees (for --root)
    m = re.search(r"column_kernel<(\d+), (\d+), (true|false|1|0)>", name)
    if m and m.group(1) in ("4", "8"):
        tile = "B5 tile" if m.group(3) in ("true", "1") else "B4"
        return f"column {tile} rpl={m.group(1)} {COLUMN_STATES[int(m.group(2))]}", int(m.group(1))
    m = re.search(r"column_x2_kernel<(\d+), (true|false|1|0)>", name)
    if m and m.group(1) in ("4", "8"):
        tile = "B5 tile" if m.group(2) in ("true", "1") else "B4"
        return (f"column {tile} rpl={m.group(1)} int16 (two pairs a warp)",
                2 * int(m.group(1)))
    return None


def run_loop(ops):
    """The opcodes between the outermost backward branch and its target,
    or None if the function has no backward branch."""
    back = [(a - t, t, a) for a, _, t in ops if t is not None and t <= a]
    if not back:
        return None
    _, start, end = max(back)
    return [op for a, op, _ in ops if start <= a <= end]


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
    funcs = list(functions(sass))
    demangled = subprocess.run([str(cuda / "cu++filt")], input="\n".join(n for n, _ in funcs),
                               capture_output=True, text=True, check=True).stdout.splitlines()
    rows = []
    for (_, ops), name in zip(funcs, demangled):
        what = label(name)
        if what:
            rows.append((*what, ops))
    if not rows:  # the names did not parse: show some
        print("no instantiation recognised among", len(funcs), "functions, e.g.",
              *demangled[:4], sep="\n  ")
    for what, cells, ops in sorted(rows):
        opcodes = [op for _, op, _ in ops]
        count = collections.Counter(op.split(".")[0] for op in opcodes)
        wide = collections.Counter(op for op in opcodes if "16x2" in op or "BF16_V2" in op)
        line = (f"{args.tag} {what} | {len(ops)} instructions | "
                + " ".join(f"{k}:{count[k]}" for k in OPCODES if count[k])
                + " | packed " + " ".join(f"{k}:{v}" for k, v in sorted(wide.items())))
        loop = run_loop(ops) if cells else None
        if loop:
            lc = collections.Counter(op.split(".")[0] for op in loop)
            line += (f" | run loop {len(loop)} instructions, {len(loop) / (RUN * cells):.2f} a "
                     f"cell (SHFL {lc['SHFL'] / (RUN * cells):.2f}, VOTE "
                     f"{lc['VOTE'] / (RUN * cells):.2f}, BRA {lc['BRA'] / (RUN * cells):.2f})")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
