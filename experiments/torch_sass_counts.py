"""Instruction counts of the wavefront and column kernels' SASS, on the
machine with the CUDA toolkit.

    python experiments/torch_sass_counts.py [--root DIR] [--tag NAME] [--dump FILE]
    python experiments/torch_sass_counts.py --sass FILE [--tag NAME]

Builds (or loads) the kernel library of the checkout at --root, runs
cuobjdump -sass on it and prints, for the instantiations of the main
shapes (the wavefront at rows 4, 8 and 16, one-tile and chained; the
chain kernel at rows 8 and 16, a whole chain and one tile, in every state
it has; the column kernels: B4 at every geometry, B5's tile (B4's template at 32 lanes
in tile mode), int16 at 4 and 8 rows a lane),
the instruction count of each and the counts of the opcodes the
recurrences run on: the 32-bit and 16x2 integer add, max and DPX add-max,
the bfloat16 and float max and add, selects, shuffles, votes, byte
permutes and logic ops.  For a one-tile wavefront (B1, B2) also its step
loop (the innermost loop with the most instructions: a chunk of 8 steps)
over the cells a thread steps in it, 8 x rows x the sublanes a thread
holds x the streams it holds (the geometry of the tree read:
swtpu_torch.ops.stream.wavefront_geometry where the tree has it, else
min(128 / rows, 32) threads a stream), with its shuffles, selects, votes,
compares and loads a cell and a step.  For the chain kernel its
iteration loop, the innermost loop with the most instructions: a chunk of
8 steps with the tile start and the staging of the wrap strips it
branches over, so an upper bound of what a chunk runs, over the cells a
thread steps in it (8 x rows x sublanes x streams a thread).  A 16-bit state that runs its cells two a register
shows 16x2 and BF16_V2 opcodes and no scalar conversions.  For a column
kernel also the instructions a run of 32 columns executes on random reads
and those over 32 columns x rows a lane x pairs a lane, the instructions a
cell (this tree's swtpu_torch/tools/fp32_rates.column_run): B4 unrolls
the run, its carry loop counted once a column (the round a column that
random reads take); B5 runs it as a loop of a few unrolled columns, each
with a vote that skips the carry's further rounds and its scan when one
round raised no lane.  --dump FILE keeps cuobjdump's output, --sass FILE
counts a kept one (c++filt demangles).  --registers prints instead, from
the build's ptxas report (swtpu_torch.ops._build.build_log_path), every
kernel instantiation's registers a thread and spill store bytes, one line
each, so that two trees' lines can be diffed.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def own_module(name, *path):
    """A module of this tree by file, whatever tree --root puts first on
    the path (a parent may lack it)."""
    spec = importlib.util.spec_from_file_location(name, HERE.joinpath(*path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


fp32_rates = own_module("own_fp32_rates", "swtpu_torch", "tools", "fp32_rates.py")

# the wavefront's state codes (stream_wavefront.cu StateMode) and modes
# (Mode), the column's state codes (ColumnState)
WAVE_STATES = {0: "int32", 1: "biased", 2: "float32", 3: "int16", 4: "uint16", 5: "bfloat16"}
WAVE_MODES = {0: "tail-acc", 1: "ripple-H", 2: "chained"}
PACKED_STATES = (3, 4, 5)  # two streams a thread
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


# a chain kernel instantiation: rows, state, one tile, and since PR 21 the
# pad shortcut (kQuiet)
CHAIN = r"stream_chain_(?:x2_)?kernel<(\d+), (\d+), (true|false|1|0)(?:, (true|false|1|0))?>"


def label(name: str):
    """(a short label, cells an instruction of the run loop covers: rows a
    lane x pairs a lane, or None for a wavefront) of a kernel instantiation
    of the main shapes, or None (cu++filt may print a template argument as
    (int)8 or (bool)1)."""
    name = re.sub(r"\((?:int|bool)\)", "", name)
    m = re.search(r"stream_wavefront_(x2_)?kernel<(\d+), (\d+), (\d+)>", name)
    if m:
        x2, (rows, mode, state) = m.group(1), map(int, m.groups()[1:])
        if rows in (4, 8, 16) and mode != 1:
            return (f"wavefront rows={rows:2d} {WAVE_MODES[mode]} {WAVE_STATES[state]}"
                    + (" (two streams a thread)" if x2 else "")), None
    # the chain kernels (stream_chain_x2_kernel in a 16-bit state; the
    # instantiations with the pad shortcut, those that serve the main paths)
    m = re.search(CHAIN, name)
    if m:
        rows, state, one = int(m.group(1)), int(m.group(2)), m.group(3) in ("true", "1")
        if rows in (8, 16) and m.group(4) not in ("false", "0"):
            return (f"chain rows={rows:2d} {'one tile' if one else 'whole chain'} "
                    f"{WAVE_STATES[state]}"
                    + (" (two streams a thread)" if state in PACKED_STATES else "")), None
        return None
    m = re.search(r"column_scores_kernel<(\d+), (\d+)(?:, (true|false|1|0))?>", name)
    if m and m.group(3) in ("true", "1"):
        return f"column B5 tile rows=8 {COLUMN_STATES[int(m.group(2))]}", 8
    if m:
        lanes, state = int(m.group(1)), int(m.group(2))
        return f"column B4 lanes={lanes:2d} rows=8 {COLUMN_STATES[state]}", 8
    # B5's kernel of older trees (for --root)
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


STEP_OPS = ("SHFL", "SEL", "VOTE", "ISETP", "LDG", "STG")  # reported a cell and a step


def cells_a_thread_step(rows, state, x2, geometry):
    """Cells a thread of a one-tile wavefront steps at once: rows x the
    sublanes it holds x the streams it holds."""
    dtype = WAVE_STATES[state]
    if geometry is None:
        sublanes = 128 // rows // min(128 // rows, 32)
    else:
        sublanes = geometry(rows, 1, "int32" if dtype == "biased" else dtype).sublanes
    return rows * sublanes * (2 if x2 else 1)


def step_loop_line(name, tool_ops, geometry, chain_lanes=None):
    """The step loop's instructions a cell and a step of a one-tile
    wavefront or a chain instantiation, or '' for any other kernel; a
    chain's threads a stream from the tree's `chain_lanes` where it has
    one, else min(128 / rows, 32)."""
    name = re.sub(r"\((?:int|bool)\)", "", name)
    chain = re.search(CHAIN, name)
    if chain:
        rows, state = int(chain.group(1)), int(chain.group(2))
        loop = fp32_rates.hot_loop(tool_ops)
        if not loop:
            return ""
        SL = 128 // rows
        one = chain.group(3) in ("true", "1")
        lanes = (chain_lanes(rows, WAVE_STATES[state] if state > 2 else "int32", one_tile=one)
                 if chain_lanes else min(SL, 32))
        cells = 8 * rows * (SL // lanes) * (2 if state in PACKED_STATES else 1)
        count = collections.Counter(op.split(".")[0] for op in loop)
        return (f" | iteration loop {len(loop)} instructions, {len(loop) / cells:.2f} a cell "
                f"({cells // 8} cells a thread-step), {len(loop) / 8:.1f} a thread-step ("
                + ", ".join(f"{k} {count[k] / 8:.2f}" for k in STEP_OPS) + " a step)")
    m = re.search(r"stream_wavefront_(x2_)?kernel<(\d+), ([01]), (\d+)>", name)
    if not m:
        return ""
    rows, state = int(m.group(2)), int(m.group(4))
    loop = fp32_rates.hot_loop(tool_ops)
    if not loop:
        return ""
    steps = 8  # the kernels' kChunk: steps a trip of the step loop
    cells = steps * cells_a_thread_step(rows, state, m.group(1), geometry)
    count = collections.Counter(op.split(".")[0] for op in loop)
    return (f" | step loop {len(loop)} instructions, {len(loop) / cells:.2f} a cell "
            f"({cells // steps} cells a thread-step), {len(loop) / steps:.1f} a thread-step ("
            + ", ".join(f"{k} {count[k] / steps:.2f}" for k in STEP_OPS) + " a step)")


def register_lines(log: str, demangler, tag):
    """`tag name: N registers, M spill bytes` for every entry function in a
    ptxas -v report, by demangled name (the anonymous namespace dropped,
    whose mangled form differs between trees), sorted."""
    found = {}
    for m in re.finditer(r"ptxas info\s*: Compiling entry function '(\S+)'", log):
        tail = log[m.end():]
        regs = re.search(r"Used (\d+) registers", tail)
        spill = re.search(r"(\d+) bytes spill stores", tail)
        found[m.group(1)] = (int(regs.group(1)), int(spill.group(1)))
    names = subprocess.run(demangler, input="\n".join(found), capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return sorted(f"{tag} {name.replace('(anonymous namespace)::', '')}: {r} registers, "
                  f"{sp} spill bytes" for name, (r, sp) in zip(names, found.values()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose kernel library to read")
    ap.add_argument("--tag", default="this", help="label of every line")
    ap.add_argument("--dump", help="also write cuobjdump's output to this file")
    ap.add_argument("--sass", help="read a saved cuobjdump output instead of building "
                    "(needs no card; c++filt demangles)")
    ap.add_argument("--registers", action="store_true",
                    help="print every instantiation's registers and spills instead")
    args = ap.parse_args()
    dump = args.dump and os.path.abspath(args.dump)
    geometry = None
    if args.sass:
        sass = Path(args.sass).read_text()
        demangler = ["c++filt"]
        sys.path.insert(0, str(HERE))
        from swtpu_torch.ops import stream

        geometry = getattr(stream, "wavefront_geometry", None)
        chain_lanes = getattr(stream, "chain_lanes", None)
    else:
        root = os.path.abspath(args.root)
        sys.path.insert(0, root)
        os.chdir(root)
        from swtpu_torch.ops import _build, stream

        geometry = getattr(stream, "wavefront_geometry", None)
        chain_lanes = getattr(stream, "chain_lanes", None)

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip(), flush=True)
        _build.load_library()
        cuda = Path(_build._nvcc()).parent
        if args.registers:
            log = _build.library_path().with_suffix(".log").read_text()
            print(*register_lines(log, [str(cuda / "cu++filt")], args.tag), sep="\n")
            return 0
        sass = subprocess.run([str(cuda / "cuobjdump"), "-sass", str(_build.library_path())],
                              capture_output=True, text=True, check=True).stdout
        demangler = [str(cuda / "cu++filt")]
        if dump:
            Path(dump).write_text(sass)
    funcs = list(functions(sass))
    demangled = subprocess.run(demangler, input="\n".join(n for n, _ in funcs),
                               capture_output=True, text=True, check=True).stdout.splitlines()
    tool = dict(fp32_rates.functions(sass))  # column_run's form of the same functions
    rows = []
    for (mangled, ops), name in zip(funcs, demangled):
        what = label(name)
        if what:
            rows.append((*what, ops, tool[mangled],
                         step_loop_line(name, tool[mangled], geometry, chain_lanes)))
    if not rows:  # the names did not parse: show some
        print("no instantiation recognised among", len(funcs), "functions, e.g.",
              *demangled[:4], sep="\n  ")
    for what, cells, ops, tool_ops, step in sorted(rows):
        opcodes = [op for _, op, _ in ops]
        count = collections.Counter(op.split(".")[0] for op in opcodes)
        wide = collections.Counter(op for op in opcodes if "16x2" in op or "BF16_V2" in op)
        line = (f"{args.tag} {what} | {len(ops)} instructions | "
                + " ".join(f"{k}:{count[k]}" for k in OPCODES if count[k])
                + " | packed " + " ".join(f"{k}:{v}" for k, v in sorted(wide.items())))
        run = fp32_rates.column_run(tool_ops, RUN) if cells else []
        if run:
            rc = collections.Counter(run)
            per = RUN * cells
            line += (f" | a run on random reads {len(run)} instructions, {len(run) / per:.2f} a "
                     f"cell (SHFL {rc['SHFL'] / per:.2f}, VOTE {rc['VOTE'] / per:.2f}, BRA "
                     f"{rc['BRA'] / per:.2f}, LDS {rc['LDS'] / per:.2f})")
        print(line + step, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
