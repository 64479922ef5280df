"""The float32 and bfloat16 recurrences' opcode rates on the card, and their
step loops.

    python -m swtpu_torch.tools.fp32_rates [--trips N]

On the machine with the CUDA toolkit and a GPU.  Prints the card's name
and power limit, then:

- ``probe`` lines: ``ops/csrc/fp32_probe.cu`` run alone, one launch a
  variant of as many blocks of 256 threads an SM as an SM holds (one
  wave), each thread holding 8 independent values (bfloat16: 8 registers
  of two): FADD; FMNMX; FSETP and FSEL; the float32 bound's mix of 3 FADD,
  5 FMNMX, 1 FSETP and 1 FSEL a value; HADD2.BF16; HFMA2.BF16 with .RELU
  (the M update's form); HMNMX2.BF16; and the bfloat16 wavefront's mix a
  register of two cells in the step's own form: 1 HFMA2.RELU, 2 HADD2,
  4 HMNMX2, a PRMT and a LOP3, the diagonal D = max(M, I) feeding the
  next M's HFMA2 as the kernel's does, so no max result feeds only
  another max and ptxas cannot merge two into one 3-input VHMNMX.  Each
  line gives the opcodes of the probe's loop from its SASS and the thread
  instructions an SM retires a clock by pipe (FMA: FADD, FMUL, FFMA, IMAD,
  HADD2, HFMA2, HMUL2; ALU: the compares, min/max (HMNMX2 too), selects,
  byte permutes and integer adds and logic; MMA: HFMA2.MMA, the 16-bit
  FMA that ptxas may send down the tensor pipe) and in all, over the
  launch's CUDA-event time at the SM clock the blocks measured
  (``clock64`` over ``globaltimer``).  The mix lines also give the rate
  that their counts predict, at the single-op probes' rates of their
  type, if the pipes' times add and if the slowest pipe (or the dispatch
  of 128 a clock) sets it, and the wavefront cell's results an SM a clock
  that the mix reached beside the bounds' model of it: the tool exits 1
  if the card ran the mix faster than the model allows.
- ``rates`` lines: each pipe's rate, the fastest of its type's single-op
  probes, and the bounds' model (``model_lanes``, which ``chip_smoke.py``'s
  ``lanes_of`` calls) at those rates and at the nominal ones: a wavefront
  cell's 10 operations and a column cell's 11 in results an SM a clock.
- ``loop`` lines: the opcodes of the hottest loop of the kernel library's
  float32 wavefront (rows 8 and 16, one tile and the chain kernel's whole
  chain) and column (B4 at 16 and 32 lanes a pair, the B5 tile)
  instantiations and its packed bfloat16 wavefront (rows 8, one tile and
  the whole chain), a cell, and the
  results an SM a clock the probe's rates of its type give that mix: the
  largest of the pipes' and the dispatch's times, against their sum.  A
  wavefront's loop is the innermost backward branch's body with the most
  instructions (the step loop), its cells the loop's adds over the
  recurrence's 3 adds a cell (two cells an instruction in bfloat16); a
  column kernel's is its run loop (the outermost backward branch's body:
  32 unrolled columns, B4's carry loop once a column), its cells 32
  columns x 8 rows a lane.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import re
import statistics
import subprocess
from pathlib import Path

VARIANTS = ("FADD", "FMNMX", "FSEL", "mix", "HADD2.BF16", "HFMA2.BF16", "HMNMX2.BF16",
            "bf16 mix")
TYPE_OF = {v: ("bfloat16" if i >= 4 else "float32") for i, v in enumerate(VARIANTS)}
THREADS = 256
FMA_PIPE = {"FADD", "FMUL", "FFMA", "IMAD", "HADD2", "HFMA2", "HMUL2"}
ALU_PIPE = {"FMNMX", "FSEL", "FSETP", "ISETP", "SEL", "IMNMX", "VIMNMX", "IADD3", "VIADD",
            "LOP3", "HMNMX2", "VHMNMX", "PRMT"}
MMA_PIPE = {"HFMA2.MMA"}
PIPES = (("FMA", FMA_PIPE), ("ALU", ALU_PIPE), ("MMA", MMA_PIPE))
DISPATCH = 128  # thread instructions an SM dispatches a clock: 4 schedulers x 1 warp instruction
# The bounds' model of the float types.  A cell's adds run on the FMA pipe
# (FADD at 128 thread instructions an SM a clock; HADD2.BF16 and HFMA2.BF16
# at 64), its max, compare and select on the ALU pipe (64 in both types),
# and all of them through the dispatch (128); the pipes run side by side,
# so the slowest sets the time.  bfloat16 gives two results an instruction
# and fuses an add and the max with 0 after it into one HFMA2.BF16.RELU;
# float32 has no such form (PTX's fma.relu is 16-bit only).  The HFMA2.MMA
# pipe, which ptxas may also send the 16-bit adds to, could only shorten
# the FMA pipe's time: that sets no bound of a wavefront or column cell,
# only that of E1's bfloat16 chains (more adds than maxes), and its rate
# is not measured.
NOMINAL = {"float32": {"FMA": 128, "ALU": 64}, "bfloat16": {"FMA": 64, "ALU": 64}}
PER_INSTRUCTION = {"float32": 1, "bfloat16": 2}  # results an instruction
FUSES_RELU = {"bfloat16"}
# (operations, adds, maxes with 0 right after an add) a float cell: the
# wavefront's diag + s, its max with 0, I's max and + extend, H's max, D's
# max, G's M + open and max, the score's compare and select; the column's
# the same with its two I maxes and its add-max
CELLS = {"wavefront": (10, 3, 1), "column": (11, 3, 1)}
ADDS_A_CELL = 3  # float adds a cell of both float32 recurrences
MIX_CELLS = 32  # values a mix's loop trip updates a thread (the probe's kValues x kRounds)


def functions(sass: str):
    """(mangled name, [(address, opcode, operands)]) of each function in
    cuobjdump's output."""
    name, ops = None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                yield name, ops
            name, ops = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)"
                     r"([^;]*)", line)
        if m and name:
            parts = m.group(2).split(".")
            op = parts[0] + (".MMA" if "MMA" in parts[1:] else "")
            ops.append((int(m.group(1), 16), op, m.group(3)))
    if name:
        yield name, ops


def hot_loop(ops):
    """The opcodes of the innermost loop with the most instructions: the
    body [target, branch] of a backward BRA that holds no other backward
    branch; [] without one."""
    loops = []
    for addr, op, rest in ops:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op == "BRA" and m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(a, b) for a, b in loops
             if not any((a, b) != (c, d) and a <= c and d <= b for c, d in loops)]
    bodies = [[op for addr, op, _ in ops if a <= addr <= b] for a, b in inner]
    return max(bodies, key=len, default=[])


def sass_of(lib: Path, nvcc: str) -> list:
    """[(demangled name, ops)] of a shared library's kernels."""
    cuda = Path(nvcc).parent
    sass = subprocess.run([str(cuda / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs = list(functions(sass))
    demangled = subprocess.run([str(cuda / "cu++filt")], input="\n".join(n for n, _ in funcs),
                               capture_output=True, text=True, check=True).stdout.splitlines()
    return [(d, ops) for d, (_, ops) in zip(demangled, funcs)]


def float32_label(name: str):
    """A label of the kernel library's float32 instantiations of the main
    shapes, or None (cu++filt may print a template argument as (int)8)."""
    name = re.sub(r"\((?:int|bool)\)", "", name)
    m = re.search(r"stream_wavefront_kernel<(\d+), (\d+), 2>", name)
    if m and m.group(1) in ("8", "16") and m.group(2) != "1":
        return f"wavefront rows={m.group(1)} {'chained' if m.group(2) == '2' else 'tail-acc'}"
    # the chain kernel (B3), a whole chain (with the pad shortcut, where
    # the tree has the choice)
    m = re.search(r"stream_chain_kernel<(\d+), 2, (false|0)(?:, (true|1))?>", name)
    if m and m.group(1) in ("8", "16"):
        return f"chain rows={m.group(1)}"
    m = re.search(r"column_scores_kernel<(\d+), 2(?:, (true|false|1|0))?>", name)
    if m and m.group(2) in ("true", "1"):
        return "column B5 tile"
    if m and m.group(1) in ("16", "32"):
        return f"column lanes={m.group(1)} B4"
    if re.search(r"column_tile_kernel<2>", name):  # B5's kernel of older trees
        return "column B5 tile"
    return None


def run_loop(ops):
    """The opcodes of the outermost loop: the body [target, branch] of the
    backward BRA that spans the most; [] without one."""
    loops = []
    for addr, op, rest in ops:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op == "BRA" and m and int(m.group(1), 16) <= addr:
            loops.append((addr - int(m.group(1), 16), int(m.group(1), 16), addr))
    if not loops:
        return []
    _, a, b = max(loops)
    return [op for addr, op, _ in ops if a <= addr <= b]


COLUMN_CELLS = 32 * 8  # cells a lane of a column kernel's run loop: 32 columns x 8 rows


def column_run(ops, columns=32):
    """The opcodes a column kernel runs over a run of `columns` columns on
    random reads: its run loop where that unrolls all of them (B4); where a
    column loop of a few unrolled columns spans most of the run loop (B5),
    the code outside the column loop once and the column loop's code,
    less what each column's first carry vote skips (the code up to its
    forward branch's target), once a pass; [] without a run loop."""
    def target(rest):
        m = re.search(r"0x([0-9a-f]+)", rest)
        return int(m.group(1), 16) if m else None

    back = [(addr - target(rest), target(rest), addr) for addr, op, rest in ops
            if op == "BRA" and target(rest) is not None and target(rest) <= addr]
    if not back:
        return []
    _, rs, re_ = max(back)
    inner = [x for x in back if rs < x[1] and x[2] < re_]
    if not inner or max(inner)[0] * 2 < re_ - rs:
        return run_loop(ops)
    _, cs, ce = max(inner)
    body = [(addr, op, rest) for addr, op, rest in ops if cs <= addr <= ce]
    skip, ends = set(), set()
    for (_, op, _), (addr, nop, rest) in zip(body, body[1:]):
        t = target(rest)
        if op == "VOTE" and nop == "BRA" and t is not None and t > addr and t not in ends:
            ends.add(t)
            skip.update(a for a, _, _ in body if addr < a < t)
    if not ends:
        return run_loop(ops)
    outside = [op for addr, op, _ in ops if rs <= addr <= re_ and not cs <= addr <= ce]
    return outside + [op for addr, op, _ in body if addr not in skip] * (columns // len(ends))


def bfloat16_label(name: str):
    """A label of the kernel library's packed bfloat16 wavefront at rows 8
    (one tile, a chained tile of older trees, or the chain kernel's whole
    chain; its main-shape rows), or None."""
    name = re.sub(r"\((?:int|bool)\)", "", name)
    m = re.search(r"stream_wavefront_x2_kernel<8, (\d+), 5>", name)
    if m and m.group(1) != "1":
        return f"wavefront rows=8 {'chained' if m.group(1) == '2' else 'tail-acc'} bfloat16"
    if re.search(r"stream_chain_(x2_)?kernel<8, 5, (false|0)(?:, (true|1))?>", name):
        return "chain rows=8 bfloat16"
    return None


def by_pipe(count) -> dict:
    """{pipe: instructions of count on it}."""
    return {pipe: sum(count[k] for k in ops) for pipe, ops in PIPES}


def pipe_rates(measured: dict) -> dict:
    """Every pipe's rate: a pipe that no single-op probe of the type reached
    (HFMA2.MMA where ptxas kept the probe's FMAs off it) at the FMA pipe's."""
    return {p: measured.get(p) or measured["FMA"] for p, _ in PIPES}


def model_lanes(dtype: str, ops: float, adds: float, relus: float = 0,
                rates: dict | None = None) -> float:
    """Results an SM a clock of `ops` float operations in `dtype`: `adds`
    of them on the FMA pipe, `relus` maxes with 0 that bfloat16 fuses into
    its add's instruction, the rest on the ALU pipe; the slowest pipe or
    the dispatch sets the time, at `rates` (thread instructions an SM a
    clock by pipe) or the nominal ones."""
    r = rates or NOMINAL[dtype]
    per = PER_INSTRUCTION[dtype]
    alu = ops - adds - (relus if dtype in FUSES_RELU else 0)
    return ops / max(adds / (per * r["FMA"]), alu / (per * r["ALU"]),
                     (adds + alu) / (per * DISPATCH))


def build_probe(nvcc: str) -> Path:
    from swtpu_torch.ops import _build

    src = _build.CSRC / "fp32_probe.cu"
    flags = (*_build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared")
    h = hashlib.sha256(" ".join(flags).encode() + src.read_bytes()).hexdigest()[:16]
    lib = _build.build_dir() / f"libfp32_probe_{h}.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([nvcc, *flags, "-o", str(lib), str(src)], check=True)
    return lib


def run_probe(lib: Path, variant: int, trips: int, sms: int):
    """(blocks an SM, median event ms of 3 launches after a warm one,
    median loop clocks and ns over the blocks of the last launch)."""
    import torch

    probe = ctypes.CDLL(str(lib))
    probe.swtpu_fp32_probe.restype = ctypes.c_int
    probe.swtpu_fp32_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                       ctypes.c_void_p]
    probe.swtpu_fp32_probe_blocks_per_sm.restype = ctypes.c_int
    probe.swtpu_fp32_probe_blocks_per_sm.argtypes = [ctypes.c_int]
    per_sm = probe.swtpu_fp32_probe_blocks_per_sm(variant)
    if per_sm <= 0:
        raise RuntimeError(f"fp32 probe variant {VARIANTS[variant]}: occupancy {per_sm}")
    blocks = sms * per_sm
    out = torch.empty(blocks * THREADS, dtype=torch.float32, device="cuda")
    clocks = torch.empty((blocks, 2), dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream()
    times = []
    for i in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rc = probe.swtpu_fp32_probe(variant, out.data_ptr(), clocks.data_ptr(), blocks, trips,
                                    1.0, stream.cuda_stream)
        end.record()
        if rc:
            raise RuntimeError(f"fp32 probe variant {VARIANTS[variant]}: CUDA error {rc}")
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    c = clocks.cpu()
    return (per_sm, statistics.median(times), float(c[:, 0].median()),
            float(c[:, 1].median()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trips", type=int, default=40000, help="loop trips of each probe thread")
    args = ap.parse_args()
    import torch

    from swtpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    nvcc = _build._nvcc()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = build_probe(nvcc)
    loops = {}
    for name, ops in sass_of(lib, nvcc):
        m = re.search(r"(?:fp32|bf16)_probe_kernel<(\d+)>", re.sub(r"\(int\)", "", name))
        if m:
            loops[int(m.group(1))] = collections.Counter(hot_loop(ops))
    on = {}  # variant -> {pipe: thread instructions an SM a clock}
    over = {}  # mix -> whether it ran faster than the bounds' model allows
    rates = {"float32": {}, "bfloat16": {}}  # each pipe's fastest single-op probe
    for v, what in enumerate(VARIANTS):
        per_sm, ms, cycles, ns = run_probe(lib, v, args.trips, sms)
        count = loops[v]
        ghz = cycles / ns
        # loop trips an SM a clock, over the launch's time at the blocks' clock
        per_clock = args.trips * per_sm * THREADS / (ms * 1e6 * ghz)
        pipes = by_pipe(count)
        total = sum(count.values())
        on[what] = {p: n * per_clock for p, n in pipes.items()}
        line = (f"probe {what} | {per_sm} blocks an SM | loop {total} instructions: "
                + " ".join(f"{k}:{n}" for k, n in sorted(count.items()))
                + f" | SM clock {ghz * 1e3:.1f} MHz, {ms:.3f} ms (a block's loop "
                f"{cycles / (ms * 1e6 * ghz):.3f} of it) | thread instructions an SM a clock: "
                + ", ".join(f"{p} pipe {r:.2f}" for p, r in on[what].items())
                + f", all {total * per_clock:.2f}")
        kind = TYPE_OF[what]
        if "mix" in what:  # the two models at the single-op probes' rates, from its counts
            r = pipe_rates(rates[kind])
            used = {p: n for p, n in pipes.items() if n}
            t_max = max(*(n / r[p] for p, n in used.items()), total / DISPATCH)
            t_sum = sum(n / r[p] for p, n in used.items())
            arith = sum(used.values())
            # its wavefront cells' results an SM a clock beside the bounds' model
            got = per_clock * MIX_CELLS * PER_INSTRUCTION[kind] * CELLS["wavefront"][0]
            model = model_lanes(kind, *CELLS["wavefront"])
            over[what] = got > model
            line += (f" | arithmetic {arith * per_clock:.2f}; predicted {arith / t_max:.2f} "
                     f"by the slowest pipe, {arith / t_sum:.2f} by the sum | wavefront cells: "
                     f"{got:.1f} results an SM a clock, the bounds' model {model:.1f}"
                     + (" (UNDER the card's rate)" if over[what] else ""))
        else:
            for p, rate in on[what].items():
                if pipes[p]:
                    rates[kind][p] = max(rates[kind].get(p, 0.0), rate)
        print(line, flush=True)
    for kind, r in rates.items():
        print(f"rates {kind} an SM a clock: "
              + ", ".join(f"{p} pipe {x:.2f}" for p, x in r.items())
              + f", dispatch {DISPATCH} (instructions; {PER_INSTRUCTION[kind]} results each) "
              "| the bounds' model in results an SM a clock, at these rates and at the "
              f"nominal {NOMINAL[kind]}: "
              + ", ".join(f"{k} cell {model_lanes(kind, *c, rates=r):.1f} and "
                          f"{model_lanes(kind, *c):.1f}" for k, c in CELLS.items()), flush=True)
    _build.load_library()
    for name, ops in sass_of(_build.library_path(), nvcc):
        what, kind = float32_label(name), "float32"
        if not what:
            what, kind = bfloat16_label(name), "bfloat16"
        if not what:
            continue
        column = what.startswith("column")
        body = collections.Counter(column_run(ops) if column else hot_loop(ops))
        per = PER_INSTRUCTION[kind]
        adds = body["FADD"] if kind == "float32" else (
            body["HADD2"] + body["HFMA2"] + body["HFMA2.MMA"])
        if not adds:
            continue
        cells = COLUMN_CELLS if column else adds * per / ADDS_A_CELL
        pipes = {p: n / cells for p, n in by_pipe(body).items() if n}
        dispatched = sum(body.values()) / cells
        arith = sum(pipes.values())
        r = pipe_rates(rates[kind])
        t_max = max(*(n / r[p] for p, n in pipes.items()), dispatched / DISPATCH)
        t_sum = sum(n / r[p] for p, n in pipes.items())
        print(f"loop {what} | a cell: "
              + " ".join(f"{k} {body[k] / cells:.2f}" for k in sorted(body)
                         if k in FMA_PIPE | ALU_PIPE | MMA_PIPE)
              + f"; {dispatched:.2f} instructions | arithmetic {arith:.2f} instructions a cell "
              f"at {arith / t_max:.1f} an SM a clock (the largest of "
              + ", ".join(f"{p} {n / r[p]:.4f}" for p, n in pipes.items())
              + f", dispatch {dispatched / DISPATCH:.4f} clocks; their sum would give "
              f"{arith / t_sum:.1f}); {1 / t_max:.1f} cells an SM a clock", flush=True)
    if any(over.values()):
        print("the bounds' model is under the rate the card reached on "
              + ", ".join(w for w, o in over.items() if o), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
