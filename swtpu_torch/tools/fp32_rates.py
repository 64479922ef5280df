"""The float32 recurrences' opcode rates on the card, and their step loops.

    python -m swtpu_torch.tools.fp32_rates [--trips N]

On the machine with the CUDA toolkit and a GPU.  Prints the card's name
and power limit, then:

- ``probe`` lines: ``ops/csrc/fp32_probe.cu`` run alone, one launch a
  variant of as many blocks of 256 threads an SM as an SM holds (one
  wave), each thread holding 8 independent values: FADD; FMNMX; FSETP
  and FSEL; and the float32 bound's mix of 3 FADD, 5 FMNMX, 1 FSETP and 1
  FSEL a value.  Each line gives the opcodes of the probe's loop from its
  SASS and the thread instructions an SM retires a clock by pipe (FMA:
  FADD, FMUL, FFMA, IMAD; ALU: the compares, min/max, selects and integer
  adds and logic) and in all, over the launch's CUDA-event time at the SM
  clock the blocks measured (``clock64`` over ``globaltimer``).  The mix
  line also gives the rate that its counts predict if the pipes' times
  add, and if the slowest pipe (or the dispatch of 128 a clock) sets it.
- ``loop`` lines: the opcodes of the hottest loop (the innermost backward
  branch's body with the most instructions: the step loop) of the kernel
  library's float32 wavefront (rows 8 and 16, one tile and chained) and
  column (4 and 8 rows a lane, B4 and the B5 tile) instantiations, a cell
  (the loop's FADDs over the recurrence's 3 float adds a cell), and the
  results an SM a clock the probe's rates give that mix: the largest of
  the FMA pipe's, the ALU pipe's and the dispatch's times, against their sum.
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

VARIANTS = ("FADD", "FMNMX", "FSEL", "mix")
THREADS = 256
FMA_PIPE = {"FADD", "FMUL", "FFMA", "IMAD"}
ALU_PIPE = {"FMNMX", "FSEL", "FSETP", "ISETP", "SEL", "IMNMX", "VIMNMX", "IADD3", "VIADD",
            "LOP3"}
DISPATCH = 128  # thread instructions an SM dispatches a clock: 4 schedulers x 1 warp instruction
ADDS_A_CELL = 3  # float adds a cell of both float32 recurrences


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
            ops.append((int(m.group(1), 16), m.group(2).split(".")[0], m.group(3)))
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
    m = re.search(r"column_kernel<(\d+), 2, (true|false|1|0)>", name)
    if m and m.group(1) in ("4", "8"):
        return f"column rpl={m.group(1)} {'B5 tile' if m.group(2) in ('true', '1') else 'B4'}"
    return None


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
        m = re.search(r"fp32_probe_kernel<(\d+)>", re.sub(r"\(int\)", "", name))
        if m:
            loops[int(m.group(1))] = collections.Counter(hot_loop(ops))
    on = {}  # variant -> (FMA-pipe, ALU-pipe) thread instructions an SM a clock
    for v, what in enumerate(VARIANTS):
        per_sm, ms, cycles, ns = run_probe(lib, v, args.trips, sms)
        count = loops[v]
        ghz = cycles / ns
        # loop trips an SM a clock, over the launch's time at the blocks' clock
        per_clock = args.trips * per_sm * THREADS / (ms * 1e6 * ghz)
        fma_n = sum(count[k] for k in FMA_PIPE)
        alu_n = sum(count[k] for k in ALU_PIPE)
        total = sum(count.values())
        on[what] = (fma_n * per_clock, alu_n * per_clock)
        line = (f"probe {what} | {per_sm} blocks an SM | loop {total} instructions: "
                + " ".join(f"{k}:{n}" for k, n in sorted(count.items()))
                + f" | SM clock {ghz * 1e3:.1f} MHz, {ms:.3f} ms (a block's loop "
                f"{cycles / (ms * 1e6 * ghz):.3f} of it) | thread instructions an SM a clock: "
                f"FMA pipe {on[what][0]:.2f}, ALU pipe {on[what][1]:.2f}, all "
                f"{total * per_clock:.2f}")
        if what == "mix":  # the two models at the table's rates, from its own counts
            t_max = max(fma_n / 128, alu_n / 64, total / DISPATCH)
            t_sum = fma_n / 128 + alu_n / 64
            arith = fma_n + alu_n
            line += (f" | arithmetic {arith * per_clock:.2f}; predicted {arith / t_max:.2f} "
                     f"by the slowest pipe, {arith / t_sum:.2f} by the sum")
        print(line, flush=True)
    # the least time of a mix: the faster probe of each pipe
    fma, alu = on["FADD"][0], max(on["FMNMX"][1], on["FSEL"][1])
    print(f"rates an SM a clock: FMA pipe {fma:.2f}, ALU pipe {alu:.2f}, dispatch {DISPATCH}",
          flush=True)
    _build.load_library()
    for name, ops in sass_of(_build.library_path(), nvcc):
        what = float32_label(name)
        body = collections.Counter(hot_loop(ops)) if what else None
        if not body or not body["FADD"]:
            continue
        cells = body["FADD"] / ADDS_A_CELL
        on_fma = sum(body[k] for k in FMA_PIPE) / cells
        on_alu = sum(body[k] for k in ALU_PIPE) / cells
        dispatched = sum(body.values()) / cells
        arith = on_fma + on_alu
        t_max = max(on_fma / fma, on_alu / alu, dispatched / DISPATCH)
        t_sum = on_fma / fma + on_alu / alu
        print(f"loop {what} | a cell: "
              + " ".join(f"{k} {body[k] / cells:.2f}" for k in sorted(body)
                         if k in FMA_PIPE | ALU_PIPE)
              + f"; {dispatched:.2f} instructions | arithmetic {arith:.2f} a cell at "
              f"{arith / t_max:.1f} results an SM a clock (the largest of FMA {on_fma / fma:.4f},"
              f" ALU {on_alu / alu:.4f}, dispatch {dispatched / DISPATCH:.4f} clocks; their sum would give "
              f"{arith / t_sum:.1f})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
