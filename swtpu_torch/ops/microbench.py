"""The microbenchmarks' kernels on torch tensors.

The ports of the two TPU microbenchmark kernels:

- E1, ``experiments/microbench_ops.py:make_kernel``: `steps` steps of 8
  dependent ops of one primitive pattern of the recurrence on a whole
  [512, 128] array, in int32, int16, float32 or bfloat16, so that the
  difference of two step counts gives one op's cost;
- E2, ``experiments/kernel_ablate.py:make_kernel``: B2's wavefront step
  (128 rows, one segment, tail accumulator) with groups of ops removed, so
  that the variants' times say where a step's cycles go.  Only ``full``
  is a correct score: it is B2, and its int32 strip equals
  ``stream_strip_reference(rows=1, segments=1)`` bit for bit.

``microbench_ops_reference`` and ``stream_ablate_reference`` are the plain
PyTorch versions; ``microbench_ops_cuda`` and ``stream_ablate_cuda``
launch the hand-written CUDA kernels (``csrc/microbench.cu``);
``microbench_ops`` and ``stream_ablate``, the entries that
``experiments/torch_microbench_ops.py`` and ``torch_kernel_ablate.py``
call, take one or the other by the tensor's device.  On the CPU only the
plain versions run; a CUDA tensor launches the kernel or raises.  Every value either computes is a small integer, exact in all four
types, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from swtpu_torch.ops.stream import _check_kernel_tensors, _raise_on_error

# E1
SHAPE = (512, 128)  # microbench_ops.py:19
OPS_PER_STEP = 8
PATTERNS = ("addmax", "select", "roll_lane", "roll_sub")
DTYPES = {
    "int32": torch.int32,
    "int16": torch.int16,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}
# E2
LANES = 128
STEP_CHUNK = 32  # kernel_ablate.py:36: stream lengths are multiples of this
VARIANTS = ("full", "norolls", "nosel", "arith", "minimal")
MA, MI, GO, GE = 5, -4, -12, -4  # kernel_ablate.py:37


def _dtype_code(dtype: torch.dtype) -> int:
    codes = list(DTYPES.values())
    if dtype not in codes:
        raise ValueError(f"dtype {dtype} is not one of {', '.join(DTYPES)}")
    return codes.index(dtype)


def microbench_ops_reference(x, pattern, steps):
    """Plain PyTorch E1: x [512, 128] of one of the four dtypes -> the
    array after `steps` steps, the same shape and dtype.

    Mirrors ``microbench_ops.py:make_kernel``: each step applies 8 times
      addmax     y = max(y + 1, y)
      select     y = where(y > 1, y, y + 1)
      roll_lane  y = max(y, roll(y, 1, axis=1) + 1)
      roll_sub   y = max(y, roll(y, 1, axis=0) + 1)
    (cyclic rolls, ``torch.roll`` for ``pltpu.roll``), then
    y = y - (y // 7) * 7 (floor division) keeps every value in 0..6."""
    if pattern not in PATTERNS:
        raise ValueError(f"unknown pattern {pattern!r}")
    _dtype_code(x.dtype)
    y = x.clone()
    for _ in range(steps):
        for _ in range(OPS_PER_STEP):
            if pattern == "roll_lane":
                y = torch.maximum(y, torch.roll(y, 1, 1) + 1)
            elif pattern == "roll_sub":
                y = torch.maximum(y, torch.roll(y, 1, 0) + 1)
            elif pattern == "addmax":
                y = torch.maximum(y + 1, y)
            else:
                y = torch.where(y > 1, y, y + 1)
        y = y - torch.div(y, 7, rounding_mode="floor") * 7
    return y


def microbench_ops_cuda(x, pattern, steps):
    """The CUDA E1 kernel on the contract of
    :func:`microbench_ops_reference`; CUDA tensors only.  Launches on the
    current stream and counts each launch in ``microbench_ops_cuda.launches``."""
    from swtpu_torch.ops._build import load_library

    if pattern not in PATTERNS:
        raise ValueError(f"unknown pattern {pattern!r}")
    code = _dtype_code(x.dtype)
    _check_kernel_tensors(x=(x, x.dtype))
    if tuple(x.shape) != SHAPE:
        raise ValueError(f"x must be {list(SHAPE)}, got {list(x.shape)}")
    if steps < 0:
        raise ValueError(f"steps {steps} must be >= 0")
    out = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.swtpu_microbench_ops(
            x.data_ptr(), out.data_ptr(), code, PATTERNS.index(pattern), steps, 1,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, "microbench_ops")
    microbench_ops_cuda.launches += 1
    return out


microbench_ops_cuda.launches = 0


def stream_ablate_reference(qT, stream, variant, dtype=torch.int32):
    """Plain PyTorch E2: qT [128, S] int8 (query row r on row r), stream
    [T, S] int8 flagged chars -> [T, S] int32, the tail accumulator after
    each step, with the state in `dtype`.

    Mirrors ``kernel_ablate.py:make_kernel`` on [128, S] planes, one eager
    op per plane update, the whole stream in one pass (the TPU's grid of
    32-step chunks carries its state in scratch, so chunking changes
    nothing).  Variants: ``full`` (B2's step), ``norolls`` (every roll,
    the char pipe's included, is the identity), ``nosel`` (no boundary
    selects), ``arith`` (the max/add core), ``minimal`` (one max + add per
    plane).  The rolls are cyclic: in ``nosel`` and ``arith`` row 0 takes
    row 127's values.  int16 state wraps in two's complement."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    _dtype_code(dtype)
    dev = qT.device
    S = qT.shape[1]
    T = stream.shape[0]
    i32 = torch.int32
    if variant == "norolls":
        def roll(x):
            return x
    else:
        def roll(x):
            return torch.roll(x, 1, 0)
    sel = variant not in ("nosel", "arith", "minimal")
    row_iota = torch.arange(LANES, device=dev)[:, None]
    seghead = row_iota == 0
    zero = torch.zeros((), dtype=dtype, device=dev)
    Gp, D1, D2, Hp = (torch.zeros((LANES, S), dtype=dtype, device=dev) for _ in range(4))
    C = torch.full((LANES, S), 4, dtype=i32, device=dev)
    acc = torch.zeros((S,), dtype=dtype, device=dev)
    q = qT.to(i32)
    sc = stream.to(i32)
    out = torch.empty((T, S), dtype=i32, device=dev)
    for r in range(T):
        if variant == "minimal":
            D1 = torch.maximum(D1 + GE, D2)
            D2 = D1
            out[r] = D1[LANES - 1].to(i32)
            continue
        if variant != "norolls":
            C = torch.roll(C, 1, 0)
        C = torch.where(seghead, sc[r], C)
        f0 = C >= 8
        cval = C & 7
        s = torch.where(cval == q, MA, MI).to(dtype)
        if variant == "arith":
            Mc = torch.clamp_min(roll(D2) + s, 0)
            Ic = torch.maximum(roll(Gp), Gp) + GE
            Hc = torch.maximum(roll(Hp), Mc)
        else:
            bmask = seghead | f0
            diag = torch.where(bmask, zero, roll(D2)) if sel else roll(D2)
            Mc = torch.clamp_min(diag + s, 0)
            G_up = torch.where(seghead, zero, roll(Gp)) if sel else roll(Gp)
            G_left = torch.where(f0, zero, Gp) if sel else Gp
            Ic = torch.maximum(G_up, G_left) + GE
            H_up = torch.where(seghead, zero, roll(Hp)) if sel else roll(Hp)
            Hc = torch.maximum(H_up, Mc)
        acc = torch.maximum(torch.where(f0[LANES - 1], zero, acc) if sel else acc,
                            Hc[LANES - 1])
        out[r] = acc.to(i32)
        D2 = D1
        D1 = torch.maximum(Mc, Ic)
        Gp = torch.maximum(Mc + GO, Ic)
        Hp = Hc
    return out


def stream_ablate_cuda(qT, stream, variant, dtype=torch.int32):
    """The CUDA E2 kernel on the contract of :func:`stream_ablate_reference`;
    CUDA tensors only.  Launches on the current stream and counts each
    launch in ``stream_ablate_cuda.launches``."""
    from swtpu_torch.ops._build import load_library

    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    code = _dtype_code(dtype)
    _check_kernel_tensors(qT=(qT, torch.int8), stream=(stream, torch.int8))
    if qT.shape[0] != LANES:
        raise ValueError(f"qT must have {LANES} rows, got {qT.shape[0]}")
    S = qT.shape[1]
    T = stream.shape[0]
    if stream.shape[1] != S:
        raise ValueError(f"stream width {stream.shape[1]} != {S} streams")
    if T % STEP_CHUNK:
        raise ValueError(f"stream length {T} not a multiple of {STEP_CHUNK}")
    out = torch.empty((T, S), dtype=torch.int32, device=qT.device)
    if T == 0 or S == 0:
        return out
    lib = load_library()
    with torch.cuda.device(qT.device):
        err = lib.swtpu_stream_ablate(
            qT.data_ptr(), stream.data_ptr(), out.data_ptr(), S, T, code,
            VARIANTS.index(variant), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, "stream_ablate")
    stream_ablate_cuda.launches += 1
    return out


stream_ablate_cuda.launches = 0


def microbench_ops(x, pattern, steps):
    """E1 on the tensor's device: the plain version on the CPU, the kernel
    on CUDA."""
    if x.device.type == "cpu":
        return microbench_ops_reference(x, pattern, steps)
    if x.device.type == "cuda":
        return microbench_ops_cuda(x, pattern, steps)
    raise ValueError(f"no microbench kernel for device {x.device}")


def stream_ablate(qT, stream, variant, dtype=torch.int32):
    """E2 on the tensors' device: the plain version on the CPU, the kernel
    on CUDA."""
    if qT.device.type == "cpu":
        return stream_ablate_reference(qT, stream, variant, dtype)
    if qT.device.type == "cuda":
        return stream_ablate_cuda(qT, stream, variant, dtype)
    raise ValueError(f"no stream-ablation kernel for device {qT.device}")
