"""The lane-major column kernel on torch tensors.

The port of ``swtpu.ops.pallas_lane``: B4's column-per-step recurrence
(``swtpu_torch.ops.column``) with the layout transposed, pairs on the
first axis and the query on the second, for queries of at most 128 bases.
The TPU kernel asked which axis carries the pairs; on the GPU the same
question is intra-task against inter-task, and the CUDA kernel
(``csrc/lane.cu``) answers it the other way from B4's port: one pair per
thread, sweeping its query in strips of 32 rows kept in registers, the I
chain an in-register ripple, and the strips handing their last row's M
and I over through a [n, B] buffer in device memory.

``lane_scores_reference`` is the plain PyTorch version of the kernel and
``lane_scores_cuda`` launches the CUDA kernel; ``_lane_call`` takes the
plain version for a tensor on the CPU and the kernel for a CUDA tensor;
there is no fallback from one to the other.

Kernel-level contract (both versions):

    q    [B, 128] int32, sentinel-padded (Q_PAD), as swtpu passes it
    t    [B, n] int8, sentinel-padded (T_PAD), n a multiple of 128
    ->   [B] int32 scores

``sw_scores_lane`` pads as swtpu pads (the query to 128 rows, the target
to a multiple of 128 columns, the pairs to a multiple of
``min(512, max(8, B))``); pads never move a score.
"""

from __future__ import annotations

import torch

from swtpu_torch.config import DEFAULT_PENALTIES, Penalties
from swtpu_torch.ops.column import NEG, _check_aligned
from swtpu_torch.ops.common import Q_PAD, T_PAD
from swtpu_torch.ops.stream import _check_kernel_tensors, _raise_on_error

LANE_TILE = 128  # query capacity: one lane tile on the TPU
BLOCK_PAIRS = 512  # swtpu's default block_pairs: it only sets the pair padding


def lane_scores_reference(q, t, penalties=DEFAULT_PENALTIES):
    """Plain PyTorch lane-major kernel (B6): q [B, 128] int32, t [B, n]
    int8 -> [B] int32 scores.

    Mirrors ``swtpu/ops/pallas_lane.py:_sw_kernel_lane`` one eager op per
    plane update on [B, 128] planes (pairs on the first axis, query rows on
    the second), with ``torch.roll`` for ``pltpu.roll``.  Per target column
    j:
      - s = match where q == t[:, j] else mismatch;
      - M = max(max(M, I) shifted one row down (zero above row 0) + s, 0);
      - base = max(max(M_up, M) + open + extend, max(I + extend, i0_bias)),
        M_up being this column's M one row up (zero above row 0), i0_bias
        row 0's seed, extend (the boundary I of 0 plus extend);
      - I = the max-plus prefix of base along the rows (log2(128) steps);
      - H = max(H, M).
    The score is the max of H over the rows."""
    ma, mi, go, ge = penalties.astuple()
    B, m = q.shape
    n = t.shape[1]
    dev = q.device
    i32 = torch.int32
    col_iota = torch.arange(m, device=dev)[None, :]
    q = q.to(i32)
    zero = torch.zeros((), dtype=i32, device=dev)
    neg = torch.tensor(NEG, dtype=i32, device=dev)
    ma_t = torch.tensor(ma, dtype=i32, device=dev)
    mi_t = torch.tensor(mi, dtype=i32, device=dev)
    i0_bias = torch.where(col_iota == 0, torch.tensor(ge, dtype=i32, device=dev), neg)
    oe = go + ge

    def shift_right(x, k, fill):
        """out[:, i] = x[:, i-k] along the query rows; rows < k get `fill`."""
        return torch.where(col_iota < k, fill, torch.roll(x, k, 1))

    M = torch.zeros((B, m), dtype=i32, device=dev)
    I = torch.zeros((B, m), dtype=i32, device=dev)
    H = torch.zeros((B, m), dtype=i32, device=dev)
    for j in range(n):
        s = torch.where(q == t[:, j : j + 1].to(i32), ma_t, mi_t)
        diag = torch.maximum(M, I)
        M_new = torch.clamp_min(shift_right(diag, 1, zero) + s, 0)
        M_up = shift_right(M_new, 1, zero)
        base = torch.maximum(
            torch.maximum(M_up, M) + oe, torch.maximum(I + ge, i0_bias)
        )
        x = base
        k = 1
        while k < m:
            x = torch.maximum(x, shift_right(x, k, neg) + k * ge)
            k *= 2
        H = torch.maximum(H, M_new)
        M, I = M_new, x
    return H.amax(1) if m else torch.zeros((B,), dtype=i32, device=dev)


def _validate_lane(q, t):
    B, m = q.shape
    if m != LANE_TILE:
        raise ValueError(f"the lane kernel takes q of {LANE_TILE} rows, got {m}")
    if t.shape[0] != B:
        raise ValueError(f"q has {B} pairs but t has {t.shape[0]}")
    if t.shape[1] % LANE_TILE:
        raise ValueError(f"target width {t.shape[1]} not a multiple of {LANE_TILE}")


def lane_scores_cuda(q, t, penalties=DEFAULT_PENALTIES):
    """The CUDA lane-major kernel on the contract of
    :func:`lane_scores_reference`; CUDA tensors only.  Launches on the
    current stream and counts each launch in ``lane_scores_cuda.launches``."""
    from swtpu_torch.ops._build import load_library

    _check_kernel_tensors(q=(q, torch.int32), t=(t, torch.int8))
    _validate_lane(q, t)
    _check_aligned(q=q, t=t)
    B, n = t.shape
    out = torch.empty((B,), dtype=torch.int32, device=q.device)
    if B == 0:
        return out
    # the strips' hand-off: the last row's M and I per column, [n, B] each
    buf = torch.empty((2, n, B), dtype=torch.int32, device=q.device)
    lib = load_library()
    ma, mi, go, ge = penalties.astuple()
    with torch.cuda.device(q.device):
        err = lib.swtpu_lane_scores(
            q.data_ptr(), t.data_ptr(), out.data_ptr(), buf[0].data_ptr(),
            buf[1].data_ptr(), B, n, ma, mi, go, ge,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, "lane_scores")
    lane_scores_cuda.launches += 1
    return out


lane_scores_cuda.launches = 0


def _lane_call(q, t, penalties):
    """q [B, 128] int32, t [B, n] int8 -> [B] int32: the plain version on
    the CPU, the kernel on CUDA."""
    if q.device.type == "cpu":
        return lane_scores_reference(q, t, penalties)
    if q.device.type == "cuda":
        return lane_scores_cuda(q, t, penalties)
    raise ValueError(f"no lane kernel for device {q.device}")


def pad_lane_batch(q, t):
    """swtpu's padding for the lane kernel: pairs to a multiple of
    ``min(512, max(8, B))``, the query to 128 rows (Q_PAD, as int32) and the
    target to a multiple of 128 columns (T_PAD)."""
    B, m = q.shape
    n = t.shape[1]
    bt = min(BLOCK_PAIRS, max(8, B))
    Bp = -(-B // bt) * bt
    np_ = -(-n // LANE_TILE) * LANE_TILE
    q = torch.nn.functional.pad(q.to(torch.int32), (0, LANE_TILE - m, 0, Bp - B),
                                value=Q_PAD)
    t = torch.nn.functional.pad(t.to(torch.int8), (0, np_ - n, 0, Bp - B),
                                value=T_PAD)
    return q.contiguous(), t.contiguous()


def sw_scores_lane(q, t, penalties: Penalties = DEFAULT_PENALTIES):
    """Score a batch of (query, target) pairs on the tensors' device: the
    counterpart of ``swtpu.ops.pallas_lane.sw_scores_pallas_lane``, without
    its TPU knobs (``interpret``, ``unroll``, and ``block_pairs``, which
    only sets the pair padding).

    Args:
      q: [B, m] int8 base codes, sentinel-padded (Q_PAD), m <= 128.
      t: [B, n] int8 base codes, sentinel-padded (T_PAD), on q's device.
      penalties: scoring penalties.

    Returns: [B] int32 scores.  On CUDA the kernel runs; on the CPU its
    plain version."""
    B, m = q.shape
    if m > LANE_TILE:
        raise ValueError(f"lane kernel requires m <= {LANE_TILE}, got {m}")
    qp, tp = pad_lane_batch(q, t)
    return _lane_call(qp, tp, penalties)[:B]
