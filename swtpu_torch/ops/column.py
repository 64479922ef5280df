"""The bucketed column kernels on torch tensors.

The port of ``swtpu.ops.pallas_kernel``.  A batch of (query, target) pairs,
each sentinel-padded to one bucket shape, is scored one DP column (every
query row of every pair) per target base.  The merged in-del matrix's
intra-column dependency ``I[i] = max(base[i], I[i-1] + extend)`` is a
max-plus prefix down the query rows.  Queries over ``QUERY_TILE`` = 256
bases chain 256-row tiles (``_chained_call``): each tile reads the
last-row M/I strips of the tile above per target column and writes its
own, and a running high score threads through the chain.

``column_scores_reference`` and ``column_chained_reference`` are the plain
PyTorch versions of the two kernels; ``column_scores_cuda`` and
``column_chained_cuda`` launch the hand-written CUDA kernels
(``csrc/column.cu``).  ``_scores_call`` and ``_tile_call`` take the plain
version for a tensor on the CPU and the kernel for a CUDA tensor; there is
no fallback from one to the other.

Kernel-level contract (both versions):

    q        [B, m] int8, sentinel-padded (Q_PAD); m a multiple of 8, at
             most 256 for the scores kernel and exactly 256 for a tile
    t        [B, n] int8, sentinel-padded (T_PAD); on CUDA n is a multiple
             of 32 (the kernel reads 32-byte runs of a pair's target)
    ms, is_  [B, n] int32: the tile above's last-row M and I per column
    h        [B] int32: the running high score

``score_width`` (None = exact int32) selects the RTL's W-bit wrap-parity
arithmetic: state holds score + 2^(W-1) ("biased"), the M update wraps
modulo 2^W and clamps on the sign bit; the I chain is never masked (see
``swtpu/ops/pallas_kernel.py:70-80`` for why masking inside the prefix
would be wrong).  A tile's strips and high score stay biased between
tiles; ``_chained_call`` subtracts the bias once at the end.

``state_dtype`` "float32" or "int16" carries the exact state in that type,
as swtpu's kernels do, with swtpu's prefix-scan floors (``STATE_FLOORS``).
The plain versions run swtpu's log2(m) prefix scan in that type; the CUDA
kernels ripple the chain down each lane's rows and carry it across lanes
(``column_geometry``: B4 and B5, one template, lazily, one lane a round;
int16 by a shuffle scan), with no floor.  Both give
the exact DP's integers, since every I candidate from the rows above
exceeds the floor (base >= open + extend) and no value nears 2^15 (a
score is at most match x 4,095 = 20,475 at +5): float32 and int16 scores
equal int32's.  Inter-tile strips stay int32.
"""

from __future__ import annotations

import torch

from swtpu_torch.config import DEFAULT_PENALTIES, Penalties
from swtpu_torch.ops.common import Q_PAD, T_PAD
from swtpu_torch.ops.stream import (
    _check_kernel_tensors, _raise_on_error, check_state_constants, state_value,
)

# Queries longer than this chain tiles of this many rows, carrying last-row
# M/I strips between tiles (the reference's reserved module-chaining ports).
QUERY_TILE = 256
# target columns the CUDA kernel reads at once: targets pad to a multiple
T_CHUNK = 32
# the plain version's target padding, swtpu's interpret-mode chunk
CPU_CHUNK = 8
NEG = -(2**30)  # the prefix scan's fill: never wins, since base >= open+extend
# the fill in each state type (swtpu's: pallas_kernel.py:62-67)
STATE_FLOORS = {"int32": NEG, "float32": -(2**23), "int16": -(2**13)}
STATE_TYPES = {"int32": torch.int32, "float32": torch.float32, "int16": torch.int16}
# the CUDA entry points' state codes (ColumnState in csrc/column.cu); a
# score width takes code 1, the biased int32 mode
STATE_CODES = {"int32": 0, "float32": 2, "int16": 3}
BIASED_CODE = 1


def _check_width(score_width, penalties) -> None:
    """The no-wrap proof for the I chain needs 2^(W-1) >= -(open + 2*extend)."""
    _, _, go, ge = penalties.astuple()
    if not 2 <= score_width <= 30:
        raise ValueError(
            f"score_width={score_width} out of range (need 2..30: the "
            "biased values live in 32-bit lanes)"
        )
    if (1 << (score_width - 1)) + (go + ge) + ge < 0:
        raise ValueError(
            f"score_width={score_width} too narrow for penalties "
            f"(need 2^(W-1) >= {-(go + 2 * ge)})"
        )


def _column_reference(q, t, penalties, score_width, strips=None, state_dtype="int32"):
    """The recurrence behind both plain versions, on [m, B] planes (query
    rows on the first axis, pairs on the second, as the TPU kernel lays
    them out), in `state_dtype`.  Returns (max of H over rows and columns
    [B], and with `strips` = (ms, is_), each [n, B], this tile's last-row M
    and I [n, B] each); all in the state's type and representation (biased
    under `score_width`)."""
    ma, mi, go, ge = penalties.astuple()
    m, B = q.shape
    n = t.shape[0]
    dev = q.device
    i32 = torch.int32
    dt = STATE_TYPES[state_dtype]
    neg = STATE_FLOORS[state_dtype]
    zero = 0
    if score_width is not None:
        mask = (1 << score_width) - 1
        zbit = 1 << (score_width - 1)
        zero = zbit  # biased representation of score 0 (boundary ties)
    row_iota = torch.arange(m, device=dev)[:, None]
    row0 = row_iota == 0
    qs = q.to(i32)
    ma_t = torch.tensor(state_value(ma, state_dtype), dtype=dt, device=dev)
    mi_t = torch.tensor(state_value(mi, state_dtype), dtype=dt, device=dev)
    oe = go + ge

    def shift_down(x, k, fill):
        """out[i] = x[i-k] along the query rows; rows < k get `fill`."""
        return torch.where(row_iota < k, fill, torch.roll(x, k, 0))

    M = torch.full((m, B), zero, dtype=dt, device=dev)
    I = torch.full((m, B), zero, dtype=dt, device=dev)  # boundary column I = 0
    H = torch.full((m, B), zero, dtype=dt, device=dev)
    if strips is None:
        # row 0's seed from the boundary I[-1][j] = 0 (RTL ZERO ties)
        i0_bias = torch.where(row0, torch.tensor(zero + ge, dtype=dt, device=dev), neg)
    else:
        ms_in, is_in = (s.to(dt) for s in strips)
        dprev = torch.full((B,), zero, dtype=dt, device=dev)  # diag at column -1
        ms_out = torch.empty((n, B), dtype=i32, device=dev)
        is_out = torch.empty((n, B), dtype=i32, device=dev)
    for j in range(n):
        s = torch.where(qs == t[j].to(i32), ma_t, mi_t)
        diag = torch.maximum(M, I)
        if strips is None:
            diag_s = shift_down(diag, 1, zero)
        else:
            # row 0's diagonal neighbour is (the tile above's last row, j-1)
            diag_s = torch.where(row0, dprev, torch.roll(diag, 1, 0))
        if score_width is not None:
            ms = (diag_s + s) & mask
            M_new = torch.where((ms & zbit) != 0, ms, zbit)
        else:
            M_new = torch.clamp_min(diag_s + s, 0)
        if strips is None:
            M_up = shift_down(M_new, 1, zero)
        else:
            # row 0's up-neighbour M, and its I seed, come from the strips
            M_up = torch.where(row0, ms_in[j], torch.roll(M_new, 1, 0))
            i0_bias = torch.where(row0, is_in[j] + ge, neg)
        base = torch.maximum(
            torch.maximum(M_up, M) + oe, torch.maximum(I + ge, i0_bias)
        )
        # max-plus prefix scan along the query rows, log2(m) steps
        x = base
        k = 1
        while k < m:
            x = torch.maximum(x, shift_down(x, k, neg) + k * ge)
            k *= 2
        H = torch.maximum(H, M_new)
        M, I = M_new, x
        if strips is not None:
            dprev = torch.maximum(ms_in[j], is_in[j])
            ms_out[j] = M_new[m - 1]
            is_out[j] = x[m - 1]
    h = H.amax(0) if m else torch.full((B,), zero, dtype=dt, device=dev)
    if strips is None:
        return h
    return h, ms_out, is_out


def column_scores_reference(q, t, penalties=DEFAULT_PENALTIES, score_width=None,
                            state_dtype="int32"):
    """Plain PyTorch column kernel (B4): q [B, m] int8, t [B, n] int8 ->
    [B] int32 scores, the state in `state_dtype` ("int32", or "float32" or
    "int16" with swtpu's floors, ``STATE_FLOORS``; score_width on int32
    only).

    Mirrors ``swtpu/ops/pallas_kernel.py:_sw_kernel`` one eager op per
    plane update on [m, B] planes.  Per target column j:
      - s = match where q == t[j] else mismatch;
      - M = max(max(M, I)[i-1, j-1] + s, 0) (biased: wrap, sign-bit clamp),
        with the zero boundary above row 0;
      - base = max(max(M_up, M) + open + extend, max(I + extend, i0_bias)),
        M_up being this column's M one row up, i0_bias row 0's seed;
      - I = the max-plus prefix of base down the rows (log2(m) steps);
      - H = max(H, M).
    The score is max(H) less the bias."""
    zero = 0 if score_width is None else 1 << (score_width - 1)
    h = _column_reference(q.t(), t.t(), penalties, score_width, state_dtype=state_dtype)
    return (h - zero).to(torch.int32)


def column_chained_reference(
    q, t, ms, is_, h, penalties=DEFAULT_PENALTIES, score_width=None, state_dtype="int32",
):
    """Plain PyTorch version of one 256-row query tile of the chained DP
    (B5): q [B, 256] int8, t [B, n] int8, the tile above's last-row strips
    ms, is_ [B, n] int32 and the running high score h [B] int32 ->
    (h, ms, is_) of this tile, the same shapes.

    Mirrors ``swtpu/ops/pallas_kernel.py:_sw_kernel_chained``: the
    recurrence of :func:`column_scores_reference` but for row 0, whose
    diagonal is max(ms, is_) of column j-1 (zero at j = 0), whose M_up is
    ms[j] and whose I seed is is_[j] + extend.  The first tile gets strips
    of zero (biased zero under `score_width`) and reproduces the unchained
    kernel.  The outputs stay biased under `score_width`.  In `state_dtype`
    the strips are cast to it as they are read, and the outputs are int32."""
    hmax, ms_out, is_out = _column_reference(
        q.t(), t.t(), penalties, score_width, strips=(ms.t(), is_.t()),
        state_dtype=state_dtype,
    )
    return torch.maximum(h.to(torch.int32), hmax.to(torch.int32)), ms_out.t(), is_out.t()


def _validate_column(q, t, tile):
    """Kernel-level shape rules shared by the two CUDA wrappers."""
    B, m = q.shape
    if t.shape[0] != B:
        raise ValueError(f"q has {B} pairs but t has {t.shape[0]}")
    if tile and m != QUERY_TILE:
        raise ValueError(f"a chained tile has {QUERY_TILE} query rows, got {m}")
    if not tile and (m % 8 or m > QUERY_TILE):
        raise ValueError(
            f"query width {m} must be a multiple of 8 and at most {QUERY_TILE}"
        )
    if t.shape[1] % T_CHUNK:
        raise ValueError(f"target width {t.shape[1]} not a multiple of {T_CHUNK}")


def _check_aligned(**tensors):
    """The kernel reads each pair's target as 16-byte vectors."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _kernel_state(score_width, state_dtype, penalties, m):
    """(W or 0, the state code) as the CUDA entry points take them, after
    the checks swtpu makes for the mode."""
    _check_state(score_width, state_dtype, penalties, m)
    return score_width or 0, BIASED_CODE if score_width else STATE_CODES[state_dtype]


def column_scores_cuda(q, t, penalties=DEFAULT_PENALTIES, score_width=None,
                       state_dtype="int32"):
    """The CUDA column kernel on the contract of
    :func:`column_scores_reference`; CUDA tensors only.  Launches on the
    current stream and counts each launch in ``column_scores_cuda.launches``."""
    from swtpu_torch.ops._build import load_library

    state = _kernel_state(score_width, state_dtype, penalties, q.shape[1])
    _check_kernel_tensors(q=(q, torch.int8), t=(t, torch.int8))
    _validate_column(q, t, tile=False)
    _check_aligned(t=t)
    B, m = q.shape
    n = t.shape[1]
    out = torch.empty((B,), dtype=torch.int32, device=q.device)
    if B == 0:
        return out
    lib = load_library()
    ma, mi, go, ge = penalties.astuple()
    with torch.cuda.device(q.device):
        err = lib.swtpu_column_scores(
            q.data_ptr(), t.data_ptr(), out.data_ptr(), B, m, n, ma, mi, go, ge,
            *state, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, "column_scores")
    column_scores_cuda.launches += 1
    return out


column_scores_cuda.launches = 0


def column_chained_cuda(
    q, t, ms, is_, h, penalties=DEFAULT_PENALTIES, score_width=None, state_dtype="int32",
):
    """The CUDA chained-tile kernel on the contract of
    :func:`column_chained_reference`; CUDA tensors only.  Launches on the
    current stream and counts each launch in ``column_chained_cuda.launches``."""
    from swtpu_torch.ops._build import load_library

    state = _kernel_state(score_width, state_dtype, penalties, None)
    _check_kernel_tensors(
        q=(q, torch.int8), t=(t, torch.int8), ms=(ms, torch.int32),
        is_=(is_, torch.int32), h=(h, torch.int32),
    )
    _validate_column(q, t, tile=True)
    _check_aligned(t=t)
    for name, s in (("ms", ms), ("is_", is_)):
        if s.shape != t.shape:
            raise ValueError(
                f"{name} shape {tuple(s.shape)} != target shape {tuple(t.shape)}"
            )
    B, n = t.shape
    if h.shape != (B,):
        raise ValueError(f"h shape {tuple(h.shape)} != ({B},)")
    outs = (
        torch.empty((B,), dtype=torch.int32, device=q.device),
        torch.empty((B, n), dtype=torch.int32, device=q.device),
        torch.empty((B, n), dtype=torch.int32, device=q.device),
    )
    if B == 0:
        return outs
    lib = load_library()
    ma, mi, go, ge = penalties.astuple()
    with torch.cuda.device(q.device):
        err = lib.swtpu_column_chained(
            q.data_ptr(), t.data_ptr(), ms.data_ptr(), is_.data_ptr(),
            h.data_ptr(), *(o.data_ptr() for o in outs), B, n, ma, mi, go, ge,
            *state, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, "column_chained")
    column_chained_cuda.launches += 1
    return outs


column_chained_cuda.launches = 0


# rows a lane of the CUDA scores kernel (B4) in the one-value states
ROWS_PER_LANE = 8


def column_geometry(m, state_dtype="int32"):
    """(lanes a pair, rows a lane, pairs a warp) of the CUDA scores kernel
    for a query of m rows (1..QUERY_TILE) in `state_dtype` (a score width
    runs int32's): the fewest lanes of ROWS_PER_LANE rows that cover m, 32
    / lanes pairs a warp; int16 (``column_x2_kernel``) two pairs a warp of
    32 lanes, the fewest rows a lane (1, 2, 4 or 8) that cover m.
    ``swtpu_column_scores`` picks its instantiation by the same rule."""
    if not 0 < m <= QUERY_TILE:
        raise ValueError(f"query width {m} must be in 1..{QUERY_TILE}")
    if state_dtype == "int16":
        return 32, next(r for r in (1, 2, 4, 8) if 32 * r >= m), 2
    lanes = next(k for k in (1, 2, 4, 8, 16, 32) if k * ROWS_PER_LANE >= m)
    return lanes, ROWS_PER_LANE, 32 // lanes


def column_kernel_info(m=QUERY_TILE, state_dtype="int32", score_width=None, tile=False):
    """(registers a thread, local spill bytes a thread, resident blocks an
    SM) of the CUDA column kernel's instantiation for a query of m rows (a
    chained tile with tile=True) in the state that `state_dtype` and
    `score_width` pick, from the CUDA runtime on the current device.
    Raises if the library's lanes and rows for m are not
    ``column_geometry``'s."""
    import ctypes

    from swtpu_torch.ops._build import load_library

    if not tile:
        geometry = column_geometry(m, state_dtype)
    if score_width is not None:
        _check_width(score_width, Penalties(0, 0, 0, 0))
    elif state_dtype not in STATE_CODES:
        raise ValueError(f"unknown state_dtype {state_dtype!r}")
    lib = load_library()
    out = (ctypes.c_int * 5)()
    code = BIASED_CODE if score_width else STATE_CODES[state_dtype]
    err = lib.swtpu_column_kernel_info(m, code, int(tile), out)
    _raise_on_error(lib, err, "column_kernel_info")
    if not tile and tuple(out[3:]) != geometry[:2]:
        raise RuntimeError(
            f"the kernel takes {tuple(out[3:])} (lanes, rows) for m={m}, "
            f"column_geometry {geometry[:2]}"
        )
    return tuple(out[:3])


def _scores_call(q, t, penalties, score_width, state_dtype="int32"):
    """q [B, m] int8, t [B, n] int8 -> [B] int32: the plain version on the
    CPU, the kernel on CUDA."""
    if q.device.type == "cpu":
        return column_scores_reference(q, t, penalties, score_width, state_dtype)
    if q.device.type == "cuda":
        return column_scores_cuda(q, t, penalties, score_width, state_dtype)
    raise ValueError(f"no column kernel for device {q.device}")


def _tile_call(q, t, ms, is_, h, penalties, score_width, state_dtype="int32"):
    """One chained tile -> (h, ms, is_): the plain version on the CPU, the
    kernel on CUDA."""
    if q.device.type == "cpu":
        return column_chained_reference(q, t, ms, is_, h, penalties, score_width, state_dtype)
    if q.device.type == "cuda":
        return column_chained_cuda(q, t, ms, is_, h, penalties, score_width, state_dtype)
    raise ValueError(f"no chained column kernel for device {q.device}")


def _chained_call(q, t, penalties, score_width, tile=_tile_call, state_dtype="int32"):
    """Chain QUERY_TILE-row tiles over the query: a Python loop of K launches
    that threads the last-row M/I strips and the running high score through
    device memory, only the previous tile's alive.  q [B, K*256], t [B, n]
    -> [B] int32 scores.  `tile` runs one tile (``_tile_call``'s contract,
    the state type as its last argument)."""
    B, m = q.shape
    n = t.shape[1]
    # boundary strips and high score: biased zero under wrap-parity
    z0 = (1 << (score_width - 1)) if score_width is not None else 0
    h = torch.full((B,), z0, dtype=torch.int32, device=q.device)
    ms = torch.full((B, n), z0, dtype=torch.int32, device=q.device)
    is_ = torch.full((B, n), z0, dtype=torch.int32, device=q.device)
    for k in range(m // QUERY_TILE):
        qtile = q[:, k * QUERY_TILE : (k + 1) * QUERY_TILE].contiguous()
        h, ms, is_ = tile(qtile, t, ms, is_, h, penalties, score_width, state_dtype)
    return h - z0


def _check_state(score_width, state_dtype, penalties, m):
    """swtpu's checks of a kernel's state: the width's range and no-wrap
    rule under wrap-parity (int32 state only), and the OverflowError of
    the first constant that an int16 state cannot hold, in swtpu's order
    (pallas_kernel.py:93-95 and 116, or 171-172 and 196 for a tile: the
    extend penalty, open + extend, the extend penalty, then k x extend for
    k = 1, 2, 4, ... < m; a tile has m = 256 and no first one).  m None:
    a chained tile."""
    if score_width is not None:
        if state_dtype != "int32":
            raise ValueError(f"score_width needs int32 state, got {state_dtype!r}")
        _check_width(score_width, penalties)
        return
    if state_dtype not in STATE_TYPES:
        raise ValueError(f"unknown state_dtype {state_dtype!r}")
    _, _, go, ge = penalties.astuple()
    first = [ge] if m is not None else []
    rows = QUERY_TILE if m is None else m
    scan = [k * ge for k in (1 << i for i in range(rows.bit_length())) if k < rows]
    check_state_constants(state_dtype, first + [go + ge, ge] + scan)


def _resolve_state(state_dtype, score_width):
    """(the register width of the wrap-parity mode or None, the state
    type) of swtpu's state_dtype: "int16_biased" is int32 state at
    `score_width`; "int32", "float32" and "int16" are exact."""
    if state_dtype == "int16_biased":
        return score_width, "int32"
    return None, state_dtype


def pad_column_batch(q, t, chunk):
    """swtpu's static padding, with sentinels (score-neutral): the query to
    a multiple of 8 rows, or of QUERY_TILE rows when it will chain; the
    target to a multiple of `chunk` columns.  Pairs are not padded: the
    CUDA kernel masks its last warp's ragged edge."""
    B, m = q.shape
    n = t.shape[1]
    mq = QUERY_TILE if m > QUERY_TILE else 8
    mp = -(-m // mq) * mq
    np_ = -(-n // chunk) * chunk
    q = q.to(torch.int8)
    t = t.to(torch.int8)
    if mp != m:
        q = torch.nn.functional.pad(q, (0, mp - m), value=Q_PAD)
    if np_ != n:
        t = torch.nn.functional.pad(t, (0, np_ - n), value=T_PAD)
    return q.contiguous(), t.contiguous()


def sw_scores_column(
    q, t, penalties: Penalties = DEFAULT_PENALTIES, state_dtype: str = "int32",
    score_width: int = 12,
):
    """Score a batch of (query, target) pairs on the tensors' device: the
    counterpart of ``swtpu.ops.pallas_kernel.sw_scores_pallas``.

    Args:
      q: [B, m] int8 base codes, sentinel-padded (Q_PAD).
      t: [B, n] int8 base codes, sentinel-padded (T_PAD), on q's device.
      penalties: scoring penalties.
      state_dtype: "int32" (exact), "float32" or "int16" (exact state in
        that type, the same scores) or "int16_biased" — the RTL's
        `score_width`-bit biased register arithmetic, overflow wrap and
        sign-bit clamp included (oracle: ``sw_score_single_biased``).
      score_width: register width for "int16_biased" (RTL default 12).

    Returns: [B] int32 scores.  A query over QUERY_TILE bases chains
    ceil(m/256) tiles.  On CUDA the kernels run; on the CPU their plain
    versions (targets padded as swtpu pads them in interpret mode)."""
    width, dtype = _resolve_state(state_dtype, score_width)
    chunk = T_CHUNK if t.device.type == "cuda" else CPU_CHUNK
    q, t = pad_column_batch(q, t, chunk)
    chained = q.shape[1] > QUERY_TILE
    _check_state(width, dtype, penalties, None if chained else q.shape[1])
    if chained:
        return _chained_call(q, t, penalties, width, state_dtype=dtype)
    return _scores_call(q, t, penalties, width, dtype)
