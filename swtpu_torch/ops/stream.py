"""The streamed anti-diagonal wavefront on torch tensors.

The port of ``swtpu.ops.pallas_stream``.  Query positions sit on wavefront
sublanes (R query rows folded into each), one logical stream per column;
every step injects one flagged char per segment head, shifts the char pipe
one sublane down, and updates every cell on the anti-diagonal.  Each
segment tail keeps a running-best accumulator that resets at a read's
first char; the [T, N] int32 strip of those accumulators is the emission
surface the host-computed coordinates index.  At rows = 1 the strip can
instead be the tail row's rippled H (``tail_acc=False``).

Queries longer than 128 bases chain K = ceil(len/128) tiles of 128 query
rows (``sw_scores_stream_long``): each tile's row 0 reads the tile above's
row-127 D/G/H from boundary strips, and each tile emits its own row 127
for the tile below.  On CUDA one launch runs the whole chain in every
state mode (``stream_chain_cuda``): the tiles run side by side, a fixed
lag apart, and hand row 127 down on the chip.

Every form runs in swtpu's six state modes: exact int32 state; float32
state (the same values, exact below 2^24); the RTL's W-bit biased
wrap-parity (``score_width``) on int32 state, where zero is 2^(W-1) and
only the M update wraps; int16 and uint16 state, whose adds wrap modulo
2^16 (uint16 wraps a mismatch of -4 to 2^16 - 4, and a negative open or
extend penalty raises swtpu's OverflowError); and
bfloat16 state, rounded to nearest even after every add, so that a score
above 256 can come out below the exact one.  The 16-bit states take rows
of at most 8, as swtpu's do.  The one-tile forms write their strips
unbiased; a chained tile writes biased strips and the chain unbiases at
its gather.

``stream_strip_reference`` and ``stream_chained_reference`` are the plain
PyTorch versions of the two kernels; ``stream_strip_cuda`` and
``stream_chained_cuda`` launch the hand-written CUDA kernels
(``csrc/stream_wavefront.cu``), which cut each stream's steps into time
slices that restart at read starts (``choose_slices``) and give the same
strips bit for bit; in a 16-bit state a thread holds two streams, one in
each half of its 32-bit registers.  ``stream_chain_cuda`` is the chained
tile's kernel over a whole chain (``chain_geometry``), whose plain
version is ``_long_strip`` with ``stream_chained_reference``; the per-tile
``stream_chained_cuda`` is the same kernel at K = 1.
``_strip_call`` takes the plain version for a tensor on the CPU and the
kernel for a CUDA tensor, and ``_long_strip`` the plain tiles on the CPU
and the chain kernel on CUDA; there is no fallback from one to the other.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import operator
from typing import NamedTuple

import torch

from swtpu_torch.config import DEFAULT_PENALTIES, Penalties

LANES = 128  # query capacity (wavefront rows)
FLAG_BIT = 8  # first-char-of-target marker in the stream bytes
# stream lengths are multiples of this many steps (the packers round up)
STEP_CHUNK = 32
ROWS = (1, 2, 4, 8, 16)
KERNEL_BLOCK = 128  # threads a block of the CUDA wavefront kernel
RESIDENT_WARPS_PER_SM = 12  # what the kernel's __launch_bounds__ guarantees
# The wrapper's slice count aims for a grid of SLICE_WARPS_PER_SM warps for
# each SM (more than one wave of the resident warps at rows 16, so that
# SMs that finish early take more blocks) and gives no slice fewer steps than
# MIN_SLICE_STEPS (each slice reruns up to a read's steps) nor fewer than
# PIPE_FILLS_PER_SLICE times a segment's sublanes (each slice refills the
# char pipe: 127 steps at rows 1), except that a stream too short for two
# such slices but of MIN_SLICE_STEPS or more is halved (one slice leaves
# most SMs idle).  They come from sweeps of slice counts at chip_smoke.py's
# cases (experiments/torch_stream_breakdown.py --sweeps slices), at rows 1
# over 4,096 steps (2 slices beat 4) and at ~1,600 steps (2 beat 1).
SLICE_WARPS_PER_SM = 32
MIN_SLICE_STEPS = 1024
PIPE_FILLS_PER_SLICE = 16
# Where the caller gives the longest read of the batch (``longest_read``),
# a slice instead spans at least READS_PER_SLICE times that read plus a
# segment's pipe fill: a slice runs on past its end until every tail of its
# warp has seen a read start, up to a read more, so this bounds the
# overrun's share by the reads the batch holds, not by a fixed guess.  3
# comes from sweeps of B1's slice counts at chip_smoke.py's (b), (c) and
# (r) (experiments/torch_stream_slices.py --only b1): their best counts
# were slices of 8.6, 4.3 and 2.6 such reads (8 slices each); at 3, with
# whole waves of blocks (choose_slices), the rule gives them 8, 8 and 4.
READS_PER_SLICE = 3
# query rows a thread of the wavefront kernel (B1, B2) holds of each of
# its streams, in at most MAX_SUBLANES sublanes: 16 rows, 8 threads a
# stream (a stream pair in a 16-bit state), at rows 4, 8 and 16
# (csrc/stream_wavefront.cu kRowsPerThread, kMaxSublanes)
ROWS_PER_THREAD = 16
MAX_SUBLANES = 4
# The chain kernel: a block runs up to RING_WARPS tiles of one group of
# streams side by side, each a lag of chain_lag_chunks(rows) chunks of
# CHAR_CHUNK steps behind the one above, handing row 127 down through a
# ring of RING_STEPS steps in shared memory (csrc/stream_wavefront.cu)
RING_WARPS = KERNEL_BLOCK // 32
RING_STEPS = 32
CHAR_CHUNK = 8  # steps whose chars the kernels load together


# the wavefront's state types, as the plain version holds them: the
# kernels compute in one of these and write int32 strips.  uint16 lives in
# int32 lanes masked to 16 bits after every add (torch's CPU uint16 lacks
# most ops): the same modular arithmetic, and a max of values in [0, 2^16)
# is the unsigned max.
STATE_DTYPES = {"int32": torch.int32, "float32": torch.float32, "int16": torch.int16,
                "uint16": torch.int32, "bfloat16": torch.bfloat16}
SIXTEEN_BIT_STATES = ("int16", "uint16", "bfloat16")
# what an integer state type holds: swtpu converts the open, then the extend
# penalty to it with jnp.array, which refuses a value outside
INT_STATE_RANGES = {"int32": (-(1 << 31), (1 << 31) - 1),
                    "int16": (-(1 << 15), (1 << 15) - 1), "uint16": (0, (1 << 16) - 1)}
# the CUDA entry points' state codes (StateMode in csrc/stream_wavefront.cu);
# a score width takes code 1, the biased int32 mode
STATE_CODES = {"int32": 0, "float32": 2, "int16": 3, "uint16": 4, "bfloat16": 5}
BIASED_CODE = 1


def _validate_config(
    segments, rows=1, state_dtype="int32", score_width=None,
    penalties=DEFAULT_PENALTIES,
):
    """Shape-independent contract checks shared by every entry, with
    swtpu's errors.  swtpu's TPU-only rules are left out: physical
    streams need not be a multiple of the 128-lane vreg width, and rows=16
    composes with segments > 1 (it hit a Mosaic layout limit, not a
    semantic one).  rows=16 with a 16-bit state stays refused: swtpu
    refuses it in interpret mode too.  A penalty that the state type
    cannot hold raises swtpu's OverflowError (uint16 at the default
    penalties)."""
    if score_width is not None:
        if state_dtype != "int32":
            # & and sign-bit tests are integer ops; float lanes cannot wrap
            raise ValueError(
                "score_width (wrap-parity) requires state_dtype='int32', "
                f"got {state_dtype!r}"
            )
        if not 2 <= score_width <= 30:
            raise ValueError(
                f"score_width={score_width} out of range (need 2..30)"
            )
        _, _, go, ge = penalties.astuple()
        if (1 << (score_width - 1)) + (go + ge) + ge < 0:
            # the I-chain no-wrap proof needs ZERO + open + extend >= -extend
            raise ValueError(
                f"score_width={score_width} too narrow for penalties "
                f"(need 2^(W-1) >= |open+extend| + |extend|)"
            )
    if LANES % segments or segments > 8:
        raise ValueError(f"segments {segments} must divide {LANES} and be <= 8")
    if rows not in ROWS:
        raise ValueError(f"rows {rows} must be one of 1/2/4/8/16")
    if rows == 16 and state_dtype in SIXTEEN_BIT_STATES:
        raise ValueError("rows=16 requires a 32-bit state dtype")
    if (LANES // rows) % segments:
        raise ValueError(
            f"sublane rows {LANES//rows} must divide by segments {segments}"
        )
    if state_dtype not in STATE_DTYPES:
        raise ValueError(f"unknown state_dtype {state_dtype!r}")
    check_state_constants(state_dtype, penalties.astuple()[2:])


def check_state_constants(state_dtype, values):
    """numpy's OverflowError for the first of `values` (Python ints that
    swtpu converts to the state type with jnp.array, in its order) that an
    integer state type cannot hold; the float types take any."""
    lo, hi = INT_STATE_RANGES.get(state_dtype, (None, None))
    for v in values:
        if lo is not None and not lo <= v <= hi:
            raise OverflowError(f"Python integer {v} out of bounds for {state_dtype}")


def state_value(x, state_dtype):
    """The Python int x as swtpu's astype leaves it in the state type: a
    16-bit integer type keeps its low 16 bits (signed for int16)."""
    if state_dtype == "int16":
        return (x + (1 << 15)) % (1 << 16) - (1 << 15)
    if state_dtype == "uint16":
        return x % (1 << 16)
    return x


def _validate_kernel_layout(qk, streamT, segments, rows=1, state_dtype="int32",
                            score_width=None, penalties=DEFAULT_PENALTIES):
    """Contract checks for pre-laid-out inputs (qk [128, S_phys],
    streamT [T, seg*S_phys])."""
    _validate_config(segments, rows, state_dtype, score_width, penalties)
    if qk.shape[0] != LANES:
        raise ValueError(f"kernel q must have {LANES} rows, got {tuple(qk.shape)}")
    S_phys = qk.shape[1]
    if streamT.shape[1] != segments * S_phys:
        raise ValueError(
            f"streamT width {streamT.shape[1]} != segments*S_phys "
            f"({segments}*{S_phys})"
        )
    if streamT.shape[0] % STEP_CHUNK:
        raise ValueError(
            f"stream length {streamT.shape[0]} not a multiple of {STEP_CHUNK}"
        )


def _validate(q, stream, segments, rows=1, state_dtype="int32", score_width=None,
              penalties=DEFAULT_PENALTIES):
    _validate_config(segments, rows, state_dtype, score_width, penalties)
    N, qcap = q.shape
    T = stream.shape[1]
    if qcap != LANES // segments:
        raise ValueError(
            f"q width {qcap} != {LANES}//segments ({LANES // segments})"
        )
    if N % segments:
        raise ValueError(f"n_streams {N} must divide by segments {segments}")
    if T % STEP_CHUNK:
        raise ValueError(f"stream length {T} not a multiple of {STEP_CHUNK}")


def _bias(score_width):
    """The zero of W-bit biased state, 2^(W-1); 0 for exact state."""
    return 0 if score_width is None else 1 << (score_width - 1)


def _q_kernel_layout(q, segments, rows=1):
    """Logical [N, qcap] queries -> kernel register [128, S_phys]: logical
    stream n = g*S_phys + s maps to segment g of physical column s, and
    query row i = k*rows + r of segment g maps to kernel row
    r*(128//rows) + g*SLg + k (SLg = 128//rows//segments)."""
    N, qcap = q.shape
    S_phys = N // segments
    SLg = LANES // rows // segments
    q4 = q.reshape(segments, S_phys, SLg, rows)  # [g, s, k, r]
    return q4.permute(3, 0, 2, 1).reshape(LANES, S_phys)


def _wavefront_reference(qk, sk, penalties, segments, rows, tail_acc=True, bounds=None,
                         score_width=None, state_dtype="int32"):
    """The recurrence behind :func:`stream_strip_reference` and
    :func:`stream_chained_reference`; returns the strip [T, segments, S],
    and with `bounds` (bD, bG, bH, each [T, S]) also the tile's row-127
    (oD, oG, oH), all int32."""
    ma, mi, go, ge = penalties.astuple()
    S = qk.shape[1]
    T = sk.shape[0]
    SL = LANES // rows
    SLg = SL // segments
    dev = qk.device
    i32 = torch.int32
    dt = STATE_DTYPES[state_dtype]
    ripple = not tail_acc and rows == 1
    if state_dtype == "uint16":
        # the 16-bit adder's wrap on int32 lanes
        def add(x, y):
            return (x + y) & 0xFFFF
    else:
        add = operator.add
    qs = qk.to(i32).reshape(rows, SL, S)
    sc = sk.to(i32).reshape(T, segments, S)
    seghead = (torch.arange(SL, device=dev) % SLg == 0)[:, None]
    heads = torch.arange(segments, device=dev) * SLg
    tails = heads + SLg - 1
    # the boundary zero: 0, or in W-bit wrap-parity the bias 2^(W-1)
    zbit = _bias(score_width)
    zero = torch.tensor(zbit, dtype=dt, device=dev)
    ma_t = torch.tensor(state_value(ma, state_dtype), dtype=dt, device=dev)
    mi_t = torch.tensor(state_value(mi, state_dtype), dtype=dt, device=dev)
    if score_width is None:
        def m_update(x):
            return torch.clamp_min(x, 0)
    else:
        # The RTL's SCORE_WIDTH registers: state holds W-bit *biased
        # unsigned* values (score + 2^(W-1)) in 32-bit lanes.  Only the M
        # update wraps (& mask) and clamps on the sign bit; the I/G chain
        # provably never wraps step-wise (every cell's merged I includes an
        # M + open + extend candidate with M >= ZERO, so I lies in
        # [ZERO + open + extend, mask]), as in the column kernel's biased
        # mode.  So I, G, D, H and the accumulator are never masked.
        mask = (1 << score_width) - 1

        def m_update(x):
            # the W-bit adder's wrap, then the sign-bit clamp: x & mask lies
            # in [0, 2^W), so "itself if bit zbit is set, else zbit" is a max
            return torch.maximum(x & mask, zero)

    # B1/B2 write their strips unbiased; a chained tile (B3) writes biased
    # strips, and the chain unbiases at its gather
    unbias = zbit if bounds is None else 0

    def plane():
        return torch.full((SL, S), zbit, dtype=dt, device=dev)

    # plane r of G and D holds row r of every sublane
    G = torch.full((rows, SL, S), zbit, dtype=dt, device=dev)
    D = torch.full((rows, SL, S), zbit, dtype=dt, device=dev)
    D2L = plane()  # D of row R-1, two steps back
    Hl = plane()  # H of row R-1, one step back
    C = torch.full((SL, S), 4, dtype=i32, device=dev)
    acc = torch.full((segments, S), zbit, dtype=dt, device=dev)
    strip = torch.empty((T, segments, S), dtype=i32, device=dev)
    if bounds is not None:
        # swtpu casts the int32 boundary strips to the state type at the load
        if state_dtype == "uint16":
            bD, bG, bH = (b & 0xFFFF for b in bounds)
        else:
            bD, bG, bH = (b.to(dt) for b in bounds)
        outs = [torch.empty((T, S), dtype=i32, device=dev) for _ in range(3)]
    for t in range(T):
        C = torch.roll(C, 1, 0)
        C[heads] = sc[t]
        f0 = C >= FLAG_BIT
        cval = C & 7
        # row 0 of a sublane reads the sublane above
        upD, upG, upH = (torch.roll(x, 1, 0) for x in (D2L, G[rows - 1], Hl))
        if bounds is None:
            upD, upG, upH = (torch.where(seghead, zero, x) for x in (upD, upG, upH))
        else:
            # the tile's row 0 reads the tile above's row 127: the same
            # column of the same read, so no zero but the read-start one
            upD[0], upG[0], upH[0] = bD[t], bG[t], bH[t]
        # M of every row at once: row 0's diagonal is the sublane above's D
        # two steps back, row r's its own row r - 1's a step back
        diag = torch.cat((upD[None], D[:-1]))
        M = m_update(add(torch.where(f0, zero, diag), torch.where(cval == qs, ma_t, mi_t)))
        G_left = torch.where(f0, zero, G)
        M_open = add(M, go)
        Hcur = torch.maximum(upH, M.amax(0))
        if ripple:
            # H ripples with the data; its own register resets at a read start
            Hcur = torch.maximum(Hcur, torch.where(f0, zero, Hl))
        # the gap chain runs down the rows within the step
        I = torch.empty_like(M)
        newG = torch.empty_like(G)
        g = upG
        for r in range(rows):
            I[r] = add(torch.maximum(g, G_left[r]), ge)
            g = newG[r] = torch.maximum(M_open[r], I[r])
        D2L = D[rows - 1]
        D = torch.maximum(M, I)
        G = newG
        Hl = Hcur
        if ripple:
            strip[t] = Hcur[tails] - unbias
        else:
            acc = torch.maximum(torch.where(f0[tails], zero, acc), Hcur[tails])
            strip[t] = acc - unbias
        if bounds is not None:
            for o, x in zip(outs, (D[-1], G[-1], Hcur)):
                o[t] = x[SL - 1]
    if bounds is None:
        return strip
    return (strip, *outs)


def stream_strip_reference(
    qk, sk, penalties=DEFAULT_PENALTIES, segments=1, rows=1, tail_acc=True,
    score_width=None, state_dtype="int32",
):
    """Plain PyTorch wavefront: qk [128, S] int8 (kernel layout), sk
    [T, segments*S] int8 -> strip [T, segments*S] int32.

    State lives on [SL, S] planes, SL = 128//rows sublanes; plane r of a
    list holds query row k*rows + r of sublane k.  Per step:
      - the char pipe C shifts one sublane down and each segment head
        takes its stream's next char; f0 = C >= 8 marks a read's first
        char, C & 7 is the base;
      - row 0 of a sublane reads the sublane above: D from two steps back
        (the diagonal) and G and H from one step back; rows r > 0 read
        row r-1 of their own sublane (D from the previous step, G from
        this one);
      - M = max(diag + s, 0), I = max(G_up, G_left) + extend,
        D = max(M, I), G = max(M + open, I); H is the running max of M down
        the sublane; segment heads and read starts see zero boundaries;
      - each segment tail folds H into its accumulator, which resets where
        f0 is set, and the accumulators are the strip row of this step.
    tail_acc=False (the ripple-H form; rows = 1 only, ignored otherwise):
    each row's H also keeps its own previous H, reset where f0 is set, and
    the strip row is the segment tails' H.
    The initial pipe is the pad char 4 and all state is zero.

    score_width=W: the RTL's W-bit wrap-parity.  Zero is the bias
    2^(W-1): the initial state, the segment heads' and read starts'
    boundaries; M = (diag + s) & (2^W - 1), or the bias where that has its
    sign bit 2^(W-1) clear; nothing else is masked; the strip rows are the
    accumulators (or H) less the bias.  state_dtype="float32" carries the
    state as float32 (exact: every value is an integer far below 2^24);
    "int16" as int16, whose adds wrap at 2^15 as JAX's do; "uint16" as
    16-bit unsigned values, every add modulo 2^16 (the match and mismatch
    scores too: -4 is 65532), so max(x, 0) is x; "bfloat16" as bfloat16,
    every add rounded to nearest even (a value above 256 keeps 8
    significant bits).  The strips are int32 in every mode."""
    T = sk.shape[0]
    strip = _wavefront_reference(qk, sk, penalties, segments, rows, tail_acc,
                                 score_width=score_width, state_dtype=state_dtype)
    return strip.reshape(T, segments * qk.shape[1])


def stream_chained_reference(qk, sk, bD, bG, bH, penalties=DEFAULT_PENALTIES, rows=1,
                             score_width=None, state_dtype="int32"):
    """Plain PyTorch version of one tile of a long-query chain (segments 1):
    qk [128, S] int8 (kernel layout), sk [T, S] int8, boundary strips bD,
    bG, bH [T, S] int32 -> (acc, oD, oG, oH), each [T, S] int32.

    The recurrence of :func:`stream_strip_reference` but for the tile's
    row 0, which reads the tile above's row 127 instead of a zero boundary:
    diag = f0 ? 0 : bD[t], G_up = bG[t], H_up = bH[t] (neither zeroed at a
    read start: it is the same column of the same read).  oD, oG and oH
    are the tile's own row 127 (D, G and H of the last sublane's row R-1)
    after each step; acc is the tail accumulator.  With zero boundaries it
    is stream_strip_reference at segments 1.  With score_width the
    boundaries are read, and all four outputs written, biased.  In a
    16-bit state the boundaries are cast to the state type as they are
    read, and the outputs written back as int32."""
    acc, *outs = _wavefront_reference(qk, sk, penalties, 1, rows, bounds=(bD, bG, bH),
                                      score_width=score_width, state_dtype=state_dtype)
    return (acc.reshape(sk.shape), *outs)


def _check_kernel_tensors(**tensors):
    """Each (name, (tensor, dtype)) must be a contiguous CUDA tensor of
    that dtype, all on one device."""
    dev = None
    for name, (x, dtype) in tensors.items():
        if x.device.type != "cuda" or x.dtype != dtype:
            raise ValueError(
                f"{name} must be a CUDA {str(dtype).removeprefix('torch.')} "
                f"tensor, got {x.dtype} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dev is not None and x.device != dev:
            raise ValueError(f"{name} on {x.device} but the others on {dev}")
        dev = x.device


def _raise_on_error(lib, err, kernel):
    if err:
        msg = lib.swtpu_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def streams_per_thread(state_dtype):
    """Streams a thread of the CUDA wavefront holds: two in a 16-bit
    state (one in each half of a 32-bit register), else one."""
    return 2 if state_dtype in SIXTEEN_BIT_STATES else 1


class WavefrontGeometry(NamedTuple):
    """How the CUDA wavefront kernel maps one launch's streams to threads:
    `lanes` threads a stream (W), each holding `sublanes` consecutive
    wavefront sublanes (V) of the rows; `streams_per_thread` streams a
    thread (two in a 16-bit state); a segment spans `segment_sublanes`
    (SLg) sublanes, whole threads, the first its head and the last its
    tail."""

    lanes: int
    sublanes: int
    streams_per_thread: int
    segment_sublanes: int


def wavefront_geometry(rows, segments=1, state_dtype="int32"):
    """The thread mapping of the wavefront kernels (B1, B2): in a 32-bit
    state (stream_wavefront_kernel) a thread holds V = min(16 / rows,
    MAX_SUBLANES) sublanes, so 16 query rows in 8 threads a stream at rows
    4, 8 and 16, and 4 sublanes in 16 and 32 threads at rows 2 and 1 (more
    spilled registers, and rows 1's long pipe fill wants the threads); in
    a 16-bit state (stream_wavefront_x2_kernel, two streams a thread) the
    same at rows 4 and 8, 8 threads a stream pair, and 32 threads a pair
    at rows 2 and 1.  A segment's SLg = 128 / (rows x segments) sublanes
    are whole threads.  The chain kernel maps its own (:func:`chain_lanes`).
    The kernels compute the same; the strip does not depend on the
    mapping."""
    SL = LANES // rows
    per_thread = streams_per_thread(state_dtype)
    if per_thread == 2 and rows < 4:
        lanes = 32
    else:
        lanes = SL // min(ROWS_PER_THREAD // rows, MAX_SUBLANES)
    return WavefrontGeometry(lanes=lanes, sublanes=SL // lanes,
                             streams_per_thread=per_thread, segment_sublanes=SL // segments)


def choose_slices(S, rows, T, sms, segments=1, state_dtype="int32", tiles=1,
                  longest_read=None, lanes=None):
    """The wrapper's slice count for S physical streams at `rows` and
    `segments` over T steps in `state_dtype` on a card of `sms` SMs.  A
    slice has ceil(S / streams_per_thread) x `lanes` threads (the wavefront
    kernel's, :func:`wavefront_geometry`, by default) times the `tiles` a
    chain's block runs side by side.

    Without `longest_read`: a grid of about
    SLICE_WARPS_PER_SM warps for every SM, no slice under MIN_SLICE_STEPS
    steps nor under PIPE_FILLS_PER_SLICE times the steps a slice takes to
    fill a segment's pipe, and 2 slices where that leaves fewer and
    T >= MIN_SLICE_STEPS.

    With the batch's longest read (in bases): a grid of
    about SLICE_WARPS_PER_SM / V warps an SM (V, the sublanes a thread
    holds, independent within a step, hide what warps would), no slice
    under READS_PER_SLICE x (longest_read + SLg) steps (SLg = 128 /
    (rows x segments): a slice runs on past its end by up to a read and a
    pipe fill), and then the largest count whose blocks fill the SMs to
    within a tenth of a whole wave, so that no SM runs a slice more than
    most.  At least 1."""
    geometry = wavefront_geometry(rows, segments, state_dtype)
    if lanes is None:
        lanes = geometry.lanes
    threads = -(-S // geometry.streams_per_thread) * lanes * tiles
    blocks = -(-threads // KERNEL_BLOCK)
    SLg = LANES // rows // segments
    if longest_read is None:
        want = round(sms * SLICE_WARPS_PER_SM * 32 / KERNEL_BLOCK / blocks)
        shortest = max(MIN_SLICE_STEPS, PIPE_FILLS_PER_SLICE * SLg)
        fit = max(T // shortest, 2 if T >= MIN_SLICE_STEPS else 1)
        return max(1, min(want, fit))
    warps = SLICE_WARPS_PER_SM / geometry.sublanes
    want = round(sms * warps * 32 / KERNEL_BLOCK / blocks)
    slices = max(1, min(want, T // (READS_PER_SLICE * (longest_read + SLg))))
    while slices > 1 and slices * blocks > sms and -slices * blocks % sms > sms // 10:
        slices -= 1
    return slices


# The longest read of the batch that the B1 launches inside a
# ``reads_up_to`` block score: the bank sets it around each packed batch,
# so that swtpu's public signatures stay as they are.
_LONGEST_READ = contextvars.ContextVar("longest_read", default=None)


@contextlib.contextmanager
def reads_up_to(longest_read):
    """Within the block, the wavefront launches that ``_strip_call`` makes
    (every B1 of the public entry points) take their slice count from
    `longest_read`, the longest read in bases of the batch they score
    (:func:`choose_slices`); None keeps the rule without it."""
    token = _LONGEST_READ.set(None if longest_read is None else int(longest_read))
    try:
        yield
    finally:
        _LONGEST_READ.reset(token)


def chain_lag_chunks(rows):
    """Chunks of CHAR_CHUNK steps by which a chain's tile runs behind the
    tile above in a block's ring: its row 0 at step t reads the tile
    above's row 127 at step t + SL - 1 (SL = 128 / rows), so the tile above
    must have finished the chunk that holds that step for t up to the last
    of a chunk."""
    return (LANES // rows + CHAR_CHUNK - 2) // CHAR_CHUNK + 1


def chain_wrap_lag_chunks(rows):
    """Chunks by which the ring's first warp runs behind the last warp's
    tile above it, whose row 127 it reads from the wrap strips in device
    memory, staged two chunks ahead: the tile above must have finished
    step t + 2 x CHAR_CHUNK + SL - 2 for t up to the last of a chunk."""
    return (LANES // rows + 3 * CHAR_CHUNK - 3) // CHAR_CHUNK + 1


class ChainGeometry(NamedTuple):
    """How the chain kernel runs K tiles over S streams and T steps: `ring`
    warps a block (tiles side by side; warp w runs tiles w, w + ring, ...),
    each `lag_chunks` chunks behind the one above (`wrap_lag_chunks` where
    it reads the wrap strips), `ring_steps` steps of row 127 in a block's
    shared-memory ring, `streams_per_warp` streams a block, `blocks` blocks
    a slice of `block_threads` threads, `slices` time slices, and whether
    every ring-th tile hands its row 127 on through [3, T, S] strips in
    device memory (`wrap`)."""

    ring: int
    lag_chunks: int
    wrap_lag_chunks: int
    ring_steps: int
    streams_per_warp: int
    blocks: int
    block_threads: int
    slices: int
    wrap: bool


def chain_lanes(rows, state_dtype="int32", one_tile=False):
    """Threads a stream of the chain kernel, min(128 / rows, 32), or in a
    16-bit state threads a stream pair, min(64 / rows, 32): two sublanes a
    thread at rows 2 to 8; on the per-tile contract (`one_tile`,
    stream_chained_cuda, the card's witness for the chain) min(128 / rows,
    32) in every state (csrc stream_chain_kernel, and kChainPairLanes of
    stream_chain_x2_kernel)."""
    return min(LANES // rows // (1 if one_tile else streams_per_thread(state_dtype)), 32)


def pads_stay_at_zero(penalties, state_dtype="int32"):
    """Whether pads alone leave every state of a chain at the boundary
    zero: no penalty a pad's cell adds (mismatch, gap open, gap extend) is
    positive in the state's arithmetic, where uint16 wraps a negative one
    to a positive one.  Where they do, the chain kernel writes the zero for
    a group with no read start in slice 0 and computes nothing there (its
    instantiation with the shortcut; the other runs such groups)."""
    mi, go, ge = penalties.astuple()[1:]
    if state_dtype == "uint16":
        return all(p % (1 << 16) == 0 for p in (mi, go, ge))
    return max(mi, go, ge) <= 0


def chain_geometry(S, rows, T, K, sms, state_dtype="int32"):
    """The chain kernel's geometry for K tiles over S streams and T steps
    at `rows` in `state_dtype` on a card of `sms` SMs: min(K, RING_WARPS)
    warps a block, W = min(128 / rows, 32) threads a stream, so that a
    warp holds 32 / W streams; in a 16-bit state W = min(64 / rows, 32)
    threads a stream pair (:func:`chain_lanes`), so that a warp holds 2 x
    32 / W streams.  The slices are choose_slices' for the grid a slice
    holds at once, the streams times the ring's warps: a block runs its K
    tiles in passes of the ring, so the resident grid, not the K tiles,
    sets how many warps each SM gets."""
    ring = min(K, RING_WARPS)
    lanes = chain_lanes(rows, state_dtype)
    per_warp = 32 // lanes * streams_per_thread(state_dtype)
    return ChainGeometry(
        ring=ring, lag_chunks=chain_lag_chunks(rows),
        wrap_lag_chunks=chain_wrap_lag_chunks(rows), ring_steps=RING_STEPS,
        streams_per_warp=per_warp, blocks=-(-S // per_warp), block_threads=32 * ring,
        slices=choose_slices(S, rows, T, sms, state_dtype=state_dtype, tiles=ring,
                             lanes=lanes),
        wrap=K > ring)


def slice_steps(T, slices):
    """Steps of the longest of `slices` slices over T steps: slice k owns
    steps from STEP_CHUNK * floor(k * floor(T / STEP_CHUNK) / slices)."""
    return STEP_CHUNK * -(-(T // STEP_CHUNK) // slices) if slices > 1 else T


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _slice_count(slices, S, rows, T, device, segments=1, state_dtype="int32",
                 longest_read=None, lanes=None):
    """`slices` checked, or the wrapper's choice for None."""
    if slices is None:
        return choose_slices(S, rows, T, _sm_count(device), segments, state_dtype,
                             longest_read=longest_read, lanes=lanes)
    slices = operator.index(slices)
    if slices < 1 or (slices > 1 and slices * STEP_CHUNK > T):
        raise ValueError(
            f"slices {slices} must be >= 1 and leave every slice at least "
            f"{STEP_CHUNK} steps of the {T}"
        )
    return slices


def _record_slices(wrapper, slices, T):
    wrapper.slices = slices
    wrapper.slice_steps = slice_steps(T, slices)


def _kernel_state(score_width, state_dtype):
    """(W or 0, the state code) as the CUDA entry points take them."""
    return score_width or 0, BIASED_CODE if score_width else STATE_CODES[state_dtype]


def stream_strip_cuda(
    qk, sk, penalties=DEFAULT_PENALTIES, segments=1, rows=1, tail_acc=True,
    slices=None, score_width=None, state_dtype="int32", longest_read=None,
):
    """The CUDA wavefront kernel on the same contract as
    :func:`stream_strip_reference`; CUDA tensors only.  ``slices`` time
    slices a stream (None: :func:`choose_slices`, from ``longest_read``,
    the batch's longest read in bases, where it is given; 1 runs each
    stream in one pass); the strip depends on neither.  Launches on the
    current stream, counts each launch in ``stream_strip_cuda.launches`` and
    records the last launch's ``.slices`` and ``.slice_steps``."""
    from swtpu_torch.ops._build import load_library

    _validate_kernel_layout(qk, sk, segments, rows, state_dtype, score_width, penalties)
    _check_kernel_tensors(qk=(qk, torch.int8), sk=(sk, torch.int8))
    S = qk.shape[1]
    T = sk.shape[0]
    slices = _slice_count(slices, S, rows, T, qk.device, segments, state_dtype,
                          longest_read=longest_read)
    out = torch.empty((T, segments * S), dtype=torch.int32, device=qk.device)
    if T == 0 or S == 0:
        return out
    lib = load_library()
    ma, mi, go, ge = penalties.astuple()
    with torch.cuda.device(qk.device):
        err = lib.swtpu_stream_wavefront(
            qk.data_ptr(), sk.data_ptr(), out.data_ptr(), S, T, segments,
            rows, int(tail_acc), ma, mi, go, ge,
            torch.cuda.current_stream().cuda_stream, slices,
            *_kernel_state(score_width, state_dtype),
        )
    _raise_on_error(lib, err, "stream_wavefront")
    stream_strip_cuda.launches += 1
    _record_slices(stream_strip_cuda, slices, T)
    return out


stream_strip_cuda.launches = stream_strip_cuda.slices = stream_strip_cuda.slice_steps = 0


def stream_chained_cuda(
    qk, sk, bD, bG, bH, penalties=DEFAULT_PENALTIES, rows=1, slices=None,
    score_width=None, state_dtype="int32",
):
    """The CUDA chained-tile kernel on the same contract as
    :func:`stream_chained_reference`; CUDA tensors only.  ``slices`` as for
    :func:`stream_strip_cuda`.  Launches on the current stream, counts each
    launch in ``stream_chained_cuda.launches`` and records the last
    launch's ``.slices`` and ``.slice_steps``."""
    from swtpu_torch.ops._build import load_library

    _validate_kernel_layout(qk, sk, 1, rows, state_dtype, score_width, penalties)
    _check_kernel_tensors(
        qk=(qk, torch.int8), sk=(sk, torch.int8), bD=(bD, torch.int32),
        bG=(bG, torch.int32), bH=(bH, torch.int32),
    )
    for name, b in (("bD", bD), ("bG", bG), ("bH", bH)):
        if b.shape != sk.shape:
            raise ValueError(
                f"{name} shape {tuple(b.shape)} != stream shape {tuple(sk.shape)}"
            )
    S = qk.shape[1]
    T = sk.shape[0]
    # the chain kernel at K = 1: its threads a stream (pair)
    slices = _slice_count(slices, S, rows, T, qk.device, state_dtype=state_dtype,
                          lanes=chain_lanes(rows, state_dtype, one_tile=True))
    outs = [torch.empty((T, S), dtype=torch.int32, device=qk.device) for _ in range(4)]
    if T == 0 or S == 0:
        return tuple(outs)
    lib = load_library()
    ma, mi, go, ge = penalties.astuple()
    with torch.cuda.device(qk.device):
        err = lib.swtpu_stream_chained(
            qk.data_ptr(), sk.data_ptr(), bD.data_ptr(), bG.data_ptr(),
            bH.data_ptr(), *(o.data_ptr() for o in outs), S, T, rows,
            ma, mi, go, ge, torch.cuda.current_stream().cuda_stream, slices,
            *_kernel_state(score_width, state_dtype),
        )
    _raise_on_error(lib, err, "stream_chained")
    stream_chained_cuda.launches += 1
    _record_slices(stream_chained_cuda, slices, T)
    return tuple(outs)


stream_chained_cuda.launches = stream_chained_cuda.slices = stream_chained_cuda.slice_steps = 0


def stream_chain_cuda(qks, sk, penalties=DEFAULT_PENALTIES, rows=16, slices=None,
                      score_width=None, state_dtype="int32"):
    """The chain kernel: every tile of a long-query chain in one launch.
    qks [K, 128, S] int8 (tile p's register in kernel layout, as
    ``_long_strip`` lays them out), sk [T, S] int8 -> the last tile's
    accumulator strip [T, S] int32 (biased with score_width), equal to the
    plain chain's (``_long_strip`` with ``stream_chained_reference``).
    CUDA tensors only; every state mode (the 16-bit ones at rows <= 8, two
    streams a thread).  ``slices`` as for :func:`stream_strip_cuda` (None:
    :func:`chain_geometry`'s); the strip does not depend on them.
    Launches on the current stream, counts each launch in
    ``stream_chain_cuda.launches`` and records the last launch's
    ``.slices`` and ``.slice_steps``."""
    from swtpu_torch.ops._build import load_library

    _validate_config(1, rows, state_dtype, score_width, penalties)
    _check_kernel_tensors(qks=(qks, torch.int8), sk=(sk, torch.int8))
    if qks.dim() != 3 or qks.shape[1] != LANES or qks.shape[2] != sk.shape[1]:
        raise ValueError(f"qks must be [K, {LANES}, S] for a [T, S] stream, got "
                         f"{tuple(qks.shape)} for {tuple(sk.shape)}")
    K, _, S = qks.shape
    T = sk.shape[0]
    if K < 1:
        raise ValueError("a chain needs at least one tile")
    if T % STEP_CHUNK:
        raise ValueError(f"stream length {T} not a multiple of {STEP_CHUNK}")
    geometry = chain_geometry(S, rows, T, K, _sm_count(qks.device), state_dtype)
    slices = geometry.slices if slices is None else _slice_count(slices, S, rows, T, None)
    out = torch.empty((T, S), dtype=torch.int32, device=qks.device)
    if T == 0 or S == 0:
        return out
    # the wrap strips: [3, T, S], written and read by the kernel alone
    wrap = (torch.empty((3, T, S), dtype=torch.int32, device=qks.device)
            if geometry.wrap else None)
    lib = load_library()
    ma, mi, go, ge = penalties.astuple()
    with torch.cuda.device(qks.device):
        err = lib.swtpu_stream_chain(
            qks.data_ptr(), sk.data_ptr(), out.data_ptr(),
            None if wrap is None else wrap.data_ptr(), S, T, K, rows, ma, mi, go, ge,
            torch.cuda.current_stream().cuda_stream, slices, geometry.ring,
            *_kernel_state(score_width, state_dtype),
            int(pads_stay_at_zero(penalties, state_dtype)),
        )
    _raise_on_error(lib, err, "stream_chain")
    stream_chain_cuda.launches += 1
    _record_slices(stream_chain_cuda, slices, T)
    return out


stream_chain_cuda.launches = stream_chain_cuda.slices = stream_chain_cuda.slice_steps = 0


def chained_launches():
    """Launches of the chained tile's kernels so far: whole chains
    (stream_chain_cuda) and single tiles (stream_chained_cuda)."""
    return stream_chain_cuda.launches + stream_chained_cuda.launches


def stream_kernel_info(rows, tail_acc=True, chained=False, score_width=None,
                       state_dtype="int32"):
    """(registers a thread, local spill bytes a thread, resident blocks an
    SM) of the CUDA wavefront kernel's instantiation for `rows` (the
    ripple-H form at rows 1 with tail_acc=False; the chained tile with
    chained=True) in the state mode that `score_width` and `state_dtype`
    pick, from the CUDA runtime on the current device."""
    # the instantiation does not depend on the penalties: none refused here
    _validate_config(1, rows, state_dtype, score_width, Penalties(0, 0, 0, 0))
    return _kernel_info(rows, 2 if chained else (1 if not tail_acc and rows == 1 else 0),
                        score_width, state_dtype)[:3]


def stream_chain_info(rows, score_width=None, state_dtype="int32", quiet=True):
    """(registers a thread, local spill bytes a thread, resident blocks of
    KERNEL_BLOCK threads an SM, static shared bytes a block) of the chain
    kernel's instantiation for `rows` in the state mode that `score_width`
    and `state_dtype` pick, from the CUDA runtime on the current device:
    the one that skips a group with no read start (`quiet`, penalties for
    which :func:`pads_stay_at_zero` holds) or the one that runs it."""
    _validate_config(1, rows, state_dtype, score_width, Penalties(0, 0, 0, 0))
    return _kernel_info(rows, 3 if quiet else 4, score_width, state_dtype)


def _kernel_info(rows, mode, score_width, state_dtype):
    import ctypes

    from swtpu_torch.ops._build import load_library

    lib = load_library()
    out = (ctypes.c_int * 4)()
    err = lib.swtpu_stream_kernel_info(rows, mode, *_kernel_state(score_width, state_dtype), out)
    _raise_on_error(lib, err, "stream_kernel_info")
    return tuple(out)


def _strip_call(qk, sk, penalties, segments, rows, tail_acc=True, score_width=None,
                state_dtype="int32"):
    """qk [128, S_phys] int8, sk [T, seg*S_phys] int8 -> strip
    [T, seg*S_phys] int32: the plain version on the CPU, the kernel on
    CUDA, in the state mode asked for."""
    mode = dict(score_width=score_width, state_dtype=state_dtype)
    if qk.device.type == "cpu":
        return stream_strip_reference(qk, sk, penalties, segments, rows, tail_acc, **mode)
    if qk.device.type == "cuda":
        return stream_strip_cuda(qk, sk, penalties, segments, rows, tail_acc, **mode,
                                 longest_read=_LONGEST_READ.get())
    raise ValueError(f"no wavefront kernel for device {qk.device}")


def _strip_call_chained(qk, sk, bD, bG, bH, penalties, rows, score_width=None,
                        state_dtype="int32"):
    """One chained tile of ``_long_strip``'s per-tile loop: qk [128, S]
    int8, sk [T, S] int8, boundary strips [T, S] int32 -> (acc, oD, oG,
    oH), each [T, S] int32 (biased with score_width): the plain version on
    the CPU.  On CUDA a chain runs in one launch (stream_chain_cuda), and
    one tile on swtpu's per-tile contract through stream_chained_cuda."""
    if qk.device.type == "cpu":
        return stream_chained_reference(qk, sk, bD, bG, bH, penalties, rows,
                                        score_width=score_width, state_dtype=state_dtype)
    raise ValueError(f"no chained wavefront kernel for device {qk.device}")


def _to_kernel_layout(q, stream, segments, rows):
    """(q [N, qcap], stream [N, T]) -> ([128, S_phys], [T, N]) contiguous."""
    qk = _q_kernel_layout(q, segments, rows).to(torch.int8).contiguous()
    return qk, stream.to(torch.int8).t().contiguous()


def sw_scores_stream_strip(
    q, stream, penalties: Penalties = DEFAULT_PENALTIES, segments=1,
    state_dtype="int32", tail_acc=True, rows=1, score_width=None,
):
    """Run the wavefront over packed streams; returns the raw strip.

    Args:
      q: [N, 128//segments] int8 per-stream query codes (sentinel-padded).
      stream: [N, T] int8 concatenated target chars (codes 0..3, +8 flag on
        each target's first char, 4 = drain/pad), T % STEP_CHUNK == 0.
      segments: queries packed per lane column (1, 2, 4 or 8).
      state_dtype: the state the kernel carries: "int32" or "float32"
        (the same strip), "int16", "uint16" or "bfloat16" (rows <= 8; see
        stream_strip_reference).
      tail_acc: the strip is the segment tails' running-best accumulators;
        False takes the ripple-H form (rows = 1 only; ignored otherwise).
      rows: query rows folded per sublane; the emission drain is
        128//(rows*segments) - 1.
      score_width: W, the RTL's W-bit biased wrap-parity arithmetic
        (int32 state only); the strip comes back unbiased.

    Returns: [N, T] int32 — each logical stream's segment-tail accumulator
    after each step; [n, off+len-1+drain] holds the score of the target at
    offset `off`.  swtpu_torch.bank.streams builds inputs and gathers.
    """
    _validate(q, stream, segments, rows, state_dtype, score_width, penalties)
    qk, sk = _to_kernel_layout(q, stream, segments, rows)
    return _strip_call(qk, sk, penalties, segments, rows, tail_acc, score_width,
                       state_dtype).t()


def unpack_stream_wire(codes, flags):
    """Inverse of swtpu_torch.bank.streams.pack_stream_wire on the tensor's
    device: 4-bases/byte codes [N, T//4] + 8-flags/byte bitmap [N, T//8]
    (uint8) -> the [N, T] int8 flagged char stream (pads come back as 0)."""
    N, nb = codes.shape
    dev = codes.device
    shifts2 = (torch.arange(4, dtype=torch.uint8, device=dev) * 2)[None, None, :]
    chars = ((codes[:, :, None] >> shifts2) & 3).reshape(N, nb * 4)
    shifts1 = torch.arange(8, dtype=torch.uint8, device=dev)[None, None, :]
    fbits = ((flags[:, :, None] >> shifts1) & 1).reshape(N, flags.shape[1] * 8)
    return (chars | (fbits << 3)).to(torch.int8)


def _gather_emissions(strip, emit_stream, emit_step, bias=0, regular=None):
    """[T, N] strip -> per-read scores (emit_step < 0 = zero-length read).
    `bias` unbiases a wrap-parity strip (the long-query chain's); a
    zero-length read scores 0 either way.

    regular: (first, stride, count) from detect_regular_emissions — read r
    emits at (r % N, first + (r // N) * stride), so read-order scores are a
    strided row slice flattened row-major.  Otherwise a scatter gather
    (torch indexes with int64, so the coordinates are widened here)."""
    if regular is not None:
        first, stride, count = regular
        ex = strip[first : first + (count - 1) * stride + 1 : stride]
        return (ex.reshape(-1) - bias).to(torch.int32)
    emit_step = emit_step.long()
    live = emit_step >= 0
    safe_step = torch.where(live, emit_step, 0)
    scores = strip[safe_step, emit_stream.long()] - bias
    return torch.where(live, scores, 0).to(torch.int32)


def sw_scores_stream_kernel_layout(
    qk, streamT, emit_stream, emit_step,
    penalties: Penalties = DEFAULT_PENALTIES, segments=1, state_dtype="int32",
    tail_acc=True, rows=1, score_width=None, emit_regular=None,
):
    """sw_scores_stream on pre-laid-out inputs: qk [128, S_phys]
    (``_q_kernel_layout``) and streamT [T, N] (the stream transposed)."""
    _validate_kernel_layout(qk, streamT, segments, rows, state_dtype, score_width,
                            penalties)
    strip = _strip_call(
        qk.to(torch.int8).contiguous(), streamT.to(torch.int8).contiguous(),
        penalties, segments, rows, tail_acc, score_width, state_dtype,
    )
    return _gather_emissions(strip, emit_stream, emit_step, regular=emit_regular)


def sw_scores_stream(
    q, stream, emit_stream, emit_step,
    penalties: Penalties = DEFAULT_PENALTIES, segments=1, state_dtype="int32",
    tail_acc=True, rows=1, score_width=None, emit_regular=None,
):
    """Wavefront scoring with the emission gather on the tensors' device:
    q [N, 128//segments], stream [N, T] -> [n_reads] int32 scores.

    emit_step < 0 marks a zero-length read (score 0).  The emission
    coordinates must have been computed for the same rows/segments.

    score_width: the RTL's W-bit biased-register arithmetic, overflow wrap
    included (int32 state only); the scores match
    oracle.sw_score_single_biased."""
    _validate(q, stream, segments, rows, state_dtype, score_width, penalties)
    qk, sk = _to_kernel_layout(q, stream, segments, rows)
    strip = _strip_call(qk, sk, penalties, segments, rows, tail_acc, score_width,
                        state_dtype)  # [T, N], unbiased
    return _gather_emissions(strip, emit_stream, emit_step, regular=emit_regular)


def sw_scores_stream_packed(
    q, codes, flags, emit_stream, emit_step,
    penalties: Penalties = DEFAULT_PENALTIES, segments=1, state_dtype="int32",
    tail_acc=True, rows=1, score_width=None, emit_regular=None,
):
    """sw_scores_stream on the 2-bit wire format (pack_stream_wire): the
    stream crosses to the device at 2.5 bits/char and expands there."""
    stream = unpack_stream_wire(codes, flags)
    return sw_scores_stream(
        q, stream, emit_stream, emit_step, penalties=penalties,
        segments=segments, state_dtype=state_dtype, tail_acc=tail_acc,
        rows=rows, score_width=score_width, emit_regular=emit_regular,
    )


def _shift_steps(x, k, fill=0, pad=None):
    """x[t] <- x[t + k], `fill`-padded at the tail (a left shift on the
    step axis of a [T, N] strip).  `fill` is the boundary zero: 0 exact,
    the bias 2^(W-1) in wrap-parity.  `pad`: at least min(k, T) rows of
    `fill`, made once by a caller that shifts many strips, so that a shift
    is one concatenation."""
    k = min(k, x.shape[0])
    if pad is None:
        pad = torch.full((k, x.shape[1]), fill, dtype=x.dtype, device=x.device)
    return torch.cat((x[k:], pad[:k]))


def _validate_long(q, T, rows, state_dtype="int32", score_width=None,
                   penalties=DEFAULT_PENALTIES):
    """Contract checks of the long-query entries; swtpu's TPU-only rules
    (the 128-lane stream count, the grid chunk) are left out, as in
    :func:`_validate_config`."""
    _validate_config(1, rows, state_dtype, score_width, penalties)
    if q.shape[1] % LANES:
        raise ValueError(f"q width {q.shape[1]} must be a multiple of {LANES}")
    if T % STEP_CHUNK:
        raise ValueError(f"stream length {T} not a multiple of {STEP_CHUNK}")


def tile_registers(q, rows):
    """Every tile's query register of q [N, K*128] in one copy: [K, 128, N]
    int8, tile p's _q_kernel_layout(q[:, p*128 : (p+1)*128], 1, rows), as
    the chain kernel (stream_chain_cuda) takes them."""
    N, width = q.shape
    K = width // LANES
    qks = q.reshape(N, K, LANES // rows, rows).permute(1, 3, 2, 0).reshape(K, LANES, N)
    return qks.to(torch.int8).contiguous()


def _long_strip(q, sk, penalties, rows, tile=None, score_width=None, state_dtype="int32"):
    """The K-tile chain on q [N, K*128] and the kernel-layout stream sk
    [T, N] int8 -> the last tile's accumulator strip [T, N] int32 (biased
    with score_width).

    Tile p+1's row 0 computes column j at step j and needs tile p's row 127
    at column j (G, H: its step j + SL - 1) and column j - 1 (D: step
    j + SL - 2), SL = 128//rows, so the boundary strips are tile p's
    outputs shifted left by those steps.  The first tile's boundaries and
    the shifts' fill are the boundary zero: 0, or the bias 2^(W-1) in
    wrap-parity (a plain 0 there would make row 0's M wrap to 2^W - 4 at
    the first mismatch).

    On CUDA, with no `tile` given, one launch of the chain kernel
    (``stream_chain_cuda``) runs every tile in every state mode and hands
    the boundaries down on the chip: no shift and no intermediate strip is
    made.  Otherwise each tile runs through `tile` (``_strip_call_chained``'s
    contract, the mode as keywords; None: ``_strip_call_chained``, the
    plain tile on the CPU), only the previous tile's strips stay alive,
    every tile's register is laid out in one copy, and each shift is one
    concatenation onto rows of the first tile's boundary zero, which no
    tile writes."""
    K = q.shape[1] // LANES
    SL = LANES // rows
    qks = tile_registers(q, rows)
    if tile is None:
        if sk.device.type == "cuda":
            return stream_chain_cuda(qks, sk, penalties, rows, score_width=score_width,
                                     state_dtype=state_dtype)
        tile = _strip_call_chained
    zero = _bias(score_width)
    zeros = torch.full(tuple(sk.shape), zero, dtype=torch.int32, device=sk.device)
    acc = bD = bG = bH = zeros
    for p in range(K):
        acc, oD, oG, oH = tile(qks[p], sk, bD, bG, bH, penalties, rows,
                               score_width=score_width, state_dtype=state_dtype)
        if p + 1 < K:
            bD = _shift_steps(oD, SL - 2, pad=zeros)
            bG = _shift_steps(oG, SL - 1, pad=zeros)
            bH = _shift_steps(oH, SL - 1, pad=zeros)
        del oD, oG, oH
    return acc


def _long_impl(q, sk, emit_stream, emit_step, penalties, rows, emit_regular,
               score_width=None, state_dtype="int32"):
    """Chain the tiles over the kernel-layout stream sk [T, N] and gather
    the emissions from the last tile's accumulator strip, unbiased there."""
    acc = _long_strip(q, sk.to(torch.int8).contiguous(), penalties, rows,
                      score_width=score_width, state_dtype=state_dtype)
    return _gather_emissions(acc, emit_stream, emit_step, bias=_bias(score_width),
                             regular=emit_regular)


def sw_scores_stream_long(
    q, stream, emit_stream, emit_step,
    penalties: Penalties = DEFAULT_PENALTIES, state_dtype="int32", rows=16,
    score_width=None, emit_regular=None,
):
    """Streamed wavefront scoring for queries longer than 128 bases: chains
    K = q.shape[1]/128 tiles of the wavefront, carrying the row-127 D/G/H
    strips between tiles (the reference's chaining ports; up to its
    4,095-base LEN_WIDTH envelope and beyond).

    Args:
      q: [N, K*128] int8 per-stream query codes, sentinel-padded (pads in
        the last tile cannot raise H; they only pass the ripple down).
      stream: [N, T] packed streams from pack_streams_long (T includes
        (128//rows - 1)*(K - 1) extra drain steps).
      emit_stream/emit_step: emission coordinates (drain = 128//rows - 1,
        as for one tile at segments 1).
      state_dtype: "int32" or "float32" state (the same scores), or
        "int16", "uint16" or "bfloat16" (rows <= 8) with their own
        arithmetic (stream_strip_reference).
      score_width: W-bit biased wrap-parity along the whole chain: the
        boundary strips carry biased values, and the gather unbiases.

    Returns [n_reads] int32 scores.
    """
    _validate_long(q, stream.shape[1], rows, state_dtype, score_width, penalties)
    return _long_impl(q, stream.t(), emit_stream, emit_step, penalties, rows, emit_regular,
                      score_width, state_dtype)


def sw_scores_stream_long_kernel_layout(
    q, streamT, emit_stream, emit_step,
    penalties: Penalties = DEFAULT_PENALTIES, state_dtype="int32", rows=16,
    score_width=None, emit_regular=None,
):
    """sw_scores_stream_long on a pre-transposed [T, N] stream (the query
    register is laid out per tile inside, as usual)."""
    _validate_long(q, streamT.shape[0], rows, state_dtype, score_width, penalties)
    return _long_impl(q, streamT, emit_stream, emit_step, penalties, rows, emit_regular,
                      score_width, state_dtype)


def sw_scores_stream_long_packed(
    q, codes, flags, emit_stream, emit_step,
    penalties: Penalties = DEFAULT_PENALTIES, state_dtype="int32", rows=16,
    score_width=None, emit_regular=None,
):
    """sw_scores_stream_long on the 2-bit wire format: the stream crosses
    to the device at 2.5 bits/char and expands there."""
    stream = unpack_stream_wire(codes, flags)
    return sw_scores_stream_long(
        q, stream, emit_stream, emit_step, penalties=penalties,
        state_dtype=state_dtype, rows=rows, score_width=score_width,
        emit_regular=emit_regular,
    )
