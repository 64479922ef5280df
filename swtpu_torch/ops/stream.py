"""The streamed anti-diagonal wavefront on torch tensors.

The port of the single-tile entries of ``swtpu.ops.pallas_stream``.  Query
positions sit on wavefront sublanes (R query rows folded into each), one
logical stream per column; every step injects one flagged char per segment
head, shifts the char pipe one sublane down, and updates every cell on the
anti-diagonal.  Each segment tail keeps a running-best accumulator that
resets at a read's first char; the [T, N] int32 strip of those
accumulators is the emission surface the host-computed coordinates index.

``stream_strip_reference`` is the plain PyTorch version of the recurrence.
``stream_strip_cuda`` launches the hand-written CUDA kernel
(``csrc/stream_wavefront.cu``).  ``_strip_call`` takes the plain version
for a tensor on the CPU and the kernel for a CUDA tensor; there is no
fallback from one to the other.
"""

from __future__ import annotations

import torch

from swtpu.config import DEFAULT_PENALTIES, Penalties

LANES = 128  # query capacity (wavefront rows)
FLAG_BIT = 8  # first-char-of-target marker in the stream bytes
# stream lengths are multiples of this many steps (the packers round up)
STEP_CHUNK = 32
ROWS = (1, 2, 4, 8, 16)


def _validate_config(segments, rows=1):
    """Shape-independent contract checks shared by every entry.  swtpu's
    TPU-only rules are left out: physical streams need not be a multiple
    of the 128-lane vreg width, and rows=16 composes with segments > 1 (it
    hit a Mosaic layout limit, not a semantic one)."""
    if LANES % segments or segments > 8:
        raise ValueError(f"segments {segments} must divide {LANES} and be <= 8")
    if rows not in ROWS:
        raise ValueError(f"rows {rows} must be one of 1/2/4/8/16")
    if (LANES // rows) % segments:
        raise ValueError(
            f"sublane rows {LANES//rows} must divide by segments {segments}"
        )


def _validate_kernel_layout(qk, streamT, segments, rows=1):
    """Contract checks for pre-laid-out inputs (qk [128, S_phys],
    streamT [T, seg*S_phys])."""
    _validate_config(segments, rows)
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


def _validate(q, stream, segments, rows=1):
    _validate_config(segments, rows)
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


def stream_strip_reference(qk, sk, penalties=DEFAULT_PENALTIES, segments=1, rows=1):
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
    The initial pipe is the pad char 4 and all state is zero."""
    ma, mi, go, ge = penalties.astuple()
    S = qk.shape[1]
    T = sk.shape[0]
    SL = LANES // rows
    SLg = SL // segments
    dev = qk.device
    i32 = torch.int32
    qs = qk.to(i32).reshape(rows, SL, S)
    sc = sk.to(i32).reshape(T, segments, S)
    seghead = (torch.arange(SL, device=dev) % SLg == 0)[:, None]
    heads = torch.arange(segments, device=dev) * SLg
    tails = heads + SLg - 1
    zero = torch.zeros((), dtype=i32, device=dev)
    ma_t = torch.tensor(ma, dtype=i32, device=dev)
    mi_t = torch.tensor(mi, dtype=i32, device=dev)

    def plane():
        return torch.zeros((SL, S), dtype=i32, device=dev)

    G = [plane() for _ in range(rows)]
    D = [plane() for _ in range(rows)]
    D2L = plane()  # D of row R-1, two steps back
    Hl = plane()  # H of row R-1, one step back
    C = torch.full((SL, S), 4, dtype=i32, device=dev)
    acc = torch.zeros((segments, S), dtype=i32, device=dev)
    strip = torch.empty((T, segments, S), dtype=i32, device=dev)
    for t in range(T):
        C = torch.roll(C, 1, 0)
        C[heads] = sc[t]
        f0 = C >= FLAG_BIT
        cval = C & 7
        s0 = torch.where(cval == qs[0], ma_t, mi_t)
        diag = torch.where(seghead | f0, zero, torch.roll(D2L, 1, 0))
        Mc = torch.clamp_min(diag + s0, 0)
        G_up = torch.where(seghead, zero, torch.roll(G[rows - 1], 1, 0))
        G_left = torch.where(f0, zero, G[0])
        Ic = torch.maximum(G_up, G_left) + ge
        Hcur = torch.maximum(torch.where(seghead, zero, torch.roll(Hl, 1, 0)), Mc)
        newD = [torch.maximum(Mc, Ic)]
        newG = [torch.maximum(Mc + go, Ic)]
        for r in range(1, rows):
            sr = torch.where(cval == qs[r], ma_t, mi_t)
            Mc = torch.clamp_min(torch.where(f0, zero, D[r - 1]) + sr, 0)
            G_left = torch.where(f0, zero, G[r])
            Ic = torch.maximum(newG[r - 1], G_left) + ge
            Hcur = torch.maximum(Hcur, Mc)
            newD.append(torch.maximum(Mc, Ic))
            newG.append(torch.maximum(Mc + go, Ic))
        D2L = D[rows - 1]
        D = newD
        G = newG
        Hl = Hcur
        acc = torch.maximum(torch.where(f0[tails], zero, acc), Hcur[tails])
        strip[t] = acc
    return strip.reshape(T, segments * S)


def stream_strip_cuda(qk, sk, penalties=DEFAULT_PENALTIES, segments=1, rows=1):
    """The CUDA wavefront kernel on the same contract as
    :func:`stream_strip_reference`; CUDA tensors only.  Launches on the
    current stream and counts each launch in ``stream_strip_cuda.launches``."""
    from swtpu_torch.ops._build import load_library

    _validate_kernel_layout(qk, sk, segments, rows)
    for name, x in (("qk", qk), ("sk", sk)):
        if x.device.type != "cuda" or x.dtype != torch.int8:
            raise ValueError(f"{name} must be a CUDA int8 tensor, got {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sk.device != qk.device:
        raise ValueError(f"qk on {qk.device} but sk on {sk.device}")
    S = qk.shape[1]
    T = sk.shape[0]
    out = torch.empty((T, segments * S), dtype=torch.int32, device=qk.device)
    if T == 0 or S == 0:
        return out
    lib = load_library()
    ma, mi, go, ge = penalties.astuple()
    with torch.cuda.device(qk.device):
        err = lib.swtpu_stream_wavefront(
            qk.data_ptr(), sk.data_ptr(), out.data_ptr(), S, T, segments,
            rows, ma, mi, go, ge, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        msg = lib.swtpu_cuda_error_string(err).decode()
        raise RuntimeError(f"stream_wavefront launch failed: CUDA error {err} ({msg})")
    stream_strip_cuda.launches += 1
    return out


stream_strip_cuda.launches = 0


def _strip_call(qk, sk, penalties, segments, rows):
    """qk [128, S_phys] int8, sk [T, seg*S_phys] int8 -> strip
    [T, seg*S_phys] int32: the plain version on the CPU, the kernel on
    CUDA."""
    if qk.device.type == "cpu":
        return stream_strip_reference(qk, sk, penalties, segments, rows)
    if qk.device.type == "cuda":
        return stream_strip_cuda(qk, sk, penalties, segments, rows)
    raise ValueError(f"no wavefront kernel for device {qk.device}")


def _to_kernel_layout(q, stream, segments, rows):
    """(q [N, qcap], stream [N, T]) -> ([128, S_phys], [T, N]) contiguous."""
    qk = _q_kernel_layout(q, segments, rows).to(torch.int8).contiguous()
    return qk, stream.to(torch.int8).t().contiguous()


def sw_scores_stream_strip(
    q, stream, penalties: Penalties = DEFAULT_PENALTIES, segments=1, rows=1,
):
    """Run the wavefront over packed streams; returns the raw strip.

    Args:
      q: [N, 128//segments] int8 per-stream query codes (sentinel-padded).
      stream: [N, T] int8 concatenated target chars (codes 0..3, +8 flag on
        each target's first char, 4 = drain/pad), T % STEP_CHUNK == 0.
      segments: queries packed per lane column (1, 2, 4 or 8).
      rows: query rows folded per sublane; the emission drain is
        128//(rows*segments) - 1.

    Returns: [N, T] int32 — each logical stream's segment-tail accumulator
    after each step; [n, off+len-1+drain] holds the score of the target at
    offset `off`.  swtpu_torch.bank.streams builds inputs and gathers.
    """
    _validate(q, stream, segments, rows)
    qk, sk = _to_kernel_layout(q, stream, segments, rows)
    return _strip_call(qk, sk, penalties, segments, rows).t()


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


def _gather_emissions(strip, emit_stream, emit_step, regular=None):
    """[T, N] strip -> per-read scores (emit_step < 0 = zero-length read).

    regular: (first, stride, count) from detect_regular_emissions — read r
    emits at (r % N, first + (r // N) * stride), so read-order scores are a
    strided row slice flattened row-major.  Otherwise a scatter gather
    (torch indexes with int64, so the coordinates are widened here)."""
    if regular is not None:
        first, stride, count = regular
        ex = strip[first : first + (count - 1) * stride + 1 : stride]
        return ex.reshape(-1).to(torch.int32)
    emit_step = emit_step.long()
    live = emit_step >= 0
    safe_step = torch.where(live, emit_step, 0)
    scores = strip[safe_step, emit_stream.long()]
    return torch.where(live, scores, 0).to(torch.int32)


def sw_scores_stream_kernel_layout(
    qk, streamT, emit_stream, emit_step,
    penalties: Penalties = DEFAULT_PENALTIES, segments=1, rows=1,
    emit_regular=None,
):
    """sw_scores_stream on pre-laid-out inputs: qk [128, S_phys]
    (``_q_kernel_layout``) and streamT [T, N] (the stream transposed)."""
    _validate_kernel_layout(qk, streamT, segments, rows)
    strip = _strip_call(
        qk.to(torch.int8).contiguous(), streamT.to(torch.int8).contiguous(),
        penalties, segments, rows,
    )
    return _gather_emissions(strip, emit_stream, emit_step, regular=emit_regular)


def sw_scores_stream(
    q, stream, emit_stream, emit_step,
    penalties: Penalties = DEFAULT_PENALTIES, segments=1, rows=1,
    emit_regular=None,
):
    """Wavefront scoring with the emission gather on the tensors' device:
    q [N, 128//segments], stream [N, T] -> [n_reads] int32 scores.

    emit_step < 0 marks a zero-length read (score 0).  The emission
    coordinates must have been computed for the same rows/segments."""
    _validate(q, stream, segments, rows)
    qk, sk = _to_kernel_layout(q, stream, segments, rows)
    strip = _strip_call(qk, sk, penalties, segments, rows)  # [T, N]
    return _gather_emissions(strip, emit_stream, emit_step, regular=emit_regular)


def sw_scores_stream_packed(
    q, codes, flags, emit_stream, emit_step,
    penalties: Penalties = DEFAULT_PENALTIES, segments=1, rows=1,
    emit_regular=None,
):
    """sw_scores_stream on the 2-bit wire format (pack_stream_wire): the
    stream crosses to the device at 2.5 bits/char and expands there."""
    stream = unpack_stream_wire(codes, flags)
    return sw_scores_stream(
        q, stream, emit_stream, emit_step, penalties=penalties,
        segments=segments, rows=rows, emit_regular=emit_regular,
    )
