"""Host-side packing for the streamed wavefront kernel.

The port of ``swtpu.bank.streams``: each of S streams is one feeder lane;
reads go greedily to the currently shortest stream, are concatenated with
a first-char flag, and every read's score-emission coordinate
(stream, step) is computed up front.  For explicit pairs
(``pack_pair_streams``) each stream holds one distinct query in its query
register and carries only that query's targets; for a mesh
(``pack_streams_sharded``) reads are dealt round-robin to shards, each
packed the same way.  The packing is bit-identical to swtpu's, so a batch
packed by either package drives either package's kernels
(``batch_to_device`` moves one onto a torch device).

swtpu's module cannot be imported here: it reaches ``swtpu.ops`` (and so
JAX) through ``swtpu.ops.common`` and ``swtpu.ops.pallas_stream``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from swtpu_torch.ops.common import Q_PAD
from swtpu_torch.ops.stream import STEP_CHUNK

STREAM_PAD = 4  # drain/pad char (never matches; no flag)
FLAG = 8
LANES = 128
DRAIN = LANES - 1


@dataclasses.dataclass
class StreamBatch:
    """Packed streams + emission map.

    q: [N, 128//segments] int8 per-stream query (replicated, sentinel-padded).
    stream: [N, T] int8 flagged char streams, T % STEP_CHUNK == 0.
    emit_stream / emit_step: [n_reads] gather coordinates into the strip.
    cells: real DP cells (query_len * sum target lens).
    segments: queries per lane column the batch was packed for.
    rows: query rows folded per wavefront sublane.
    emit_regular: (first_step, stride, count) when read r emits at
      (stream r % N, step first + (r // N) * stride), else None.

    The array fields are numpy arrays as packed, or torch tensors after
    :func:`batch_to_device`.
    """

    q: np.ndarray
    stream: np.ndarray
    emit_stream: np.ndarray
    emit_step: np.ndarray
    cells: int
    segments: int = 1
    rows: int = 1
    emit_regular: Optional[tuple] = None

    @property
    def total_steps(self) -> int:
        return self.stream.shape[0] * self.stream.shape[1]


def detect_regular_emissions(
    emit_stream: np.ndarray, emit_step: np.ndarray, S: int
) -> Optional[tuple]:
    """(first, stride, count) if read r emits at (r % S, first + (r//S)*stride)
    for every r — one vectorized O(R) check at pack time."""
    R = len(emit_step)
    if R == 0 or R % S:
        return None
    per = R // S
    r = np.arange(R, dtype=np.int64)
    if not np.array_equal(np.asarray(emit_stream, np.int64), r % S):
        return None
    first = int(emit_step[0])
    if first < 0:
        return None
    stride = int(emit_step[S]) - first if per > 1 else 1
    if stride <= 0:
        return None
    if not np.array_equal(
        np.asarray(emit_step, np.int64), (r // S) * stride + first
    ):
        return None
    return (first, stride, per)


def pack_streams(
    query: np.ndarray,
    targets: Sequence[np.ndarray],
    n_streams: int = 256,
    segments: int = 1,
    lens: Optional[np.ndarray] = None,
    rows: int = 1,
) -> StreamBatch:
    """Assign reads to streams (greedy shortest-stream), concatenate with
    flags, compute emission coordinates.

    targets: either a sequence of 1-D code arrays, or — the dense form — a
    [n_reads, width] int8 matrix with `lens` giving each read's real length
    (the rest of each row is ignored).  The dense form takes the native C++
    plan/fill path when the toolchain is available.

    segments: queries per lane column in the kernel (1/2/4).
    rows: query rows folded per sublane; the emission drain is
    128//(rows*segments) - 1."""
    qcap = LANES // segments
    if len(query) > qcap:
        raise ValueError(
            f"query of {len(query)} bases exceeds capacity {qcap} at "
            f"segments={segments}"
        )
    if lens is not None:
        tmat = np.asarray(targets)
        if tmat.ndim != 2:
            raise ValueError("lens requires a dense [n, width] target matrix")
        return _pack_streams_dense(
            query, tmat.astype(np.int8, copy=False),
            np.asarray(lens, np.int32), n_streams, segments, rows,
        )
    n_reads = len(targets)
    S = n_streams
    # large ragged lists: densify and take the native plan/fill path
    # instead of the per-read Python greedy loop
    if n_reads >= 1024 and not isinstance(targets, np.ndarray) and all(
        isinstance(t, np.ndarray) and t.ndim == 1 for t in targets[:64]
    ):
        try:
            tlens = np.fromiter((len(t) for t in targets), np.int32, n_reads)
            flat = np.concatenate(targets).astype(np.int8, copy=False)
            w = max(int(tlens.max()), 1)
            tmat = np.zeros((n_reads, w), np.int8)
            tmat[np.arange(w)[None, :] < tlens[:, None]] = flat
            return _pack_streams_dense(query, tmat, tlens, S, segments, rows)
        except (ValueError, TypeError):
            pass  # odd element shapes/dtypes: fall through to greedy
    # equal-length reads, count divisible by S: greedy shortest-stream
    # degenerates to round-robin, packed here without the per-read loop
    if n_reads and n_reads % S == 0 and len(targets[0]) > 0:
        tmat = targets if isinstance(targets, np.ndarray) else None
        if tmat is None and all(
            isinstance(t, np.ndarray) and t.ndim == 1 and len(t) == len(targets[0])
            for t in targets[: min(n_reads, 64)]
        ):
            lens = {len(t) for t in targets}
            if len(lens) == 1:
                tmat = np.stack(targets)
        if tmat is not None and tmat.ndim == 2:
            return _pack_streams_equal(
                query, tmat.astype(np.int8), S, segments, rows
            )
    # large equal-width matrix that misses the divisibility condition above
    if (
        isinstance(targets, np.ndarray) and targets.ndim == 2
        and n_reads >= 1024 and targets.shape[1] > 0
    ):
        return _pack_streams_dense(
            query, targets.astype(np.int8, copy=False),
            np.full(n_reads, targets.shape[1], np.int32), S, segments, rows,
        )
    return _pack_streams_greedy(query, targets, S, segments, rows)


def pack_streams_long(
    query: np.ndarray,
    targets: Sequence[np.ndarray],
    n_streams: int = 256,
    rows: int = 16,
    lens: Optional[np.ndarray] = None,
) -> StreamBatch:
    """Pack for :func:`swtpu_torch.ops.stream.sw_scores_stream_long`:
    queries longer than one 128-row tile.  Stream assignment and emission
    coordinates do not depend on the query length (drain = 128//rows - 1,
    as for one tile at segments 1); the stream gains (128//rows - 1)*(K - 1)
    extra drain steps for the K-tile chain."""
    query = np.asarray(query, np.int8)
    K = max(1, -(-len(query) // LANES))
    # emission and stream layout from a length-1 probe query (same drain),
    # then widen the query register and scale the cell count
    b = pack_streams(
        query[:1], targets, n_streams, segments=1, lens=lens, rows=rows,
    )
    SL = LANES // rows
    extra = (SL - 1) * (K - 1)
    T = -(-(b.stream.shape[1] + extra) // STEP_CHUNK) * STEP_CHUNK
    stream = np.full((n_streams, T), STREAM_PAD, dtype=np.int8)
    stream[:, : b.stream.shape[1]] = b.stream
    q = np.full((n_streams, K * LANES), Q_PAD, dtype=np.int8)
    q[:, : len(query)] = query[None, :]
    cells = b.cells * int(len(query))  # the probe counted 1 cell per target char
    return StreamBatch(
        q, stream, b.emit_stream, b.emit_step, cells, 1, rows,
        emit_regular=b.emit_regular,  # the emission layout is query-independent
    )


def _finish_batch(batch: StreamBatch) -> StreamBatch:
    """Stamp the regular-emission pattern (strided-extract fast path)."""
    batch.emit_regular = detect_regular_emissions(
        batch.emit_stream, batch.emit_step, batch.stream.shape[0]
    )
    return batch


def _query_register(query: np.ndarray, S: int, qcap: int) -> np.ndarray:
    q = np.full((S, qcap), Q_PAD, dtype=np.int8)
    q[:, : len(query)] = np.asarray(query, dtype=np.int8)[None, :]
    return q


def _pack_streams_greedy(
    query: np.ndarray,
    targets: Sequence[np.ndarray],
    S: int,
    segments: int,
    rows: int = 1,
) -> StreamBatch:
    """Pure-Python greedy shortest-stream packing (the reference semantics);
    terminal, so it is the fallback when the native toolchain is missing."""
    qcap = LANES // segments
    drain = LANES // (rows * segments) - 1
    n_reads = len(targets)
    chunks: List[List[np.ndarray]] = [[] for _ in range(S)]
    fill = np.zeros(S, dtype=np.int64)
    emit_stream = np.zeros(n_reads, dtype=np.int32)
    emit_step = np.zeros(n_reads, dtype=np.int64)
    cells = 0
    for r, t in enumerate(targets):
        t = np.asarray(t, dtype=np.int8)
        if len(t) == 0:
            emit_stream[r] = 0
            emit_step[r] = -1  # zero-length read: score 0 by definition
            continue
        s = int(np.argmin(fill))
        flagged = t.copy()
        flagged[0] |= FLAG
        chunks[s].append(flagged)
        emit_stream[r] = s
        emit_step[r] = fill[s] + len(t) - 1 + drain
        fill[s] += len(t)
        cells += len(query) * len(t)

    T = int(fill.max()) + drain if n_reads else STEP_CHUNK
    T = -(-T // STEP_CHUNK) * STEP_CHUNK
    stream = np.full((S, T), STREAM_PAD, dtype=np.int8)
    for s in range(S):
        if chunks[s]:
            cat = np.concatenate(chunks[s])
            stream[s, : len(cat)] = cat

    return _finish_batch(StreamBatch(
        _query_register(query, S, qcap), stream, emit_stream,
        _check_emit_step(emit_step), cells, segments, rows,
    ))


def _check_emit_step(emit_step: np.ndarray) -> np.ndarray:
    """Emission steps are consumed as int32 by the kernels' callers; a
    stream longer than 2^31 steps would wrap at the cast."""
    if emit_step.size and int(emit_step.max()) >= 2**31:
        raise ValueError(
            "stream exceeds 2^31 steps; emission coordinates would overflow "
            "int32 — split the database into smaller batches"
        )
    return emit_step


def _pack_streams_dense(
    query: np.ndarray, tmat: np.ndarray, lens: np.ndarray, S: int,
    segments: int, rows: int = 1,
) -> StreamBatch:
    """Ragged dense-matrix packing via the native C++ plan/fill
    pipeline; pure-Python greedy fallback if the toolchain is missing.
    Bit-identical to the per-read greedy path."""
    qcap = LANES // segments
    drain = LANES // (rows * segments) - 1
    n_reads = tmat.shape[0]
    try:
        from swtpu_torch.runtime.native import NativePacker, native_available

        if not native_available():
            raise RuntimeError("native unavailable")
        packer = NativePacker()
        emit_stream, emit_step, max_fill = packer.plan_streams(lens, S, drain)
        T = max(max_fill + drain, STEP_CHUNK) if n_reads else STEP_CHUNK
        T = -(-T // STEP_CHUNK) * STEP_CHUNK
        stream = packer.fill_streams(
            tmat, lens, emit_stream, emit_step, drain, FLAG, T, S, STREAM_PAD
        )
    except RuntimeError:
        # no native toolchain: the terminal greedy packer (pack_streams()
        # here would re-enter the densify branch and recurse)
        return _pack_streams_greedy(
            query, [tmat[i, : lens[i]] for i in range(n_reads)], S, segments,
            rows,
        )
    cells = int(len(query)) * int(lens.astype(np.int64).sum())
    return _finish_batch(StreamBatch(
        _query_register(query, S, qcap), stream, emit_stream,
        _check_emit_step(emit_step), cells, segments, rows,
    ))


def _pack_streams_equal(
    query: np.ndarray, tmat: np.ndarray, S: int, segments: int, rows: int = 1
) -> StreamBatch:
    """Vectorized round-robin packing of a [B, n] equal-length read matrix."""
    qcap = LANES // segments
    drain = LANES // (rows * segments) - 1
    B, n = tmat.shape
    per = B // S  # reads per stream
    flagged = tmat.copy()
    flagged[:, 0] |= FLAG
    # read r -> stream r % S, slot r // S (greedy == round-robin here)
    body = flagged.reshape(per, S, n).transpose(1, 0, 2).reshape(S, per * n)
    T = -(-(per * n + drain) // STEP_CHUNK) * STEP_CHUNK
    stream = np.full((S, T), STREAM_PAD, dtype=np.int8)
    stream[:, : per * n] = body
    r = np.arange(B, dtype=np.int64)
    emit_stream = (r % S).astype(np.int32)
    emit_step = (r // S) * n + (n - 1) + drain
    return StreamBatch(
        _query_register(query, S, qcap), stream, emit_stream,
        _check_emit_step(emit_step), len(query) * B * n, segments, rows,
        emit_regular=(n - 1 + drain, n, per),  # regular by construction
    )


def dedupe_queries(queries) -> tuple:
    """(distinct int8 query arrays, [n] int32 uid per input): the one
    content-keyed dedup that the pair packer and ScoreBank's chunker both
    use, so that their distinct-query counts always agree."""
    uid_by_key = {}
    qlist: List[np.ndarray] = []
    uid = np.empty(len(queries), np.int32)
    for i, qq in enumerate(queries):
        qq = np.asarray(qq, dtype=np.int8)
        u = uid_by_key.get(qq.tobytes())
        if u is None:
            u = uid_by_key[qq.tobytes()] = len(qlist)
            qlist.append(qq)
        uid[i] = u
    return qlist, uid


def pack_pair_streams(
    queries: Sequence[np.ndarray],
    targets: Sequence[np.ndarray],
    n_streams: int = 256,
    segments: int = 1,
    rows: int = 1,
) -> StreamBatch:
    """Pack explicit (query, target) pairs onto the wavefront: each logical
    stream holds ONE query in its per-stream query register (the kernel's q
    is per stream already: the reference's per-module `ld_q`), and every
    pair's target rides a stream owned by its query.

    Streams go to the distinct queries in proportion to their total target
    chars (largest remainder, at least one each); within a query's streams,
    targets go to the shortest stream.  Raises if there are more distinct
    queries than logical streams: the caller chunks the pair set
    (ScoreBank.score_pairs does).  Emission coordinates follow
    pack_streams' drain contract."""
    if len(queries) != len(targets):
        raise ValueError("queries and targets must pair up")
    qcap = LANES // segments
    drain = LANES // (rows * segments) - 1
    n = len(queries)
    S = n_streams
    # pairs sharing a query (by content) share its streams
    qlist, uid = dedupe_queries(queries)
    for qq in qlist:
        if len(qq) > qcap:
            raise ValueError(
                f"query of {len(qq)} bases exceeds capacity {qcap} at "
                f"segments={segments}"
            )
    U = len(qlist)
    if U > S:
        raise ValueError(
            f"{U} distinct queries exceed {S} logical streams; split the "
            "pair set into chunks of <= n_streams distinct queries"
        )
    load = np.zeros(U, np.int64)
    for i in range(n):
        load[uid[i]] += len(targets[i])
    # largest-remainder proportional stream allocation, >= 1 per query
    total = max(int(load.sum()), 1)
    want = load.astype(np.float64) * S / total
    alloc = np.maximum(np.floor(want).astype(np.int64), 1)
    while alloc.sum() > S:
        alloc[int(np.argmax(alloc))] -= 1
    # leftovers go to the largest fractional remainders
    rema = want - np.floor(want)
    while alloc.sum() < S:
        k = int(np.argmax(rema))
        alloc[k] += 1
        rema[k] = -1.0
    first = np.zeros(U, np.int64)
    np.cumsum(alloc[:-1], out=first[1:])
    # greedy shortest-stream within each query's stream span
    fill = np.zeros(S, dtype=np.int64)
    chunks: List[List[np.ndarray]] = [[] for _ in range(S)]
    emit_stream = np.zeros(n, dtype=np.int32)
    emit_step = np.zeros(n, dtype=np.int64)
    cells = 0
    for i in range(n):
        t = np.asarray(targets[i], dtype=np.int8)
        if len(t) == 0:
            emit_stream[i] = 0
            emit_step[i] = -1  # zero-length target: score 0 by definition
            continue
        u = uid[i]
        lo, hi = int(first[u]), int(first[u] + alloc[u])
        s = lo + int(np.argmin(fill[lo:hi]))
        flagged = t.copy()
        flagged[0] |= FLAG
        chunks[s].append(flagged)
        emit_stream[i] = s
        emit_step[i] = fill[s] + len(t) - 1 + drain
        fill[s] += len(t)
        cells += len(qlist[u]) * len(t)

    T = int(fill.max()) + drain if n else STEP_CHUNK
    T = -(-T // STEP_CHUNK) * STEP_CHUNK
    stream = np.full((S, T), STREAM_PAD, dtype=np.int8)
    for s in range(S):
        if chunks[s]:
            cat = np.concatenate(chunks[s])
            stream[s, : len(cat)] = cat
    q = np.full((S, qcap), Q_PAD, dtype=np.int8)
    for u in range(U):
        qq = qlist[u]
        q[int(first[u]) : int(first[u] + alloc[u]), : len(qq)] = qq[None, :]
    return _finish_batch(StreamBatch(
        q, stream, emit_stream, _check_emit_step(emit_step), cells, segments,
        rows,
    ))


def pack_stream_wire(stream: np.ndarray):
    """Compress a flagged char-stream matrix for the host->device copy:
    2-bit codes packed 4/byte LSB-first plus a first-char flag bitmap
    packed 8/byte — 2.5 bits/char instead of 8.

    Pad chars lose their identity (code 4 -> 0), which is score-safe: pad
    columns sit after every gathered emission step, and read boundaries are
    re-established by the flag bits.

    stream: [N, T] int8, T % 8 == 0.  Returns (codes [N, T//4] uint8,
    flags [N, T//8] uint8)."""
    N, T = stream.shape
    if T % 8:
        raise ValueError(f"stream length {T} must be a multiple of 8")
    try:
        from swtpu_torch.runtime.native import NativePacker, native_available

        if native_available():
            return NativePacker().pack_wire(stream)
    except RuntimeError:
        pass
    u = stream.astype(np.uint8)
    quads = (u & 3).reshape(N, T // 4, 4)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    codes = np.bitwise_or.reduce(quads << shifts, axis=2).astype(np.uint8)
    flags = np.packbits((u & FLAG) != 0, axis=1, bitorder="little")
    return codes, flags


def gather_stream_scores(strip: np.ndarray, batch: StreamBatch) -> np.ndarray:
    """strip [S, T] -> per-read scores in submission order."""
    scores = np.zeros(len(batch.emit_step), dtype=np.int32)
    live = batch.emit_step >= 0
    scores[live] = strip[batch.emit_stream[live], batch.emit_step[live]]
    return scores


def batch_to_device(batch, device) -> StreamBatch:
    """Copy a packed batch — a StreamBatch of this package or of
    ``swtpu.bank.streams``, numpy fields — onto `device` as torch tensors:
    q and stream int8, the emission coordinates int64 (torch's index
    type).  Scalars and the emission pattern carry over unchanged."""

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return StreamBatch(
        put(batch.q, np.int8), put(batch.stream, np.int8),
        put(batch.emit_stream, np.int64), put(batch.emit_step, np.int64),
        int(batch.cells), int(batch.segments), int(batch.rows),
        batch.emit_regular,
    )


def score_streams(
    query: np.ndarray,
    targets: Sequence[np.ndarray],
    n_streams: int = 256,
    penalties=None,
    device="cuda",
    segments: int = 1,
    rows: int = 1,
    state_dtype: str = "int32",
) -> np.ndarray:
    """Streamed scoring end to end on `device`: pack the reads, run the
    wavefront over the streams (the CUDA kernel on the card, its plain
    version on the CPU) and gather each read's score from the strip.
    swtpu's ``score_streams`` with `device` in place of `interpret`."""
    from swtpu_torch.config import DEFAULT_PENALTIES
    from swtpu_torch.ops.stream import reads_up_to, sw_scores_stream_strip

    batch = pack_streams(query, targets, n_streams, segments=segments, rows=rows)
    d = batch_to_device(batch, device)
    with reads_up_to(max(map(len, targets), default=0)):
        strip = sw_scores_stream_strip(
            d.q, d.stream, penalties or DEFAULT_PENALTIES, segments=segments,
            rows=rows, state_dtype=state_dtype,
        )
    return gather_stream_scores(strip.cpu().numpy(), batch)


@dataclasses.dataclass
class ShardedStreamBatch:
    """Per-shard stacks of stream batches (leading axis = mesh shard).

    Reads are dealt round-robin across shards and every shard's streams pad
    to a common length, so one call of the sharded scorer covers the mesh.

    q: [D, N, 128//segments] int8 (or [D, N, K*128] for a long query);
    stream: [D, N, T] int8.
    emit_stream/emit_step: [D, R] gather coordinates (R = max reads/shard).
    ids: [D, R] global read index, -1 on padding slots.
    cells: total real DP cells across shards.
    """

    q: np.ndarray
    stream: np.ndarray
    emit_stream: np.ndarray
    emit_step: np.ndarray
    ids: np.ndarray
    cells: int
    segments: int = 1
    emit_regular: Optional[tuple] = None  # common per-shard pattern, if any


def pack_streams_sharded(
    query: np.ndarray,
    targets: Sequence[np.ndarray],
    n_shards: int,
    n_streams: int = 256,
    segments: int = 1,
    rows: int = 1,
) -> ShardedStreamBatch:
    """Deal reads round-robin to `n_shards` shards and pack each with
    :func:`pack_streams` (or :func:`pack_streams_long` for a query past one
    128-row tile); pad stream length and read count to the shard maxima.
    Bit-identical to swtpu's in every field.

    targets: a sequence of 1-D code arrays, or the dense EncodedDB /
    (mat, lens) form — dense shards slice the matrix round-robin and take
    the native plan/fill path per shard (no per-read Python objects)."""
    batches, groups = _pack_shards(query, targets, n_shards, n_streams, segments, rows)
    return _stack_shards(batches, groups, n_streams, segments)


def _pack_shards(query, targets, n_shards, n_streams, segments, rows):
    """(a StreamBatch a shard, the read ids a shard): the round-robin deal
    and each shard's pack, before the stack."""
    from swtpu_torch.bank.scorebank import _dense_form

    tmat, tlens = _dense_form(targets)
    n_reads = len(tlens) if tlens is not None else len(targets)
    groups = [list(range(d, n_reads, n_shards)) for d in range(n_shards)]
    if len(query) > LANES // segments:
        if segments != 1:
            raise ValueError("long queries require segments=1")

        def pack(t, lens):
            return pack_streams_long(query, t, n_streams=n_streams, rows=rows, lens=lens)
    else:
        def pack(t, lens):
            return pack_streams(query, t, n_streams=n_streams, segments=segments, rows=rows,
                                lens=lens)
    if tlens is not None:
        batches = [pack(tmat[d::n_shards], np.asarray(tlens)[d::n_shards])
                   for d in range(n_shards)]
    else:
        batches = [pack([targets[i] for i in g], None) for g in groups]
    return batches, groups


def _stack_shards(batches, groups, n_streams, segments) -> ShardedStreamBatch:
    """The shards' batches padded to the longest stream and the most reads
    a shard, stacked on a leading shard axis."""
    T = max(b.stream.shape[1] for b in batches)
    R = max(len(g) for g in groups)
    D = len(batches)
    q = np.stack([b.q for b in batches])
    stream = np.full((D, n_streams, T), STREAM_PAD, dtype=np.int8)
    emit_stream = np.zeros((D, R), np.int32)
    emit_step = np.full((D, R), -1, np.int64)
    ids = np.full((D, R), -1, np.int32)
    cells = 0
    for d, (g, b) in enumerate(zip(groups, batches)):
        stream[d, :, : b.stream.shape[1]] = b.stream
        emit_stream[d, : len(g)] = b.emit_stream
        emit_step[d, : len(g)] = b.emit_step
        ids[d, : len(g)] = g
        cells += b.cells
    # the strided-extract fast path applies mesh-wide only when every shard
    # shares one regular pattern and no shard needed read-count padding
    regs = {b.emit_regular for b in batches}
    common = regs.pop() if len(regs) == 1 and all(len(g) == R for g in groups) else None
    return ShardedStreamBatch(q, stream, emit_stream, emit_step, ids, cells, segments,
                              emit_regular=common)


def scatter_sharded_scores(
    shard_scores, batch: ShardedStreamBatch, n_reads: int
) -> np.ndarray:
    """[D, R] per-shard scores (an array or a tensor) -> [n_reads]
    read-order scores."""
    if isinstance(shard_scores, torch.Tensor):
        shard_scores = shard_scores.cpu().numpy()
    out = np.zeros(n_reads, np.int32)
    live = batch.ids >= 0
    out[batch.ids[live]] = np.asarray(shard_scores)[live]
    return out
