"""Sharded device-resident serving: a loaded database spread over a mesh.

The port of ``swtpu.bank.serving``.  Each mesh shard holds one shard of
the packed streams resident on its device, in the kernel's [T, N] layout
exactly like the one-device ``LoadedDatabase``, and every query runs the
streamed wavefront once a shard on it (B1 for a query of up to 128 bases,
K chained B3 tiles for a longer one), passing the resident stream to the
kernel uncopied.  The query register is made once and copied to each
distinct device of the mesh; results come back as the full read-order
score vector, or as the merged top-K (2k values).

Build with :meth:`swtpu_torch.bank.ScoreBank.load_database_sharded`, score
with :meth:`score_loaded_sharded` / :meth:`topk_loaded_sharded`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from swtpu_torch.config import DEFAULT_PENALTIES, Penalties
from swtpu_torch.utils.metrics import BatchEvent


@dataclasses.dataclass
class ShardedLoadedDatabase:
    """A packed database resident across a mesh's shards.

    streams: D tensors [T, N] int8, contiguous (the kernel's layout), shard
      d's on ``mesh.devices[d]``.
    emit_stream_dev/emit_step_dev/ids_dev: D tensors [R] int32, each on its
      shard's device (R = max reads a shard; padding slots carry
      emit_step = -1, ids = -1).
    ids_host: [D, R] the same ids on the host.
    order_dev: [n_reads] int64 on the first device: read r's position in
      the flattened [D, R] scores, so that the read-order scatter is one
      gather on the device and only n_reads scores are copied back.
    Scorers are cached per (long_query, k, full_scores) on the object.
    """

    streams: List[torch.Tensor]
    emit_stream_dev: List[torch.Tensor]
    emit_step_dev: List[torch.Tensor]
    ids_dev: List[torch.Tensor]
    ids_host: np.ndarray
    order_dev: torch.Tensor
    t_lens: np.ndarray
    total_chars: int
    n_reads: int
    rows: int
    k_max: int
    segments: int
    mesh: object
    axis: str
    n_shards: int
    penalties: Penalties
    state_dtype: str
    score_width: Optional[int] = None
    emit_regular: Optional[tuple] = None  # strided-extract pattern
    _scorers: Dict[tuple, object] = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> tuple:
        """(D, T, N): the stacked streams' shape."""
        T, N = self.streams[0].shape
        return (self.n_shards, int(T), int(N))


def make_sharded_loaded_scorer(
    mesh,
    axis: str = "data",
    penalties: Penalties = DEFAULT_PENALTIES,
    segments: int = 1,
    rows: int = 1,
    state_dtype: str = "int32",
    k: int = 0,
    long_query: bool = False,
    full_scores: bool = True,
    score_width: Optional[int] = None,
    emit_regular: Optional[tuple] = None,
):
    """The wavefront over resident stream shards with a replicated query.

    Signature (D = mesh shards; each argument but the register a list of D
    tensors on the shards' devices):
      full_scores, k=0:   scores[D, R] = f(regs, streams, es, ep, ids)
      full_scores, k>0:   (scores[D, R], top_s[k], top_ids[k]) = f(...)
      not full_scores:    (top_s[k], top_ids[k]) = f(...)   # k > 0 required

    regs maps each distinct device to the query register there: the
    kernel layout [128, S_phys] for a one-tile query, or the raw
    [N, K*128] per-stream register for chained tiles (long_query=True)."""
    from swtpu_torch.ops.stream import (
        sw_scores_stream_kernel_layout, sw_scores_stream_long_kernel_layout,
    )
    from swtpu_torch.parallel.sharded import _check_axis, _merge_topk

    _check_axis(mesh, axis)
    if not full_scores and not k:
        raise ValueError("full_scores=False requires k > 0")
    kw = dict(penalties=penalties, rows=rows, state_dtype=state_dtype,
              score_width=score_width, emit_regular=emit_regular)

    def score(regs, streams, es, ep, ids):
        out = []
        for dev, st, e, p in zip(mesh.devices, streams, es, ep):
            if long_query:
                s = sw_scores_stream_long_kernel_layout(regs[dev], st, e, p, **kw)
            else:
                s = sw_scores_stream_kernel_layout(regs[dev], st, e, p,
                                                   segments=segments, **kw)
            out.append(s)
        if not k:
            return torch.stack([s.to(mesh.devices[0]) for s in out])
        fs, fids = _merge_topk(out, ids, k, mesh)
        if not full_scores:
            return fs, fids
        return torch.stack([s.to(mesh.devices[0]) for s in out]), fs, fids

    return score


def load_database_sharded(
    bank,
    targets,
    mesh,
    max_query_len: int = 128,
    axis: str = "data",
) -> ShardedLoadedDatabase:
    """Pack `targets` into per-shard streams and leave every shard resident
    on its mesh device.

    Reads are dealt round-robin across the mesh's shards; each shard packs
    exactly like :meth:`ScoreBank.load_database` (the same geometry from
    ``stream_geometry``, the same multi-tile drain capacity) and pads to
    the common (T, R) envelope; shard d's [T, N] stream lies only on its
    device.  With ``wire_2bit`` on CUDA each shard crosses once at 2.5
    bits/char and unpacks on its own device.  Requires the stream backend."""
    from swtpu_torch.bank.scorebank import _dense_form, _put, stream_geometry
    from swtpu_torch.bank.streams import (
        LANES, _pack_shards, _stack_shards, pack_stream_wire,
    )
    from swtpu_torch.ops.stream import unpack_stream_wire
    from swtpu_torch.parallel.sharded import _check_axis

    if bank.backend != "stream":
        raise ValueError(
            f"load_database_sharded requires the stream backend (got {bank.backend!r})"
        )
    _check_axis(mesh, axis)
    D = int(mesh.shape[axis])
    segments, rows, phys = stream_geometry(max_query_len, bank.config, mesh.devices[0])
    k_max = max(1, -(-int(max_query_len) // LANES))
    # a probe query of the capacity packs the drain the longest query needs
    probe = np.zeros((k_max * LANES if k_max > 1 else 1,), np.int8)
    n_streams = phys if k_max > 1 else phys * segments
    batches, groups = _pack_shards(probe, targets, D, n_streams, segments, rows)
    if bank.verify_integrity:
        from swtpu_torch.utils.guards import check_stream_batch

        for b in batches:
            check_stream_batch(b)
    packed = _stack_shards(batches, groups, n_streams, segments)
    _, tlens = _dense_form(targets)
    t_lens = (np.asarray(tlens, np.int64) if tlens is not None
              else np.fromiter((len(t) for t in targets), np.int64, len(targets)))
    n_reads = len(t_lens)
    ids = packed.ids
    emit_step = packed.emit_step.astype(np.int32)

    streams = []
    for d, dev in enumerate(mesh.devices):
        if bank.config.wire_2bit and dev.type == "cuda":
            # one 2.5-bit/char crossing a shard, expanded and transposed on
            # the shard's device
            codes, flags = pack_stream_wire(packed.stream[d])
            streams.append(unpack_stream_wire(_put(codes, dev), _put(flags, dev))
                           .t().contiguous())
        else:
            streams.append(_put(packed.stream[d].T, dev))
    return ShardedLoadedDatabase(
        streams=streams,
        emit_stream_dev=[_put(packed.emit_stream[d], dev) for d, dev in enumerate(mesh.devices)],
        emit_step_dev=[_put(emit_step[d], dev) for d, dev in enumerate(mesh.devices)],
        ids_dev=[_put(ids[d], dev) for d, dev in enumerate(mesh.devices)],
        ids_host=ids,
        order_dev=_put(_read_order(ids, n_reads), mesh.devices[0]),
        t_lens=t_lens,
        total_chars=int(t_lens.sum()),
        n_reads=n_reads,
        rows=rows,
        k_max=k_max,
        segments=segments,
        mesh=mesh,
        axis=axis,
        n_shards=D,
        penalties=bank.config.penalties,
        state_dtype=bank._stream_dtype(),
        score_width=bank.config.score_width,
        emit_regular=packed.emit_regular,
    )


def _query_register(query: np.ndarray, db: ShardedLoadedDatabase):
    """(registers, long_query): the query register, made once on the
    mesh's first device and copied to each other distinct device, as
    {device: register} — the kernel layout [128, S_phys] for a one-tile
    query, the raw [N, K*128] register for chained tiles.  The capacity
    and segment errors of the one-device dispatch."""
    from swtpu_torch.bank.scorebank import _put_query
    from swtpu_torch.bank.streams import LANES
    from swtpu_torch.ops.common import Q_PAD
    from swtpu_torch.ops.stream import _q_kernel_layout

    query = np.asarray(query, np.int8)
    N = db.shape[2]
    qcap = LANES // db.segments
    long_query = len(query) > qcap
    if not long_query:
        width = qcap
    elif db.segments > 1:
        raise ValueError(
            f"query of {len(query)} bases exceeds the segmented capacity "
            f"{qcap} this database was loaded for — reload with a larger "
            "max_query_len"
        )
    else:
        K = -(-len(query) // LANES)
        if K > db.k_max:
            raise ValueError(
                f"query of {len(query)} bases needs {K} tiles; database was "
                f"loaded with max_query_len for {db.k_max} — reload with a "
                "larger max_query_len"
            )
        width = K * LANES
    home = db.mesh.devices[0]
    q = torch.full((N, width), Q_PAD, dtype=torch.int8, device=home)
    q[:, : len(query)] = _put_query(query, home)
    if not long_query:
        q = _q_kernel_layout(q, db.segments, db.rows).to(torch.int8).contiguous()
    regs = {}
    for dev in db.mesh.devices:
        if dev not in regs:
            regs[dev] = q if dev == home else q.to(dev)
    return regs, long_query


def _get_scorer(db: ShardedLoadedDatabase, long_query: bool, k: int, full_scores: bool):
    key = (long_query, k, full_scores)
    fn = db._scorers.get(key)
    if fn is None:
        fn = db._scorers[key] = make_sharded_loaded_scorer(
            db.mesh, axis=db.axis, penalties=db.penalties, segments=db.segments,
            rows=db.rows, state_dtype=db.state_dtype, k=k, long_query=long_query,
            full_scores=full_scores, score_width=db.score_width,
            emit_regular=db.emit_regular,
        )
    return fn


def dispatch_loaded_sharded(query: np.ndarray, db: ShardedLoadedDatabase,
                            k: int = 0, full_scores: bool = True):
    """Enqueue one query over the whole mesh; returns the device outputs
    (scores [D, R] and/or the top-K) without waiting for them."""
    from swtpu_torch.bank.scorebank import longest_read
    from swtpu_torch.ops.stream import reads_up_to

    regs, long_q = _query_register(query, db)
    fn = _get_scorer(db, long_q, k, full_scores)
    with reads_up_to(longest_read(db.t_lens)):
        return fn(regs, db.streams, db.emit_stream_dev, db.emit_step_dev, db.ids_dev)


def _padded_cells(db: ShardedLoadedDatabase, qlen: int) -> int:
    """The wavefront's capacity swept for a query of `qlen` bases: every
    shard's T x N x 128//segments, once a tile."""
    from swtpu_torch.bank.streams import LANES

    D, T, N = db.shape
    return D * T * N * (LANES // db.segments) * max(1, -(-qlen // LANES))


def _read_order(ids: np.ndarray, n_reads: int) -> np.ndarray:
    """[n_reads] int64: read r's position in the flattened [D, R] ids."""
    order = np.zeros(n_reads, np.int64)
    flat = ids.reshape(-1)
    live = np.flatnonzero(flat >= 0)
    order[flat[live]] = live
    return order


def _to_read_order(db: ShardedLoadedDatabase, s_g: torch.Tensor) -> torch.Tensor:
    """[D, R] shard scores on the first device -> [n_reads] in read order,
    still on the device (one gather)."""
    return s_g.reshape(-1)[db.order_dev]


def score_loaded_sharded(bank, query: np.ndarray, db: ShardedLoadedDatabase,
                         event_log=None):
    """Score `query` against the mesh-resident database; returns a
    read-order ScoreResult (the full score vector, gathered across
    shards).  event_log receives one "loaded_sharded" record."""
    t0 = time.perf_counter()
    s_g = dispatch_loaded_sharded(query, db)
    return finish_loaded_sharded(bank, query, db, s_g, t0, event_log=event_log)


def finish_loaded_sharded(bank, query: np.ndarray, db: ShardedLoadedDatabase,
                          s_g, t0, event_log=None):
    """Put a dispatched query's scores in read order on the device and copy
    them back (waiting for them): the serving front end dispatches under
    its lock and finishes outside it, so clients pipeline."""
    from swtpu_torch.bank.scorebank import ScoreResult

    scores = _to_read_order(db, s_g).cpu().numpy()
    if bank.verify_integrity:
        from swtpu_torch.utils.guards import check_scores

        check_scores(scores, np.full(db.n_reads, len(query)), db.t_lens,
                     db.penalties.match)
    cells = int(len(query)) * db.total_chars
    padded = _padded_cells(db, len(query))
    elapsed = time.perf_counter() - t0
    if event_log is not None:
        event_log.emit(
            BatchEvent(
                "loaded_sharded", t_wall=time.time(), elapsed_s=elapsed,
                reads=db.n_reads, cells=cells, padded_cells=padded,
                note=f"qlen={len(query)} shards={db.n_shards}",
            )
        )
    return ScoreResult(scores, cells, padded, elapsed)


def finish_topk_loaded_sharded(query, db: ShardedLoadedDatabase, devs, t0,
                               event_log=None, k=None) -> List[Tuple[int, int]]:
    """Copy a dispatched top-K back: (score, read index) pairs, sentinel
    slots dropped; event_log receives one "loaded_sharded_topk" record
    (its note's k is `k`, else the cut's length)."""
    fs, fids = devs[0].cpu().numpy(), devs[1].cpu().numpy()
    if event_log is not None:
        event_log.emit(
            BatchEvent(
                "loaded_sharded_topk", t_wall=time.time(),
                elapsed_s=time.perf_counter() - t0,
                reads=db.n_reads, cells=int(len(query)) * db.total_chars,
                padded_cells=0,
                note=f"qlen={len(query)} k={len(fs) if k is None else k} "
                f"shards={db.n_shards}",
            )
        )
    return [(int(s), int(i)) for s, i in zip(fs, fids) if i >= 0]


def topk_loaded_sharded(bank, query: np.ndarray, db: ShardedLoadedDatabase,
                        k: int = 10, event_log=None) -> List[Tuple[int, int]]:
    """Mesh-wide best hits: each shard's top-K cut on its device, merged
    over the mesh (and processes), only 2k values copied back.  The order
    is ScoreResult.top_k's (score desc, id asc)."""
    t0 = time.perf_counter()
    kk = min(k, db.n_reads) or 1
    devs = dispatch_loaded_sharded(query, db, k=kk, full_scores=False)
    return finish_topk_loaded_sharded(query, db, devs, t0, event_log=event_log, k=k)[:k]


def score_loaded_many_sharded(
    bank, queries: Sequence[np.ndarray], db: ShardedLoadedDatabase, event_log=None,
) -> List:
    """Many queries over the mesh: every query is enqueued before any
    result is copied back.  Each result's elapsed_s is the batch's wall
    time divided evenly; event_log receives one "loaded_sharded_many"
    record a query."""
    from swtpu_torch.bank.scorebank import ScoreResult

    t0 = time.perf_counter()
    devs = [_to_read_order(db, dispatch_loaded_sharded(q, db)) for q in queries]
    mats = [d.cpu().numpy() for d in devs]
    share = (time.perf_counter() - t0) / max(len(queries), 1)
    results = []
    for q, m in zip(queries, mats):
        cells = int(len(q)) * db.total_chars
        padded = _padded_cells(db, len(q))
        if event_log is not None:
            event_log.emit(
                BatchEvent(
                    "loaded_sharded_many", t_wall=time.time(), elapsed_s=share,
                    reads=db.n_reads, cells=cells, padded_cells=padded,
                    note=f"qlen={len(q)} shards={db.n_shards}",
                )
            )
        results.append(ScoreResult(m, cells, padded, share))
    return results
