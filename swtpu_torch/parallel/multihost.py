"""Scoring one job across processes on ``torch.distributed``.

The port of ``swtpu.parallel.multihost``: each process owns a shard of the
database, the query is replicated, and the merged top-K reaches every
process.  What crosses between processes is the stream geometry (five
integers a process) and 2k candidates a process, so the default backend
is gloo, which also runs two processes on one card (NCCL refuses two ranks
on one device); ``backend="nccl"`` is for ranks that each own a GPU.  The
nccl branches (here and in ``sharded._all_gather_keys``) are untested: no
test or card run has had a GPU a rank, and only gloo has run.  The
localhost harness that runs N such processes is
``swtpu_torch.testing.regress``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from swtpu_torch.parallel.mesh import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
) -> None:
    """``torch.distributed.init_process_group`` on `backend`: with a
    coordinator ("host:port"), the process count and this process's id, a
    TCP rendezvous there; with none of them, ``env://`` (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK from the environment)."""
    import torch.distributed as dist

    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
        return
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )


def shard_rows(local_rows, mesh: Mesh, axis: str = "data"):
    """This process's rows split over its mesh devices: the D contiguous
    blocks, block d on ``mesh.devices[d]`` (the port's form of a global
    array made from process-local data)."""
    from swtpu_torch.parallel.sharded import _check_axis, shard_blocks

    _check_axis(mesh, axis)
    return shard_blocks(local_rows, mesh)


def _process_allgather(values: np.ndarray) -> np.ndarray:
    """[world, len(values)] int64: every process's `values`, in rank
    order (CPU tensors on gloo, the process's device on nccl, a branch
    that has never run: see the module docstring)."""
    import torch.distributed as dist

    dev = "cpu"
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    mine = torch.as_tensor(np.asarray(values, np.int64), device=dev)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return torch.stack(parts).cpu().numpy()


def score_database_multihost(
    query: np.ndarray,
    local_targets: Sequence[np.ndarray],
    local_ids: np.ndarray,
    mesh: Optional[Mesh] = None,
    k: int = 10,
    backend: str = "auto",
    penalties=None,
    n_streams: Optional[int] = None,
    stream_steps: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Score this process's shard within the global job.

    Returns (top_scores [k], top_ids [k], local_scores): the top-K merged
    over every process, the same on each; local_scores in the order of
    local_targets.

    backend 'auto' is the streamed wavefront ('stream'); 'scan' and
    'pallas' pad to dense [B, 8-multiple] batches (Q_PAD / T_PAD) and run
    the scan or the column kernels a mesh shard.  local_targets: a
    sequence of 1-D code arrays, or the dense EncodedDB / (mat, lens) form.

    All processes must call this together.  The stream backend agrees the
    packed geometry (stream length T, reads a shard R) across processes and
    pads to the maxima, so ragged shards need no pinning; `stream_steps`
    pins T (and must cover every process's).  The dense backends need
    equal per-process batch shapes (pad with sentinel rows, id -1)."""
    from swtpu_torch.config import DEFAULT_PENALTIES
    from swtpu_torch.ops.common import Q_PAD, T_PAD
    from swtpu_torch.parallel.mesh import make_mesh
    from swtpu_torch.parallel.sharded import make_sharded_topk

    pen = penalties or DEFAULT_PENALTIES
    if mesh is None:
        mesh = make_mesh()
    if backend == "auto":
        backend = "stream"
    if backend == "stream":
        return _score_database_multihost_stream(
            query, local_targets, local_ids, mesh, k, pen,
            n_streams=n_streams, stream_steps=stream_steps,
        )

    from swtpu_torch.bank.scorebank import _dense_form

    tmat, tlens = _dense_form(local_targets)
    if tlens is not None:
        B = len(tlens)
        n_max = int(np.max(tlens)) if B else 1
    else:
        B = len(local_targets)
        n_max = max((len(t) for t in local_targets), default=1)
    qw = max(8, -(-len(query) // 8) * 8)
    tw = max(8, -(-n_max // 8) * 8)
    q = np.full((B, qw), Q_PAD, np.int8)
    q[:, : len(query)] = np.asarray(query, np.int8)[None, :]
    t = np.full((B, tw), T_PAD, np.int8)
    if tlens is not None:
        w = min(tw, tmat.shape[1])
        t[:, :w] = tmat[:, :w]
        # sentinel pads past each read's true length (the dense matrix may
        # carry anything there)
        t[np.arange(tw)[None, :] >= np.asarray(tlens)[:, None]] = T_PAD
    else:
        for i, tt in enumerate(local_targets):
            t[i, : len(tt)] = tt
    topk = make_sharded_topk(mesh, k=k, axis=mesh.axis_name, backend=backend, penalties=pen)
    top_s, top_ids, scores = topk(q, t, np.asarray(local_ids, np.int32))
    return top_s.cpu().numpy(), top_ids.cpu().numpy(), scores.cpu().numpy()


def _score_database_multihost_stream(
    query: np.ndarray,
    local_targets: Sequence[np.ndarray],
    local_ids: np.ndarray,
    mesh: Mesh,
    k: int,
    pen,
    n_streams: Optional[int] = None,
    stream_steps: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The stream path across processes: this process packs its shard over
    its mesh devices (``pack_streams_sharded``), every process runs the
    wavefront on each of its shards, and the merged top-K reaches every
    process.

    The geometry is agreed, not pinned: every process packs its own shard,
    then [T, R, *emit_regular] all-gathers as int64 and each process pads to
    the maxima.  The strided gather (``emit_regular``) applies only when
    every process reports the same pattern and the same R; a process that
    pads R drops the tail before the read-order scatter.  The geometry
    comes from ``stream_geometry``: the device settings on CUDA, swtpu's
    interpret settings (rows 1, 8 streams) on the CPU, so both packages
    pack the same batch there."""
    from swtpu_torch.bank.scorebank import _dense_form, longest_read, stream_geometry
    from swtpu_torch.bank.streams import (
        LANES, STREAM_PAD, pack_streams_sharded, scatter_sharded_scores,
    )
    from swtpu_torch.config import SWConfig
    from swtpu_torch.ops.stream import STEP_CHUNK, reads_up_to
    from swtpu_torch.parallel.sharded import make_sharded_stream_scorer

    # a query over one tile packs segments 1; the rows and streams are the
    # geometry's at segments 1, as swtpu's
    _, rows, phys = stream_geometry(LANES, SWConfig(), mesh.devices[0])
    if n_streams is None:
        n_streams = phys
    if stream_steps is not None and stream_steps % STEP_CHUNK:
        raise ValueError(
            f"stream_steps={stream_steps} must be a multiple of "
            f"{STEP_CHUNK} (the kernel's step-chunk grid)"
        )
    L = mesh.size
    batch = pack_streams_sharded(query, local_targets, n_shards=L, n_streams=n_streams,
                                 rows=rows)
    stream = batch.stream
    T_local = stream.shape[2]
    R_local = batch.emit_stream.shape[1]
    reg_local = batch.emit_regular or (-1, -1, -1)
    if mesh.world_size > 1:
        dims = _process_allgather(np.array([T_local, R_local, *reg_local], np.int64))
        T_all, R_all = int(dims[:, 0].max()), int(dims[:, 1].max())
        # the strided gather only when every process reports the same
        # regular pattern and the same R (no padding anywhere): agreed in
        # the same all-gather as the geometry
        same_pattern = (dims[:, 2:] == dims[0, 2:]).all() and dims[0, 2] >= 0
        same_r = (dims[:, 1] == dims[0, 1]).all()
        emit_regular = (tuple(int(x) for x in dims[0, 2:])
                        if same_pattern and same_r else None)
    else:
        T_all, R_all = T_local, R_local
        emit_regular = batch.emit_regular
    if stream_steps is not None:
        if T_all > stream_steps:
            raise ValueError(
                f"packed stream needs {T_all} steps (max across hosts) > "
                f"pinned stream_steps={stream_steps}; every host's shard "
                "must fit the pinned envelope — raise the pin or drop it "
                "to auto-negotiate"
            )
        T_all = stream_steps
    if T_all != T_local:
        wide = np.full((L, n_streams, T_all), STREAM_PAD, np.int8)
        wide[:, :, :T_local] = stream
        stream = wide
    emit_stream, emit_step, bids = batch.emit_stream, batch.emit_step, batch.ids
    if R_all != R_local:
        emit_stream = np.zeros((L, R_all), emit_stream.dtype)
        emit_step = np.full((L, R_all), -1, batch.emit_step.dtype)
        bids = np.full((L, R_all), -1, np.int32)
        emit_stream[:, :R_local] = batch.emit_stream
        emit_step[:, :R_local] = batch.emit_step
        bids[:, :R_local] = batch.ids
    # emission ids become global read ids; padding slots stay -1
    gids = np.where(
        bids >= 0, np.asarray(local_ids, np.int32)[np.maximum(bids, 0)], np.int32(-1),
    ).astype(np.int32)
    scorer = make_sharded_stream_scorer(
        mesh, axis=mesh.axis_name, penalties=pen, k=k, rows=rows, state_dtype="int32",
        emit_regular=emit_regular,
    )
    _, tlens = _dense_form(local_targets)
    with reads_up_to(longest_read(tlens if tlens is not None else map(len, local_targets))):
        s, top_s, top_ids = scorer(batch.q, stream, emit_stream, emit_step.astype(np.int32),
                                   gids)
    # drop the cross-process R padding before the read-order scatter
    local_scores = scatter_sharded_scores(s[:, :R_local], batch, len(np.asarray(local_ids)))
    return top_s.cpu().numpy(), top_ids.cpu().numpy(), local_scores
