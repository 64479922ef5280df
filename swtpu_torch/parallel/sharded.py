"""Data-parallel scoring and the collective top-K merge over a mesh.

The port of ``swtpu.parallel.sharded``.  A batch's leading dim splits into
D contiguous blocks (swtpu's ``P(axis)``), block d runs on
``mesh.devices[d]``, and the results come back in block order on the
mesh's first device.  The query is replicated; per-shard results merge by
gathering each shard's top-K candidates on the first device and, when a
``torch.distributed`` group is up, across processes (``all_gather`` of
int64 keys), then cutting by (score desc, id asc), swtpu's order.

Each shard's work is the port's own kernels: ``backend="pallas"`` the
bucketed column kernels (``ops.column``: B4, chained B5 tiles past 256
query rows), ``backend="scan"`` the column scan (``ops.scan``), and the
stream scorer the streamed wavefront (B1, chained B3 tiles past 128 query
rows), each launched once a shard.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from swtpu_torch.config import DEFAULT_PENALTIES, Penalties
from swtpu_torch.parallel.mesh import Mesh
from swtpu_torch.parallel.topk import _local_topk

SENTINEL_SCORE = -(2**30)  # a sentinel row's score in the merge: below every real one
_LOW = (1 << 31) - 1  # a key's low 32 bits hold _LOW - id: ascending ids first


def _kernel_fn(backend: str, penalties: Penalties) -> Callable:
    """q [B, m], t [B, n] tensors on one device -> [B] int32 scores."""
    if backend == "pallas":
        from swtpu_torch.ops.column import sw_scores_column

        return lambda q, t: sw_scores_column(q, t, penalties)
    if backend == "scan":
        from swtpu_torch.ops.scan import sw_scores_scan

        return lambda q, t: sw_scores_scan(q, t, penalties)
    raise ValueError(f"unknown backend {backend!r} (pallas or scan)")


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis_name:
        raise ValueError(f"axis {axis!r} is not the mesh's axis {mesh.axis_name!r}")


def shard_blocks(x, mesh: Mesh, what: str = "batch") -> List[torch.Tensor]:
    """x [B, ...] (a tensor or an array) -> D contiguous blocks, block d on
    ``mesh.devices[d]``.  B must divide by D: pad the batch (the packer's
    ``batch_align=D``)."""
    x = torch.as_tensor(x)
    D = mesh.size
    B = x.shape[0]
    if B % D:
        raise ValueError(
            f"{what}: leading dim {B} is not a multiple of the mesh's {D} shards "
            f"(pack with batch_align={D})"
        )
    step = B // D
    return [x[d * step : (d + 1) * step].to(dev) for d, dev in enumerate(mesh.devices)]


def _gather(blocks: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Per-shard results concatenated in block order on the first device."""
    home = mesh.devices[0]
    return torch.cat([b.to(home) for b in blocks])


def make_sharded_scorer(
    mesh: Mesh,
    axis: str = "data",
    backend: str = "scan",
    penalties: Penalties = DEFAULT_PENALTIES,
) -> Callable:
    """scores [B] int32 = f(q [B, m], t [B, n]) with B split over the
    mesh's shards.  B must divide by the shard count (the packer's
    batch_align)."""
    _check_axis(mesh, axis)
    kernel = _kernel_fn(backend, penalties)

    def score(q, t):
        qs, ts = shard_blocks(q, mesh, "q"), shard_blocks(t, mesh, "t")
        return _gather([kernel(qb, tb) for qb, tb in zip(qs, ts)], mesh)

    return score


def make_sharded_topk(
    mesh: Mesh,
    k: int,
    axis: str = "data",
    backend: str = "scan",
    penalties: Penalties = DEFAULT_PENALTIES,
) -> Callable:
    """(top_scores [k], top_ids [k], scores [B]) = f(q [B, m], t [B, n],
    ids [B]): per-shard top-k, then the merge of the k x shards candidates
    (across processes too).  Sentinel rows carry id -1; they can only
    appear when k exceeds the live rows."""
    _check_axis(mesh, axis)
    kernel = _kernel_fn(backend, penalties)

    def score_topk(q, t, ids):
        qs, ts = shard_blocks(q, mesh, "q"), shard_blocks(t, mesh, "t")
        id_blocks = shard_blocks(ids, mesh, "ids")
        s = [kernel(qb, tb) for qb, tb in zip(qs, ts)]
        fin_s, fin_ids = _merge_topk(s, id_blocks, k, mesh)
        return fin_s, fin_ids, _gather(s, mesh)

    return score_topk


def make_sharded_stream_scorer(
    mesh: Mesh,
    axis: str = "data",
    penalties: Penalties = DEFAULT_PENALTIES,
    segments: int = 1,
    k: int = 0,
    rows: int = 1,
    state_dtype: str = "int32",
    emit_regular=None,
) -> Callable:
    """The streamed wavefront over the mesh: each shard runs one packed
    shard's streams (B1, or B3 tiles for a query register over 128 bases)
    and emits its reads' scores; with k > 0 the merged top-K too.

    Inputs are a ShardedStreamBatch's arrays (leading axis = shard, of the
    mesh's size):
      scores[D, R] = f(q[D, N, qcap], stream[D, N, T],
                       emit_stream[D, R], emit_step[D, R], ids[D, R])
    With k > 0 returns (scores[D, R], top_scores[k], top_ids[k]).  rows /
    state_dtype select the kernel variant; the batch must be packed with
    the same rows."""
    from swtpu_torch.ops.stream import LANES, sw_scores_stream, sw_scores_stream_long

    _check_axis(mesh, axis)

    def score(q, stream, es, ep, ids):
        args = [shard_blocks(x, mesh, name)
                for x, name in ((q, "q"), (stream, "stream"), (es, "emit_stream"),
                                (ep, "emit_step"), (ids, "ids"))]
        if args[0][0].shape[0] != 1:
            raise ValueError(
                f"q: {args[0][0].shape[0] * mesh.size} packed shards for a mesh of "
                f"{mesh.size}: pack with n_shards={mesh.size}"
            )
        out = []
        for qb, sb, eb, pb, _ in zip(*args):
            if qb.shape[-1] > LANES:
                s = sw_scores_stream_long(
                    qb[0], sb[0], eb[0], pb[0], penalties, rows=rows,
                    state_dtype=state_dtype, emit_regular=emit_regular,
                )
            else:
                s = sw_scores_stream(
                    qb[0], sb[0], eb[0], pb[0], penalties, segments=segments,
                    rows=rows, state_dtype=state_dtype, emit_regular=emit_regular,
                )
            out.append(s)
        scores = torch.stack([s.to(mesh.devices[0]) for s in out])
        if not k:
            return scores
        fin_s, fin_ids = _merge_topk(out, [b[0] for b in args[4]], k, mesh)
        return scores, fin_s, fin_ids

    return score


def _keys(s: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Unique int64 keys ordering (score desc, id asc) by key desc."""
    return s.to(torch.int64) * (1 << 32) + (_LOW - ids.to(torch.int64))


def _all_gather_keys(keys: torch.Tensor) -> torch.Tensor:
    """Every process's candidate keys, in rank order: ``all_gather`` of the
    counts, then of the keys padded to the largest count (gloo on the CPU,
    nccl on the process's device, a branch that no test or card run has
    reached: only gloo has run)."""
    import torch.distributed as dist

    home = keys.device
    if dist.get_backend() == "gloo":
        keys = keys.cpu()
    world = dist.get_world_size()
    n = torch.tensor([keys.numel()], dtype=torch.int64, device=keys.device)
    counts = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(counts, n)
    width = max(int(c) for c in counts)
    padded = torch.zeros(width, dtype=torch.int64, device=keys.device)
    padded[: keys.numel()] = keys
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    return torch.cat([p[: int(c)] for p, c in zip(parts, counts)]).to(home)


def _merge_topk(shard_scores: Sequence[torch.Tensor], shard_ids: Sequence[torch.Tensor],
                k: int, mesh: Mesh):
    """The collective top-K with swtpu's tie order: equal scores rank by
    ascending id, exactly like ScoreResult.top_k's stable argsort, so the
    one-device and sharded answers agree bit for bit on tied databases.
    Sentinel rows (id < 0) are masked below every real score and can only
    appear when k exceeds the live rows.

    Each shard is cut on its own device (``_local_topk``, kk = min(k, the
    shard's rows)); the candidates gather on the mesh's first device, and
    across processes when the mesh has a process group, as int64 keys
    (score in the high 32 bits, the complement of the id in the low): the
    keys are unique, so a sort orders ties by id and no tie is left to
    ``torch.topk``.  Returns (scores [<= k] int32, ids [<= k] int32)."""
    home = mesh.devices[0]
    keys = []
    for s, ids in zip(shard_scores, shard_ids):
        ids = ids.to(s.device)
        masked = torch.where(ids >= 0, s, SENTINEL_SCORE).to(torch.int32)
        kk = min(k, masked.shape[0])
        loc_s, loc_ids = _local_topk(masked, ids, kk)
        keys.append(_keys(loc_s, loc_ids).to(home))
    keys = torch.cat(keys)
    if mesh.world_size > 1:
        keys = _all_gather_keys(keys)
    keys = torch.sort(keys, descending=True).values[:k]
    top_s = (keys >> 32).to(torch.int32)
    top_ids = (_LOW - (keys & 0xFFFFFFFF)).to(torch.int32)
    return top_s, top_ids
