"""The port's mesh, sharded scorers, collective top-K, sharded stream
packing and score_database_multihost (one process) on a mesh of 8 CPU
shards, against swtpu's on its 8-device virtual CPU mesh (tests/conftest.py)
at tolerance 0: scores, top-K with its tie order, packed fields."""

import jax
import numpy as np
import pytest
import torch

from swtpu.bank.scorebank import ScoreResult
from swtpu.bank.streams import pack_streams_sharded as ref_pack_sharded
from swtpu.ops import sentinel_pad_batch
from swtpu.oracle import score_many_vs_one, sw_score_batch
from swtpu.parallel import make_mesh as ref_make_mesh
from swtpu.parallel import make_sharded_scorer as ref_make_scorer
from swtpu.parallel import make_sharded_stream_scorer as ref_make_stream_scorer
from swtpu.parallel import make_sharded_topk as ref_make_topk
from swtpu.parallel.multihost import score_database_multihost as ref_multihost
from swtpu_torch.bank.streams import (
    ShardedStreamBatch, pack_streams_sharded, scatter_sharded_scores,
)
from swtpu_torch.ops.common import T_PAD
from swtpu_torch.parallel import mesh as mesh_mod
from swtpu_torch.parallel.mesh import Mesh, make_mesh
from swtpu_torch.parallel.multihost import score_database_multihost, shard_rows
from swtpu_torch.parallel.sharded import (
    _merge_topk, make_sharded_scorer, make_sharded_stream_scorer, make_sharded_topk,
)

torch.set_num_threads(1)
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def meshes():
    """(the port's mesh of 8 CPU shards, swtpu's 8-device mesh)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs swtpu's 8 virtual CPU devices")
    return make_mesh(devices=CPU8), ref_make_mesh(8)


def _batch(rng, B, m, n):
    q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    ql = rng.integers(1, m + 1, size=B)
    tl = rng.integers(1, n + 1, size=B)
    return q, ql, t, tl


def _reads(rng, n, lo, hi):
    return [rng.integers(0, 4, size=int(rng.integers(lo, hi))).astype(np.int8)
            for _ in range(n)]


# ------------------------------------------------------------------ the mesh


def test_make_mesh_devices_shape_and_process():
    mesh = make_mesh(devices=["cpu"] * 8, axis_name="reads")
    assert isinstance(mesh, Mesh) and mesh.size == 8 and mesh.shape == {"reads": 8}
    assert mesh.devices == tuple(CPU8) and (mesh.rank, mesh.world_size) == (0, 1)
    assert make_mesh(3, devices=CPU8).shape == {"data": 3}


def test_make_mesh_without_cuda_names_devices(monkeypatch):
    """No CUDA device and no devices=: a RuntimeError naming devices=; a
    named CUDA device without one raises too.  There is no CPU default."""
    monkeypatch.setattr(mesh_mod.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(devices=["cuda:0"] * 4)


def test_batch_not_a_multiple_of_the_shards_raises(meshes):
    mesh, _ = meshes
    rng = np.random.default_rng(1)
    q, ql, t, tl = _batch(rng, 12, 8, 8)
    qp, tp = sentinel_pad_batch(q, ql, t, tl)
    with pytest.raises(ValueError, match="batch_align=8"):
        make_sharded_scorer(mesh)(qp, tp)
    with pytest.raises(ValueError, match="batch_align=8"):
        make_sharded_topk(mesh, k=3)(qp, tp, np.arange(12, dtype=np.int32))
    with pytest.raises(ValueError, match="batch_align=8"):
        shard_rows(qp, mesh)
    with pytest.raises(ValueError, match="axis"):
        make_sharded_scorer(mesh, axis="model")


# ------------------------------------------------- dense scorers and the top-K


@pytest.mark.parametrize("backend,B,m,n", [("scan", 64, 32, 48), ("pallas", 16, 8, 8),
                                           ("pallas", 16, 264, 16)])
def test_sharded_scorer_and_topk_equal_swtpu(meshes, backend, B, m, n):
    """The scan and the column path (B4; B5 tiles at a 264-base query) a
    shard: scores and the merged top-5, against swtpu's (its pallas
    backend in interpret mode)."""
    mesh, ref_mesh = meshes
    rng = np.random.default_rng(2)
    q, ql, t, tl = _batch(rng, B, m, n)
    qp, tp = sentinel_pad_batch(q, ql, t, tl)
    want = sw_score_batch(q, t, ql, tl)
    ids = np.arange(B, dtype=np.int32)
    got = make_sharded_scorer(mesh, backend=backend)(qp, tp)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    top_s, top_ids, scores = make_sharded_topk(mesh, k=5, backend=backend)(qp, tp, ids)
    interp = {"interpret": True} if backend == "pallas" else {}
    if m <= 256:
        ref = ref_make_topk(ref_mesh, k=5, backend=backend, **interp)(qp, tp, ids)
        np.testing.assert_array_equal(top_s.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(top_ids.numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(
            np.asarray(ref_make_scorer(ref_mesh, backend=backend, **interp)(qp, tp)), want)
    np.testing.assert_array_equal(scores.numpy(), want)
    assert list(zip(top_s.tolist(), top_ids.tolist())) == ScoreResult(want, 0, 0, 1).top_k(5)


def test_topk_ties_equal_swtpu_and_host(meshes):
    """Every read duplicates one of 4 targets: the merged top-10's tie
    order is swtpu's and ScoreResult.top_k's (score desc, id asc)."""
    mesh, ref_mesh = meshes
    rng = np.random.default_rng(42)
    B, m, n = 32, 12, 16
    q = np.tile(rng.integers(0, 4, size=(1, m)).astype(np.int8), (B, 1))
    t = rng.integers(0, 4, size=(4, n)).astype(np.int8)[rng.integers(0, 4, size=B)]
    ids = np.arange(B, dtype=np.int32)
    top_s, top_ids, scores = make_sharded_topk(mesh, k=10)(q, t, ids)
    ref_s, ref_ids, _ = ref_make_topk(ref_mesh, k=10)(q, t, ids)
    got = list(zip(top_s.tolist(), top_ids.tolist()))
    assert got == list(zip(np.asarray(ref_s).tolist(), np.asarray(ref_ids).tolist()))
    assert got == ScoreResult(scores.numpy(), 0, 0, 1).top_k(10)


def test_merge_topk_ties_sentinels_and_large_shards():
    """_merge_topk alone: shards of 1,280 tied scores (the two-level cut's
    size), ids that do not follow the position, sentinel ids masked below
    every score, and k past the live rows."""
    mesh = make_mesh(devices=["cpu"] * 3)
    rng = np.random.default_rng(77)
    s = [torch.from_numpy(rng.integers(0, 5, size=1280).astype(np.int32)) for _ in range(3)]
    ids = [torch.arange(d, 3 * 1280, 3, dtype=torch.int32) for d in range(3)]
    top_s, top_ids = _merge_topk(s, ids, 12, mesh)
    all_s, all_ids = torch.cat(s).numpy(), torch.cat(ids).numpy()
    order = np.lexsort((all_ids, -all_s))[:12]
    np.testing.assert_array_equal(top_s.numpy(), all_s[order])
    np.testing.assert_array_equal(top_ids.numpy(), all_ids[order])
    few = [torch.tensor([3, 9], dtype=torch.int32), torch.tensor([9, 0], dtype=torch.int32),
           torch.tensor([7, 7], dtype=torch.int32)]
    few_ids = [torch.tensor([4, -1], dtype=torch.int32), torch.tensor([2, 0], dtype=torch.int32),
               torch.tensor([-1, -1], dtype=torch.int32)]
    top_s, top_ids = _merge_topk(few, few_ids, 5, mesh)
    assert list(zip(top_s.tolist(), top_ids.tolist())) == [
        (9, 2), (3, 4), (0, 0), (-(2**30), -1), (-(2**30), -1)]


# --------------------------------------------------------- sharded streams


def _same_sharded_batch(got: ShardedStreamBatch, want):
    for f in ("q", "stream", "emit_stream", "emit_step", "ids"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.cells, got.segments, got.emit_regular) == (
        want.cells, want.segments, want.emit_regular)


def _dense(targets, width):
    lens = np.array([len(t) for t in targets], np.int32)
    mat = np.full((len(targets), width), T_PAD, np.int8)
    for i, t in enumerate(targets):
        mat[i, : len(t)] = t
    return mat, lens


@pytest.mark.parametrize("qlen,segments,rows,n", [(21, 1, 1, 37), (20, 1, 4, 25),
                                                  (30, 4, 1, 19), (200, 1, 1, 13),
                                                  (300, 1, 4, 64)])
def test_pack_streams_sharded_equals_swtpu(qlen, segments, rows, n):
    """Every field, in the list and the dense forms (the dense one on the
    native plan/fill), short and long (pack_streams_long) queries, shards
    padded in R and not (64 equal reads over 8 shards of 8 streams: the
    common pattern)."""
    rng = np.random.default_rng(qlen)
    targets = _reads(rng, n, 3, 50)
    if n == 64:
        targets = [rng.integers(0, 4, size=24).astype(np.int8) for _ in range(n)]
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    kw = dict(n_shards=8, n_streams=8 if segments == 1 else 4, segments=segments, rows=rows)
    want = ref_pack_sharded(query, targets, **kw)
    _same_sharded_batch(pack_streams_sharded(query, targets, **kw), want)
    dense = _dense(targets, 60)
    _same_sharded_batch(pack_streams_sharded(query, dense, **kw),
                        ref_pack_sharded(query, dense, **kw))
    assert (want.emit_regular is not None) == (n == 64)


def test_pack_streams_sharded_long_query_needs_segments_1():
    with pytest.raises(ValueError, match="long queries require segments=1"):
        pack_streams_sharded(np.zeros(40, np.int8), [np.zeros(5, np.int8)], 2,
                             segments=4)


@pytest.mark.parametrize("case", ["short", "long", "ties", "rows4"])
def test_sharded_stream_scorer_equals_swtpu(meshes, case):
    """The wavefront a shard (B1's plain version; B3's for a 200-base
    query), the scatter and the merged top-k against swtpu's interpret
    kernels under shard_map."""
    mesh, ref_mesh = meshes
    rng = np.random.default_rng(6)
    rows, k = (4, 2) if case == "rows4" else (1, 8)
    if case == "ties":
        base = _reads(rng, 3, 6, 20)
        targets = [base[int(rng.integers(0, 3))] for _ in range(26)]
    else:
        targets = _reads(rng, {"short": 37, "long": 16, "rows4": 25}[case], 3, 50)
    query = rng.integers(0, 4, size=200 if case == "long" else 21).astype(np.int8)
    batch = pack_streams_sharded(query, targets, n_shards=8, n_streams=8, rows=rows)
    args = (batch.q, batch.stream, batch.emit_stream, batch.emit_step.astype(np.int32),
            batch.ids)
    s, top_s, top_ids = make_sharded_stream_scorer(mesh, k=k, rows=rows,
                                                   emit_regular=batch.emit_regular)(*args)
    ref_s, ref_top_s, ref_top_ids = ref_make_stream_scorer(
        ref_mesh, interpret=True, k=k, rows=rows, emit_regular=batch.emit_regular)(*args)
    assert s.shape == (8, batch.ids.shape[1]) and s.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(top_s.numpy(), np.asarray(ref_top_s))
    np.testing.assert_array_equal(top_ids.numpy(), np.asarray(ref_top_ids))
    got = scatter_sharded_scores(s, batch, len(targets))
    np.testing.assert_array_equal(got, score_many_vs_one(query, targets))
    assert list(zip(top_s.tolist(), top_ids.tolist())) == ScoreResult(got, 0, 0, 1).top_k(k)
    only = make_sharded_stream_scorer(mesh, rows=rows)(*args)
    np.testing.assert_array_equal(only.numpy(), s.numpy())


def test_sharded_stream_scorer_wants_one_shard_a_device(meshes):
    mesh, _ = meshes
    rng = np.random.default_rng(8)
    batch = pack_streams_sharded(np.zeros(8, np.int8), _reads(rng, 16, 3, 9), n_shards=16,
                                 n_streams=8)
    with pytest.raises(ValueError, match="n_shards=8"):
        make_sharded_stream_scorer(mesh)(batch.q, batch.stream, batch.emit_stream,
                                         batch.emit_step, batch.ids)


# ------------------------------------------- score_database_multihost, 1 process


@pytest.mark.parametrize("backend,qlen,dense", [("stream", 16, False), ("auto", 200, False),
                                                ("stream", 16, True), ("scan", 16, True),
                                                ("scan", 40, False), ("pallas", 16, False)])
def test_multihost_one_process_equals_swtpu(meshes, backend, qlen, dense):
    """One process: the stream path (a 200-base query on chained tiles),
    the dense backends, the dense (mat, lens) form; the merged top-4 and
    the local scores against swtpu's."""
    mesh, ref_mesh = meshes
    rng = np.random.default_rng(qlen)
    targets = _reads(rng, 24, 4, 40)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    ids = np.arange(24, dtype=np.int32)
    db = _dense(targets, 40) if dense else targets
    got = score_database_multihost(query, db, ids, mesh=mesh, k=4, backend=backend)
    if backend == "pallas":  # swtpu's interpret kernels: the oracle instead
        want = score_many_vs_one(query, targets)
        order = np.lexsort((ids, -want))[:4]
        want = (want[order], ids[order], want)
    else:
        want = ref_multihost(query, db, ids, mesh=ref_mesh, k=4, backend=backend)
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(got[2], score_many_vs_one(query, targets))


def test_multihost_stream_steps_pinning_and_errors(meshes):
    """stream_steps pins T (scores unchanged); a pin under T and one that
    is no multiple of 32 raise swtpu's ValueErrors."""
    mesh, ref_mesh = meshes
    rng = np.random.default_rng(7)
    targets = _reads(rng, 16, 4, 40)
    query = rng.integers(0, 4, size=20).astype(np.int8)
    ids = np.arange(16, dtype=np.int32)
    _, _, local = score_database_multihost(query, targets, ids, mesh=mesh, k=3,
                                           stream_steps=512)
    np.testing.assert_array_equal(local, score_many_vs_one(query, targets))
    for steps in (32, 100):
        with pytest.raises(ValueError) as e:
            score_database_multihost(query, targets, ids, mesh=mesh, k=3, stream_steps=steps)
        with pytest.raises(ValueError) as ref_e:
            ref_multihost(query, targets, ids, mesh=ref_mesh, k=3, stream_steps=steps)
        assert str(e.value) == str(ref_e.value)
        assert ("multiple of" if steps == 100 else "stream_steps") in str(e.value)
