"""The CUDA kernels on the card: the wavefront's strips, the column
kernels' scores and chained-tile strips, the lane-major kernel's scores
and the microbenchmarks' outputs against their plain PyTorch versions, and
ScoreBank(device="cuda") on both backends against the oracle.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import functools

import numpy as np
import pytest
import torch

from swtpu_torch import DEFAULT_PENALTIES, Penalties, SWConfig, ScoreBank, score_many_vs_one
from swtpu_torch.bank import scorebank
from swtpu_torch.bank.scorebank import EncodedDB
from swtpu_torch.bank.streams import pack_streams, pack_streams_long
from swtpu_torch.ops import column, lane, microbench
from swtpu_torch.ops import stream as port
from swtpu_torch.oracle import sw_score_single_biased
from swtpu_torch.testing.gaps import long_gap_pairs
from swtpu_torch.utils.metrics import EventLog

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _db(rng, n, hi):
    """EncodedDB of reads of 0..hi-1 bases, reads 2 and 5 zero-length."""
    lens = rng.integers(1, hi, size=n).astype(np.int32)
    lens[[2, 5]] = 0
    mat = rng.integers(0, 4, size=(n, hi)).astype(np.int8)
    mat[np.arange(hi)[None, :] >= lens[:, None]] = 4
    return EncodedDB([f"db{i}" for i in range(n)], mat, lens)


# time slices a stream: one pass, a few, and the wrapper's choice (None)
SLICES = [1, 2, 7, None]


@pytest.mark.parametrize("slices", SLICES)
@pytest.mark.parametrize(
    "segments,rows", [(1, 1), (1, 2), (1, 16), (2, 8), (4, 4), (8, 1), (8, 16)]
)
def test_kernel_strip_equals_plain_version(cuda_device, segments, rows, slices):
    rng = np.random.default_rng(segments * 31 + rows)
    db = _db(rng, 400, 200)
    query = rng.integers(0, 4, size=128 // segments - 1).astype(np.int8)
    phys = 40  # not a multiple of a warp's streams: ragged last block
    b = pack_streams(query, db.mat, n_streams=phys * segments, segments=segments,
                     lens=db.lens, rows=rows)
    qk, sk = port._to_kernel_layout(
        torch.from_numpy(b.q), torch.from_numpy(b.stream), segments, rows
    )
    want = port.stream_strip_reference(qk, sk, DEFAULT_PENALTIES, segments, rows)
    launches = port.stream_strip_cuda.launches
    got = port.stream_strip_cuda(
        qk.to(cuda_device), sk.to(cuda_device), DEFAULT_PENALTIES, segments, rows,
        slices=slices,
    )
    torch.cuda.synchronize()
    assert port.stream_strip_cuda.launches == launches + 1
    assert port.stream_strip_cuda.slices == (slices or port.choose_slices(
        phys, rows, sk.shape[0], port._sm_count(cuda_device), segments))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# every legal (rows, segments) of the wavefront kernel's geometry
GEOMETRIES = [(r, g) for r in port.ROWS for g in (1, 2, 4, 8)]
# the state modes of the 32-bit kernel: (score_width, state_dtype)
STRIP_MODES = {"int32": (None, "int32"), "W=12": (12, "int32"), "float32": (None, "float32")}


@functools.lru_cache(maxsize=None)
def _geometry_case(rows, segments, long_reads):
    """(qk, sk, longest read) on the CPU: 40 physical streams of reads of
    0-199 bases, the first equal to the query (it passes the 12-bit
    ceiling at 128 bases); with `long_reads`, 40 reads of 513-2,048
    bases, chip_smoke.py's (r), on 8 streams a segment."""
    rng = np.random.default_rng(rows * 10 + segments + 1000 * long_reads)
    if long_reads:
        lens = rng.integers(513, 2049, size=40).astype(np.int32)
        mat = rng.integers(0, 4, size=(40, 2048)).astype(np.int8)
        mat[np.arange(2048)[None, :] >= lens[:, None]] = 4
        db, phys = EncodedDB([f"db{i}" for i in range(40)], mat, lens), 8
    else:
        db, phys = _db(rng, 400, 200), 40
    query = rng.integers(0, 4, size=128 // segments - 1).astype(np.int8)
    db.mat[0, : len(query)] = query
    db.mat[0, len(query):] = 4
    db.lens[0] = len(query)
    b = pack_streams(query, db.mat, n_streams=phys * segments, segments=segments,
                     lens=db.lens, rows=rows)
    qk, sk = port._to_kernel_layout(torch.from_numpy(b.q), torch.from_numpy(b.stream),
                                    segments, rows)
    return qk, sk, int(db.lens.max())


@functools.lru_cache(maxsize=None)
def _geometry_plain(rows, segments, long_reads, mode):
    qk, sk, _ = _geometry_case(rows, segments, long_reads)
    width, dtype = STRIP_MODES[mode]
    return port.stream_strip_reference(qk, sk, DEFAULT_PENALTIES, segments, rows,
                                       score_width=width, state_dtype=dtype)


@pytest.mark.parametrize("mode", list(STRIP_MODES))
@pytest.mark.parametrize("rows,segments", GEOMETRIES)
def test_every_geometry_strip_equals_plain_version(cuda_device, rows, segments, mode):
    """B1 (B2 at rows 1) at every legal rows x segments, 16 query rows a
    thread at rows 4-16 (4 sublanes at rows 1 and 2), in int32, W = 12 and
    float32: the strip in one slice and in the wrapper's slices for the
    batch's longest read equals the plain version's, and the count is
    choose_slices' for that read."""
    qk, sk, longest = _geometry_case(rows, segments, False)
    want = _geometry_plain(rows, segments, False, mode)
    width, dtype = STRIP_MODES[mode]
    geometry = port.wavefront_geometry(rows, segments, dtype)
    assert geometry.sublanes == min(16 // rows, port.MAX_SUBLANES)
    dq, ds = qk.to(cuda_device), sk.to(cuda_device)
    for slices in (1, None):
        got = port.stream_strip_cuda(dq, ds, DEFAULT_PENALTIES, segments, rows, slices=slices,
                                     score_width=width, state_dtype=dtype,
                                     longest_read=longest)
        torch.cuda.synchronize()
        assert port.stream_strip_cuda.slices == (slices or port.choose_slices(
            qk.shape[1], rows, sk.shape[0], port._sm_count(cuda_device), segments, dtype,
            longest_read=longest))
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=f"{slices}")


@pytest.mark.parametrize("mode", list(STRIP_MODES))
@pytest.mark.parametrize("rows,segments", [(16, 1), (8, 2), (4, 4), (1, 1), (2, 8)])
def test_long_read_strip_equals_plain_version(cuda_device, rows, segments, mode):
    """Reads of 513-2,048 bases, (r)'s: every slice shorter than a read at
    32-step slices, and the wrapper's slices for the longest read."""
    qk, sk, longest = _geometry_case(rows, segments, True)
    want = _geometry_plain(rows, segments, True, mode)
    width, dtype = STRIP_MODES[mode]
    dq, ds = qk.to(cuda_device), sk.to(cuda_device)
    for slices in (1, None, sk.shape[0] // port.STEP_CHUNK):
        got = port.stream_strip_cuda(dq, ds, DEFAULT_PENALTIES, segments, rows, slices=slices,
                                     score_width=width, state_dtype=dtype,
                                     longest_read=longest)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=f"{slices}")


def test_kernel_rejects_bad_tensors(cuda_device):
    qk = torch.zeros((128, 8), dtype=torch.int8, device=cuda_device)
    sk = torch.zeros((32, 8), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA int8 tensor"):
        port.stream_strip_cuda(qk.int(), sk, DEFAULT_PENALTIES, 1, 16)
    with pytest.raises(ValueError, match="contiguous"):
        port.stream_strip_cuda(qk, torch.zeros((8, 32), dtype=torch.int8,
                                               device=cuda_device).t(),
                               DEFAULT_PENALTIES, 1, 16)


@pytest.mark.parametrize("qlen", [20, 60, 128])
@pytest.mark.parametrize("wire", [True, False])
def test_score_database_equals_oracle(cuda_device, qlen, wire):
    rng = np.random.default_rng(qlen + wire)
    db = _db(rng, 3000, 200)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    launches = port.stream_strip_cuda.launches
    res = ScoreBank(SWConfig(wire_2bit=wire), device=cuda_device).score_database(query, db)
    assert port.stream_strip_cuda.launches == launches + 1
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, db.as_list()))


@pytest.mark.parametrize("slices", SLICES)
@pytest.mark.parametrize("segments", [1, 2, 4, 8])
def test_ripple_h_strip_equals_plain_version(cuda_device, segments, slices):
    rng = np.random.default_rng(segments + 100)
    db = _db(rng, 400, 200)
    query = rng.integers(0, 4, size=128 // segments - 1).astype(np.int8)
    b = pack_streams(query, db.mat, n_streams=40 * segments, segments=segments,
                     lens=db.lens, rows=1)
    qk, sk = port._to_kernel_layout(
        torch.from_numpy(b.q), torch.from_numpy(b.stream), segments, 1
    )
    want = port.stream_strip_reference(qk, sk, DEFAULT_PENALTIES, segments, 1, False)
    got = port.stream_strip_cuda(
        qk.to(cuda_device), sk.to(cuda_device), DEFAULT_PENALTIES, segments, 1, False,
        slices=slices,
    )
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    scores = port.sw_scores_stream(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
          for a in (b.q, b.stream, b.emit_stream, b.emit_step)),
        segments=segments, tail_acc=False,
    )
    np.testing.assert_array_equal(scores.cpu().numpy(),
                                  score_many_vs_one(query, db.as_list()))


@pytest.mark.parametrize("slices", SLICES)
@pytest.mark.parametrize("rows", [1, 2, 4, 8, 16])
def test_chained_kernel_equals_plain_version(cuda_device, rows, slices):
    """All four strips of one tile, on random boundary strips, at 40
    physical streams (a ragged last block)."""
    rng = np.random.default_rng(rows + 200)
    db = _db(rng, 400, 200)
    b = pack_streams(rng.integers(0, 4, size=1).astype(np.int8), db.mat,
                     n_streams=40, lens=db.lens, rows=rows)
    sk = torch.from_numpy(b.stream.T.copy())
    qk = torch.from_numpy(rng.integers(0, 4, size=(128, 40)).astype(np.int8))
    bounds = [torch.from_numpy(rng.integers(-20, 60, size=sk.shape).astype(np.int32))
              for _ in range(3)]
    want = port.stream_chained_reference(qk, sk, *bounds, DEFAULT_PENALTIES, rows)
    launches = port.stream_chained_cuda.launches
    got = port.stream_chained_cuda(
        qk.to(cuda_device), sk.to(cuda_device), *(x.to(cuda_device) for x in bounds),
        DEFAULT_PENALTIES, rows, slices=slices,
    )
    torch.cuda.synchronize()
    assert port.stream_chained_cuda.launches == launches + 1
    assert port.stream_chained_cuda.slices == (slices or port.choose_slices(
        40, rows, sk.shape[0], port._sm_count(cuda_device), lanes=min(128 // rows, 32)))
    for name, g, w in zip(("acc", "oD", "oG", "oH"), got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), err_msg=name)


def _edge_streams(rng, case, S=40):
    """[T, S] int8 kernel-layout streams: "long_reads", reads of 150-300
    bases, longer than a 32-step slice; "pad_tail", reads of 1-60 bases in
    which every stream goes pad-only somewhere in its second half, and
    stream 0 after its first read."""
    T = 1024
    sk = rng.integers(0, 4, size=(T, S)).astype(np.int8)
    lo, hi = (150, 301) if case == "long_reads" else (1, 61)
    for s in range(S):
        t = 0
        while t < T:
            sk[t, s] |= 8
            t += int(rng.integers(lo, hi))
    if case == "pad_tail":
        ends = rng.integers(T // 2, T, size=S)
        ends[0] = int(np.flatnonzero(sk[1:, 0] >= 8)[0]) + 1
        sk[np.arange(T)[:, None] >= ends[None, :]] = 4
    return torch.from_numpy(sk)


@pytest.mark.parametrize("case", ["long_reads", "pad_tail"])
@pytest.mark.parametrize("rows", [1, 16])
def test_kernels_slice_edge_cases_equal_plain_version(cuda_device, case, rows):
    """Both kernels at 32-step slices (every slice shorter than a read in
    "long_reads"; slices of pads only in "pad_tail") and at 5 slices."""
    rng = np.random.default_rng(rows + len(case))
    sk = _edge_streams(rng, case)
    qk = torch.from_numpy(rng.integers(0, 4, size=(128, sk.shape[1])).astype(np.int8))
    bounds = [torch.from_numpy(rng.integers(-20, 60, size=sk.shape).astype(np.int32))
              for _ in range(3)]
    want = port.stream_strip_reference(qk, sk, DEFAULT_PENALTIES, 1, rows)
    want_chain = port.stream_chained_reference(qk, sk, *bounds, DEFAULT_PENALTIES, rows)
    dev = [x.to(cuda_device) for x in (qk, sk, *bounds)]
    for slices in (sk.shape[0] // port.STEP_CHUNK, 5):
        got = port.stream_strip_cuda(*dev[:2], DEFAULT_PENALTIES, 1, rows, slices=slices)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=f"{slices}")
        got = port.stream_chained_cuda(*dev, DEFAULT_PENALTIES, rows, slices=slices)
        for name, g, w in zip(("acc", "oD", "oG", "oH"), got, want_chain):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                          err_msg=f"{name} {slices}")


@pytest.mark.parametrize("slices", [0, -3, 2.0, 33])
def test_bad_slice_counts_raise(cuda_device, slices):
    """0, a negative count, a non-integer or a slice under 32 steps
    (33 slices of 1,024 steps) raise before any launch."""
    qk = torch.zeros((128, 8), dtype=torch.int8, device=cuda_device)
    sk = torch.zeros((1024, 8), dtype=torch.int8, device=cuda_device)
    b = torch.zeros((1024, 8), dtype=torch.int32, device=cuda_device)
    launches = (port.stream_strip_cuda.launches, port.stream_chained_cuda.launches)
    error = TypeError if isinstance(slices, float) else ValueError
    with pytest.raises(error):
        port.stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, 1, 16, slices=slices)
    with pytest.raises(error):
        port.stream_chained_cuda(qk, sk, b, b, b, DEFAULT_PENALTIES, 16, slices=slices)
    assert (port.stream_strip_cuda.launches, port.stream_chained_cuda.launches) == launches


@pytest.mark.parametrize(
    "rows,mode",
    [(r, "tail_acc") for r in port.ROWS] + [(1, "ripple_h")]
    + [(r, "chained") for r in port.ROWS],
)
def test_kernel_holds_the_slices_occupancy(cuda_device, rows, mode):
    """Every instantiation holds the resident warps the kernel's launch
    bounds promise, without spilling."""
    regs, local, blocks = port.stream_kernel_info(
        rows, tail_acc=mode != "ripple_h", chained=mode == "chained")
    assert 0 < regs <= 65536 // (port.RESIDENT_WARPS_PER_SM * 32)
    assert local == 0
    assert blocks * port.KERNEL_BLOCK >= port.RESIDENT_WARPS_PER_SM * 32


def test_chained_kernel_rejects_bad_tensors(cuda_device):
    qk = torch.zeros((128, 8), dtype=torch.int8, device=cuda_device)
    sk = torch.zeros((32, 8), dtype=torch.int8, device=cuda_device)
    b = torch.zeros((32, 8), dtype=torch.int32, device=cuda_device)
    launches = port.stream_chained_cuda.launches
    with pytest.raises(ValueError, match="bD must be a CUDA int32 tensor"):
        port.stream_chained_cuda(qk, sk, b.to(torch.int64), b, b, DEFAULT_PENALTIES, 16)
    with pytest.raises(ValueError, match="bH shape"):
        port.stream_chained_cuda(qk, sk, b, b, b[:8], DEFAULT_PENALTIES, 16)
    with pytest.raises(ValueError, match="bG must be contiguous"):
        port.stream_chained_cuda(qk, sk, b, b.t().contiguous().t(), b,
                                 DEFAULT_PENALTIES, 16)
    with pytest.raises(ValueError, match="bD must be a CUDA int32 tensor"):
        port.stream_chained_cuda(qk, sk, b.cpu(), b, b, DEFAULT_PENALTIES, 16)
    assert port.stream_chained_cuda.launches == launches


def test_launch_failure_raises(cuda_device, monkeypatch):
    """A launch the card refuses raises with the CUDA error, and counts no
    launch."""
    from swtpu_torch.ops import _build

    lib = _build.load_library()

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def swtpu_stream_chained(*args):
            return 1  # cudaErrorInvalidValue

        @staticmethod
        def swtpu_stream_wavefront(*args):
            return 1

    monkeypatch.setattr(_build, "load_library", lambda: Refusing())
    qk = torch.zeros((128, 8), dtype=torch.int8, device=cuda_device)
    sk = torch.zeros((32, 8), dtype=torch.int8, device=cuda_device)
    b = torch.zeros((32, 8), dtype=torch.int32, device=cuda_device)
    launches = (port.stream_strip_cuda.launches, port.stream_chained_cuda.launches)
    with pytest.raises(RuntimeError, match="stream_chained launch failed: CUDA error 1"):
        port.stream_chained_cuda(qk, sk, b, b, b, DEFAULT_PENALTIES, 16)
    with pytest.raises(RuntimeError, match="stream_wavefront launch failed"):
        port.stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, 1, 16)
    assert (port.stream_strip_cuda.launches, port.stream_chained_cuda.launches) == launches


@pytest.mark.parametrize("qlen", [200, 600])
@pytest.mark.parametrize("wire", [True, False])
def test_long_query_score_database_equals_oracle(cuda_device, qlen, wire):
    rng = np.random.default_rng(qlen + wire)
    db = _db(rng, 2000, 200)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    launches = port.stream_chain_cuda.launches, port.stream_chained_cuda.launches
    res = ScoreBank(SWConfig(wire_2bit=wire), device=cuda_device).score_database(query, db)
    K = -(-qlen // 128)
    # one launch of the chain kernel runs the K tiles
    assert (port.stream_chain_cuda.launches - launches[0],
            port.stream_chained_cuda.launches - launches[1]) == (1, 0)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, db.as_list()))
    b = pack_streams_long(query, db.mat, n_streams=512, rows=16, lens=db.lens)
    assert (res.cells, res.padded_cells) == (b.cells, b.stream.size * 128 * K)


CHAIN_MODES = {"int32": (None, "int32"), "biased W=12": (12, "int32"),
               "float32": (None, "float32")}


def _chain_case(rows, K, S, reads, lo, hi):
    """(q [S, K*128], sk [T, S]) on the card's host side: `reads` reads of
    lo-hi bases packed as ScoreBank packs them (fewer reads than streams
    leave whole warps of pads), every 5th a window of the query across a
    tile boundary, the query 5 bases short of K tiles."""
    rng = np.random.default_rng(rows * 100 + K + S)
    query = rng.integers(0, 4, size=128 * K - 5).astype(np.int8)
    reads_ = [rng.integers(0, 4, size=int(n)).astype(np.int8)
              for n in rng.integers(lo, hi + 1, size=reads)]
    for i in range(0, reads, 5):
        if K > 1:
            at = 128 * int(rng.integers(1, K))
            reads_[i] = query[at - int(rng.integers(5, 60)) : at + int(rng.integers(5, 60))]
    b = pack_streams_long(query, reads_, n_streams=S, rows=rows)
    return torch.from_numpy(b.q), torch.from_numpy(b.stream.T.copy())


# (rows, K): every row count at a few tiles (rows 1: an 18-chunk lag),
# and rows 16 up to the 32 tiles of a 4,095-base query
CHAIN_CASES = [(r, k) for r in (1, 4, 8) for k in (1, 2, 5)] + [
    (16, k) for k in (1, 2, 3, 4, 5, 8, 9, 17, 32)]


@pytest.mark.parametrize("mode", list(CHAIN_MODES))
@pytest.mark.parametrize("rows,K", CHAIN_CASES)
def test_chain_kernel_equals_per_tile_chain(cuda_device, rows, K, mode):
    """The chain kernel's strip = the per-tile kernel's chain (K launches,
    the host's shifts) on the whole strip, bit for bit: on 42 streams full
    of reads (a ragged last warp) and on 512 streams of which 64 hold reads
    (whole warps of pads, skipped); at the geometry's slices and at
    32-step slices; from K = 5 on, every 4th tile is fed through the wrap
    strips; one launch a call."""
    width, dtype = CHAIN_MODES[mode]
    kw = dict(score_width=width, state_dtype=dtype)
    for S, reads, lo, hi in ((42, 300, 10, 120), (512, 64, 100, 300)):
        q, sk = _chain_case(rows, K, S, reads, lo, hi)
        q, sk = q.to(cuda_device), sk.to(cuda_device)
        launches = port.stream_chained_cuda.launches
        want = port._long_strip(q, sk, DEFAULT_PENALTIES, rows,
                                tile=port.stream_chained_cuda, **kw)
        assert port.stream_chained_cuda.launches == launches + K
        qks = port.tile_registers(q, rows)
        T = sk.shape[0]
        for run in (dict(), dict(slices=T // port.STEP_CHUNK)):
            launches = port.stream_chain_cuda.launches
            got = port.stream_chain_cuda(qks, sk, DEFAULT_PENALTIES, rows, **run, **kw)
            torch.cuda.synchronize()
            assert port.stream_chain_cuda.launches == launches + 1
            np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy(),
                                          err_msg=f"S={S} {run}")
        launches = port.stream_chain_cuda.launches, port.stream_chained_cuda.launches
        got = port._long_strip(q, sk, DEFAULT_PENALTIES, rows, **kw)
        assert (port.stream_chain_cuda.launches - launches[0],
                port.stream_chained_cuda.launches - launches[1]) == (1, 0)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("mode", list(CHAIN_MODES))
def test_chain_kernel_equals_plain_chain(cuda_device, mode):
    """The chain kernel against the plain chain (_long_strip with the plain
    tile on the CPU), K = 3 at rows 16 and K = 2 at rows 1."""
    width, dtype = CHAIN_MODES[mode]
    kw = dict(score_width=width, state_dtype=dtype)
    for rows, K in ((16, 3), (1, 2)):
        q, sk = _chain_case(rows, K, 42, 120, 10, 80)
        want = port._long_strip(q, sk, DEFAULT_PENALTIES, rows, **kw)
        got = port._long_strip(q.to(cuda_device), sk.to(cuda_device), DEFAULT_PENALTIES,
                               rows, **kw)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=f"rows {rows}")


@pytest.mark.parametrize("rows,dtype,width", [
    (r, d, w) for r in (1, 8, 16)
    for d, w in (("int32", None), ("int32", 12), ("float32", None), ("int16", None),
                 ("bfloat16", None)) if r <= 8 or d not in port.SIXTEEN_BIT_STATES])
def test_chain_kernel_with_positive_penalties_equals_plain_chain(cuda_device, rows, dtype,
                                                                 width):
    """A positive mismatch and gap open raise the pad-only streams off the
    zero, so the chain kernel runs the groups with no read start in slice
    0 (pads_stay_at_zero is false): = the plain chain on 107 streams of
    which the last warps hold pads only, in the geometry's slices and in
    32-step slices."""
    pen = Penalties(match=3, mismatch=1, gap_open=2, gap_extend=-1)
    kw = dict(score_width=width, state_dtype=dtype)
    assert not port.pads_stay_at_zero(pen, dtype)
    q, sk = _chain_case(rows, 2, 107, 24, 100, 300)
    want = port._long_strip(q, sk, pen, rows, **kw)
    assert bool((sk[:, -32:] == 4).all()) and bool((want[:, -32:] != port._bias(width)).any())
    qks = port.tile_registers(q.to(cuda_device), rows)
    for slices in (None, sk.shape[0] // port.STEP_CHUNK):
        got = port.stream_chain_cuda(qks, sk.to(cuda_device), pen, rows, slices=slices, **kw)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=f"{slices}")
    # the instantiation without the pad shortcut: no spill, the launch
    # bounds' resident warps, the same ring
    regs, local, blocks, shared = port.stream_chain_info(rows, width, dtype, quiet=False)
    assert 0 < regs <= 65536 // (port.RESIDENT_WARPS_PER_SM * 32) and local == 0
    assert blocks * port.KERNEL_BLOCK >= port.RESIDENT_WARPS_PER_SM * 32
    assert shared == port.stream_chain_info(rows, width, dtype)[3]


@pytest.mark.parametrize("rows", port.ROWS)
def test_chain_kernel_holds_its_occupancy(cuda_device, rows):
    """Every 32-bit instantiation of the chain kernel holds the resident
    warps its launch bounds promise, without spilling, and its ring in
    shared memory."""
    for width, dtype in CHAIN_MODES.values():
        regs, local, blocks, shared = port.stream_chain_info(rows, width, dtype)
        assert 0 < regs <= 65536 // (port.RESIDENT_WARPS_PER_SM * 32)
        assert local == 0
        assert blocks * port.KERNEL_BLOCK >= port.RESIDENT_WARPS_PER_SM * 32
        assert (port.RING_WARPS - 1) * port.RING_STEPS * 3 * 4 <= shared <= 8192


def test_chain_kernel_rejects_bad_inputs(cuda_device):
    """Bad shapes and a 16-bit state at rows 16 (no such instantiation)
    raise before any launch."""
    qks = torch.zeros((3, 128, 8), dtype=torch.int8, device=cuda_device)
    sk = torch.zeros((64, 8), dtype=torch.int8, device=cuda_device)
    launches = port.stream_chain_cuda.launches
    with pytest.raises(ValueError, match="qks must be"):
        port.stream_chain_cuda(qks[:, :64], sk, DEFAULT_PENALTIES, 16)
    with pytest.raises(ValueError, match="rows=16 requires a 32-bit state dtype"):
        port.stream_chain_cuda(qks, sk, DEFAULT_PENALTIES, 16, state_dtype="int16")
    with pytest.raises(ValueError, match="stream length"):
        port.stream_chain_cuda(qks, sk[:40], DEFAULT_PENALTIES, 16)
    assert port.stream_chain_cuda.launches == launches


def _column_batch(rng, B, m, n):
    """Sentinel-padded [B, m] queries and [B, n] targets of ragged lengths,
    pair 0 identical over min(m, n) bases (its score wraps at W = 10 once
    it passes 102 matches)."""
    q_lens = rng.integers(0, m + 1, size=B)
    t_lens = rng.integers(0, n + 1, size=B)
    q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    k = min(m, n)
    t[0, :k] = q[0, :k]
    q_lens[0] = t_lens[0] = k
    q[np.arange(m)[None, :] >= q_lens[:, None]] = column.Q_PAD
    t[np.arange(n)[None, :] >= t_lens[:, None]] = column.T_PAD
    return torch.from_numpy(q), torch.from_numpy(t)


# the column kernels' state modes: (score width, state type)
COLUMN_MODES = [(None, "int32"), (12, "int32"), (10, "int32"), (None, "float32"),
                (None, "int16")]


@pytest.mark.parametrize("width,state_dtype", COLUMN_MODES)
@pytest.mark.parametrize("m", [8, 32, 64, 128, 136, 256])
def test_column_kernel_equals_plain_version(cuda_device, m, width, state_dtype):
    """B4 at each geometry (lanes a pair; int16's rows a lane), 1001 pairs
    (a ragged last block and warp), in each state mode; float32 and int16
    also equal int32."""
    rng = np.random.default_rng(m + (width or 0))
    q, t = _column_batch(rng, 1001, m, 160)
    want = column.column_scores_reference(q, t, DEFAULT_PENALTIES, width, state_dtype)
    launches = column.column_scores_cuda.launches
    got = column.column_scores_cuda(q.to(cuda_device), t.to(cuda_device),
                                    DEFAULT_PENALTIES, width, state_dtype)
    torch.cuda.synchronize()
    assert column.column_scores_cuda.launches == launches + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    if state_dtype != "int32":
        exact = column.column_scores_cuda(q.to(cuda_device), t.to(cuda_device))
        np.testing.assert_array_equal(got.cpu().numpy(), exact.cpu().numpy())


@pytest.mark.parametrize("width,state_dtype", COLUMN_MODES)
@pytest.mark.parametrize("m", [32, 128, 256])
def test_column_kernel_long_gaps_equal_plain_version(cuda_device, m, width, state_dtype):
    """B4 on targets that are their queries with 8-200 bases cut out (and
    self-pairs): the in-del chain crosses many lanes, so the lazy carry runs
    many rounds a column; 999 pairs."""
    q, t = (torch.from_numpy(x) for x in long_gap_pairs(np.random.default_rng(m), 999, m))
    want = column.column_scores_reference(q, t, DEFAULT_PENALTIES, width, state_dtype)
    got = column.column_scores_cuda(q.to(cuda_device), t.to(cuda_device),
                                    DEFAULT_PENALTIES, width, state_dtype)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    if width != 10:  # a self-pair of 256 bases wraps at W = 10
        assert (got[::8] == 5 * m).all()


@pytest.mark.parametrize("width,state_dtype", [(None, "int32"), (10, "int32"),
                                               (None, "float32"), (None, "int16")])
@pytest.mark.parametrize("K", [2, 3])
def test_column_chain_equals_plain_version(cuda_device, K, width, state_dtype):
    """Whole K-tile chains through B5 and its plain version: every tile's
    h, ms and is, and the scores; on 301 ragged pairs, then on 299
    long-gap pairs of K x 256 bases whose cuts of 8-300 bases span a
    boundary between tiles (the I seed crosses it, the lazy carry runs
    many lanes), every 8th a self-pair scoring 5 a base."""
    rng = np.random.default_rng(K * 7 + (width or 0))
    m = K * column.QUERY_TILE
    ragged = _column_batch(rng, 301, m, 160)
    gaps = [torch.from_numpy(x) for x in long_gap_pairs(
        np.random.default_rng([K, 8]), 299, m, cut=(8, 300), across=column.QUERY_TILE)]

    def run(q, t, tile):
        outs = []

        def record(*args):
            outs.append(tile(*args))
            return outs[-1]

        return column._chained_call(q, t, DEFAULT_PENALTIES, width, tile=record,
                                    state_dtype=state_dtype), outs

    for label, (q, t) in (("ragged", ragged), ("long gaps", gaps)):
        launches = column.column_chained_cuda.launches
        got, got_tiles = run(q.to(cuda_device), t.to(cuda_device),
                             column.column_chained_cuda)
        want, want_tiles = run(q, t, column.column_chained_reference)
        torch.cuda.synchronize()
        assert column.column_chained_cuda.launches == launches + K
        for k, (g, w) in enumerate(zip(got_tiles, want_tiles)):
            for name, a, b in zip(("h", "ms", "is_"), g, w):
                np.testing.assert_array_equal(a.cpu().numpy(), b.numpy(),
                                              err_msg=f"{label} tile {k} {name}")
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=label)
        if label == "long gaps" and width is None:  # W = 10 wraps a self-pair
            assert (got[::8] == 5 * m).all()


def test_column_kernels_reject_bad_tensors(cuda_device):
    q = torch.zeros((4, 256), dtype=torch.int8, device=cuda_device)
    t = torch.zeros((4, 64), dtype=torch.int8, device=cuda_device)
    s = torch.zeros((4, 64), dtype=torch.int32, device=cuda_device)
    h = torch.zeros((4,), dtype=torch.int32, device=cuda_device)
    launches = (column.column_scores_cuda.launches, column.column_chained_cuda.launches)
    with pytest.raises(ValueError, match="multiple of 32"):
        column.column_scores_cuda(q, t[:, :40].contiguous())
    with pytest.raises(ValueError, match="at most 256"):
        column.column_scores_cuda(torch.zeros((4, 264), dtype=torch.int8,
                                              device=cuda_device), t)
    with pytest.raises(ValueError, match="256 query rows"):
        column.column_chained_cuda(q[:, :128].contiguous(), t, s, s, h)
    with pytest.raises(ValueError, match="ms must be a CUDA int32 tensor"):
        column.column_chained_cuda(q, t, s.long(), s, h)
    with pytest.raises(ValueError, match="h shape"):
        column.column_chained_cuda(q, t, s, s, h[:2])
    with pytest.raises(ValueError, match="score_width=5 too narrow"):
        column.column_scores_cuda(q, t, DEFAULT_PENALTIES, 5)
    with pytest.raises(OverflowError, match="-38400 out of bounds for int16"):
        column.column_chained_cuda(q, t, s, s, h, Penalties(5, -4, -12, -300),
                                   state_dtype="int16")
    assert (column.column_scores_cuda.launches,
            column.column_chained_cuda.launches) == launches


@pytest.mark.parametrize("qlen", [100, 300])
def test_bucketed_score_database_equals_oracle(cuda_device, qlen):
    """ScoreBank(backend="pallas") on three buckets: B4 per bucket, or a B5
    chain of 2 tiles per bucket for the 300-base query."""
    rng = np.random.default_rng(qlen + 300)
    db = _db(rng, 3000, 400)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    wrapper = column.column_chained_cuda if qlen > 256 else column.column_scores_cuda
    launches = wrapper.launches
    res = ScoreBank(backend="pallas", device=cuda_device).score_database(query, db)
    assert wrapper.launches == launches + 3 * (2 if qlen > 256 else 1)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, db.as_list()))


def test_bucketed_score_pairs_wrap_parity(cuda_device):
    """score_pairs at the RTL's 12-bit width: identical 450-base pairs
    wrap; every pair equals the biased oracle."""
    rng = np.random.default_rng(12)
    lens = rng.integers(24, 513, size=(2, 120))
    queries = [rng.integers(0, 4, size=k).astype(np.int8) for k in lens[0]]
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in lens[1]]
    for i in (0, 1, 2):
        queries[i] = rng.integers(0, 4, size=450).astype(np.int8)
        targets[i] = queries[i].copy()
    bank = ScoreBank(SWConfig(score_width=12), device=cuda_device)
    assert bank.backend == "pallas"
    res = bank.score_pairs(queries, targets)
    want = [sw_score_single_biased(a, b, DEFAULT_PENALTIES, 12)
            for a, b in zip(queries, targets)]
    np.testing.assert_array_equal(res.scores, want)
    assert res.scores[0] < 5 * 450  # wrapped, not the exact score


def test_column_launch_failure_raises(cuda_device, monkeypatch):
    """A column launch the card refuses raises with the CUDA error, and
    counts no launch."""
    from swtpu_torch.ops import _build

    lib = _build.load_library()

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def swtpu_column_scores(*args):
            return 1  # cudaErrorInvalidValue

        @staticmethod
        def swtpu_column_chained(*args):
            return 1

    monkeypatch.setattr(_build, "load_library", lambda: Refusing())
    q = torch.zeros((4, 256), dtype=torch.int8, device=cuda_device)
    t = torch.zeros((4, 64), dtype=torch.int8, device=cuda_device)
    s = torch.zeros((4, 64), dtype=torch.int32, device=cuda_device)
    h = torch.zeros((4,), dtype=torch.int32, device=cuda_device)
    launches = (column.column_scores_cuda.launches, column.column_chained_cuda.launches)
    with pytest.raises(RuntimeError, match="column_scores launch failed: CUDA error 1"):
        column.column_scores_cuda(q, t)
    with pytest.raises(RuntimeError, match="column_chained launch failed"):
        column.column_chained_cuda(q, t, s, s, h)
    assert (column.column_scores_cuda.launches,
            column.column_chained_cuda.launches) == launches


@pytest.mark.parametrize("B,n", [(1, 128), (1001, 256), (128, 128), (129, 384),
                                 (31, 640), (4096, 128)])
def test_lane_kernel_equals_plain_version(cuda_device, B, n):
    """B6 on ragged pairs, whole blocks and ragged last blocks."""
    rng = np.random.default_rng(B + n)
    q, t = _column_batch(rng, B, 128, n)
    q = q.to(torch.int32)
    want = lane.lane_scores_reference(q, t)
    launches = lane.lane_scores_cuda.launches
    got = lane.lane_scores_cuda(q.to(cuda_device), t.to(cuda_device))
    torch.cuda.synchronize()
    assert lane.lane_scores_cuda.launches == launches + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("m,n", [(1, 1), (40, 150), (128, 300)])
def test_sw_scores_lane_equals_column_and_oracle(cuda_device, m, n):
    rng = np.random.default_rng(m + n)
    q, t = _column_batch(rng, 1001, m, n)
    got = lane.sw_scores_lane(q.to(cuda_device), t.to(cuda_device))
    col = column.sw_scores_column(q.to(cuda_device), t.to(cuda_device))
    np.testing.assert_array_equal(got.cpu().numpy(), col.cpu().numpy())
    qn, tn = q.numpy(), t.numpy()
    want = [score_many_vs_one(qn[i][qn[i] != column.Q_PAD],
                              [tn[i][tn[i] != column.T_PAD]])[0] for i in range(0, 1001, 50)]
    np.testing.assert_array_equal(got.cpu().numpy()[::50], want)


def test_lane_kernel_rejects_bad_tensors(cuda_device):
    q = torch.full((4, 128), 5, dtype=torch.int32, device=cuda_device)
    t = torch.full((4, 128), 4, dtype=torch.int8, device=cuda_device)
    launches = lane.lane_scores_cuda.launches
    with pytest.raises(ValueError, match="q must be a CUDA int32 tensor"):
        lane.lane_scores_cuda(q.to(torch.int8), t)
    with pytest.raises(ValueError, match="128 rows"):
        lane.lane_scores_cuda(q[:, :64].contiguous(), t)
    with pytest.raises(ValueError, match="multiple of 128"):
        lane.lane_scores_cuda(q, t[:, :64].contiguous())
    assert lane.lane_scores_cuda.launches == launches


@pytest.mark.parametrize("pattern", microbench.PATTERNS)
@pytest.mark.parametrize("dtype", list(microbench.DTYPES))
def test_microbench_ops_kernel_equals_plain_version(cuda_device, dtype, pattern):
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 5, microbench.SHAPE)
                         .astype(np.float32)).to(microbench.DTYPES[dtype])
    want = microbench.microbench_ops_reference(x, pattern, 5)
    launches = microbench.microbench_ops_cuda.launches
    got = microbench.microbench_ops_cuda(x.to(cuda_device), pattern, 5)
    torch.cuda.synchronize()
    assert microbench.microbench_ops_cuda.launches == launches + 1
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.cpu().float().numpy(), want.float().numpy())


@pytest.mark.parametrize("variant", microbench.VARIANTS)
@pytest.mark.parametrize("dtype", list(microbench.DTYPES))
def test_stream_ablate_kernel_equals_plain_version(cuda_device, dtype, variant):
    """E2 at 40 streams (a ragged last block), with read starts."""
    rng = np.random.default_rng(len(variant) + len(dtype))
    qT = torch.from_numpy(rng.integers(0, 4, (128, 40)).astype(np.int8))
    sk = rng.integers(0, 4, (128, 40)).astype(np.int8)
    sk[rng.random(sk.shape) < 0.02] |= 8
    sk = torch.from_numpy(sk)
    want = microbench.stream_ablate_reference(qT, sk, variant, microbench.DTYPES[dtype])
    launches = microbench.stream_ablate_cuda.launches
    got = microbench.stream_ablate_cuda(qT.to(cuda_device), sk.to(cuda_device), variant,
                                        microbench.DTYPES[dtype])
    torch.cuda.synchronize()
    assert microbench.stream_ablate_cuda.launches == launches + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_stream_ablate_full_equals_the_wavefront_kernel(cuda_device):
    rng = np.random.default_rng(3)
    qT = torch.from_numpy(rng.integers(0, 4, (128, 64)).astype(np.int8)).to(cuda_device)
    sk = rng.integers(0, 4, (512, 64)).astype(np.int8)
    sk[rng.random(sk.shape) < 0.01] |= 8
    sk = torch.from_numpy(sk).to(cuda_device)
    got = microbench.stream_ablate_cuda(qT, sk, "full")
    want = port.stream_strip_cuda(qT, sk, DEFAULT_PENALTIES, 1, 1)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_new_launch_failures_raise(cuda_device, monkeypatch):
    """A launch of B6, E1 or E2 that the card refuses raises with the CUDA
    error, and counts no launch."""
    from swtpu_torch.ops import _build

    lib = _build.load_library()

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def swtpu_lane_scores(*args):
            return 1  # cudaErrorInvalidValue

        @staticmethod
        def swtpu_microbench_ops(*args):
            return 1

        @staticmethod
        def swtpu_stream_ablate(*args):
            return 1

    monkeypatch.setattr(_build, "load_library", lambda: Refusing())
    wrappers = (lane.lane_scores_cuda, microbench.microbench_ops_cuda,
                microbench.stream_ablate_cuda)
    launches = [w.launches for w in wrappers]
    q = torch.full((4, 128), 5, dtype=torch.int32, device=cuda_device)
    t = torch.full((4, 128), 4, dtype=torch.int8, device=cuda_device)
    with pytest.raises(RuntimeError, match="lane_scores launch failed: CUDA error 1"):
        lane.lane_scores_cuda(q, t)
    with pytest.raises(RuntimeError, match="microbench_ops launch failed"):
        microbench.microbench_ops_cuda(
            torch.zeros(microbench.SHAPE, dtype=torch.int32, device=cuda_device),
            "addmax", 1)
    with pytest.raises(RuntimeError, match="stream_ablate launch failed"):
        microbench.stream_ablate_cuda(t.t().contiguous(), t.t()[:32].contiguous(), "full")
    assert [w.launches for w in wrappers] == launches


# the state modes beside exact int32: (score_width, state_dtype)
MODES = {"biased W=8": (8, "int32"), "biased W=12": (12, "int32"), "float32": (None, "float32")}


@functools.lru_cache(maxsize=None)
def _mode_case(segments, rows, tail_acc, mode):
    """(qk, sk, plain strip) of a mode's case, computed once for all the
    slice counts."""
    width, dtype = MODES[mode]
    qk, sk = _mode_batch(segments, rows)
    want = port.stream_strip_reference(qk, sk, DEFAULT_PENALTIES, segments, rows, tail_acc,
                                       score_width=width, state_dtype=dtype)
    return qk, sk, want


def _mode_batch(segments, rows):
    """A packed batch in the kernel layout on the CPU: 40 physical streams
    of ragged reads, the first read equal to the query so that at W = 8 it
    wraps (its exact score is 5 x the query's length, past 127)."""
    rng = np.random.default_rng(segments * 7 + rows + 300)
    db = _db(rng, 400, 200)
    query = rng.integers(0, 4, size=128 // segments - 1).astype(np.int8)
    db.mat[0, : len(query)] = query
    db.mat[0, len(query):] = 4
    db.lens[0] = len(query)
    b = pack_streams(query, db.mat, n_streams=40 * segments, segments=segments,
                     lens=db.lens, rows=rows)
    return port._to_kernel_layout(torch.from_numpy(b.q), torch.from_numpy(b.stream),
                                  segments, rows)


@pytest.mark.parametrize("slices", SLICES)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("segments,rows,tail_acc", [
    (1, 1, True), (1, 16, True), (2, 8, True), (4, 4, True), (1, 1, False), (4, 1, False),
])
def test_mode_strip_equals_plain_version(cuda_device, segments, rows, tail_acc, mode, slices):
    """The biased and float32 kernels, both forms, against their plain
    versions; the float32 strip also equals the exact int32 one."""
    width, dtype = MODES[mode]
    qk, sk, want = _mode_case(segments, rows, tail_acc, mode)
    kw = dict(score_width=width, state_dtype=dtype)
    launches = port.stream_strip_cuda.launches
    got = port.stream_strip_cuda(qk.to(cuda_device), sk.to(cuda_device), DEFAULT_PENALTIES,
                                 segments, rows, tail_acc, slices=slices, **kw)
    torch.cuda.synchronize()
    assert port.stream_strip_cuda.launches == launches + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    if dtype == "float32":
        exact = port.stream_strip_cuda(qk.to(cuda_device), sk.to(cuda_device),
                                       DEFAULT_PENALTIES, segments, rows, tail_acc)
        np.testing.assert_array_equal(got.cpu().numpy(), exact.cpu().numpy())


@functools.lru_cache(maxsize=None)
def _mode_chained_case(rows, mode):
    """(qk, sk, bounds, plain outputs) of one chained tile in a mode, on
    random boundary strips (around 2^(W-1) in the biased mode)."""
    width, dtype = MODES[mode]
    rng = np.random.default_rng(rows + 400)
    db = _db(rng, 400, 200)
    b = pack_streams(rng.integers(0, 4, size=1).astype(np.int8), db.mat,
                     n_streams=40, lens=db.lens, rows=rows)
    sk = torch.from_numpy(b.stream.T.copy())
    qk = torch.from_numpy(rng.integers(0, 4, size=(128, 40)).astype(np.int8))
    bias = 0 if width is None else 1 << (width - 1)
    bounds = [torch.from_numpy(bias + rng.integers(-20, 60, size=sk.shape).astype(np.int32))
              for _ in range(3)]
    want = port.stream_chained_reference(qk, sk, *bounds, DEFAULT_PENALTIES, rows,
                                         score_width=width, state_dtype=dtype)
    return qk, sk, bounds, want


@pytest.mark.parametrize("slices", SLICES)
@pytest.mark.parametrize("mode", ["biased W=12", "float32"])
@pytest.mark.parametrize("rows", [1, 16])
def test_mode_chained_kernel_equals_plain_version(cuda_device, rows, mode, slices):
    """All four strips of one tile in each mode against the plain
    version."""
    width, dtype = MODES[mode]
    qk, sk, bounds, want = _mode_chained_case(rows, mode)
    kw = dict(score_width=width, state_dtype=dtype)
    got = port.stream_chained_cuda(
        qk.to(cuda_device), sk.to(cuda_device), *(x.to(cuda_device) for x in bounds),
        DEFAULT_PENALTIES, rows, slices=slices, **kw,
    )
    for name, g, w in zip(("acc", "oD", "oG", "oH"), got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), err_msg=name)


# the 16-bit states: (state type, penalties it takes); uint16 refuses the
# default open penalty and wraps a mismatch of -4 to 65532
SIXTEEN_BIT = {
    "int16": ("int16", DEFAULT_PENALTIES),
    "uint16": ("uint16", Penalties(5, 0, 0, 0)),
    "uint16 wrap": ("uint16", Penalties(5, -4, 0, 0)),
    "bfloat16": ("bfloat16", DEFAULT_PENALTIES),
}


@functools.lru_cache(maxsize=None)
def _16bit_case(segments, rows, tail_acc, mode):
    dtype, pen = SIXTEEN_BIT[mode]
    qk, sk = _mode_batch(segments, rows)
    want = port.stream_strip_reference(qk, sk, pen, segments, rows, tail_acc,
                                       state_dtype=dtype)
    return qk, sk, want


@pytest.mark.parametrize("slices", SLICES)
@pytest.mark.parametrize("mode", list(SIXTEEN_BIT))
@pytest.mark.parametrize("segments,rows,tail_acc", [
    (1, 1, True), (1, 8, True), (2, 8, True), (4, 4, True), (1, 1, False), (4, 1, False),
])
def test_16bit_strip_equals_plain_version(cuda_device, segments, rows, tail_acc, mode, slices):
    """The int16, uint16 and bfloat16 kernels, both forms, against their
    plain versions; int16 and exact uint16 also equal int32."""
    dtype, pen = SIXTEEN_BIT[mode]
    qk, sk, want = _16bit_case(segments, rows, tail_acc, mode)
    args = (qk.to(cuda_device), sk.to(cuda_device), pen, segments, rows, tail_acc)
    launches = port.stream_strip_cuda.launches
    got = port.stream_strip_cuda(*args, slices=slices, state_dtype=dtype)
    torch.cuda.synchronize()
    assert port.stream_strip_cuda.launches == launches + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    if mode in ("int16", "uint16"):
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      port.stream_strip_cuda(*args).cpu().numpy())


@functools.lru_cache(maxsize=None)
def _16bit_chained_case(rows, mode):
    """One chained tile in a 16-bit state on random boundary strips in the
    state's range."""
    dtype, pen = SIXTEEN_BIT[mode]
    rng = np.random.default_rng(rows + 410)
    db = _db(rng, 400, 200)
    b = pack_streams(rng.integers(0, 4, size=1).astype(np.int8), db.mat,
                     n_streams=40, lens=db.lens, rows=rows)
    sk = torch.from_numpy(b.stream.T.copy())
    qk = torch.from_numpy(rng.integers(0, 4, size=(128, 40)).astype(np.int8))
    lo = 0 if dtype == "uint16" else -20
    bounds = [torch.from_numpy(rng.integers(lo, 300, size=sk.shape).astype(np.int32))
              for _ in range(3)]
    if dtype == "bfloat16":  # what a bfloat16 tile writes: bfloat16 values
        bounds = [x.to(torch.bfloat16).to(torch.int32) for x in bounds]
    want = port.stream_chained_reference(qk, sk, *bounds, pen, rows, state_dtype=dtype)
    return qk, sk, bounds, want


@pytest.mark.parametrize("slices", SLICES)
@pytest.mark.parametrize("mode", list(SIXTEEN_BIT))
@pytest.mark.parametrize("rows", [1, 8])
def test_16bit_chained_kernel_equals_plain_version(cuda_device, rows, mode, slices):
    dtype, pen = SIXTEEN_BIT[mode]
    qk, sk, bounds, want = _16bit_chained_case(rows, mode)
    got = port.stream_chained_cuda(
        qk.to(cuda_device), sk.to(cuda_device), *(x.to(cuda_device) for x in bounds),
        pen, rows, slices=slices, state_dtype=dtype,
    )
    # the chain kernel at K = 1, one sublane a thread
    assert port.stream_chained_cuda.slices == (slices or port.choose_slices(
        40, rows, sk.shape[0], port._sm_count(cuda_device), state_dtype=dtype,
        lanes=port.chain_lanes(rows, dtype, one_tile=True)))
    for name, g, w in zip(("acc", "oD", "oG", "oH"), got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), err_msg=name)


@pytest.mark.parametrize("dtype", ["int16", "uint16", "bfloat16"])
def test_16bit_rows_16_is_refused(cuda_device, dtype):
    """No rows-16 16-bit instantiation exists: the wrappers raise swtpu's
    ValueError, and the library refuses the launch and the query."""
    import ctypes

    from swtpu_torch.ops import _build

    qk = torch.zeros((128, 8), dtype=torch.int8, device=cuda_device)
    sk = torch.zeros((32, 8), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="rows=16 requires a 32-bit state dtype"):
        port.stream_strip_cuda(qk, sk, Penalties(5, 0, 0, 0), 1, 16, state_dtype=dtype)
    out = (ctypes.c_int * 3)()
    code = port.STATE_CODES[dtype]
    assert _build.load_library().swtpu_stream_kernel_info(16, 0, 0, code, out) == 1


# every instantiation: rows 16 only in the 32-bit states
@pytest.mark.parametrize("rows,form,mode", [
    (r, form, mode)
    for mode in [*MODES, *port.SIXTEEN_BIT_STATES]
    for r, form in [(r, "tail_acc") for r in port.ROWS] + [(1, "ripple_h")]
    + [(r, "chained") for r in port.ROWS]
    if r < 16 or mode in MODES
])
def test_mode_kernels_hold_the_slices_occupancy(cuda_device, rows, form, mode):
    width, dtype = MODES.get(mode, (None, mode))
    regs, local, blocks = port.stream_kernel_info(
        rows, tail_acc=form != "ripple_h", chained=form == "chained",
        score_width=width, state_dtype=dtype)
    assert 0 < regs <= 65536 // (port.RESIDENT_WARPS_PER_SM * 32)
    assert local == 0
    assert blocks * port.KERNEL_BLOCK >= port.RESIDENT_WARPS_PER_SM * 32


def _pairs(rng, n, lo, hi, n_queries):
    """n pairs over n_queries distinct queries of lo..hi bases, targets of
    0..hi bases; every 8th target is its query."""
    qs = [rng.integers(0, 4, size=k).astype(np.int8) for k in rng.integers(lo, hi + 1, n_queries)]
    queries = [qs[i] for i in rng.integers(0, n_queries, size=n)]
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in rng.integers(0, hi + 1, n)]
    for i in range(0, n, 8):
        targets[i] = queries[i].copy()
    return queries, targets


def test_score_pairs_default_backend_equals_oracle(cuda_device):
    """ScoreBank(device="cuda") takes the pair streams: more distinct
    queries than one call's streams, so several B1 launches."""
    rng = np.random.default_rng(21)
    queries, targets = _pairs(rng, 3000, 40, 128, 700)
    bank = ScoreBank(SWConfig(stream_phys=256), device=cuda_device)
    assert bank.backend == "stream"
    launches = port.stream_strip_cuda.launches
    res = bank.score_pairs(queries, targets)
    assert port.stream_strip_cuda.launches - launches == 3  # 700 queries / 256 streams
    want = [score_many_vs_one(q, [t])[0] for q, t in zip(queries, targets)]
    np.testing.assert_array_equal(res.scores, want)


def test_stream_score_width_equals_biased_oracle(cuda_device):
    """score_width on the stream backend: score_database short and long,
    and score_pairs with short and long queries, identical pairs past the
    12-bit ceiling wrapping."""
    rng = np.random.default_rng(22)
    bank = ScoreBank(SWConfig(score_width=12), backend="stream", device=cuda_device)
    queries, targets = _pairs(rng, 200, 24, 128, 30)
    longs, ltargets = _pairs(rng, 40, 420, 500, 2)
    queries, targets = queries + longs, targets + ltargets
    launches = port.stream_strip_cuda.launches, port.stream_chain_cuda.launches
    res = bank.score_pairs(queries, targets)
    assert port.stream_strip_cuda.launches > launches[0]
    assert port.stream_chain_cuda.launches - launches[1] == 2  # 2 chains of 4 tiles
    want = [sw_score_single_biased(q, t, DEFAULT_PENALTIES, 12) for q, t in zip(queries, targets)]
    np.testing.assert_array_equal(res.scores, want)
    assert res.scores[200] < 5 * len(queries[200])  # wrapped
    db = _db(rng, 300, 200)
    for qlen in (60, 450):
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        got = bank.score_database(query, db).scores
        want = [sw_score_single_biased(query, t, DEFAULT_PENALTIES, 12) for t in db.as_list()]
        np.testing.assert_array_equal(got, want)


PAIR_JOBS = 12  # distinct long queries: jobs of the side-by-side dispatch


def _long_query_pairs(rng):
    """4 pairs each of PAIR_JOBS distinct queries of 129-400 bases, in a
    random order; targets of 0-80 bases, every 5th a window of its query."""
    qs = [rng.integers(0, 4, size=k).astype(np.int8)
          for k in rng.integers(129, 401, size=PAIR_JOBS)]
    owner = rng.permutation(np.repeat(np.arange(PAIR_JOBS), 4))
    queries = [qs[u] for u in owner]
    targets = [rng.integers(0, 4, size=k).astype(np.int8)
               for k in rng.integers(0, 81, size=len(owner))]
    for i in range(0, len(owner), 5):
        k = int(rng.integers(1, 81))
        off = int(rng.integers(0, len(queries[i]) - k + 1))
        targets[i] = queries[i][off : off + k].copy()
    return queries, targets


@pytest.mark.parametrize("width", [None, 12])
def test_pair_jobs_side_by_side(cuda_device, width, monkeypatch, tmp_path):
    """score_pairs' long-query jobs on CUDA streams of their own: the
    oracle's and the column path's scores, one B3 launch (its chain) a
    job, the jobs on at least 2 streams; with a window of 1 (each job
    finished before the next is dispatched) the same scores and records."""
    queries, targets = _long_query_pairs(np.random.default_rng(40 + (width or 0)))
    cfg = SWConfig(score_width=width)
    bank = ScoreBank(cfg, backend="stream", device=cuda_device)
    distinct = {q.tobytes(): q for q in queries}
    streams, dispatch = [], bank._dispatch_long

    def dispatch_long(*args, stream=None, **kw):
        streams.append(stream)
        return dispatch(*args, stream=stream, **kw)

    monkeypatch.setattr(bank, "_dispatch_long", dispatch_long)
    runs = {}
    for window in (scorebank.JOB_WINDOW, 1):
        streams.clear()
        monkeypatch.setattr(scorebank, "JOB_WINDOW", window)
        log = EventLog(tmp_path / f"events{window}.jsonl")
        launches = port.stream_chain_cuda.launches
        res = bank.score_pairs(queries, targets, event_log=log)
        assert port.stream_chain_cuda.launches - launches == len(distinct)
        log.close()
        records = [(e.kind, e.reads, e.cells, e.padded_cells, e.note)
                   for e in EventLog.parse(tmp_path / f"events{window}.jsonl")]
        assert [r[0] for r in records] == ["stream_long"] * PAIR_JOBS
        assert len(streams) == PAIR_JOBS
        assert len({s.cuda_stream for s in streams}) >= 2
        runs[window] = res, records
    (res, records), (one, one_records) = runs.values()
    np.testing.assert_array_equal(one.scores, res.scores)
    assert one_records == records
    assert (one.cells, one.padded_cells) == (res.cells, res.padded_cells)
    if width is None:
        want = np.zeros(len(queries), np.int32)
        for q in distinct.values():
            idx = [i for i, x in enumerate(queries) if np.array_equal(x, q)]
            want[idx] = score_many_vs_one(q, [targets[i] for i in idx])
    else:
        want = [sw_score_single_biased(q, t, DEFAULT_PENALTIES, width)
                for q, t in zip(queries, targets)]
    np.testing.assert_array_equal(res.scores, want)
    col = ScoreBank(cfg, backend="pallas", device=cuda_device).score_pairs(queries, targets)
    np.testing.assert_array_equal(res.scores, col.scores)


@pytest.mark.parametrize("qlen", [60, 128, 300])
@pytest.mark.parametrize("wire", [True, False])
def test_float32_state_equals_oracle(cuda_device, qlen, wire):
    rng = np.random.default_rng(qlen + wire + 500)
    db = _db(rng, 2000, 200)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    cfg = SWConfig(stream_state_dtype="float32", wire_2bit=wire)
    res = ScoreBank(cfg, device=cuda_device).score_database(query, db)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, db.as_list()))


@pytest.mark.parametrize("qlen", [60, 300])
def test_16bit_bank_equals_oracle_and_plain_path(cuda_device, qlen):
    """ScoreBank(stream_state_dtype=..., stream_rows=8) on the card: int16
    and exact uint16 equal the oracle, bfloat16 and wrapping uint16 the
    port's plain path on the CPU, short and long queries; without
    stream_rows a segments-1 query takes rows 16 there and raises swtpu's
    ValueError."""
    rng = np.random.default_rng(qlen + 600)
    db = _db(rng, 300, 200)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    for mode, (dtype, pen) in SIXTEEN_BIT.items():
        cfg = SWConfig(stream_state_dtype=dtype, stream_rows=8, penalties=pen)
        got = ScoreBank(cfg, device=cuda_device).score_database(query, db).scores
        if mode in ("int16", "uint16"):
            want = score_many_vs_one(query, db.as_list(), pen)
        else:
            want = ScoreBank(cfg, device="cpu").score_database(query, db).scores
        np.testing.assert_array_equal(got, want, err_msg=mode)
    with pytest.raises(ValueError, match="rows=16 requires a 32-bit state dtype"):
        ScoreBank(SWConfig(stream_state_dtype="int16"), device=cuda_device).score_database(
            rng.integers(0, 4, size=128).astype(np.int8), db)


def test_16bit_score_pairs_equals_oracle(cuda_device):
    """score_pairs in int16 on the pair streams and the chained tiles."""
    rng = np.random.default_rng(23)
    queries, targets = _pairs(rng, 300, 24, 128, 40)
    longs, ltargets = _pairs(rng, 30, 300, 400, 2)
    queries, targets = queries + longs, targets + ltargets
    bank = ScoreBank(SWConfig(stream_state_dtype="int16", stream_rows=8), device=cuda_device)
    res = bank.score_pairs(queries, targets)
    want = [score_many_vs_one(q, [t])[0] for q, t in zip(queries, targets)]
    np.testing.assert_array_equal(res.scores, want)


# The packed 16-bit forms: a thread holds two streams, one in each half of
# its registers (and a warp of the int16 column kernel two pairs).  Odd
# stream counts leave the last pair a dead high half; reads of 1-300 bases,
# one in 7 the query itself, start at other steps in the two halves of a
# pair, and slices of 32 steps (FINE) hold many a slice in which only one
# half of a pair starts a read.
PACKED_S = [1, 3, 511, 64]
PACKED_FORMS = [(1, 1, True), (1, 1, False), (1, 2, True), (1, 4, True), (1, 8, True),
                (2, 8, True)]
FINE = "32-step"
PACKED_SLICES = [1, 2, 7, None, FINE]


def _packed_reads(rng, n, query):
    """[n, 300] int8 reads of 1-300 bases and their lengths, every 7th the
    query."""
    lens = rng.integers(1, 301, size=n).astype(np.int32)
    mat = rng.integers(0, 4, size=(n, 300)).astype(np.int8)
    mat[::7, : len(query)] = query
    lens[::7] = len(query)
    mat[np.arange(300)[None, :] >= lens[:, None]] = 4
    return mat, lens


def _packed_batch(S, segments, rows):
    """(qk, sk) on the CPU: S physical streams at `segments` of packed reads
    (_packed_reads), in the kernel layout."""
    rng = np.random.default_rng(S * 17 + segments * 5 + rows)
    query = rng.integers(0, 4, size=128 // segments - 1).astype(np.int8)
    mat, lens = _packed_reads(rng, max(8, 4 * S * segments), query)
    b = pack_streams(query, mat, n_streams=S * segments, segments=segments, lens=lens,
                     rows=rows)
    return port._to_kernel_layout(torch.from_numpy(b.q), torch.from_numpy(b.stream),
                                  segments, rows)


def _one_half_only(sk, S, segments):
    """(32-step slice, segment, pair) cells in which exactly one of the
    pair's two streams starts a read."""
    T = sk.shape[0]
    starts = (sk.reshape(T // 32, 32, segments, S) >= 8).any(1)
    pairs = starts[..., : S - S % 2].reshape(T // 32, segments, S // 2, 2)
    return int((pairs[..., 0] != pairs[..., 1]).sum())


def _slices(slices, T):
    return T // port.STEP_CHUNK if slices == FINE else slices


@functools.lru_cache(maxsize=None)
def _packed_case(S, segments, rows, tail_acc, mode):
    dtype, pen = SIXTEEN_BIT[mode]
    qk, sk = _packed_batch(S, segments, rows)
    want = port.stream_strip_reference(qk, sk, pen, segments, rows, tail_acc,
                                       state_dtype=dtype)
    return qk, sk, want


@pytest.mark.parametrize("slices", PACKED_SLICES)
@pytest.mark.parametrize("mode", list(SIXTEEN_BIT))
@pytest.mark.parametrize("segments,rows,tail_acc", PACKED_FORMS)
@pytest.mark.parametrize("S", PACKED_S)
def test_packed_strip_equals_plain_version(cuda_device, S, segments, rows, tail_acc, mode,
                                           slices):
    """B1/B2 with two streams a thread, both forms, at odd and even stream
    counts and read starts that differ between the halves of a pair."""
    dtype, pen = SIXTEEN_BIT[mode]
    qk, sk, want = _packed_case(S, segments, rows, tail_acc, mode)
    T = sk.shape[0]
    assert S == 1 or _one_half_only(sk, S, segments) > 0
    n = _slices(slices, T)
    got = port.stream_strip_cuda(qk.to(cuda_device), sk.to(cuda_device), pen, segments,
                                 rows, tail_acc, slices=n, state_dtype=dtype)
    torch.cuda.synchronize()
    assert port.stream_strip_cuda.slices == (n or port.choose_slices(
        S, rows, T, port._sm_count(cuda_device), segments, dtype))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@functools.lru_cache(maxsize=None)
def _packed_chained_case(S, rows, mode):
    """One chained tile on _packed_batch's streams and random boundary
    strips in the state's range."""
    dtype, pen = SIXTEEN_BIT[mode]
    qk, sk = _packed_batch(S, 1, rows)
    rng = np.random.default_rng(S + rows + 700)
    lo = 0 if dtype == "uint16" else -20
    bounds = [torch.from_numpy(rng.integers(lo, 300, size=sk.shape).astype(np.int32))
              for _ in range(3)]
    if dtype == "bfloat16":  # what a bfloat16 tile writes: bfloat16 values
        bounds = [x.to(torch.bfloat16).to(torch.int32) for x in bounds]
    want = port.stream_chained_reference(qk, sk, *bounds, pen, rows, state_dtype=dtype)
    return qk, sk, bounds, want


@pytest.mark.parametrize("slices", PACKED_SLICES)
@pytest.mark.parametrize("mode", list(SIXTEEN_BIT))
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
@pytest.mark.parametrize("S", PACKED_S)
def test_packed_chained_kernel_equals_plain_version(cuda_device, S, rows, mode, slices):
    """B3 with two streams a thread: all four strips of one tile."""
    dtype, pen = SIXTEEN_BIT[mode]
    qk, sk, bounds, want = _packed_chained_case(S, rows, mode)
    n = _slices(slices, sk.shape[0])
    got = port.stream_chained_cuda(
        qk.to(cuda_device), sk.to(cuda_device), *(x.to(cuda_device) for x in bounds),
        pen, rows, slices=n, state_dtype=dtype,
    )
    for name, g, w in zip(("acc", "oD", "oG", "oH"), got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), err_msg=name)


@pytest.mark.parametrize("mode", list(SIXTEEN_BIT))
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("S", [3, 511])
def test_packed_chain_equals_plain_version(cuda_device, S, rows, mode):
    """Whole K = 2 chains of a 256-base query with two streams a thread:
    every tile's four strips and the last accumulator."""
    dtype, pen = SIXTEEN_BIT[mode]
    rng = np.random.default_rng(S + rows + 800)
    query = rng.integers(0, 4, size=256).astype(np.int8)
    mat, lens = _packed_reads(rng, max(8, 4 * S), query[:200])
    b = pack_streams_long(query, mat, n_streams=S, rows=rows, lens=lens)
    q, sk = torch.from_numpy(b.q), torch.from_numpy(b.stream.T.copy())

    def run(q, sk, tile):
        outs = []

        def record(*args, **kw):
            outs.append(tile(*args, **kw))
            return outs[-1]

        return port._long_strip(q, sk, pen, rows, tile=record, state_dtype=dtype), outs

    launches = port.stream_chained_cuda.launches
    got, got_tiles = run(q.to(cuda_device), sk.to(cuda_device), port.stream_chained_cuda)
    want, want_tiles = run(q, sk, port.stream_chained_reference)
    assert port.stream_chained_cuda.launches == launches + 2
    for k, (g, w) in enumerate(zip(got_tiles, want_tiles)):
        for name, a, b in zip(("acc", "oD", "oG", "oH"), g, w):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy(),
                                          err_msg=f"tile {k} {name}")
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# The 16-bit chain in one launch: (rows, K) of the chain kernel's packed
# instantiations, every rows at 1, 2 and 5 tiles (5: one wrap past the
# 4-warp ring), rows 8 (the main shapes') also at 4 and 9 (two wraps)
CHAIN16_CASES = [(r, k) for r in (1, 2, 4, 8) for k in (1, 2, 5)] + [(8, 4), (8, 9)]


@functools.lru_cache(maxsize=None)
def _chain16_case(rows, K, mode, sparse):
    """(q, sk, the plain chain's strip) on the CPU: 43 streams full of reads
    (odd: the last pair's high half dead), or with `sparse` 24 reads on 107
    streams, which leaves groups (2 x 32 / W streams) with no read start."""
    dtype, pen = SIXTEEN_BIT[mode]
    S, reads, lo, hi = (107, 24, 100, 300) if sparse else (43, 150, 10, 120)
    q, sk = _chain_case(rows, K, S, reads, lo, hi)
    return q, sk, port._long_strip(q, sk, pen, rows, state_dtype=dtype)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("mode", list(SIXTEEN_BIT))
@pytest.mark.parametrize("rows,K", CHAIN16_CASES)
def test_16bit_chain_kernel_equals_plain_chain(cuda_device, rows, K, mode, sparse):
    """The chain kernel in each 16-bit state (two streams a thread, uint16's
    wrapping mismatch included) = the plain chain (the plain tile, the
    host's shifts) bit for bit: in one slice, in the geometry's and in
    32-step slices, one launch each; _long_strip on the card takes the one
    launch and no per-tile one."""
    dtype, pen = SIXTEEN_BIT[mode]
    q, sk, want = _chain16_case(rows, K, mode, sparse)
    if sparse:
        assert bool((sk[:, -32:] == 4).all())
    dq, ds = q.to(cuda_device), sk.to(cuda_device)
    qks = port.tile_registers(dq, rows)
    T = sk.shape[0]
    geometry = port.chain_geometry(sk.shape[1], rows, T, K, port._sm_count(cuda_device), dtype)
    for slices in (1, None, T // port.STEP_CHUNK):
        launches = port.stream_chain_cuda.launches
        got = port.stream_chain_cuda(qks, ds, pen, rows, slices=slices, state_dtype=dtype)
        torch.cuda.synchronize()
        assert port.stream_chain_cuda.launches == launches + 1
        assert port.stream_chain_cuda.slices == (slices or geometry.slices)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=f"{slices}")
    launches = port.stream_chain_cuda.launches, port.stream_chained_cuda.launches
    got = port._long_strip(dq, ds, pen, rows, state_dtype=dtype)
    assert (port.stream_chain_cuda.launches - launches[0],
            port.stream_chained_cuda.launches - launches[1]) == (1, 0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("dtype", port.SIXTEEN_BIT_STATES)
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_16bit_chain_kernel_holds_its_occupancy(cuda_device, rows, dtype):
    """Every instantiation of the 16-bit chain kernel, the whole chain's
    and the per-tile contract's: no spill, the resident warps its launch
    bounds promise, its ring in the 32-bit state's shared bytes; with the
    pad shortcut and without it."""
    for quiet in (True, False):
        regs, local, blocks, shared = port.stream_chain_info(rows, state_dtype=dtype,
                                                             quiet=quiet)
        assert 0 < regs <= 65536 // (port.RESIDENT_WARPS_PER_SM * 32)
        assert local == 0
        assert blocks * port.KERNEL_BLOCK >= port.RESIDENT_WARPS_PER_SM * 32
        assert shared == port.stream_chain_info(rows)[3]
    regs, local, blocks = port.stream_kernel_info(rows, chained=True, state_dtype=dtype)
    assert 0 < regs <= 65536 // (port.RESIDENT_WARPS_PER_SM * 32) and local == 0


@functools.lru_cache(maxsize=None)
def _geometry16_plain(rows, segments, mode):
    qk, sk, _ = _geometry_case(rows, segments, False)
    dtype, pen = SIXTEEN_BIT[mode]
    return port.stream_strip_reference(qk, sk, pen, segments, rows, state_dtype=dtype)


@pytest.mark.parametrize("mode", list(SIXTEEN_BIT))
@pytest.mark.parametrize("rows,segments", [(r, g) for r, g in GEOMETRIES if r <= 8])
def test_16bit_every_geometry_strip_equals_plain_version(cuda_device, rows, segments, mode):
    """B1 (B2 at rows 1) in each 16-bit state at every legal rows x
    segments, 8 threads a stream pair of 16 query rows at rows 4 and 8:
    the strip in one slice and in the wrapper's slices for the batch's
    longest read equals the plain version's; the count is choose_slices'
    for that read."""
    dtype, pen = SIXTEEN_BIT[mode]
    qk, sk, longest = _geometry_case(rows, segments, False)
    want = _geometry16_plain(rows, segments, mode)
    assert port.wavefront_geometry(rows, segments, dtype).lanes == (8 if rows >= 4 else 32)
    dq, ds = qk.to(cuda_device), sk.to(cuda_device)
    for slices in (1, None):
        got = port.stream_strip_cuda(dq, ds, pen, segments, rows, slices=slices,
                                     state_dtype=dtype, longest_read=longest)
        torch.cuda.synchronize()
        assert port.stream_strip_cuda.slices == (slices or port.choose_slices(
            qk.shape[1], rows, sk.shape[0], port._sm_count(cuda_device), segments, dtype,
            longest_read=longest))
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=f"{slices}")


def test_16bit_bank_long_query_is_one_chain_launch(cuda_device):
    """ScoreBank(stream_state_dtype="int16", stream_rows=8) on (e)'s shape
    cut down (a 512-base query, reads of 128): one chain launch a call, no
    per-tile launch, the oracle's scores."""
    rng = np.random.default_rng(512)
    db = _db(rng, 2000, 129)
    query = rng.integers(0, 4, size=512).astype(np.int8)
    bank = ScoreBank(SWConfig(stream_state_dtype="int16", stream_rows=8), device=cuda_device)
    for _ in range(2):
        launches = port.stream_chain_cuda.launches, port.stream_chained_cuda.launches
        res = bank.score_database(query, db)
        assert (port.stream_chain_cuda.launches - launches[0],
                port.stream_chained_cuda.launches - launches[1]) == (1, 0)
        np.testing.assert_array_equal(res.scores, score_many_vs_one(query, db.as_list()))


@pytest.mark.parametrize("pen", [DEFAULT_PENALTIES, Penalties(40, -4, -12, -4)])
@pytest.mark.parametrize("m", [8, 64, 128, 256])  # 1, 2, 4 and 8 rows a lane
@pytest.mark.parametrize("B", [1, 2, 1001])
def test_packed_column_kernel_equals_plain_version(cuda_device, B, m, pen):
    """B4 in int16, two pairs a warp: odd B leaves the last warp a dead
    high half; the scores also equal the int32 kernel's (at +40 pair 0's
    passes 8,191 from m = 256)."""
    rng = np.random.default_rng(B + m + pen.match)
    q, t = _column_batch(rng, B, m, 320)
    want = column.column_scores_reference(q, t, pen, None, "int16")
    got = column.column_scores_cuda(q.to(cuda_device), t.to(cuda_device), pen,
                                    state_dtype="int16")
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    exact = column.column_scores_cuda(q.to(cuda_device), t.to(cuda_device), pen)
    np.testing.assert_array_equal(got.cpu().numpy(), exact.cpu().numpy())


@pytest.mark.parametrize("B", [1, 1001])
def test_packed_column_chain_equals_plain_version(cuda_device, B):
    """A two-tile B5 chain in int16 at +40 a match, two pairs a warp: every
    tile's h, ms and is, and the scores (pair 0 scores 40 x 320), also
    equal to the int32 chain's."""
    pen = Penalties(40, -4, -12, -4)
    rng = np.random.default_rng(B + 900)
    q, t = _column_batch(rng, B, 2 * column.QUERY_TILE, 320)

    def run(q, t, tile, state_dtype):
        outs = []

        def record(*args):
            outs.append(tile(*args))
            return outs[-1]

        return column._chained_call(q, t, pen, None, tile=record,
                                    state_dtype=state_dtype), outs

    got, got_tiles = run(q.to(cuda_device), t.to(cuda_device), column.column_chained_cuda,
                         "int16")
    want, want_tiles = run(q, t, column.column_chained_reference, "int16")
    exact, _ = run(q.to(cuda_device), t.to(cuda_device), column.column_chained_cuda, "int32")
    for k, (g, w) in enumerate(zip(got_tiles, want_tiles)):
        for name, a, b in zip(("h", "ms", "is_"), g, w):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy(),
                                          err_msg=f"tile {k} {name}")
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), exact.cpu().numpy())
    assert got[0] == 40 * 320


@pytest.mark.parametrize("m,tile", [(8, False), (16, False), (32, False), (64, False),
                                    (128, False), (256, False), (256, True)])
@pytest.mark.parametrize("width,state_dtype", COLUMN_MODES)
def test_column_kernels_do_not_spill(cuda_device, m, tile, width, state_dtype):
    """Every column instantiation (each geometry, the tile, each state)
    runs from registers alone and fits a block on an SM."""
    regs, local, blocks = column.column_kernel_info(m, state_dtype, width, tile)
    assert 0 < regs <= 255
    assert local == 0
    assert blocks >= 1


@pytest.mark.parametrize("state_dtype", ["int32", "float32", "int16"])
def test_column_kernel_geometry_is_the_hosts(cuda_device, state_dtype):
    """At every query width 1..256 the library's instantiation has
    column_geometry's lanes a pair and rows a lane (column_kernel_info
    raises where they differ)."""
    for m in range(1, column.QUERY_TILE + 1):
        assert column.column_kernel_info(m, state_dtype)[1] == 0


# resident serving: (max_query_len, query lengths it serves, config)
SERVING = {
    "seg4": (32, (8, 32), SWConfig()),
    "seg2": (64, (40, 64), SWConfig()),
    "long": (256, (20, 128, 129, 256), SWConfig()),
    "long_w12": (512, (100, 450), SWConfig(score_width=12)),
    "int16_rows8": (128, (60, 128), SWConfig(stream_state_dtype="int16", stream_rows=8)),
}


@pytest.mark.parametrize("wire", [True, False])
@pytest.mark.parametrize("case", list(SERVING))
def test_loaded_database_equals_score_database(cuda_device, case, wire):
    """load_database on the card, both crossings, at the CUDA geometry:
    score_loaded (with the kernels on the resident stream itself),
    score_loaded_many and topk_loaded against score_database and the
    oracle; reads 3 and 400 are the longest query (tied at the top)."""
    import dataclasses

    cap, qlens, cfg = SERVING[case]
    cfg = dataclasses.replace(cfg, wire_2bit=wire)
    rng = np.random.default_rng(cap + len(qlens))
    db = _db(rng, 700, 300)
    queries = [rng.integers(0, 4, size=k).astype(np.int8) for k in qlens]
    reads = db.as_list()
    reads[3] = reads[400] = queries[-1].copy()
    bank = ScoreBank(cfg, backend="stream", device=cuda_device)
    loaded = bank.load_database(reads, max_query_len=cap)
    assert loaded.stream.is_cuda and loaded.stream.is_contiguous()
    port.stream_strip_cuda.launches = port.stream_chain_cuda.launches = 0
    port.stream_chained_cuda.launches = 0
    wave = bank.score_loaded_many(queries, loaded)
    short = sum(len(q) <= 128 for q in queries)
    assert port.stream_strip_cuda.launches == short
    # one chain a longer query, no tile on its own
    assert port.stream_chain_cuda.launches == len(queries) - short
    assert port.stream_chained_cuda.launches == 0
    for q, res in zip(queries, wave):
        want = bank.score_database(q, reads)
        np.testing.assert_array_equal(res.scores, want.scores)
        np.testing.assert_array_equal(bank.score_loaded(q, loaded).scores, res.scores)
        if cfg.score_width is None:
            np.testing.assert_array_equal(res.scores, score_many_vs_one(q, reads))
        else:  # the biased oracle is a Python loop: reads 0-63 and 400
            held = [*range(64), 400]
            assert res.scores[held].tolist() == [
                sw_score_single_biased(q, reads[i], score_width=12) for i in held]
        assert bank.topk_loaded(q, loaded, k=5) == res.top_k(5)
    if cfg.score_width is None:  # at 12 bits the 450-base copies wrap
        assert bank.topk_loaded(queries[-1], loaded, k=2) == [(5 * len(queries[-1]), 3),
                                                              (5 * len(queries[-1]), 400)]


def test_serve_engine_threads_on_the_card(cuda_device):
    """Four threads dispatch through one engine on the card at once, each
    a different query; every answer equals score_loaded's."""
    import threading

    from swtpu_torch.server import ServeEngine

    rng = np.random.default_rng(77)
    db = _db(rng, 3000, 200)
    bank = ScoreBank(device=cuda_device)
    loaded = bank.load_database(db, max_query_len=256)
    engine = ServeEngine(bank, db.names, db, db=loaded)
    seqs = ["".join("ACGT"[int(c)] for c in rng.integers(0, 4, size=k))
            for k in (30, 128, 200, 256)]
    got = {}

    def client(i):
        for _ in range(3):
            got.setdefault(i, []).append(engine.handle(f"SEQ {seqs[i]}"))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    from swtpu_torch.io.encode import encode_seq

    for i, seq in enumerate(seqs):
        want = bank.score_loaded(encode_seq(seq), loaded).scores.tolist()
        for lines in got[i]:
            assert [int(l.rsplit("\t", 1)[1]) for l in lines] == want
    assert engine.served == 12


# the chunked dispatch over 3,001 reads: (query length, chunk reads); 1,000
# and 3,000 leave a tail chunk of one read, 777 one of 670
CHUNKED = [(20, 1000), (100, 3000), (60, 777), (128, 1000)]


@pytest.mark.parametrize("wire", [True, False])
@pytest.mark.parametrize("qlen,chunk", CHUNKED)
def test_chunked_equals_one_shot_on_the_card(cuda_device, qlen, chunk, wire):
    """stream_chunk_reads on the card, both crossings: the scores and cells
    of the one-shot call, one wavefront launch a chunk, the oracle on a
    sample; the pinned buffers' views keep each array's type and shape."""
    import dataclasses

    from swtpu_torch.utils.metrics import EventLog

    rng = np.random.default_rng(qlen + chunk)
    db = _db(rng, 3001, 200)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    cfg = SWConfig(wire_2bit=wire)
    one = ScoreBank(cfg, device=cuda_device).score_database(query, db)
    log = EventLog()
    port.stream_strip_cuda.launches = 0
    got = ScoreBank(dataclasses.replace(cfg, stream_chunk_reads=chunk),
                    device=cuda_device).score_database(query, db, event_log=log)
    chunks = -(-3001 // chunk)
    assert port.stream_strip_cuda.launches == chunks
    np.testing.assert_array_equal(got.scores, one.scores)
    assert got.cells == one.cells
    assert log.events[0].note.startswith(f"chunks={chunks} chunk_reads={chunk}")
    held = [*range(100), 2999, 3000]
    np.testing.assert_array_equal(got.scores[held],
                                  score_many_vs_one(query, [db.read(i) for i in held]))


def test_one_shot_is_one_chunk_on_the_card(cuda_device, monkeypatch):
    """A call without chunks is the chunk loop's one chunk: no pinned
    staging, one wavefront launch, a "stream" event with swtpu's note.  A
    chunked call stages through a stager of its own, so two threads
    chunking on one bank each get the one-shot call's scores."""
    import threading

    from swtpu_torch.bank import scorebank as bank_mod
    from swtpu_torch.utils.metrics import EventLog

    real = bank_mod._PinnedStager.put
    puts = []

    def counted(self, *arrays):
        puts.append(self)
        return real(self, *arrays)

    monkeypatch.setattr(bank_mod._PinnedStager, "put", counted)
    rng = np.random.default_rng(4)
    db = _db(rng, 2500, 200)
    query = rng.integers(0, 4, size=64).astype(np.int8)
    log = EventLog()
    port.stream_strip_cuda.launches = 0
    first = ScoreBank(device=cuda_device).score_database(query, db, event_log=log)
    assert not puts and port.stream_strip_cuda.launches == 1
    assert log.events[0].kind == "stream" and log.events[0].note.startswith("streams=")
    bank = ScoreBank(SWConfig(stream_chunk_reads=700), device=cuda_device)
    got = {}

    def work(i):
        got[i] = bank.score_database(query, db)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert len(puts) == 8 and len({id(p) for p in puts}) == 2
    for res in got.values():
        np.testing.assert_array_equal(res.scores, first.scores)
        assert res.cells == first.cells


def test_pinned_buffer_not_overwritten_while_its_copy_is_in_flight(cuda_device, monkeypatch):
    """The copy stream sleeps before the first chunk's copy, so that copy
    is still waiting when the host comes back to the same pinned buffer
    for the third chunk; the host must wait for it, or the first chunk
    would be scored on the third chunk's data."""
    from swtpu_torch.bank import scorebank as bank_mod

    real = bank_mod._PinnedStager.put
    slept = []

    def slow_first_copy(self, *arrays):
        if not slept:
            with torch.cuda.stream(self.copy_stream):
                torch.cuda._sleep(400_000_000)  # a few hundred ms of cycles
            slept.append(True)
        return real(self, *arrays)

    monkeypatch.setattr(bank_mod._PinnedStager, "put", slow_first_copy)
    rng = np.random.default_rng(5)
    db = _db(rng, 5000, 200)
    query = rng.integers(0, 4, size=100).astype(np.int8)
    got = ScoreBank(SWConfig(stream_chunk_reads=1000), device=cuda_device).score_database(
        query, db)
    monkeypatch.undo()
    want = ScoreBank(device=cuda_device).score_database(query, db)
    assert slept
    np.testing.assert_array_equal(got.scores, want.scores)


def test_resume_and_faults_on_the_card(cuda_device, tmp_path, monkeypatch):
    """score_database_resumable on the stream backend (killed after its
    first chunk, then finished with only the rest scored) and
    score_database_with_faults on the column kernels, on the card."""
    from swtpu_torch.bank import resume
    from swtpu_torch.bank import scorebank as bank_mod
    from swtpu_torch.testing.faults import FaultConfig, score_database_with_faults

    rng = np.random.default_rng(6)
    db = _db(rng, 3001, 200)
    query = rng.integers(0, 4, size=100).astype(np.int8)
    bank = ScoreBank(device=cuda_device)
    want = bank.score_database(query, db).scores
    real = bank_mod.sw_scores_stream_packed
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
        return real(*a, **kw)

    monkeypatch.setattr(bank_mod, "sw_scores_stream_packed", flaky)
    state = tmp_path / "job.npz"
    with pytest.raises(RuntimeError, match="simulated crash"):
        resume.score_database_resumable(bank, query, db, state, chunk_reads=1000)
    res = resume.score_database_resumable(bank, query, db, state, chunk_reads=1000)
    assert calls["n"] == 5  # chunks 0 and 1 (crashed), then 1, 2 and 3
    np.testing.assert_array_equal(res.scores, want)
    reads = db.as_list()
    pallas = ScoreBank(backend="pallas", device=cuda_device)
    scores, inj = score_database_with_faults(pallas, query, reads, FaultConfig(
        seed=7, reorder_percent=100, drop_percent=40, delay_ms_max=1))
    np.testing.assert_array_equal(scores, want)
    assert inj.injected_drops > 0  # 3 here: the delays' draws shift the drops


# ------------------------------------------------- a mesh of 4 shards on one card


@pytest.fixture
def cuda_mesh(cuda_device):
    """Four shards on the first card (the counterpart of swtpu's virtual
    devices on a machine with one GPU)."""
    from swtpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=[torch.device("cuda:0")] * 4)


@pytest.mark.parametrize("backend,m", [("pallas", 128), ("pallas", 300), ("scan", 40)])
def test_sharded_topk_on_the_card(cuda_mesh, backend, m):
    """make_sharded_topk with the column kernels (B4; B5 tiles at 300 bases)
    and the scan, one call a shard: the plain versions' scores and the
    host's top-k order."""
    from swtpu_torch.bank.scorebank import ScoreResult
    from swtpu_torch.ops.common import sentinel_pad_batch
    from swtpu_torch.ops.scan import sw_scores_scan
    from swtpu_torch.parallel.sharded import make_sharded_topk

    rng = np.random.default_rng(m)
    B, n = 64, 96
    q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    t[7] = t[3]  # a tie
    qp, tp = sentinel_pad_batch(q, rng.integers(1, m + 1, size=B), t,
                                rng.integers(1, n + 1, size=B))
    ids = np.arange(B, dtype=np.int32)
    before = (column.column_scores_cuda.launches, column.column_chained_cuda.launches)
    top_s, top_ids, scores = make_sharded_topk(cuda_mesh, k=6, backend=backend)(qp, tp, ids)
    launched = (column.column_scores_cuda.launches - before[0],
                column.column_chained_cuda.launches - before[1])
    want = (sw_scores_scan(qp, tp) if backend == "scan"
            else column.sw_scores_column(torch.from_numpy(qp), torch.from_numpy(tp))).numpy()
    assert scores.device.type == "cuda"
    np.testing.assert_array_equal(scores.cpu().numpy(), want)
    assert list(zip(top_s.tolist(), top_ids.tolist())) == ScoreResult(want, 0, 0, 1).top_k(6)
    assert launched == {"scan": (0, 0), "pallas": (4, 0) if m <= 256 else (0, 8)}[backend]


@pytest.mark.parametrize("qlen", [100, 256])
def test_sharded_stream_scorer_on_the_card(cuda_mesh, qlen):
    """make_sharded_stream_scorer over 4 shards of one card: one B1 a shard
    (one B3 chain of 2 tiles a shard at 256 bases), the one-device scores
    and top-k."""
    from swtpu_torch.bank.scorebank import stream_geometry
    from swtpu_torch.bank.streams import pack_streams_sharded, scatter_sharded_scores
    from swtpu_torch.parallel.sharded import make_sharded_stream_scorer

    rng = np.random.default_rng(qlen)
    db = _db(rng, 3000, 200)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    segments, rows, phys = stream_geometry(qlen, SWConfig(), "cuda")
    b = pack_streams_sharded(query, db, 4, n_streams=phys * segments, segments=segments,
                             rows=rows)
    launches = (port.stream_strip_cuda.launches, port.stream_chain_cuda.launches)
    s, top_s, top_ids = make_sharded_stream_scorer(
        cuda_mesh, k=10, segments=segments, rows=rows, emit_regular=b.emit_regular)(
        b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32), b.ids)
    launched = (port.stream_strip_cuda.launches - launches[0],
                port.stream_chain_cuda.launches - launches[1])
    assert launched == ((4, 0) if qlen <= 128 else (0, 4))
    got = scatter_sharded_scores(s, b, len(db.lens))
    one = ScoreBank(device="cuda").score_database(query, db)
    np.testing.assert_array_equal(got, one.scores)
    assert list(zip(top_s.tolist(), top_ids.tolist())) == one.top_k(10)


def test_loaded_sharded_on_the_card(cuda_mesh):
    """load_database_sharded on 4 shards of one card: each shard's stream
    resident and uncopied, the one-device resident answers for queries of
    one and of two tiles, score_loaded_many_sharded, topk_loaded_sharded
    with ties, and ServeEngine's sharded branch."""
    from swtpu_torch.io.encode import decode_seq
    from swtpu_torch.server import ServeEngine

    rng = np.random.default_rng(12)
    db = _db(rng, 5000, 200)
    query = rng.integers(0, 4, size=100).astype(np.int8)
    db.mat[::500] = 4
    db.mat[::500, :100] = query
    db.lens[::500] = 100
    bank = ScoreBank(device="cuda")
    one = bank.load_database(db, max_query_len=256)
    sharded = bank.load_database_sharded(db, cuda_mesh, max_query_len=256)
    assert sharded.n_shards == 4 and all(s.is_cuda and s.is_contiguous()
                                         for s in sharded.streams)
    queries = [query, rng.integers(0, 4, size=200).astype(np.int8)]
    launches = (port.stream_strip_cuda.launches, port.stream_chain_cuda.launches)
    many = bank.score_loaded_many_sharded(queries, sharded)
    assert (port.stream_strip_cuda.launches - launches[0],
            port.stream_chain_cuda.launches - launches[1]) == (4, 4)  # a chain a shard
    for q, r in zip(queries, many):
        want = bank.score_loaded(q, one)
        np.testing.assert_array_equal(r.scores, want.scores)
        np.testing.assert_array_equal(bank.score_loaded_sharded(q, sharded).scores,
                                      want.scores)
        assert bank.topk_loaded_sharded(q, sharded, k=10) == bank.topk_loaded(q, one, k=10)
    top = bank.topk_loaded_sharded(query, sharded, k=10)
    assert top == [(500, i) for i in range(0, 5000, 500)]
    engine = ServeEngine(bank, db.names, db, db=sharded)
    seq = decode_seq(query)
    assert engine.handle(f"TOP 3 {seq}") == [f"# top: >db{i} score: 500"
                                             for i in (0, 500, 1000)]
    assert sharded.order_dev.device.type == "cuda"


def test_default_suite_on_the_card(cuda_device):
    """swtpu_torch.testing.suite on the card: suites/default.json's
    outcomes equal the CPU's field for field, and every one passes or is
    one of swtpu's skips; the stream corruptions are caught on the wire
    path the card takes."""
    import dataclasses
    from pathlib import Path

    from swtpu_torch.testing.suite import run_suite

    path = Path(__file__).resolve().parent.parent / "suites" / "default.json"
    got = run_suite(path)
    assert ([dataclasses.asdict(o) for o in got]
            == [dataclasses.asdict(o) for o in run_suite(path, device="cpu")])
    assert all(o.passed for o in got)
    assert [o.name for o in got if o.skipped] == ["multihost", "lying_device"]
    assert [o.detail for o in got if o.name == "corruption_inject_stream"] == [
        "stream codes: caught; stream scores: caught"] * 2


def test_bench_headline_stage_on_the_card(cuda_device):
    """swtpu_torch.bench's headline stage on the card at swtpu's shape:
    every launch's 64-score window equals the oracle (the stage raises
    otherwise), float32 state, (a)'s cells, and a positive rate no lower
    than the floor."""
    from swtpu_torch import bench

    res = bench.STAGES["stream_chain"](cuda_device)
    assert res["cells"] == 262144 * 128 * 128
    assert res["state_dtype"] == "float32" and list(res["times_s"]) == ["1", "33"]
    assert 0 < res["floor"] <= res["gcups"] <= 3 * res["floor"]


@pytest.mark.parametrize("state", ["int32", "float32"])
def test_ladder_4095_query_on_the_card(cuda_device, state):
    """chip_smoke.py's case (q) at 4,096 reads: a 4,095-base query against
    reads of 128 bases, every 64th a window of the query.  The stream
    backend's 32 B3 tiles a call = the column path's 16 B5 tiles = the
    oracle on a sample, the windows and the top-10.  The 32 B3 tiles run
    in one launch of the chain kernel."""
    rng = np.random.default_rng(4095)
    n, L = 4096, 128
    query = rng.integers(0, 4, size=4095).astype(np.int8)
    mat = rng.integers(0, 4, size=(n, L)).astype(np.int8)
    windows = np.arange(0, n, 64)
    for r, off in zip(windows, rng.integers(0, 4095 - L + 1, size=len(windows))):
        mat[r] = query[off : off + L]
    db = EncodedDB([f"db{i}" for i in range(n)], mat, np.full(n, L, np.int32))
    port.stream_chain_cuda.launches = column.column_chained_cuda.launches = 0
    port.stream_chained_cuda.launches = 0
    got = ScoreBank(SWConfig(stream_state_dtype=state), backend="stream",
                    device=cuda_device).score_database(query, db)
    assert (port.stream_chain_cuda.launches, port.stream_chained_cuda.launches) == (1, 0)
    col = ScoreBank(backend="pallas", device=cuda_device).score_database(query, db)
    assert column.column_chained_cuda.launches == 16
    np.testing.assert_array_equal(got.scores, col.scores)
    idx = np.unique(np.concatenate([rng.choice(n, size=32, replace=False), windows,
                                    [i for _, i in got.top_k(10)]]))
    want = score_many_vs_one(query, [db.read(i) for i in idx])
    np.testing.assert_array_equal(got.scores[idx], want)
    assert (got.scores[windows] == 5 * L).all()
