"""The port's long-query path (queries over 128 bases, chained 128-row
tiles) against swtpu's in interpret mode and the oracle: packing field for
field, per-tile strips bit for bit, scores exactly.  The CUDA kernel's own
tests are in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.bank import streams as ref_streams
from swtpu.config import DEFAULT_PENALTIES, Penalties
from swtpu.ops import pallas_stream as ref
from swtpu.oracle import score_many_vs_one
from swtpu_torch.bank import streams
from swtpu_torch.ops import stream as port

torch.set_num_threads(1)

CUSTOM = Penalties(match=3, mismatch=-2, gap_open=-5, gap_extend=-1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _reads(rng, n, hi=50):
    """n reads of 0..hi-1 bases; reads 2 and 5 are zero-length."""
    lens = rng.integers(1, hi, size=n)
    lens[[2, 5]] = 0
    return [rng.integers(0, 4, size=k).astype(np.int8) for k in lens]


def _assert_same_batch(got, want):
    for f in ("q", "stream", "emit_stream", "emit_step"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.cells == want.cells
    assert (got.segments, got.rows) == (want.segments, want.rows)
    assert got.emit_regular == want.emit_regular


def _targets(rng, form):
    """(targets, extra pack_streams_long arguments) in one input form."""
    if form == "list":
        return _reads(rng, 40), {}
    if form == "dense":
        lens = rng.integers(0, 60, size=300).astype(np.int32)
        lens[[1, 7]] = 0
        mat = rng.integers(0, 4, size=(300, 60)).astype(np.int8)
        mat[np.arange(60)[None, :] >= lens[:, None]] = 4
        return mat, {"lens": lens}
    return list(rng.integers(0, 4, size=(24, 30)).astype(np.int8)), {}  # equal


@pytest.mark.parametrize("form", ["list", "dense", "equal"])
@pytest.mark.parametrize("rows", [1, 2, 4, 16])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_pack_streams_long_matches_swtpu(K, rows, form):
    rng = np.random.default_rng(K * 100 + rows * 3 + len(form))
    query = rng.integers(0, 4, size=128 * K - 5).astype(np.int8)
    targets, kw = _targets(rng, form)
    got = streams.pack_streams_long(query, targets, n_streams=8, rows=rows, **kw)
    want = ref_streams.pack_streams_long(query, targets, n_streams=8, rows=rows, **kw)
    _assert_same_batch(got, want)
    assert got.q.shape == (8, 128 * K)
    assert (got.emit_regular is not None) == (form == "equal")


@pytest.mark.parametrize("k", [0, 1, 14, 127])
def test_shift_steps_matches_swtpu(k):
    x = np.random.default_rng(k).integers(-50, 50, size=(160, 8)).astype(np.int32)
    got = port._shift_steps(_t(x), k)
    want = np.asarray(ref._shift_steps(jnp.asarray(x), k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows,penalties", [(1, DEFAULT_PENALTIES), (2, CUSTOM), (4, DEFAULT_PENALTIES)])
def test_chained_tile_strips_equal_swtpu_interpret(rows, penalties):
    """All four strips of one tile, on non-zero random boundary strips."""
    rng = np.random.default_rng(rows + 300)
    b = streams.pack_streams(np.zeros(1, np.int8), _reads(rng, 16, 30), n_streams=8, rows=rows)
    sk = np.ascontiguousarray(b.stream.T)
    qk = rng.integers(0, 4, size=(128, 8)).astype(np.int8)
    qk[-5:] = 5  # query pad rows
    bounds = [rng.integers(-20, 60, size=sk.shape).astype(np.int32) for _ in range(3)]
    got = port.stream_chained_reference(_t(qk), _t(sk), *map(_t, bounds), penalties, rows)
    want = ref._strip_call_chained(
        qk, sk, *bounds, *penalties.astuple(), True, rows=rows,
    )
    for name, g, w in zip(("acc", "oD", "oG", "oH"), got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == sk.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize(
    "qlen,rows,penalties",
    [(129, 2, DEFAULT_PENALTIES), (200, 4, CUSTOM), (257, 1, DEFAULT_PENALTIES),
     (520, 4, CUSTOM)],
)
def test_long_scores_equal_swtpu_and_oracle(qlen, rows, penalties):
    rng = np.random.default_rng(qlen)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    targets = _reads(rng, 30)
    b = streams.pack_streams_long(query, targets, n_streams=8, rows=rows)
    step32 = b.emit_step.astype(np.int32)
    got = port.sw_scores_stream_long(
        _t(b.q), _t(b.stream), _t(b.emit_stream), _t(step32), penalties, rows=rows,
    )
    want = np.asarray(ref.sw_scores_stream_long(
        b.q, b.stream, b.emit_stream, step32, penalties, interpret=True, rows=rows,
    ))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, score_many_vs_one(query, targets, penalties))
    assert got[2] == got[5] == 0  # the zero-length reads


@pytest.mark.parametrize("rows", [1, 4])
def test_one_tile_chain_is_the_single_tile_strip(rows):
    """K = 1 (zero boundary strips) equals the wavefront at segments 1."""
    rng = np.random.default_rng(rows + 400)
    query = rng.integers(0, 4, size=100).astype(np.int8)
    targets = _reads(rng, 30)
    b = streams.pack_streams_long(query, targets, n_streams=8, rows=rows)
    short = streams.pack_streams(query, targets, n_streams=8, rows=rows)
    np.testing.assert_array_equal(b.stream, short.stream)
    sk = _t(b.stream.T)
    chain = port._long_strip(_t(b.q), sk, DEFAULT_PENALTIES, rows)
    qk = port._q_kernel_layout(_t(b.q), 1, rows).to(torch.int8).contiguous()
    np.testing.assert_array_equal(
        chain.numpy(), port.stream_strip_reference(qk, sk, DEFAULT_PENALTIES, 1, rows).numpy()
    )
    args = (_t(b.q), _t(b.stream), _t(b.emit_stream), _t(b.emit_step))
    np.testing.assert_array_equal(
        port.sw_scores_stream_long(*args, rows=rows).numpy(),
        port.sw_scores_stream(*args, rows=rows).numpy(),
    )


def test_gap_spanning_the_tile_boundary():
    """A 60-base insertion in the query across its rows 100-159 (tiles 0
    and 1): the best alignment takes the gap, so the G carry between
    tiles decides the score."""
    rng = np.random.default_rng(9)
    read = rng.integers(0, 4, size=200).astype(np.int8)
    query = np.concatenate([read[:100], rng.integers(0, 4, size=60).astype(np.int8), read[100:]])
    targets = [read] + _reads(rng, 15)
    want = score_many_vs_one(query, targets)
    assert want[0] > 5 * 100  # more than either half alone
    b = streams.pack_streams_long(query, targets, n_streams=4, rows=4)
    got = port.sw_scores_stream_long(
        _t(b.q), _t(b.stream), _t(b.emit_stream), _t(b.emit_step), rows=4,
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_long_entries_agree():
    """The 2-bit wire entry equals the unpacked one, and the kernel-layout
    entry (a [T, N] stream) the logical one."""
    rng = np.random.default_rng(11)
    query = rng.integers(0, 4, size=300).astype(np.int8)
    targets = _reads(rng, 30)
    b = streams.pack_streams_long(query, targets, n_streams=8, rows=2)
    step32 = _t(b.emit_step.astype(np.int32))
    logical = port.sw_scores_stream_long(
        _t(b.q), _t(b.stream), _t(b.emit_stream), step32, rows=2,
    )
    codes, flags = streams.pack_stream_wire(b.stream)
    packed = port.sw_scores_stream_long_packed(
        _t(b.q), _t(codes), _t(flags), _t(b.emit_stream), step32, rows=2,
    )
    layout = port.sw_scores_stream_long_kernel_layout(
        _t(b.q), _t(b.stream.T), _t(b.emit_stream), step32, rows=2,
    )
    np.testing.assert_array_equal(logical.numpy(), score_many_vs_one(query, targets))
    np.testing.assert_array_equal(packed.numpy(), logical.numpy())
    np.testing.assert_array_equal(layout.numpy(), logical.numpy())


def test_regular_gather_on_long_queries():
    rng = np.random.default_rng(12)
    query = rng.integers(0, 4, size=180).astype(np.int8)
    mat = rng.integers(0, 4, size=(24, 21)).astype(np.int8)
    b = streams.pack_streams_long(query, mat, n_streams=8, rows=4)
    assert b.emit_regular is not None
    args = (_t(b.q), _t(b.stream), _t(b.emit_stream), _t(b.emit_step))
    regular = port.sw_scores_stream_long(*args, rows=4, emit_regular=b.emit_regular)
    scatter = port.sw_scores_stream_long(*args, rows=4)
    np.testing.assert_array_equal(regular.numpy(), scatter.numpy())
    np.testing.assert_array_equal(regular.numpy(), score_many_vs_one(query, list(mat)))


@pytest.mark.parametrize(
    "q_width,T,rows", [(200, 32, 16), (256, 40, 16), (256, 32, 3), (256, 32, 32)],
)
def test_validate_long_errors_match(q_width, T, rows):
    q = np.zeros((8, q_width), np.int8)
    with pytest.raises(ValueError) as got:
        port._validate_long(_t(q), T, rows)
    with pytest.raises(ValueError) as want:
        ref._validate_long(q, T, rows, "int32", True, DEFAULT_PENALTIES, n_streams=8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype", ["bfloat16", "int16"])
def test_long_16bit_states_equal_swtpu(dtype):
    """The long-query entries in bfloat16 and int16 state: at their default
    rows (16) swtpu's ValueError; at rows 8 swtpu's scores, on a 300-base
    query whose own read (1,500 exactly) bfloat16 rounds down.  swtpu runs
    at a 2-step chunk (its default 8-step bfloat16 tile takes XLA minutes
    to compile)."""
    rng = np.random.default_rng(23)
    query = rng.integers(0, 4, size=300).astype(np.int8)
    targets = _reads(rng, 30, 80)
    targets[4] = query.copy()
    b = streams.pack_streams_long(query, targets, n_streams=4, rows=8)
    args = (b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32))
    kw = dict(state_dtype=dtype)
    with pytest.raises(ValueError) as got:
        port.sw_scores_stream_long(*map(_t, args), **kw)
    with pytest.raises(ValueError) as want:
        ref.sw_scores_stream_long(*args, interpret=True, **kw)
    assert str(got.value) == str(want.value) == "rows=16 requires a 32-bit state dtype"
    got = port.sw_scores_stream_long(*map(_t, args), rows=8, **kw)
    np.testing.assert_array_equal(
        got.numpy(), port.sw_scores_stream_long_kernel_layout(
            _t(b.q), _t(b.stream.T), *map(_t, args[2:]), rows=8, **kw).numpy())
    want = ref.sw_scores_stream_long(*args, interpret=True, rows=8, chunk=2, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact = score_many_vs_one(query, targets)
    if dtype == "int16":
        np.testing.assert_array_equal(got.numpy(), exact)
    else:
        assert got[4] < exact[4] == 1500


def test_chained_wrapper_takes_cuda_tensors_only():
    sk = torch.zeros((32, 8), dtype=torch.int8)
    qk = torch.zeros((128, 8), dtype=torch.int8)
    b = torch.zeros((32, 8), dtype=torch.int32)
    launches = port.stream_chained_cuda.launches
    with pytest.raises(ValueError, match="qk must be a CUDA int8 tensor"):
        port.stream_chained_cuda(qk, sk, b, b, b, DEFAULT_PENALTIES, 16)
    meta = [x.to("meta") for x in (qk, sk, b, b, b)]
    with pytest.raises(ValueError, match="no chained wavefront kernel"):
        port._strip_call_chained(*meta, DEFAULT_PENALTIES, 16)
    assert port.stream_chained_cuda.launches == launches
