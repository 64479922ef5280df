"""The port's column kernels' plain versions (B4 and B5) against swtpu's
interpret-mode Pallas kernels and the oracles: scores, one chained tile's
h/ms/is strips, exact and wrap-parity modes.  All integers: bit-equal.
The CUDA kernels' own tests are in test_torch_cuda.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from swtpu.config import DEFAULT_PENALTIES, Penalties
from swtpu.ops import common as ref_common
from swtpu.ops.pallas_kernel import _sw_kernel_chained, sw_scores_pallas
from swtpu.oracle import sw_score_batch, sw_score_single, sw_score_single_biased
from swtpu_torch.ops import column, common
from swtpu_torch.testing.gaps import long_gap_pairs

torch.set_num_threads(1)

CUSTOM = Penalties(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ragged(rng, B, m_max, n_max):
    q_lens = rng.integers(1, m_max + 1, size=B)
    t_lens = rng.integers(1, n_max + 1, size=B)
    q = rng.integers(0, 4, size=(B, m_max)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n_max)).astype(np.int8)
    return q, q_lens, t, t_lens


def _biased(q, q_lens, t, t_lens, width, pen=DEFAULT_PENALTIES):
    return np.array(
        [sw_score_single_biased(q[i, : q_lens[i]], t[i, : t_lens[i]], pen, width)
         for i in range(len(q_lens))],
        dtype=np.int32,
    )


def _swtpu(qp, tp, pen=DEFAULT_PENALTIES, **kw):
    return np.asarray(
        sw_scores_pallas(qp, tp, pen, block_pairs=128, interpret=True, unroll=1, **kw)
    )


def _port(qp, tp, pen=DEFAULT_PENALTIES, **kw):
    got = column.sw_scores_column(_t(qp), _t(tp), pen, **kw)
    assert got.dtype == torch.int32
    return got.numpy()


@pytest.mark.parametrize(
    "B,m,n,seed,pen",
    [
        (8, 8, 8, 0, DEFAULT_PENALTIES),
        (16, 32, 32, 1, DEFAULT_PENALTIES),
        (4, 16, 64, 3, DEFAULT_PENALTIES),
        (8, 24, 24, 7, CUSTOM),  # custom penalties
        (5, 16, 16, 11, DEFAULT_PENALTIES),  # B not a multiple of the block
        (4, 136, 16, 21, DEFAULT_PENALTIES),  # m > 128 on one tile
    ],
)
def test_scores_equal_swtpu_and_oracle(B, m, n, seed, pen):
    rng = np.random.default_rng(seed)
    q, q_lens, t, t_lens = _ragged(rng, B, m, n)
    qp, tp = common.sentinel_pad_batch(q, q_lens, t, t_lens)
    got = _port(qp, tp, pen)
    np.testing.assert_array_equal(got, sw_score_batch(q, t, q_lens, t_lens, pen))
    np.testing.assert_array_equal(got, _swtpu(qp, tp, pen))


@pytest.mark.parametrize("width", [12, 10])
def test_biased_scores_equal_swtpu_and_oracle(width):
    rng = np.random.default_rng(1)
    q, q_lens, t, t_lens = _ragged(rng, 8, 32, 32)
    qp, tp = common.sentinel_pad_batch(q, q_lens, t, t_lens)
    kw = dict(state_dtype="int16_biased", score_width=width)
    got = _port(qp, tp, **kw)
    np.testing.assert_array_equal(got, _biased(q, q_lens, t, t_lens, width))
    np.testing.assert_array_equal(got, _swtpu(qp, tp, **kw))


def test_biased_overflow_wrap():
    """An overflowing identical 128-base pair beside in-range random
    pairs: the per-cell wrap and clamp, not the exact score."""
    rng = np.random.default_rng(2)
    q = rng.integers(0, 4, size=(4, 128)).astype(np.int8)
    t = rng.integers(0, 4, size=(4, 128)).astype(np.int8)
    q[0] = t[0] = np.tile(np.arange(4, dtype=np.int8), 32)
    lens = np.full((4,), 128)
    want = _biased(q, lens, t, lens, 10)
    assert want[0] == 510 and sw_score_single(q[0], t[0]) == 640
    kw = dict(state_dtype="int16_biased", score_width=10)
    got = _port(q, t, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _swtpu(q, t, **kw))


def test_biased_in_range_equals_exact():
    rng = np.random.default_rng(3)
    q, q_lens, t, t_lens = _ragged(rng, 6, 24, 48)
    qp, tp = common.sentinel_pad_batch(q, q_lens, t, t_lens)
    got = _port(qp, tp, state_dtype="int16_biased", score_width=12)
    np.testing.assert_array_equal(got, sw_score_batch(q, t, q_lens, t_lens))


def test_chained_scores_equal_swtpu():
    """m = 300 takes two chained tiles in both packages."""
    rng = np.random.default_rng(5)
    q, q_lens, t, t_lens = _ragged(rng, 3, 300, 16)
    q_lens[0] = 300
    qp, tp = common.sentinel_pad_batch(q, q_lens, t, t_lens)
    got = _port(qp, tp)
    np.testing.assert_array_equal(got, sw_score_batch(q, t, q_lens, t_lens))
    np.testing.assert_array_equal(got, _swtpu(qp, tp))


def _swtpu_tile(q, t, ms, is_, h, pen, width, dt=jnp.int32):
    """One interpret-mode launch of swtpu's _sw_kernel_chained on [B, ...]
    inputs (pairs padded to a 128-lane block, as sw_scores_pallas does);
    returns (h [B], ms [B, n], is_ [B, n])."""
    ma, mi, go, ge = pen.astuple()
    B, n = t.shape
    bt = 128
    pad = ((0, bt - B), (0, 0))
    qT = np.pad(q, pad, constant_values=ref_common.Q_PAD).T
    tT = np.pad(t, pad, constant_values=ref_common.T_PAD).T
    msT, isT = (np.pad(s, pad).T for s in (ms, is_))
    kernel = functools.partial(
        _sw_kernel_chained, ma=ma, mi=mi, go=go, ge=ge, unroll=1, chunk=8,
        dt=dt, biased_width=width,
    )
    strip = pl.BlockSpec((n, bt), lambda b: (0, b), memory_space=pltpu.VMEM)
    hspec = pl.BlockSpec((1, bt), lambda b: (0, b), memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        kernel,
        grid=(1,),
        in_specs=[
            pl.BlockSpec((256, bt), lambda b: (0, b), memory_space=pltpu.VMEM),
            strip, strip, strip, hspec,
        ],
        out_specs=(hspec, strip, strip),
        out_shape=(
            jax.ShapeDtypeStruct((1, bt), jnp.int32),
            jax.ShapeDtypeStruct((n, bt), jnp.int32),
            jax.ShapeDtypeStruct((n, bt), jnp.int32),
        ),
        interpret=True,
    )(qT, tT, msT, isT, np.pad(h, (0, bt - B))[None, :])
    oh, oms, ois = (np.asarray(x) for x in out)
    return oh[0, :B], oms[:, :B].T, ois[:, :B].T


@pytest.mark.parametrize("width,state_dtype", [(None, "int32"), (10, "int32"),
                                               (None, "float32"), (None, "int16")])
def test_chained_tile_strips_equal_swtpu(width, state_dtype):
    """One tile with non-zero incoming strips: the port's plain tile on
    the 13 real columns, swtpu's on them padded to 16 (its chunk), the
    strips with (biased) zero.  A tile is causal in j, so the first 13
    strip columns must agree, and the pad columns cannot raise h."""
    rng = np.random.default_rng(17 if width is None else 18)
    z = 0 if width is None else 1 << (width - 1)
    B, n, npad = 3, 13, 16
    q = rng.integers(0, 4, size=(B, 256)).astype(np.int8)
    q[1, 200:] = common.Q_PAD
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    t[0] = q[0, 243:]  # the tile's tail rows match: strips out rise
    ms = rng.integers(z, z + 60, size=(B, n)).astype(np.int32)
    is_ = rng.integers(z - 10, z + 50, size=(B, n)).astype(np.int32)
    h = (max(ms.max(), is_.max()) + rng.integers(0, 5, size=B)).astype(np.int32)
    got = column.column_chained_reference(
        _t(q), _t(t), _t(ms), _t(is_), _t(h), DEFAULT_PENALTIES, width, state_dtype
    )
    padc = ((0, 0), (0, npad - n))
    want = _swtpu_tile(
        q, np.pad(t, padc, constant_values=common.T_PAD),
        np.pad(ms, padc, constant_values=z), np.pad(is_, padc, constant_values=z),
        h, DEFAULT_PENALTIES, width, getattr(jnp, state_dtype),
    )
    for name, g, w in zip(("h", "ms", "is_"), got, want):
        assert g.dtype == torch.int32 and g.shape == (B, n)[: g.dim()]
        np.testing.assert_array_equal(g.numpy(), w[..., :n], err_msg=name)
    assert (got[1].numpy() != z).any()


def test_chained_gap_spans_tiles():
    """A 300-base insertion across the tile boundary: the I strip carry."""
    rng = np.random.default_rng(9)
    tseq = rng.integers(0, 4, size=80).astype(np.int8)
    q = np.concatenate([tseq[:40], rng.integers(0, 4, size=300).astype(np.int8), tseq[40:]])
    want = sw_score_batch(q[None], tseq[None], np.array([len(q)]), np.array([80]))
    np.testing.assert_array_equal(_port(q[None], tseq[None]), want)


def test_chained_4000_base_query():
    """16 tiles, the reference's LEN_WIDTH envelope."""
    rng = np.random.default_rng(7)
    q, q_lens, t, t_lens = _ragged(rng, 3, 4000, 24)
    q_lens[0] = 4000
    qp, tp = common.sentinel_pad_batch(q, q_lens, t, t_lens)
    np.testing.assert_array_equal(_port(qp, tp), sw_score_batch(q, t, q_lens, t_lens))


def test_chained_biased_wraps():
    """An identical 300-base pair scores 1500 exactly: past the 10-bit
    ceiling, and the biased strips carry the wrap across the tiles."""
    seq = np.tile(np.arange(4, dtype=np.int8), 75)
    rng = np.random.default_rng(4)
    q = np.stack([seq, rng.integers(0, 4, size=300).astype(np.int8)])
    t = np.stack([seq, rng.integers(0, 4, size=300).astype(np.int8)])
    lens = np.full((2,), 300)
    want = _biased(q, lens, t, lens, 10)
    assert want[0] < 1500
    got = _port(q, t, state_dtype="int16_biased", score_width=10)
    np.testing.assert_array_equal(got, want)


def test_padding_rules():
    """swtpu's padding: queries to 8 rows or 256 when chained, targets to
    the chunk; sentinels only."""
    q = _t(np.zeros((3, 9), np.int8))
    t = _t(np.zeros((3, 33), np.int8))
    qp, tp = column.pad_column_batch(q, t, column.T_CHUNK)
    assert qp.shape == (3, 16) and tp.shape == (3, 64)
    assert (qp[:, 9:] == common.Q_PAD).all() and (tp[:, 33:] == common.T_PAD).all()
    qp, tp = column.pad_column_batch(_t(np.zeros((3, 257), np.int8)), t, column.CPU_CHUNK)
    assert qp.shape == (3, 512) and tp.shape == (3, 40)


@pytest.mark.parametrize("width,pen", [(1, DEFAULT_PENALTIES), (31, DEFAULT_PENALTIES), (5, DEFAULT_PENALTIES), (3, CUSTOM)])
def test_width_checks_match_swtpu(width, pen):
    q = np.zeros((2, 8), np.int8)
    with pytest.raises(ValueError) as e:
        _port(q, q, pen, state_dtype="int16_biased", score_width=width)
    with pytest.raises(ValueError) as e_ref:
        _swtpu(q, q, pen, state_dtype="int16_biased", score_width=width)
    assert str(e.value) == str(e_ref.value)


@pytest.mark.parametrize("state_dtype", ["float32", "int16"])
def test_exact_states_equal_swtpu_on_a_256_row_bucket(state_dtype):
    """B4 in float32 and int16 state (swtpu's floors -2^23 and -2^13 in its
    prefix scan) at the 256-row shape against a 32-column target bucket:
    swtpu's scores, the oracle's, and int32's."""
    rng = np.random.default_rng(31)
    q, q_lens, t, t_lens = _ragged(rng, 6, 256, 32)
    q_lens[0] = 256
    qp, tp = common.sentinel_pad_batch(q, q_lens, t, t_lens)
    got = _port(qp, tp, state_dtype=state_dtype)
    np.testing.assert_array_equal(got, _swtpu(qp, tp, state_dtype=state_dtype))
    np.testing.assert_array_equal(got, sw_score_batch(q, t, q_lens, t_lens))
    np.testing.assert_array_equal(got, _port(qp, tp))


# the long-gap modes: (swtpu's state_dtype, score width or None)
LONG_GAP_MODES = [("int32", None), ("int16_biased", 12), ("float32", None)]


@pytest.mark.parametrize("state_dtype,width", LONG_GAP_MODES)
@pytest.mark.parametrize("m", [32, 128, 256])
def test_long_gap_pairs_equal_swtpu_and_oracle(m, state_dtype, width):
    """Targets that are their queries with 8-200 bases cut out (and
    self-pairs), so the in-del chain runs far down the column, across many
    of the CUDA kernel's lanes: the plain version = swtpu's interpret-mode
    kernel = the oracle, at tolerance 0."""
    q, t = long_gap_pairs(np.random.default_rng(40 + m), 8, m)
    kw = dict(state_dtype=state_dtype) if width is None else dict(
        state_dtype=state_dtype, score_width=width)
    got = _port(q, t, **kw)
    lens = np.full(8, m)
    t_lens = (t != common.T_PAD).sum(1)
    want = (_biased(q, lens, t, t_lens, width) if width
            else sw_score_batch(q, t, lens, t_lens))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _swtpu(q, t, **kw))
    assert (want[::8] == 5 * m).all()  # the self-pairs


def test_int16_chain_past_8191():
    """A two-tile chain (B5) in int16 state whose self-matching 300-base
    pair scores 12,000 at +40 a match: past the 8,191 that swtpu's int16
    floor of -2^13 leaves room for, yet exact in both packages, so no floor
    wins; every pair equals swtpu, the oracle and int32.  (float32's tile
    is held in test_chained_tile_strips_equal_swtpu.)"""
    state_dtype = "int16"
    rng = np.random.default_rng(32)
    pen = Penalties(match=40, mismatch=-4, gap_open=-12, gap_extend=-4)
    q, q_lens, t, t_lens = _ragged(rng, 3, 300, 300)
    t[0] = q[0]
    q_lens[0] = t_lens[0] = 300
    qp, tp = common.sentinel_pad_batch(q, q_lens, t, t_lens)
    got = _port(qp, tp, pen, state_dtype=state_dtype)
    want = sw_score_batch(q, t, q_lens, t_lens, pen)
    assert want[0] == 12000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _swtpu(qp, tp, pen, state_dtype=state_dtype))
    np.testing.assert_array_equal(got, _port(qp, tp, pen))


@pytest.mark.parametrize("m", [8, 256, 300])
@pytest.mark.parametrize("pen", [Penalties(5, -4, -12, -300), Penalties(5, -4, -40000, -4)])
def test_int16_overflow_equals_swtpu(pen, m):
    """A penalty that int16 state cannot hold raises swtpu's OverflowError,
    found in swtpu's order (open + extend; k x extend of the prefix scan,
    which reaches 128 x extend only at 256 rows)."""
    q = np.zeros((2, m), np.int8)
    outcomes = []
    for run in (_port, _swtpu):
        try:
            run(q, q, pen, state_dtype="int16")
            outcomes.append("ok")
        except OverflowError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] == ("ok" if m == 8 and pen.gap_extend == -300
                           else f"Python integer {-38400 if pen.gap_extend == -300 else -40004} "
                           "out of bounds for int16")


@pytest.mark.parametrize("seed", [0, 1])
def test_sentinel_padding_equals_swtpu(seed):
    rng = np.random.default_rng(seed)
    q, q_lens, t, t_lens = _ragged(rng, 6, 20, 30)
    got = common.sentinel_pad_batch(q, q_lens, t, t_lens, q_pad_len=24, t_pad_len=32)
    want = ref_common.sentinel_pad_batch(q, q_lens, t, t_lens, q_pad_len=24, t_pad_len=32)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        common.pad_to_static(t, t_lens, common.T_PAD, 30),
        ref_common.pad_to_static(t, t_lens, ref_common.T_PAD, 30),
    )
    with pytest.raises(ValueError, match="pad_len=10 < max sequence length"):
        common.pad_to_static(t, np.full(6, 20), common.T_PAD, 10)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels take CUDA tensors only; no launch is counted."""
    q = _t(np.zeros((2, 256), np.int8))
    t = _t(np.zeros((2, 32), np.int8))
    s = _t(np.zeros((2, 32), np.int32))
    h = _t(np.zeros(2, np.int32))
    launches = (column.column_scores_cuda.launches, column.column_chained_cuda.launches)
    with pytest.raises(ValueError, match="q must be a CUDA int8 tensor"):
        column.column_scores_cuda(q, t)
    with pytest.raises(ValueError, match="q must be a CUDA int8 tensor"):
        column.column_chained_cuda(q, t, s, s, h)
    assert (column.column_scores_cuda.launches, column.column_chained_cuda.launches) == launches


@pytest.mark.parametrize("m,state_dtype,geometry", [
    (1, "int32", (1, 8, 32)), (8, "int32", (1, 8, 32)), (16, "int32", (2, 8, 16)),
    (32, "int32", (4, 8, 8)), (40, "int32", (8, 8, 4)), (64, "float32", (8, 8, 4)),
    (65, "int32", (16, 8, 2)), (128, "int32", (16, 8, 2)), (136, "float32", (32, 8, 1)),
    (256, "int32", (32, 8, 1)), (1, "int16", (32, 1, 2)), (32, "int16", (32, 1, 2)),
    (40, "int16", (32, 2, 2)), (64, "int16", (32, 2, 2)), (65, "int16", (32, 4, 2)),
    (128, "int16", (32, 4, 2)), (136, "int16", (32, 8, 2)), (256, "int16", (32, 8, 2)),
])
def test_rows_per_lane_covers_the_query(m, state_dtype, geometry):
    """The CUDA kernel's instantiation for a query of m rows: (lanes a pair,
    rows a lane, pairs a warp), B4's fewest lanes of 8 rows that cover m in
    the one-value states, int16's fewest rows over 32 lanes, two pairs a
    warp (swtpu_column_scores' choice)."""
    assert column.column_geometry(m, state_dtype) == geometry


@pytest.mark.parametrize("state_dtype", ["int32", "float32", "int16"])
def test_column_geometry_at_every_width(state_dtype):
    """At every query width 1..256: the lanes of a pair cover the query, a
    warp's pairs fill its 32 lanes, and no smaller power of two of lanes
    (one-value states) or rows (int16) would cover it."""
    for m in range(1, column.QUERY_TILE + 1):
        lanes, rows, pairs = column.column_geometry(m, state_dtype)
        assert lanes * rows >= m
        assert lanes & (lanes - 1) == 0 and rows & (rows - 1) == 0
        if state_dtype == "int16":  # two pairs in the halves of each register
            assert (lanes, pairs) == (32, 2) and (rows == 1 or 32 * rows // 2 < m)
        else:
            assert lanes * pairs == 32 and rows == column.ROWS_PER_LANE
            assert lanes == 1 or lanes // 2 * rows < m
    for m in (0, column.QUERY_TILE + 1):
        with pytest.raises(ValueError, match=f"query width {m}"):
            column.column_geometry(m, state_dtype)


@pytest.mark.parametrize("kw,match", [
    (dict(m=300), "query width 300"), (dict(m=0), "query width 0"),
    (dict(state_dtype="uint16"), "unknown state_dtype"),
    (dict(score_width=40), "score_width=40 out of range"),
])
def test_column_kernel_info_checks_before_the_library(kw, match):
    """column_kernel_info refuses an instantiation that does not exist
    before it loads the kernel library."""
    with pytest.raises(ValueError, match=match):
        column.column_kernel_info(**kw)
