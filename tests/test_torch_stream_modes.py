"""The wavefront's state modes beside exact int32 state: the RTL's W-bit
biased wrap-parity (score_width), float32 state, and int16, uint16 and
bfloat16 state, in the plain versions of B1/B2 (one tile) and B3 (chained
tiles), the entry points and ScoreBank's stream backend, against swtpu's
kernels in interpret mode and the oracles, at tolerance 0.  The CUDA
kernels' own tests are in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from swtpu.bank import ScoreBank as RefBank
from swtpu.config import DEFAULT_PENALTIES, Penalties
from swtpu.config import SWConfig as RefConfig
from swtpu.ops import pallas_stream as ref
from swtpu.oracle import score_many_vs_one, sw_score_single_biased
from swtpu_torch.bank import ScoreBank, streams
from swtpu_torch.config import SWConfig
from swtpu_torch.ops import stream as port

torch.set_num_threads(1)

# swtpu's interpret-mode kernels run at this grid chunk here: the strip
# does not depend on the chunk, and at rows 16 the default 8-step body
# takes ~30 s to trace, a 2-step one ~3 s
REF_CHUNK = 2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _penalties(width, qlen):
    """The default penalties at 8 bits (a read equal to a query of 26 bases
    or more passes the ceiling); at wider widths a match large enough that
    the query's own read passes it, since one tile's query is too short to
    reach 2^11 at +5 a match."""
    if width is None or width == 8:
        return DEFAULT_PENALTIES
    return Penalties(match=(1 << (width - 1)) // qlen + 3, mismatch=-4, gap_open=-12,
                     gap_extend=-4)


def _batch(seed, segments, rows, phys=4, n=None, hi=40):
    """(query, targets, batch): ragged reads of 0..hi-1 bases, read 3 of
    length 0, and reads 0 and 5 equal to the query, so that they pass the
    ceiling of a narrow width."""
    rng = np.random.default_rng(seed)
    n = n or phys * segments * 3
    query = rng.integers(0, 4, size=128 // segments - 2).astype(np.int8)
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in rng.integers(1, hi, size=n)]
    targets[3] = np.zeros(0, np.int8)
    targets[0] = targets[5] = query.copy()
    b = streams.pack_streams(query, targets, n_streams=phys * segments, segments=segments,
                             rows=rows)
    return query, targets, b


def _ref_strip(b, penalties, segments, rows, tail_acc=True, **mode):
    """swtpu's strip kernel in interpret mode on the batch: [N, T]."""
    qk, sk = ref._to_kernel_layout(b.q, b.stream, segments, rows)
    out = ref._strip_call(qk, sk, *penalties.astuple(), True, seg=segments, tail_acc=tail_acc,
                          rows=rows, chunk=REF_CHUNK, **mode)
    return np.asarray(out).T


def _biased_oracle(query, targets, penalties, width):
    return [sw_score_single_biased(query, t, penalties, width) for t in targets]


# the 16-bit states, each at penalties it takes: uint16 refuses a negative
# open or extend penalty (swtpu's OverflowError), and wraps a mismatch of -4
# to 65532 ("uint16 wrap"); at mismatch 0 it is exact
SIXTEEN_BIT = {
    "int16": ("int16", DEFAULT_PENALTIES),
    "uint16 wrap": ("uint16", Penalties(5, -4, 0, 0)),
    "uint16": ("uint16", Penalties(5, 0, 0, 0)),
    "bfloat16": ("bfloat16", DEFAULT_PENALTIES),
}


def _check_16bit_strip(mode, got, exact, b):
    """What each 16-bit state's strip must show beside the exact one:
    int16 and exact uint16 equal it; uint16 wrap sits at 2^16 - 4 and
    above; bfloat16 rounds a read equal to the query (5 x 126 bases, past
    256) below its exact score."""
    if mode in ("int16", "uint16"):
        np.testing.assert_array_equal(got, exact)
    elif mode == "uint16 wrap":
        assert got.max() >= 65532 and (got != exact).any()
    else:
        scores = streams.gather_stream_scores(got, b)
        exact_scores = streams.gather_stream_scores(exact, b)
        assert scores[0] < exact_scores[0] and (scores <= exact_scores).all()


@pytest.mark.parametrize("width", [8, 12, 16])
@pytest.mark.parametrize("segments,rows", [(1, 1), (1, 4), (2, 8), (4, 4), (1, 16)])
def test_biased_strip_equals_swtpu_interpret_strip(segments, rows, width):
    query, targets, b = _batch(segments * 31 + rows + width, segments, rows)
    pen = _penalties(width, len(query))
    got = port.sw_scores_stream_strip(_t(b.q), _t(b.stream), pen, segments=segments,
                                      rows=rows, score_width=width)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _ref_strip(b, pen, segments, rows,
                                                          score_width=width))
    scores = streams.gather_stream_scores(got.numpy(), b)
    np.testing.assert_array_equal(scores, _biased_oracle(query, targets, pen, width))
    assert scores[0] < pen.match * len(query)  # the query's own read wrapped


@pytest.mark.parametrize("segments", [1, 4])
def test_biased_ripple_h_strip_equals_swtpu_interpret_strip(segments):
    query, targets, b = _batch(segments + 70, segments, 1)
    got = port.sw_scores_stream_strip(_t(b.q), _t(b.stream), segments=segments,
                                      tail_acc=False, score_width=8)
    np.testing.assert_array_equal(
        got.numpy(), _ref_strip(b, DEFAULT_PENALTIES, segments, 1, False, score_width=8))
    scores = streams.gather_stream_scores(got.numpy(), b)
    np.testing.assert_array_equal(scores, _biased_oracle(query, targets, DEFAULT_PENALTIES, 8))


@pytest.mark.parametrize("segments,rows", [(1, 1), (2, 8)])
def test_float32_strip_equals_swtpu_and_int32_strips(segments, rows):
    query, targets, b = _batch(segments + rows + 80, segments, rows)
    args = (_t(b.q), _t(b.stream))
    got = port.sw_scores_stream_strip(*args, segments=segments, rows=rows,
                                      state_dtype="float32")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), _ref_strip(b, DEFAULT_PENALTIES, segments, rows, state_dtype="float32"))
    np.testing.assert_array_equal(
        got.numpy(), port.sw_scores_stream_strip(*args, segments=segments, rows=rows).numpy())
    np.testing.assert_array_equal(streams.gather_stream_scores(got.numpy(), b),
                                  score_many_vs_one(query, targets))


@pytest.mark.parametrize("mode", list(SIXTEEN_BIT))
@pytest.mark.parametrize("segments,rows", [(1, 1), (1, 4), (1, 8), (2, 1), (2, 4), (2, 8)])
def test_16bit_strip_equals_swtpu_interpret_strip(segments, rows, mode):
    dtype, pen = SIXTEEN_BIT[mode]
    query, targets, b = _batch(segments * 31 + rows + 200, segments, rows)
    args = (_t(b.q), _t(b.stream), pen)
    got = port.sw_scores_stream_strip(*args, segments=segments, rows=rows, state_dtype=dtype)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), _ref_strip(b, pen, segments, rows, state_dtype=dtype))
    exact = port.sw_scores_stream_strip(*args, segments=segments, rows=rows)
    _check_16bit_strip(mode, got.numpy(), exact.numpy(), b)


@pytest.mark.parametrize("mode", list(SIXTEEN_BIT))
def test_16bit_ripple_h_strip_equals_swtpu_interpret_strip(mode):
    dtype, pen = SIXTEEN_BIT[mode]
    query, targets, b = _batch(210, 1, 1)
    args = (_t(b.q), _t(b.stream), pen)
    got = port.sw_scores_stream_strip(*args, tail_acc=False, state_dtype=dtype)
    np.testing.assert_array_equal(
        got.numpy(), _ref_strip(b, pen, 1, 1, False, state_dtype=dtype))
    exact = port.sw_scores_stream_strip(*args, tail_acc=False)
    _check_16bit_strip(mode, got.numpy(), exact.numpy(), b)


@pytest.mark.parametrize("mode", list(SIXTEEN_BIT))
def test_16bit_chain_tiles_equal_swtpu_interpret(mode):
    """Both tiles of a K = 2 chain at rows 4 in each 16-bit state, all four
    strips, against swtpu's interpret-mode tile on the port's own inputs
    (the int32 boundary strips cast to the state at the load), and the
    chain's scores against swtpu's long-query entry (both at REF_CHUNK: at
    its default 8-step body XLA takes ~5 min to compile swtpu's bfloat16
    tile)."""
    dtype, pen = SIXTEEN_BIT[mode]
    rng = np.random.default_rng(220)
    rows = 4
    query = rng.integers(0, 4, size=200).astype(np.int8)
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in rng.integers(1, 60, size=12)]
    targets[2] = query.copy()  # 1,000 exactly: bfloat16 rounds it
    b = streams.pack_streams_long(query, targets, n_streams=4, rows=rows)
    tiles = []

    def tile(qk, sk, bD, bG, bH, p, r, **mode_kw):
        got = port.stream_chained_reference(qk, sk, bD, bG, bH, p, r, **mode_kw)
        want = ref._strip_call_chained(qk.numpy(), sk.numpy(), bD.numpy(), bG.numpy(),
                                       bH.numpy(), *p.astuple(), True, rows=r,
                                       chunk=REF_CHUNK, **mode_kw)
        for name, g, w in zip(("acc", "oD", "oG", "oH"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"tile {len(tiles)} {name}")
        tiles.append(got)
        return got

    port._long_strip(_t(b.q), _t(b.stream.T), pen, rows, tile=tile, state_dtype=dtype)
    assert len(tiles) == 2
    emit = (_t(b.emit_stream), _t(b.emit_step.astype(np.int32)))
    got = port.sw_scores_stream_long(_t(b.q), _t(b.stream), *emit, pen, rows=rows,
                                     state_dtype=dtype)
    want = ref.sw_scores_stream_long(b.q, b.stream, b.emit_stream,
                                     b.emit_step.astype(np.int32), pen, interpret=True,
                                     rows=rows, state_dtype=dtype, chunk=REF_CHUNK)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if mode == "bfloat16":
        assert got[2] < 1000


@pytest.mark.parametrize("K", [2, 3])
def test_biased_chain_tiles_equal_swtpu_interpret(K):
    """Every tile of a K-tile chain at W = 12, all four (biased) strips,
    against swtpu's interpret-mode tile on the port's own inputs; the
    first tile's boundaries are the bias, not 0."""
    rng = np.random.default_rng(K + 90)
    rows = 4
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in rng.integers(1, 60, size=12)]
    query = rng.integers(0, 4, size=128 * K - 5).astype(np.int8)
    b = streams.pack_streams_long(query, targets, n_streams=4, rows=rows)
    tiles = []

    def tile(qk, sk, bD, bG, bH, pen, r, **mode):
        got = port.stream_chained_reference(qk, sk, bD, bG, bH, pen, r, **mode)
        want = ref._strip_call_chained(qk.numpy(), sk.numpy(), bD.numpy(), bG.numpy(),
                                       bH.numpy(), *pen.astuple(), True, rows=r, **mode)
        for name, g, w in zip(("acc", "oD", "oG", "oH"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"tile {len(tiles)} {name}")
        if not tiles:
            assert int(bD.min()) == int(bD.max()) == 1 << 11
        tiles.append(got)
        return got

    port._long_strip(_t(b.q), _t(b.stream.T), DEFAULT_PENALTIES, rows, tile=tile,
                     score_width=12)
    assert len(tiles) == K


@pytest.mark.parametrize("entry", ["stream", "kernel_layout", "packed"])
def test_long_query_w12_equals_swtpu_and_biased_oracle(entry):
    """A 450-base query at W = 12: reads equal to it score 2,250 exactly,
    past the 12-bit ceiling, and wrap."""
    rng = np.random.default_rng(91)
    query = rng.integers(0, 4, size=450).astype(np.int8)
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in rng.integers(1, 80, size=14)]
    targets[3] = np.zeros(0, np.int8)
    targets[1] = targets[9] = query.copy()
    b = streams.pack_streams_long(query, targets, n_streams=4, rows=2)
    emit = (_t(b.emit_stream), _t(b.emit_step.astype(np.int32)))
    kw = dict(rows=2, score_width=12, emit_regular=b.emit_regular)
    if entry == "stream":
        got = port.sw_scores_stream_long(_t(b.q), _t(b.stream), *emit, **kw)
    elif entry == "kernel_layout":
        got = port.sw_scores_stream_long_kernel_layout(_t(b.q), _t(b.stream.T), *emit, **kw)
    else:
        codes, flags = streams.pack_stream_wire(b.stream)
        got = port.sw_scores_stream_long_packed(_t(b.q), _t(codes), _t(flags), *emit, **kw)
    want = _biased_oracle(query, targets, DEFAULT_PENALTIES, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[3] == 0 and got[1] == got[9] < 5 * 450
    if entry == "stream":
        ref_scores = ref.sw_scores_stream_long(
            b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32), interpret=True,
            rows=2, score_width=12)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_scores))


def test_long_query_float32_equals_int32_and_oracle():
    rng = np.random.default_rng(92)
    query = rng.integers(0, 4, size=300).astype(np.int8)
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in rng.integers(0, 80, size=14)]
    b = streams.pack_streams_long(query, targets, n_streams=4, rows=4)
    args = (_t(b.q), _t(b.stream), _t(b.emit_stream), _t(b.emit_step))
    got = port.sw_scores_stream_long(*args, rows=4, state_dtype="float32")
    np.testing.assert_array_equal(got.numpy(), port.sw_scores_stream_long(*args, rows=4).numpy())
    np.testing.assert_array_equal(got.numpy(), score_many_vs_one(query, targets))


@pytest.mark.parametrize("entry", ["stream", "packed", "kernel_layout"])
def test_short_entries_take_the_modes(entry):
    """Every short entry passes score_width and state_dtype through."""
    query, targets, b = _batch(93, 2, 8)
    emit = (_t(b.emit_stream), _t(b.emit_step.astype(np.int32)))
    for mode, want in (
        (dict(score_width=8), _biased_oracle(query, targets, DEFAULT_PENALTIES, 8)),
        (dict(state_dtype="float32"), score_many_vs_one(query, targets)),
    ):
        kw = dict(segments=2, rows=8, emit_regular=b.emit_regular, **mode)
        if entry == "stream":
            got = port.sw_scores_stream(_t(b.q), _t(b.stream), *emit, **kw)
        elif entry == "packed":
            codes, flags = streams.pack_stream_wire(b.stream)
            got = port.sw_scores_stream_packed(_t(b.q), _t(codes), _t(flags), *emit, **kw)
        else:
            qk = port._q_kernel_layout(_t(b.q), 2, 8)
            got = port.sw_scores_stream_kernel_layout(qk, _t(b.stream.T), *emit, **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(mode))


# (segments, rows, state dtype, score width, penalties) that swtpu's
# _validate_config refuses
BAD_CONFIGS = [
    (1, 1, "float32", 12, DEFAULT_PENALTIES),
    (1, 1, "int32", 1, DEFAULT_PENALTIES),
    (1, 16, "int32", 31, DEFAULT_PENALTIES),
    (1, 1, "int32", 4, DEFAULT_PENALTIES),  # 8 < |open + extend| + |extend|
    (1, 1, "int32", 5, Penalties(5, -4, -10, -6)),
    (3, 1, "int32", 12, DEFAULT_PENALTIES),
    (16, 1, "float32", None, DEFAULT_PENALTIES),
    (1, 3, "float32", None, DEFAULT_PENALTIES),
    (4, 64, "int32", 12, DEFAULT_PENALTIES),
    (1, 16, "int16", None, DEFAULT_PENALTIES),  # rows 16 needs a 32-bit state
    (1, 16, "uint16", None, Penalties(5, 0, 0, 0)),
    (1, 16, "bfloat16", None, DEFAULT_PENALTIES),
    (1, 1, "bfloat16", 12, DEFAULT_PENALTIES),
]


@pytest.mark.parametrize("config", BAD_CONFIGS)
def test_validation_errors_equal_swtpu(config):
    segments, rows, dtype, width, pen = config
    with pytest.raises(ValueError) as got:
        port._validate_config(segments, rows, dtype, width, pen)
    with pytest.raises(ValueError) as want:
        ref._validate_config(segments, True, rows, dtype, width, pen)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype", ["int16", "uint16", "bfloat16"])
def test_16bit_scores_at_default_penalties_equal_swtpu(dtype):
    """sw_scores_stream in each 16-bit state at the default penalties, as
    swtpu's in interpret mode: the same scores, or for uint16 (open -12)
    the same OverflowError, also from the CUDA wrapper before it looks at
    its tensors."""
    query, targets, b = _batch(230, 1, 1)
    args = (b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32))
    if dtype == "uint16":
        with pytest.raises(OverflowError) as got:
            port.sw_scores_stream(*map(_t, args), state_dtype=dtype)
        with pytest.raises(OverflowError) as want:
            ref.sw_scores_stream(*args, interpret=True, state_dtype=dtype)
        assert str(got.value) == str(want.value) == "Python integer -12 out of bounds for uint16"
        with pytest.raises(OverflowError):
            port.stream_strip_cuda(_t(b.q), _t(b.stream), state_dtype=dtype)
        return
    got = port.sw_scores_stream(*map(_t, args), state_dtype=dtype)
    want = ref.sw_scores_stream(*args, interpret=True, state_dtype=dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact = score_many_vs_one(query, targets)
    if dtype == "int16":
        np.testing.assert_array_equal(got.numpy(), exact)
    else:
        assert got[0] < exact[0]  # the query's own read, 630 exactly, rounds down


@pytest.mark.parametrize("qlen", [20, 128, 450])
def test_score_database_w12_on_stream_equals_swtpu_and_biased_oracle(qlen):
    """ScoreBank(score_width=12, backend="stream") on the CPU, short and
    long queries, against swtpu's stream backend in interpret mode; the
    query's own read wraps at 450 bases (2,250 exactly)."""
    rng = np.random.default_rng(qlen + 94)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    reads = [rng.integers(0, 4, size=k).astype(np.int8) for k in rng.integers(0, 90, size=20)]
    reads[4] = query.copy()
    cfg = dict(score_width=12)
    bank = ScoreBank(SWConfig(**cfg), backend="stream", device="cpu")
    assert bank.backend == "stream"
    got = bank.score_database(query, reads)
    want = RefBank(RefConfig(**cfg), backend="stream", interpret=True).score_database(query, reads)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.scores, _biased_oracle(query, reads, DEFAULT_PENALTIES, 12))
    assert (got.cells, got.padded_cells) == (want.cells, want.padded_cells)
    assert (got.scores[4] == 5 * qlen) == (qlen < 410)


@pytest.mark.parametrize("qlen", [60, 200])
def test_score_database_float32_state_equals_int32(qlen):
    rng = np.random.default_rng(qlen + 95)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    reads = [rng.integers(0, 4, size=k).astype(np.int8) for k in rng.integers(0, 90, size=20)]
    got = ScoreBank(SWConfig(stream_state_dtype="float32"), device="cpu").score_database(
        query, reads)
    np.testing.assert_array_equal(
        got.scores, ScoreBank(device="cpu").score_database(query, reads).scores)
    np.testing.assert_array_equal(got.scores, score_many_vs_one(query, reads))


def test_bank_state_choice():
    """"auto" state is int32, score_width forces int32, float32 is kept;
    'auto' still sends score_width to the column kernels."""
    assert ScoreBank(device="cpu")._stream_dtype() == "int32"
    assert ScoreBank(SWConfig(stream_state_dtype="float32"), device="cpu")._stream_dtype() == "float32"
    wbank = ScoreBank(SWConfig(score_width=12, stream_state_dtype="float32"), device="cpu",
                      backend="stream")
    assert wbank._stream_dtype() == "int32"
    assert ScoreBank(SWConfig(score_width=12), device="cpu").backend == "pallas"
