"""swtpu_torch.ops.stream against swtpu.ops.pallas_stream (interpret mode)
and the oracle: raw strips bit for bit, scores exactly.  The CUDA
kernel's own tests are in test_torch_cuda.py."""

from pathlib import Path

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


def _reads(rng, n, hi=40):
    lens = rng.integers(1, hi, size=n)
    lens[3] = 0
    return [rng.integers(0, 4, size=k).astype(np.int8) for k in lens]


def _case(seed, segments, rows, n_reads=30, phys=8, hi=40):
    rng = np.random.default_rng(seed)
    query = rng.integers(0, 4, size=128 // segments - 3).astype(np.int8)
    targets = _reads(rng, n_reads, hi)
    b = streams.pack_streams(query, targets, n_streams=phys * segments,
                             segments=segments, rows=rows)
    return query, targets, b


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "segments,rows,n_reads,hi",
    [(1, 1, 30, 40), (1, 4, 30, 40), (2, 8, 30, 40), (4, 4, 30, 40), (1, 16, 12, 20)],
)
def test_plain_strip_equals_swtpu_interpret_strip(segments, rows, n_reads, hi):
    query, targets, b = _case(segments * 31 + rows, segments, rows, n_reads, hi=hi)
    got = port.sw_scores_stream_strip(_t(b.q), _t(b.stream), segments=segments, rows=rows)
    want = np.asarray(ref.sw_scores_stream_strip(
        b.q, b.stream, interpret=True, segments=segments, rows=rows,
    ))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        streams.gather_stream_scores(got.numpy(), b), score_many_vs_one(query, targets)
    )


@pytest.mark.parametrize("segments,rows", [(1, 1), (1, 16), (2, 8), (4, 4), (8, 2)])
@pytest.mark.parametrize("penalties", [DEFAULT_PENALTIES, Penalties(3, -1, -3, -2)])
def test_scores_equal_oracle(segments, rows, penalties):
    query, targets, b = _case(segments + rows, segments, rows)
    got = port.sw_scores_stream(
        _t(b.q), _t(b.stream), _t(b.emit_stream), _t(b.emit_step), penalties,
        segments=segments, rows=rows,
    )
    np.testing.assert_array_equal(got.numpy(), score_many_vs_one(query, targets, penalties))
    assert got[3] == 0  # the zero-length read


@pytest.mark.parametrize("segments", [1, 2, 4])
def test_ripple_h_strip_equals_swtpu_interpret_strip(segments):
    """tail_acc=False: the strip is the segment tails' rippled H."""
    query, targets, b = _case(segments + 50, segments, 1)
    got = port.sw_scores_stream_strip(
        _t(b.q), _t(b.stream), segments=segments, tail_acc=False,
    )
    want = np.asarray(ref.sw_scores_stream_strip(
        b.q, b.stream, interpret=True, segments=segments, tail_acc=False,
    ))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        streams.gather_stream_scores(got.numpy(), b), score_many_vs_one(query, targets)
    )


@pytest.mark.parametrize("entry", ["logical", "packed", "kernel_layout"])
def test_ripple_h_entries_equal_oracle(entry):
    query, targets, b = _case(60, 2, 1)
    pen = Penalties(3, -1, -3, -2)
    emit = (_t(b.emit_stream), _t(b.emit_step.astype(np.int32)))
    kw = dict(segments=2, tail_acc=False, emit_regular=b.emit_regular)
    if entry == "logical":
        got = port.sw_scores_stream(_t(b.q), _t(b.stream), *emit, pen, **kw)
    elif entry == "packed":
        codes, flags = streams.pack_stream_wire(b.stream)
        got = port.sw_scores_stream_packed(_t(b.q), _t(codes), _t(flags), *emit, pen, **kw)
    else:
        qk = port._q_kernel_layout(_t(b.q), 2, 1)
        got = port.sw_scores_stream_kernel_layout(qk, _t(b.stream.T), *emit, pen, **kw)
    np.testing.assert_array_equal(got.numpy(), score_many_vs_one(query, targets, pen))


def test_tail_acc_takes_effect_at_one_row_only():
    """As in swtpu, rows > 1 always emits the tail accumulator."""
    _, _, b = _case(61, 1, 4)
    args = (_t(b.q), _t(b.stream))
    np.testing.assert_array_equal(
        port.sw_scores_stream_strip(*args, rows=4, tail_acc=False).numpy(),
        port.sw_scores_stream_strip(*args, rows=4).numpy(),
    )


def test_unpack_stream_wire_equals_swtpu():
    _, _, b = _case(5, 1, 1)
    codes, flags = streams.pack_stream_wire(b.stream)
    got = port.unpack_stream_wire(_t(codes), _t(flags))
    want = np.asarray(ref.unpack_stream_wire(jnp.asarray(codes), jnp.asarray(flags)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    real = b.stream != streams.STREAM_PAD  # pads come back as code 0
    np.testing.assert_array_equal(got.numpy()[real], b.stream[real])


def test_regular_gather_equals_scatter_gather():
    rng = np.random.default_rng(6)
    query = rng.integers(0, 4, size=50).astype(np.int8)
    mat = rng.integers(0, 4, size=(48, 21)).astype(np.int8)
    b = streams.pack_streams(query, mat, n_streams=16, segments=2, rows=8)
    assert b.emit_regular is not None
    args = (_t(b.q), _t(b.stream), _t(b.emit_stream), _t(b.emit_step))
    regular = port.sw_scores_stream(*args, segments=2, rows=8, emit_regular=b.emit_regular)
    scatter = port.sw_scores_stream(*args, segments=2, rows=8)
    np.testing.assert_array_equal(regular.numpy(), scatter.numpy())
    np.testing.assert_array_equal(regular.numpy(), score_many_vs_one(query, list(mat)))


def test_packed_scores_equal_swtpu_packed():
    query, targets, b = _case(7, 2, 1)
    codes, flags = streams.pack_stream_wire(b.stream)
    step32 = b.emit_step.astype(np.int32)  # ScoreBank's emission dtype
    got = port.sw_scores_stream_packed(
        _t(b.q), _t(codes), _t(flags), _t(b.emit_stream), _t(step32), segments=2,
    )
    want = np.asarray(ref.sw_scores_stream_packed(
        b.q, codes, flags, b.emit_stream, step32, interpret=True, segments=2,
    ))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, score_many_vs_one(query, targets))


def test_kernel_layout_entry_matches_logical_entry():
    query, targets, b = _case(8, 4, 4)
    qk = port._q_kernel_layout(_t(b.q), 4, 4)
    np.testing.assert_array_equal(
        qk.numpy(), np.asarray(ref._q_kernel_layout(jnp.asarray(b.q), 4, 4))
    )
    got = port.sw_scores_stream_kernel_layout(
        qk, _t(b.stream.T), _t(b.emit_stream), _t(b.emit_step), segments=4, rows=4,
    )
    np.testing.assert_array_equal(got.numpy(), score_many_vs_one(query, targets))


def _error(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


@pytest.mark.parametrize("segments,rows", [(3, 1), (16, 1), (1, 3), (2, 5)])
def test_validate_config_errors_match(segments, rows):
    assert _error(port._validate_config, segments, rows) == _error(
        ref._validate_config, segments, True, rows
    )


@pytest.mark.parametrize(
    "q_shape,stream_shape,segments",
    [((8, 64), (8, 32), 1), ((9, 64), (9, 32), 2), ((8, 128), (8, 40), 1)],
)
def test_validate_errors_match(q_shape, stream_shape, segments):
    q, s = np.zeros(q_shape, np.int8), np.zeros(stream_shape, np.int8)
    assert _error(port._validate, _t(q), _t(s), segments, 1) == _error(
        ref._validate, q, s, segments, True, 1
    )


@pytest.mark.parametrize(
    "qk_shape,sk_shape,segments",
    [((64, 8), (32, 8), 1), ((128, 8), (32, 12), 2), ((128, 8), (40, 8), 1)],
)
def test_validate_kernel_layout_errors_match(qk_shape, sk_shape, segments):
    qk, sk = np.zeros(qk_shape, np.int8), np.zeros(sk_shape, np.int8)
    assert _error(port._validate_kernel_layout, _t(qk), _t(sk), segments, 1) == _error(
        ref._validate_kernel_layout, qk, sk, segments, True, 1
    )


def test_swtpu_batch_through_port_ops():
    rng = np.random.default_rng(9)
    query = rng.integers(0, 4, size=60).astype(np.int8)
    targets = _reads(rng, 25)
    b = ref_streams.pack_streams(query, targets, n_streams=16, segments=2, rows=8)
    d = streams.batch_to_device(b, "cpu")
    got = port.sw_scores_stream(
        d.q, d.stream, d.emit_stream, d.emit_step, segments=2, rows=8,
        emit_regular=d.emit_regular,
    )
    np.testing.assert_array_equal(got.numpy(), score_many_vs_one(query, targets))


def test_port_batch_through_swtpu_ops():
    query, targets, b = _case(10, 4, 1)
    got = np.asarray(ref.sw_scores_stream(
        b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32),
        interpret=True, segments=4, emit_regular=b.emit_regular,
    ))
    np.testing.assert_array_equal(got, score_many_vs_one(query, targets))


def test_kernel_wrapper_takes_cuda_tensors_only():
    _, _, b = _case(11, 1, 16)
    qk, sk = port._to_kernel_layout(_t(b.q), _t(b.stream), 1, 16)
    launches = port.stream_strip_cuda.launches
    with pytest.raises(ValueError, match="CUDA int8 tensor"):
        port.stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, 1, 16)
    with pytest.raises(ValueError, match="no wavefront kernel"):
        port._strip_call(qk.to("meta"), sk.to("meta"), DEFAULT_PENALTIES, 1, 16)
    assert port.stream_strip_cuda.launches == launches


def test_build_dir(monkeypatch, tmp_path):
    """build/swtpu_torch/ in a checkout; an installed package (no
    pyproject.toml two levels up) builds under the user's cache, and
    SWTPU_TORCH_BUILD_DIR overrides both."""
    from swtpu_torch.ops import _build

    monkeypatch.delenv("SWTPU_TORCH_BUILD_DIR", raising=False)
    root = Path(_build.__file__).resolve().parents[2]
    assert _build.build_dir() == root / "build" / "swtpu_torch"
    installed = tmp_path / "site-packages" / "swtpu_torch" / "ops" / "_build.py"
    monkeypatch.setattr(_build, "__file__", str(installed))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir() == tmp_path / "cache" / "swtpu_torch"
    monkeypatch.setenv("SWTPU_TORCH_BUILD_DIR", str(tmp_path / "mine"))
    assert _build.build_dir() == tmp_path / "mine"
    assert _build.library_path().parent == tmp_path / "mine"

