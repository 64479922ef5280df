"""swtpu_torch's host packer against swtpu's: the same inputs must pack to
the same batch, field for field (bit-identical emission contract)."""

import numpy as np
import pytest
import torch

import swtpu.runtime.native as native
import swtpu_torch.runtime.native as port_native
from swtpu.bank import streams as ref
from swtpu_torch.bank import streams as port
from swtpu_native_ref import use_swtpu_native

torch.set_num_threads(1)

ARRAYS = ("q", "stream", "emit_stream", "emit_step")


def _assert_same_batch(got, want):
    for f in ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.cells == want.cells
    assert (got.segments, got.rows) == (want.segments, want.rows)
    assert got.emit_regular == want.emit_regular


def _ragged(rng, n, hi=60):
    """n reads with lengths in [0, hi); reads 1 and 7 are zero-length."""
    lens = rng.integers(0, hi, size=n)
    lens[[1, 7]] = 0
    return [rng.integers(0, 4, size=k).astype(np.int8) for k in lens]


def _dense(rng, n, hi=60):
    lens = rng.integers(0, hi, size=n).astype(np.int32)
    lens[[1, 7]] = 0
    mat = rng.integers(0, 4, size=(n, hi)).astype(np.int8)
    mat[np.arange(hi)[None, :] >= lens[:, None]] = 4
    return mat, lens


def _query(rng, segments):
    return rng.integers(0, 4, size=128 // segments - 2).astype(np.int8)


CONFIGS = [(1, 1), (1, 4), (1, 16), (2, 1), (2, 8), (4, 1), (4, 4)]


@pytest.mark.parametrize("segments,rows", CONFIGS)
def test_greedy_packer_matches(segments, rows):
    rng = np.random.default_rng(10 + segments * 17 + rows)
    query = _query(rng, segments)
    targets = _ragged(rng, 50)
    args = dict(n_streams=4 * segments, segments=segments, rows=rows)
    _assert_same_batch(
        port.pack_streams(query, targets, **args),
        ref.pack_streams(query, targets, **args),
    )


@pytest.mark.parametrize("segments,rows", [(1, 16), (2, 8), (4, 4), (1, 1)])
def test_dense_native_packer_matches(segments, rows, monkeypatch):
    # swtpu's library built apart from its in-place build, which a parallel
    # worker can race
    use_swtpu_native(monkeypatch)
    assert native.native_available() and port_native.native_available()
    rng = np.random.default_rng(20 + segments + rows)
    query = _query(rng, segments)
    mat, lens = _dense(rng, 300)
    args = dict(n_streams=8 * segments, segments=segments, rows=rows, lens=lens)
    _assert_same_batch(
        port.pack_streams(query, mat, **args),
        ref.pack_streams(query, mat, **args),
    )


def test_large_ragged_list_densifies_like_swtpu():
    rng = np.random.default_rng(30)
    query = _query(rng, 2)
    targets = _ragged(rng, 1100)
    args = dict(n_streams=32, segments=2, rows=8)
    _assert_same_batch(
        port.pack_streams(query, targets, **args),
        ref.pack_streams(query, targets, **args),
    )


def test_dense_packer_without_native_toolchain(monkeypatch):
    monkeypatch.setattr(native, "native_available", lambda: False)
    monkeypatch.setattr(port_native, "native_available", lambda: False)
    rng = np.random.default_rng(31)
    query = _query(rng, 1)
    mat, lens = _dense(rng, 120)
    args = dict(n_streams=8, segments=1, rows=4, lens=lens)
    _assert_same_batch(
        port.pack_streams(query, mat, **args),
        ref.pack_streams(query, mat, **args),
    )


@pytest.mark.parametrize("segments,rows", [(1, 16), (2, 1), (4, 4)])
@pytest.mark.parametrize("as_list", [False, True])
def test_equal_length_packer_matches(segments, rows, as_list):
    rng = np.random.default_rng(40 + segments + rows)
    query = _query(rng, segments)
    S = 4 * segments
    mat = rng.integers(0, 4, size=(3 * S, 25)).astype(np.int8)
    targets = list(mat) if as_list else mat
    got = port.pack_streams(query, targets, n_streams=S, segments=segments, rows=rows)
    want = ref.pack_streams(query, targets, n_streams=S, segments=segments, rows=rows)
    _assert_same_batch(got, want)
    assert got.emit_regular is not None


@pytest.mark.parametrize("use_native", [True, False])
def test_pack_stream_wire_matches(use_native, monkeypatch):
    if not use_native:
        monkeypatch.setattr(native, "native_available", lambda: False)
        monkeypatch.setattr(port_native, "native_available", lambda: False)
    rng = np.random.default_rng(50)
    b = port.pack_streams(_query(rng, 1), _ragged(rng, 40), n_streams=8)
    for got, want in zip(port.pack_stream_wire(b.stream), ref.pack_stream_wire(b.stream)):
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="multiple of 8"):
        port.pack_stream_wire(b.stream[:, :12])


def test_regular_emission_detection_matches():
    rng = np.random.default_rng(60)
    S = 6
    for emit_stream, emit_step in [
        (np.arange(12) % S, (np.arange(12) // S) * 9 + 5),  # regular
        (np.arange(12) % S, np.arange(12)),  # irregular stride
        (np.arange(11) % S, np.arange(11)),  # count not a multiple of S
        (rng.permutation(12) % S, (np.arange(12) // S) * 9 + 5),
    ]:
        assert port.detect_regular_emissions(emit_stream, emit_step, S) == (
            ref.detect_regular_emissions(emit_stream, emit_step, S)
        )


def test_gather_and_batch_to_device():
    rng = np.random.default_rng(70)
    want = ref.pack_streams(_query(rng, 2), _ragged(rng, 30), n_streams=8,
                            segments=2, rows=8)
    strip = rng.integers(0, 100, size=want.stream.shape).astype(np.int32)
    np.testing.assert_array_equal(
        port.gather_stream_scores(strip, want), ref.gather_stream_scores(strip, want)
    )
    d = port.batch_to_device(want, "cpu")
    assert isinstance(d, port.StreamBatch)
    assert (d.q.dtype, d.stream.dtype) == (torch.int8, torch.int8)
    assert (d.emit_stream.dtype, d.emit_step.dtype) == (torch.int64, torch.int64)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(d, f).numpy(), getattr(want, f))
    assert (d.cells, d.segments, d.rows, d.emit_regular) == (
        want.cells, want.segments, want.rows, want.emit_regular
    )
