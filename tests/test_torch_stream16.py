"""The 16-bit wavefront's geometry and routing, held on the CPU.

In a 16-bit state (int16, uint16, bfloat16) a thread of the CUDA
wavefront holds two streams, one in each half of its 32-bit registers.
B1 (stream_wavefront_x2_kernel) runs 8 threads a stream pair at rows 4
and 8, 16 query rows of each stream a thread, and takes its slices from
the batch's longest read as the 32-bit kernel does; a long query's chain
is one launch of a chain kernel (stream_chain_x2_kernel) as in every state,
a warp holding twice the streams of a 32-bit one.  Here: the mappings and
slice counts the wrappers compute, ``_long_strip``'s route on CUDA
tensors, and the plain 16-bit chain at K = 5 (one wrap past the 4-warp
ring) and the chain kernel's rule on it (``fused_chain``) against swtpu's
interpret-mode chain, exact.  The kernels themselves are held on the card
(test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from swtpu.config import DEFAULT_PENALTIES, Penalties
from swtpu_torch.ops import stream as port
from test_torch_stream_chain import _chain_batch, _slicings, _swtpu_chain, fused_chain

SIXTEEN = port.SIXTEEN_BIT_STATES
# the 16-bit states with the penalties each takes: uint16 refuses a
# negative open or extend penalty, and wraps a mismatch of -4 to 65532
MODES = {"int16": ("int16", DEFAULT_PENALTIES), "uint16": ("uint16", Penalties(5, 0, 0, 0)),
         "uint16 wrap": ("uint16", Penalties(5, -4, 0, 0)),
         "bfloat16": ("bfloat16", DEFAULT_PENALTIES)}
K_WRAP = port.RING_WARPS + 1  # tiles of a chain that wraps past the ring once
SMS = 132  # the H100's SMs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype", SIXTEEN)
@pytest.mark.parametrize("rows,segments", [(r, g) for r in (1, 2, 4, 8) for g in (1, 2, 4, 8)])
def test_16bit_wavefront_geometry(rows, segments, dtype):
    """W threads of V sublanes a stream pair cover its 128 / rows
    sublanes; a segment is whole threads (its head and tail a thread's
    first and last sublanes); 8 threads of 16 query rows at rows 4 and 8,
    32 threads at rows 2 and 1; two streams a thread."""
    port._validate_config(segments, rows, dtype, penalties=Penalties(5, 0, 0, 0))
    g = port.wavefront_geometry(rows, segments, dtype)
    SL = port.LANES // rows
    assert g.lanes * g.sublanes == SL and 32 % g.lanes == 0
    assert g.streams_per_thread == 2
    assert g.segment_sublanes == SL // segments and g.segment_sublanes % g.sublanes == 0
    assert g.lanes == (8 if rows >= 4 else 32)
    if rows >= 4:
        assert rows * g.sublanes == port.ROWS_PER_THREAD
        assert g == port.wavefront_geometry(rows, segments)._replace(streams_per_thread=2)


# (S physical streams, rows, T, segments, longest read) of chip_smoke.py's
# 16-bit B1 shapes: (a) at rows 8 and 4, (c) at rows 8, (r)'s long reads
SLICE_SHAPES = [(512, 8, 65568, 1, 128), (512, 4, 65568, 1, 128), (512, 8, 9152, 2, 256),
                (511, 8, 9152, 2, 256), (512, 8, 42240, 1, 2048)]


@pytest.mark.parametrize("dtype", SIXTEEN)
@pytest.mark.parametrize("shape", SLICE_SHAPES)
def test_16bit_choose_slices(shape, dtype):
    """Without a read: a grid of SLICE_WARPS_PER_SM warps an SM over the
    16-bit kernel's threads (ceil(S / 2) pairs of W threads), capped by
    the slice length.  With the longest read: slices of at least
    READS_PER_SLICE reads and a pipe fill, SLICE_WARPS_PER_SM / V warps an
    SM, in whole waves of blocks to a tenth, as in a 32-bit state."""
    S, rows, T, segments, longest = shape
    g = port.wavefront_geometry(rows, segments, dtype)
    blocks = -(-(-(-S // 2) * g.lanes) // port.KERNEL_BLOCK)
    SLg = port.LANES // rows // segments
    plain = port.choose_slices(S, rows, T, SMS, segments, dtype)
    fit = max(T // max(port.MIN_SLICE_STEPS, port.PIPE_FILLS_PER_SLICE * SLg), 2)
    assert plain == max(1, min(round(SMS * port.SLICE_WARPS_PER_SM * 32 / port.KERNEL_BLOCK
                                     / blocks), fit))
    got = port.choose_slices(S, rows, T, SMS, segments, dtype, longest_read=longest)
    assert got >= 1
    assert got == 1 or port.slice_steps(T, got) >= port.READS_PER_SLICE * (longest + SLg)
    assert got * blocks <= SMS or -got * blocks % SMS <= SMS // 10
    assert got * blocks * port.KERNEL_BLOCK // 32 <= round(
        SMS * port.SLICE_WARPS_PER_SM / g.sublanes) + blocks * port.KERNEL_BLOCK // 32


@pytest.mark.parametrize("dtype", SIXTEEN)
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_16bit_chain_geometry(rows, dtype):
    """The chain kernel in a 16-bit state: W = min(64 / rows, 32) threads
    a stream pair, two sublanes a thread at rows 2 to 8 (8 threads at rows
    8), so a warp holds 2 x 32 / W streams, at most the ring's 4 slots of
    pairs; the ring, lags and wrap do not change."""
    lanes = port.chain_lanes(rows, dtype)
    assert lanes == {8: 8, 4: 16, 2: 32, 1: 32}[rows]
    assert port.LANES // rows // lanes == (4 if rows == 1 else 2)
    # the per-tile contract (the card's witness): one sublane a thread but
    # at rows 1
    assert port.chain_lanes(rows, dtype, one_tile=True) == min(port.LANES // rows, 32)
    assert port.chain_lanes(rows) == min(port.LANES // rows, 32)
    for S, T, K in ((512, 72064, 2), (512, 16448, 4), (511, 4096, K_WRAP), (3, 1024, 1)):
        got = port.chain_geometry(S, rows, T, K, SMS, dtype)
        wide = port.chain_geometry(S, rows, T, K, SMS)
        assert got.streams_per_warp == 2 * 32 // lanes and 32 // lanes <= port.RING_WARPS
        assert got.blocks == -(-S // got.streams_per_warp)
        assert got._replace(streams_per_warp=0, blocks=0, slices=0) == wide._replace(
            streams_per_warp=0, blocks=0, slices=0)
        assert got.slices == port.choose_slices(S, rows, T, SMS, state_dtype=dtype,
                                                tiles=got.ring, lanes=lanes)
        assert got.wrap == (K > port.RING_WARPS)


class _OnCuda:
    """Stands for a CUDA stream tensor: what ``_long_strip`` reads of it
    before it picks a route."""

    device = torch.device("cuda")

    def __init__(self, shape):
        self.shape = shape


ALL_STATES = {"int32": {}, "W=12": dict(score_width=12), "float32": dict(state_dtype="float32"),
              **{m: dict(state_dtype=d) for m, (d, _) in MODES.items()}}


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("mode", list(ALL_STATES))
def test_long_strip_on_cuda_runs_the_chain_kernel_in_every_state(monkeypatch, mode, rows):
    """On a CUDA tensor ``_long_strip`` sends a chain in every state, the
    16-bit ones included, to one stream_chain_cuda call: no tile runs on
    its own, so no shift and no intermediate strip is made."""
    kw = ALL_STATES[mode]
    pen = MODES[mode][1] if mode in MODES else DEFAULT_PENALTIES
    q, sk = _chain_batch(3, rows, 3)
    calls = []

    def chain(qks, stream, penalties, r, **mode_kw):
        calls.append((qks, stream, penalties, r, mode_kw))
        return "strip"

    def tile(*args, **kwargs):
        raise AssertionError("a tile ran on its own")

    monkeypatch.setattr(port, "stream_chain_cuda", chain)
    for name in ("stream_chained_cuda", "stream_chained_reference", "_strip_call_chained"):
        monkeypatch.setattr(port, name, tile)
    stream = _OnCuda(tuple(sk.shape))
    assert port._long_strip(q, stream, pen, rows, **kw) == "strip"
    assert len(calls) == 1
    qks, got_stream, got_pen, got_rows, got_kw = calls[0]
    torch.testing.assert_close(qks, port.tile_registers(q, rows), rtol=0, atol=0)
    assert (got_stream, got_pen, got_rows) == (stream, pen, rows)
    assert got_kw == dict(score_width=kw.get("score_width"),
                          state_dtype=kw.get("state_dtype", "int32"))


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_16bit_chain_equals_swtpu_interpret_chain(mode):
    """The plain chain (``_long_strip`` with the plain tile and the host's
    shifts) at K = 5, rows 8, in each 16-bit state against swtpu's
    interpret-mode chain: bit-equal (tolerance 0), its every third read a
    window of the query across a tile boundary."""
    dtype, pen = MODES[mode]
    q, sk = _chain_batch(508, 8, K_WRAP)
    got = port._long_strip(q, sk, pen, 8, state_dtype=dtype)
    want = _swtpu_chain(q, sk, pen, 8, state_dtype=dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("rows", [1, 8])
def test_fused_16bit_chain_equals_plain_chain(rows, mode):
    """The chain kernel's rule (``fused_chain``: the tiles side by side in
    each slice, the wrap strips past the ring, a group of 2 x 32 / W
    streams skipped without a read start) in each 16-bit state at K = 5:
    bit-equal to the plain chain with a slice boundary on a read start (a
    lag and a handover before others) and, at rows 8, at 32-step slices
    (rows 1's 17-chunk lag makes those slow here).  uint16 with a wrapping mismatch makes pads alone
    raise the accumulator, so its all-pad group runs in slice 0."""
    dtype, pen = MODES[mode]
    q, sk = _chain_batch(500 + rows, rows, K_WRAP)
    want = port._long_strip(q, sk, pen, rows, state_dtype=dtype)
    pads = (sk == 4).all(0)
    assert bool(pads.any())
    assert bool((want[:, pads] != 0).any()) == (mode == "uint16 wrap")
    qks = port.tile_registers(q, rows)
    for label, starts in _slicings(sk.shape[0])[1 : 3 if rows == 8 else 2]:
        got = fused_chain(qks, sk, pen, rows, starts, state_dtype=dtype)
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=label)
