"""The CUDA wavefront kernels' time slices, held on the CPU.

The kernels (csrc/stream_wavefront.cu) cut each stream's steps into slices
that start with zero state and a pad-filled pipe, and stitch each segment
column at the step its tail sees a read's first char.  A plain model of
that rule lives here: it runs the plain recurrence slice by slice and
stitches the columns as the kernel does.  Its strips must equal the
unsliced plain version's and swtpu's interpret-mode strips bit for bit, on
every stream case and on whole long-query chains, exact and in the W-bit
wrap-parity mode.  The kernels themselves
are held against the plain versions on the card (test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

from swtpu.config import DEFAULT_PENALTIES, Penalties
from swtpu.ops import pallas_stream as ref
from swtpu_torch.bank import streams
from swtpu_torch.ops import stream as port

torch.set_num_threads(1)

CUSTOM = Penalties(match=3, mismatch=-2, gap_open=-5, gap_extend=-1)
UNWRITTEN = -(1 << 30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def kernel_starts(T, slices):
    """Slice boundaries b_0 = 0 < ... < b_C = T as the kernel places them."""
    quanta = T // port.STEP_CHUNK
    return [port.STEP_CHUNK * (k * quanta // slices) for k in range(slices)] + [T]


def handover_steps(sk, SLg, b):
    """Per column of sk [T, N]: the step at which its tail sees the first
    read start that entered at or after step b (T if there is none)."""
    T = sk.shape[0]
    flags = sk[b:] >= port.FLAG_BIT
    first = flags.to(torch.int32).argmax(0) + b + SLg - 1
    return torch.where(flags.any(0), first, T).clamp(max=T)


def sliced_outputs(qk, sk, penalties, segments, rows, starts, tail_acc=True, bounds=None,
                   **mode):
    """The kernel's slicing rule on the plain recurrence: slice k starts
    at starts[k] with zero state (and the boundary strips from there),
    and each column takes slice k's output from the step its tail sees
    the first read start at or after starts[k] (slice 0: step 0) up to the
    step it sees the first one at or after starts[k+1].  Returns the strip
    [T, segments*S] (with `bounds`, also oD, oG, oH [T, S]); fails if any
    element is written by no slice or by two.  `mode` (score_width,
    state_dtype) goes to the recurrence: in wrap-parity the zero state a
    slice starts from is the bias 2^(W-1)."""
    T, N = sk.shape
    SLg = port.LANES // rows // segments
    n_out = 1 if bounds is None else 4
    outs = [torch.full((T, N), UNWRITTEN, dtype=torch.int32) for _ in range(n_out)]
    writes = torch.zeros((T, N), dtype=torch.int32)
    for k, (b0, b1) in enumerate(zip(starts, starts[1:])):
        lo = torch.zeros(N, dtype=torch.int64) if k == 0 else handover_steps(sk, SLg, b0)
        hi = handover_steps(sk, SLg, b1) if b1 < T else torch.full((N,), T)
        end = int(hi.max())  # the slice runs on until every tail hands over
        if end <= b0:
            continue
        cut = None if bounds is None else [x[b0:end] for x in bounds]
        res = port._wavefront_reference(qk, sk[b0:end], penalties, segments, rows,
                                        tail_acc, bounds=cut, **mode)
        res = [res] if bounds is None else list(res)
        t = torch.arange(b0, end)[:, None]
        mine = (t >= lo) & (t < hi)
        writes[b0:end] += mine
        for out, r in zip(outs, res):
            out[b0:end] = torch.where(mine, r.reshape(end - b0, N), out[b0:end])
    assert bool((writes == 1).all()), "an element written by no slice or by two"
    return outs[0] if bounds is None else tuple(outs)


def _batch(seed, segments, rows, phys=4, reads_per_stream=4, hi=60, wrap=False):
    """A packed batch in the kernel layout: ragged reads of 0..hi-1 bases
    (read 3 zero-length), so streams end in pad runs of different
    lengths; with `wrap`, reads 6 and 9 equal the query (their scores pass
    the 8-bit ceiling)."""
    rng = np.random.default_rng(seed)
    n = phys * segments * reads_per_stream
    lens = rng.integers(1, hi, size=n)
    lens[3] = 0
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in lens]
    query = rng.integers(0, 4, size=128 // segments - 3).astype(np.int8)
    if wrap:
        targets[6] = targets[9] = query.copy()
    b = streams.pack_streams(query, targets, n_streams=phys * segments,
                             segments=segments, rows=rows)
    qk, sk = port._to_kernel_layout(_t(b.q), _t(b.stream), segments, rows)
    return b, qk, sk


def hand_starts(sk):
    """Boundaries placed on purpose: on a read start of column 0, inside a
    read of column 0 (not on its first char), and inside the pad run that
    ends the column whose last read ends first.  Each lies in one of those
    places for the column named, whatever it is for the others."""
    T = sk.shape[0]
    col = sk[:, 0]
    starts = (col >= port.FLAG_BIT).nonzero().flatten().tolist()
    on_start = next(t for t in starts if t > 0)
    inside = next(t for t in range(on_start + 1, T) if 0 <= int(col[t]) < 4)
    real = (sk != 4).to(torch.int32)
    last = T - 1 - real.flip(0).argmax(0)  # each column's last non-pad step
    c = int(last.argmin())
    in_pad = (int(last[c]) + 1 + T) // 2
    assert int(sk[in_pad, c]) == 4 and in_pad > inside
    return [0, on_start, inside, in_pad, T]


def _boundaries(sk):
    """A case's slicings: the kernel's at 2 and 5 slices and at the
    shortest slices (32 steps, shorter than most reads), and the
    hand-placed boundaries."""
    T = sk.shape[0]
    out = {f"{c} slices": kernel_starts(T, c) for c in (2, 5, T // port.STEP_CHUNK)}
    out["on a read start, inside a read, inside a pad run"] = hand_starts(sk)
    return out


STRIP_CASES = [
    (rows, segments, True) for rows in (1, 2, 4, 16) for segments in (1, 2, 4)
] + [(1, segments, False) for segments in (1, 2, 4)]


@pytest.mark.parametrize("rows,segments,tail_acc", STRIP_CASES)
def test_sliced_strip_equals_plain_strip(rows, segments, tail_acc):
    pen = CUSTOM if (rows + segments) % 2 else DEFAULT_PENALTIES
    _, qk, sk = _batch(rows * 10 + segments + 7 * tail_acc, segments, rows)
    want = port.stream_strip_reference(qk, sk, pen, segments, rows, tail_acc)
    for label, starts in _boundaries(sk).items():
        got = sliced_outputs(qk, sk, pen, segments, rows, starts, tail_acc)
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=label)


@pytest.mark.parametrize("rows,segments,tail_acc", [
    (1, 1, True), (2, 2, True), (4, 4, True), (16, 1, True), (1, 1, False), (1, 4, False),
])
def test_sliced_biased_strip_equals_plain_strip(rows, segments, tail_acc):
    """The slicing rule in W-bit wrap-parity (W = 8): a slice starts from
    the bias, the same value a read's first char resets the state to, so
    the handover rule holds unchanged, on read starts, inside reads and in
    pad runs, with reads equal to the query that wrap."""
    b, qk, sk = _batch(rows * 10 + segments + 7 * tail_acc + 500, segments, rows, wrap=True)
    mode = dict(score_width=8)
    want = port.stream_strip_reference(qk, sk, DEFAULT_PENALTIES, segments, rows, tail_acc,
                                       **mode)
    for label, starts in _boundaries(sk).items():
        got = sliced_outputs(qk, sk, DEFAULT_PENALTIES, segments, rows, starts, tail_acc,
                             **mode)
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=label)
    scores = streams.gather_stream_scores(want.t().numpy(), b)
    assert scores[6] == scores[9] < 5 * (128 // segments - 3)  # wrapped


@pytest.mark.parametrize(
    "rows,segments,tail_acc", [(1, 1, True), (4, 4, True), (2, 2, True), (1, 2, False)]
)
def test_sliced_strip_equals_swtpu_interpret_strip(rows, segments, tail_acc):
    b, qk, sk = _batch(rows + segments + 40, segments, rows, phys=2, hi=40)
    want = np.asarray(ref.sw_scores_stream_strip(
        b.q, b.stream, interpret=True, segments=segments, rows=rows, tail_acc=tail_acc,
    ))
    starts = kernel_starts(sk.shape[0], 3)
    got = sliced_outputs(qk, sk, DEFAULT_PENALTIES, segments, rows, starts, tail_acc)
    np.testing.assert_array_equal(got.t().numpy(), want)


def test_boundaries_fall_in_every_kind_of_place():
    """Across the strip cases, the boundaries fall on read starts, inside
    reads and inside pad runs; there are reads longer than the shortest
    slice and zero-length reads; and some stream has no read start after
    a boundary."""
    seen = set()
    longest_read = 0
    no_read_after = False
    for rows, segments, tail_acc in STRIP_CASES:
        b, _, sk = _batch(rows * 10 + segments + 7 * tail_acc, segments, rows)
        assert (b.emit_step < 0).any()  # the zero-length read
        for row in b.stream:  # a read runs from its flag to the next
            longest_read = max(longest_read, int(np.diff(np.flatnonzero(row >= 8)).max(initial=0)))
        for starts in _boundaries(sk).values():
            for t in starts[1:-1]:
                row = sk[t]
                seen |= {"read start"} if bool((row >= 8).any()) else set()
                seen |= {"inside a read"} if bool(((row >= 0) & (row < 4)).any()) else set()
                seen |= {"pad"} if bool((row == 4).any()) else set()
                flags_after = (sk[t:] >= 8).any(0)
                no_read_after |= not bool(flags_after.all())
    assert seen == {"read start", "inside a read", "pad"}
    assert longest_read > port.STEP_CHUNK
    assert no_read_after


@pytest.mark.parametrize("K,rows,penalties", [(2, 4, DEFAULT_PENALTIES), (2, 16, CUSTOM),
                                              (3, 2, CUSTOM), (3, 8, DEFAULT_PENALTIES)])
def test_sliced_chain_equals_plain_chain(K, rows, penalties):
    """Every tile of a K-tile chain, all four strips, through the sliced
    model and the unsliced plain tile, on the same inputs: tile p + 1 of
    both chains is fed the sliced chain's tile p."""
    rng = np.random.default_rng(K * 10 + rows)
    lens = rng.integers(1, 70, size=24)
    lens[[2, 5]] = 0
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in lens]
    query = rng.integers(0, 4, size=128 * K - 9).astype(np.int8)
    b = streams.pack_streams_long(query, targets, n_streams=4, rows=rows)
    sk = _t(b.stream.T)
    T = sk.shape[0]
    tiles = []

    def tile(qk, sk, bD, bG, bH, pen, r, **mode):
        want = port.stream_chained_reference(qk, sk, bD, bG, bH, pen, r, **mode)
        for slices in (3, T // port.STEP_CHUNK):
            got = sliced_outputs(qk, sk, pen, 1, r, kernel_starts(T, slices),
                                 bounds=(bD, bG, bH), **mode)
            for name, g, w in zip(("acc", "oD", "oG", "oH"), got, want):
                np.testing.assert_array_equal(
                    g.numpy(), w.numpy(), err_msg=f"tile {len(tiles)} {name} {slices} slices")
        tiles.append(want)
        return got

    acc = port._long_strip(_t(b.q), sk, penalties, rows, tile=tile)
    assert len(tiles) == K
    np.testing.assert_array_equal(
        acc.numpy(), port._long_strip(_t(b.q), sk, penalties, rows).numpy())


def test_sliced_biased_chain_equals_plain_chain():
    """The slicing rule on a 4-tile chain at W = 12: every tile's four
    biased strips, sliced, equal the unsliced plain tile's, and two reads
    equal to the 450-base query wrap."""
    rng = np.random.default_rng(600)
    lens = rng.integers(1, 70, size=20)
    lens[2] = 0
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in lens]
    query = rng.integers(0, 4, size=450).astype(np.int8)
    targets[1] = targets[6] = query.copy()
    rows = 8
    b = streams.pack_streams_long(query, targets, n_streams=4, rows=rows)
    sk = _t(b.stream.T)
    T = sk.shape[0]
    tiles = []

    def tile(qk, sk, bD, bG, bH, pen, r, **mode):
        want = port.stream_chained_reference(qk, sk, bD, bG, bH, pen, r, **mode)
        for slices in (3, T // port.STEP_CHUNK):
            got = sliced_outputs(qk, sk, pen, 1, r, kernel_starts(T, slices),
                                 bounds=(bD, bG, bH), **mode)
            for name, g, w in zip(("acc", "oD", "oG", "oH"), got, want):
                np.testing.assert_array_equal(
                    g.numpy(), w.numpy(), err_msg=f"tile {len(tiles)} {name} {slices} slices")
        tiles.append(want)
        return got

    acc = port._long_strip(_t(b.q), sk, DEFAULT_PENALTIES, rows, tile=tile, score_width=12)
    assert len(tiles) == 4
    scores = port._gather_emissions(acc, _t(b.emit_stream), _t(b.emit_step), bias=1 << 11)
    assert scores[1] == scores[6] < 5 * 450  # wrapped
    assert scores[2] == 0


def test_sliced_chain_tile_equals_swtpu_interpret():
    """One chained tile on random boundary strips, sliced, against swtpu's
    interpret-mode tile."""
    rng = np.random.default_rng(500)
    lens = rng.integers(1, 50, size=16)
    lens[4] = 0
    b = streams.pack_streams(np.zeros(1, np.int8),
                             [rng.integers(0, 4, size=k).astype(np.int8) for k in lens],
                             n_streams=4, rows=4)
    sk = np.ascontiguousarray(b.stream.T)
    qk = rng.integers(0, 4, size=(128, 4)).astype(np.int8)
    bounds = [rng.integers(-20, 60, size=sk.shape).astype(np.int32) for _ in range(3)]
    want = ref._strip_call_chained(qk, sk, *bounds, *CUSTOM.astuple(), True, rows=4)
    got = sliced_outputs(_t(qk), _t(sk), CUSTOM, 1, 4, kernel_starts(sk.shape[0], 4),
                         bounds=tuple(map(_t, bounds)))
    for name, g, w in zip(("acc", "oD", "oG", "oH"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


# (S physical streams, rows, T, segments) of chip_smoke.py's cases (a)-(e),
# the shootout's rows-1 strip and its E2 comparison strip, and the slice
# counts the wrapper gives them on a card of 132 SMs without a longest
# read (a direct call's rule); (b) at 8 threads a stream has a quarter of
# the threads it had at 32, so the warps allow 33 slices and the 1,024-step
# floor gives 17
MAIN_SHAPES = [
    ((512, 16, 65568, 1), 33),  # (a)
    ((512, 4, 18112, 4), 17),  # (b)
    ((512, 8, 9152, 2), 8),  # (c)
    ((512, 16, 72064, 1), 33),  # (d)
    ((512, 16, 16448, 1), 16),  # (e)
    ((512, 1, 16512, 1), 8),  # the shootout, rows 1
    ((512, 1, 4096, 1), 2),  # E2's comparison: 127 steps of pipe fill a slice
    ((512, 1, 4096, 4), 4),  # the same at segments 4: 31 steps
]


@pytest.mark.parametrize("shape,want", MAIN_SHAPES)
def test_choose_slices_at_the_main_shapes(shape, want):
    S, rows, T, segments = shape
    slices = port.choose_slices(S, rows, T, 132, segments)
    assert slices == want
    steps = port.slice_steps(T, slices)
    assert steps >= port.MIN_SLICE_STEPS
    assert steps >= port.PIPE_FILLS_PER_SLICE * (port.LANES // rows // segments)


# the 16-bit states' launches hold two streams a thread of 8 threads a
# stream pair at rows 8, the 32-bit ones a stream of 8 threads: half the
# threads, so without a longest read the wrapper gives the 16-bit states
# twice the slices where the steps allow them: (a) and (d) at rows 8 (511
# streams: the last pair's high half dead), (c), where the slice length
# caps both
PACKED_SHAPES = [
    ((512, 8, 65568, 1), {"int32": 33, "float32": 33, "int16": 64, "uint16": 64,
                          "bfloat16": 64}),
    ((511, 8, 65568, 1), {"int32": 33, "int16": 64}),
    ((512, 8, 72064, 1), {"int32": 33, "int16": 66, "bfloat16": 66}),
    ((512, 8, 9152, 2), {"int32": 8, "int16": 8, "uint16": 8}),
]


@pytest.mark.parametrize("shape,want", PACKED_SHAPES)
def test_choose_slices_counts_the_threads_of_a_packed_launch(shape, want):
    S, rows, T, segments = shape
    for dtype, slices in want.items():
        assert port.choose_slices(S, rows, T, 132, segments, dtype) == slices, dtype


@pytest.mark.parametrize("dtype,streams", [("int32", 1), ("float32", 1), ("int16", 2),
                                           ("uint16", 2), ("bfloat16", 2)])
def test_streams_per_thread(dtype, streams):
    assert port.streams_per_thread(dtype) == streams


@pytest.mark.parametrize("S,rows,T", [(40, 16, 992), (8, 1, 32), (512, 16, 1000), (0, 16, 0)])
def test_choose_slices_keeps_short_streams_whole(S, rows, T):
    assert port.choose_slices(max(S, 1), rows, T, 132) == 1
    assert port.slice_steps(T, 1) == T


@pytest.mark.parametrize("S,rows,T,segments", [(40, 16, 1024, 1), (512, 16, 1600, 1),
                                               (512, 4, 1600, 4), (512, 1, 1728, 1),
                                               (512, 1, 4064, 1)])
def test_choose_slices_halves_streams_too_short_for_two_slices(S, rows, T, segments):
    assert port.choose_slices(S, rows, T, 132, segments) == 2


@pytest.mark.parametrize("slices,T", [(0, 320), (-1, 320), (11, 320), (2, 32)])
def test_bad_slice_counts_raise(slices, T):
    with pytest.raises(ValueError, match=f"slices {slices} must be"):
        port._slice_count(slices, 8, 16, T, None)


@pytest.mark.parametrize("slices,T,steps", [(1, 320, 320), (10, 320, 32), (7, 320, 64),
                                            (3, 96, 32), (16, 65568, 4128)])
def test_slice_steps_is_the_longest_slice(slices, T, steps):
    assert port._slice_count(slices, 8, 16, T, None) == slices
    assert port.slice_steps(T, slices) == steps
    b = kernel_starts(T, slices)
    assert max(np.diff(b)) == steps and min(np.diff(b)) >= port.STEP_CHUNK


@pytest.mark.parametrize("rows,segments,state_dtype", [
    (r, g, d) for r in port.ROWS for g in (1, 2, 4, 8) for d in ("int32", "float32", "int16")
    if r < 16 or d != "int16"  # swtpu refuses rows 16 in a 16-bit state
])
def test_wavefront_geometry_is_legal(rows, segments, state_dtype):
    """The kernel's thread mapping at every rows x segments: W threads of
    V sublanes cover a stream's 128 / rows sublanes, a warp holds whole
    streams, and a segment is whole threads, so its head and tail are a
    thread's first and last sublanes; min(16 / rows, 4) sublanes a thread,
    16 query rows of each stream in 8 threads a stream at rows 4-16, or a
    stream pair in a 16-bit state (rows <= 8), whose rows 2 and 1 take 32
    threads a pair."""
    port._validate_config(segments, rows, state_dtype)
    g = port.wavefront_geometry(rows, segments, state_dtype)
    SL = port.LANES // rows
    assert g.lanes * g.sublanes == SL and 32 % g.lanes == 0
    assert g.segment_sublanes == SL // segments
    assert g.segment_sublanes % g.sublanes == 0
    assert g.segment_sublanes // g.sublanes * segments == g.lanes
    if state_dtype == "int16" and rows < 4:
        assert (g.lanes, g.streams_per_thread) == (32, 2)
    else:
        assert g.sublanes == min(16 // rows, port.MAX_SUBLANES)
        assert rows * g.sublanes == (16 if rows >= 4 else 4 * rows)
        assert g.streams_per_thread == (2 if state_dtype == "int16" else 1)


# (S physical streams, rows, T, segments, longest read) of chip_smoke.py's
# cases (a)-(c) and (r) and the slice counts the wrapper gives them from
# the longest read on a card of 132 SMs
LONGEST_SHAPES = [
    ((512, 16, 65568, 1, 128), 33),  # (a): 32 warps an SM
    ((512, 4, 18112, 4, 256), 8),  # (b): 8 warps an SM (4 sublanes a thread)
    ((512, 8, 9152, 2, 256), 8),  # (c): 11 slices fit, 8 make whole waves
    ((512, 16, 42240, 1, 2048), 4),  # (r): 6 fit, 4 make a whole wave
    ((512, 1, 16512, 1, 128), 2),  # the shootout's rows-1 strip (B2)
    ((40, 16, 4096, 1, 200), 6),  # fewer blocks than SMs: what fits
]


@pytest.mark.parametrize("shape,want", LONGEST_SHAPES)
def test_choose_slices_from_the_longest_read(shape, want):
    """At most SLICE_WARPS_PER_SM / V warps an SM, slices of at least
    READS_PER_SLICE reads and a pipe fill, and blocks within a tenth of a
    wave of whole waves over the SMs (or under one wave)."""
    S, rows, T, segments, longest = shape
    slices = port.choose_slices(S, rows, T, 132, segments, longest_read=longest)
    assert slices == want
    SLg = port.LANES // rows // segments
    assert port.slice_steps(T, slices) >= port.READS_PER_SLICE * (longest + SLg)
    blocks = slices * -(-S * port.wavefront_geometry(rows, segments).lanes
                         // port.KERNEL_BLOCK)
    assert blocks <= 132 or -blocks % 132 <= 132 // 10


@pytest.mark.parametrize("shape,_", PACKED_SHAPES)
def test_longest_read_leaves_the_16bit_and_chain_slices(shape, _):
    """The batch's longest read sets the 16-bit kernel's slices as it sets
    the 32-bit kernel's, over the 16-bit kernel's own threads (two streams
    a thread): slices of at least READS_PER_SLICE reads and a pipe fill,
    at most SLICE_WARPS_PER_SM / V warps an SM, whole waves to a tenth.
    The chain kernel takes no read: its geometry counts min(128 / rows,
    32) threads a stream, or in a 16-bit state min(64 / rows, 32) threads
    a stream pair, two streams a thread."""
    S, rows, T, segments = shape
    SLg = port.LANES // rows // segments
    for dtype in ("int16", "uint16", "bfloat16"):
        g = port.wavefront_geometry(rows, segments, dtype)
        got = port.choose_slices(S, rows, T, 132, segments, dtype, longest_read=100)
        blocks = -(-(-(-S // 2)) * g.lanes // port.KERNEL_BLOCK)
        want = max(1, min(round(132 * port.SLICE_WARPS_PER_SM / g.sublanes * 32
                                / port.KERNEL_BLOCK / blocks),
                          T // (port.READS_PER_SLICE * (100 + SLg))))
        while want > 1 and want * blocks > 132 and -want * blocks % 132 > 132 // 10:
            want -= 1
        assert got == want, dtype
        assert got == 1 or port.slice_steps(T, got) >= port.READS_PER_SLICE * (100 + SLg)
        assert got != port.choose_slices(S, rows, T, 132, segments, dtype)
    for dtype, per_thread in (("int32", 1), ("int16", 2), ("bfloat16", 2)):
        for K in (1, 2, 5):
            got = port.chain_geometry(S, rows, T, K, 132, dtype)
            lanes = min(port.LANES // rows // per_thread, 32)
            assert got.slices == port.choose_slices(S, rows, T, 132, state_dtype=dtype,
                                                    tiles=got.ring, lanes=lanes)
            assert got.streams_per_warp == 32 // lanes * per_thread
            assert got.blocks == -(-S // got.streams_per_warp)


def _long_read_batch(seed, rows, n_reads=4, phys=2):
    """(r)'s reads, 513-2,048 bases, on `phys` streams in the kernel
    layout."""
    rng = np.random.default_rng(seed)
    targets = [rng.integers(0, 4, size=k).astype(np.int8)
               for k in rng.integers(513, 2049, size=n_reads)]
    query = rng.integers(0, 4, size=125).astype(np.int8)
    b = streams.pack_streams(query, targets, n_streams=phys, rows=rows)
    qk, sk = port._to_kernel_layout(_t(b.q), _t(b.stream), 1, rows)
    return b, qk, sk, max(map(len, targets))


def test_long_read_slices_equal_plain_and_swtpu_strip():
    """Reads of 513-2,048 bases at rows 4: slices shorter than a read (2
    and 3), the hand-placed boundaries and the count the rule gives for
    the longest read on this batch's streams, each equal to the unsliced
    plain strip and swtpu's interpret-mode strip."""
    b, qk, sk, longest = _long_read_batch(2048, 4)
    T = sk.shape[0]
    want = port.stream_strip_reference(qk, sk, DEFAULT_PENALTIES, 1, 4)
    ref_strip = np.asarray(ref.sw_scores_stream_strip(b.q, b.stream, interpret=True, rows=4))
    np.testing.assert_array_equal(want.t().numpy(), ref_strip)
    rule = port.choose_slices(qk.shape[1], 4, T, 132, longest_read=longest)
    cuts = {f"{c} slices": kernel_starts(T, c) for c in {2, 3, rule}}
    cuts["on a read start, inside a read, inside a pad run"] = hand_starts(sk)
    for label, starts in cuts.items():
        got = sliced_outputs(qk, sk, DEFAULT_PENALTIES, 1, 4, starts)
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=label)


def test_long_read_slices_at_rows_16_equal_plain_strip():
    """(r)'s geometry, rows 16 on reads of 513-2,048 bases, in W = 12:
    slices of about a read, each boundary inside a read of some stream."""
    _, qk, sk, _ = _long_read_batch(4096, 16, n_reads=2, phys=1)
    T = sk.shape[0]
    mode = dict(score_width=12)
    want = port.stream_strip_reference(qk, sk, DEFAULT_PENALTIES, 1, 16, **mode)
    starts = kernel_starts(T, T // 1024)
    assert all(((sk[t] >= 0) & (sk[t] < 4)).any() for t in starts[1:-1])
    got = sliced_outputs(qk, sk, DEFAULT_PENALTIES, 1, 16, starts, **mode)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_reads_up_to_reaches_every_b1_batch(monkeypatch):
    """Every bank path that packs a B1 batch hands the wrapper its longest
    read through reads_up_to, with swtpu's signatures: one-shot, chunked,
    resident, sharded resident, pair streams, score_streams; outside them,
    none."""
    from swtpu_torch import SWConfig, ScoreBank
    from swtpu_torch.parallel.mesh import make_mesh

    seen = []
    real = port._strip_call

    def spy(*a, **kw):
        seen.append(port._LONGEST_READ.get())
        return real(*a, **kw)

    monkeypatch.setattr(port, "_strip_call", spy)
    rng = np.random.default_rng(77)
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in rng.integers(1, 90, 60)]
    lens = [len(t) for t in targets]
    query = rng.integers(0, 4, size=20).astype(np.int8)
    bank = ScoreBank(backend="stream", device="cpu")
    bank.score_database(query, targets)
    assert seen == [max(lens)]
    seen.clear()
    ScoreBank(SWConfig(stream_chunk_reads=25), backend="stream",
              device="cpu").score_database(query, targets)
    assert seen == [max(lens[:25]), max(lens[25:50]), max(lens[50:])]
    seen.clear()
    db = bank.load_database(targets, max_query_len=32)
    bank.score_loaded(query, db)
    assert seen == [max(lens)]
    seen.clear()
    sdb = bank.load_database_sharded(targets, make_mesh(devices=["cpu"] * 2))
    bank.score_loaded_sharded(query, sdb)
    assert seen == [max(lens)] * 2
    seen.clear()
    bank.score_pairs([query] * 60, targets)
    assert seen == [max(lens)]
    seen.clear()
    streams.score_streams(query, targets, n_streams=8, device="cpu")
    assert seen == [max(lens)]
    seen.clear()
    port.sw_scores_stream_strip(_t(np.zeros((8, 128), np.int8)),
                                _t(np.full((8, 32), 4, np.int8)))
    assert seen == [None]
