"""The chain kernel (a long query's K tiles in one launch), held on the CPU.

The kernel (csrc/stream_wavefront.cu, stream_chain_kernel) runs every
tile of a chain in one launch: a block's warps are the tiles of one group
of streams, each a fixed lag behind the tile above, and each slice of the
chain runs all K tiles over its own window.  Tile p+1 is fed tile p's row
127 from the same slice, raw values from before the slice's first read
start included, and the boundary zero past the step the tiles stopped at;
a block runs a group's tiles min(K, RING_WARPS) at a time, and a tile
that opens a pass is fed instead through strips in device memory that
hold what the tile above wrote.  A block whose streams hold no read start
at or after its slice's start writes nothing, or in slice 0 the zero.  A plain
model of that rule lives here (`fused_chain`): its last accumulator strip
must equal the plain chain's (``_long_strip`` with the plain tile) and
swtpu's interpret-mode chain bit for bit, exact, at W = 12 and in float32.
The kernel itself is held against the per-tile chain and the plain version
on the card (test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.config import DEFAULT_PENALTIES, Penalties
from swtpu.ops import pallas_stream as ref
from swtpu_torch.bank import streams
from swtpu_torch.ops import stream as port

CUSTOM = Penalties(match=3, mismatch=-2, gap_open=-5, gap_extend=-1)
MODES = {"exact": {}, "W=12": dict(score_width=12), "float32": dict(state_dtype="float32")}
UNWRITTEN = -(1 << 30)
S_STREAMS, LIVE = 12, 6  # streams of a test batch; the last 6 hold only pads


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for this module's many small torch ops (the suite runs
    several workers), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def kernel_starts(T, slices):
    """Slice boundaries b_0 = 0 < ... < b_C = T as the kernels place them."""
    quanta = T // port.STEP_CHUNK
    return [port.STEP_CHUNK * (k * quanta // slices) for k in range(slices)] + [T]


def handover_steps(sk, SL, b):
    """Per column of sk [T, S]: the step at which its tail sees the first
    read start that entered at or after step b (T if there is none)."""
    T = sk.shape[0]
    flags = sk[b:] >= port.FLAG_BIT
    first = flags.to(torch.int32).argmax(0) + b + SL - 1
    return torch.where(flags.any(0), first, T).clamp(max=T)


def _shifted(src, b0, E, shift, end, zero):
    """Row 0's boundary over the window [b0, E): src [>= E, S] holds the
    producer's row 127 by absolute step; step t reads step t + shift, or
    the zero from its column's `end` on."""
    pad = torch.full((max(0, E + shift - src.shape[0]), src.shape[1]), zero, dtype=src.dtype)
    full = torch.cat((src, pad))
    x = torch.arange(b0, E)[:, None] + shift
    return torch.where(x < end[None, :], full[b0 + shift : E + shift], zero)


def fused_chain(qks, sk, penalties, rows, starts, **mode):
    """The chain kernel's rule on the plain recurrence: qks [K, 128, S]
    (each tile's register), sk [T, S], slice boundaries `starts`; a ring
    of min(K, RING_WARPS) tiles a block, as the kernel runs them.

    Streams go in groups of chain_geometry's streams_per_warp, a block's:
    32 / min(128 / rows, 32), twice as many in a 16-bit state.  In each
    slice [b0, b1) a group runs if one of its streams holds a read start
    at or after b0; its tiles stop at the first chunk start at or after
    b1 by which every tail has handed over (or at T).  Tile p+1 of a slice
    runs over the slice's window fed, at step t, tile p's row 127 at
    t + SL - 2 (D) and t + SL - 1 (G, H): tile p's raw values from the
    same slice, or where p+1 is a multiple of the ring the strip of what
    tile p wrote in every slice, and the boundary zero from its group's
    stop on.  Each tile writes column s from the step its tail sees the
    first read start at or after b0 (slice 0: step 0) up to the one at or
    after b1.  A group with no read start at all writes the zero in slice
    0, where pads alone leave every state at the zero
    (``pads_stay_at_zero``), and runs there otherwise.  Returns the last
    tile's strip [T, S] int32; fails if an element is written by no slice
    or by two."""
    K = qks.shape[0]
    T, S = sk.shape
    SL = port.LANES // rows
    ring = min(K, port.RING_WARPS)
    per_warp = port.chain_geometry(S, rows, T, K, 132,
                                   mode.get("state_dtype", "int32")).streams_per_warp
    group = torch.arange(S) // per_warp
    n_groups = int(group.max()) + 1
    zero = port._bias(mode.get("score_width"))
    flags = sk >= port.FLAG_BIT
    quiet = port.pads_stay_at_zero(penalties, mode.get("state_dtype", "int32"))
    slices = []
    for k, (b0, b1) in enumerate(zip(starts, starts[1:])):
        lo = torch.zeros(S, dtype=torch.int64) if k == 0 else handover_steps(sk, SL, b0)
        hi = handover_steps(sk, SL, b1) if b1 < T else torch.full((S,), T)
        has = (flags[b0:].any(0) | (k == 0 and not quiet)).to(torch.int64)
        runs = torch.zeros(n_groups, dtype=torch.int64).scatter_reduce(
            0, group, has, "amax") > 0
        last_hi = torch.zeros(n_groups, dtype=torch.int64).scatter_reduce(
            0, group, hi, "amax")
        stop = torch.clamp(torch.clamp(-(-(last_hi + 1) // 8) * 8, min=b1), max=T)
        slices.append((b0, lo, hi, runs[group], stop[group]))
    prev = None  # tile p-1: (its raw row 127 by slice, what it wrote)
    for p in range(K):
        wrote = [torch.full((T, S), UNWRITTEN, dtype=torch.int32) for _ in range(4)]
        writes = torch.zeros((T, S), dtype=torch.int32)
        raw = []
        for b0, lo, hi, run, end in slices:
            if not bool(run.any()):
                raw.append(None)
                continue
            E = int(end[run].max())
            if p == 0:
                bounds = [torch.full((E - b0, S), zero, dtype=torch.int32)] * 3
            else:  # tile p-1's raw row 127 in this slice, or what it wrote
                src = prev[0][len(raw)] if p % ring else prev[1]
                bounds = [_shifted(x, b0, E, sh, end, zero)
                          for x, sh in zip(src, (SL - 2, SL - 1, SL - 1))]
            res = port._wavefront_reference(qks[p], sk[b0:E], penalties, 1, rows,
                                            bounds=bounds, **mode)
            full = [torch.zeros((T, S), dtype=torch.int32) for _ in range(3)]
            for f, r in zip(full, res[1:]):
                f[b0:E] = r
            raw.append(full)
            t = torch.arange(b0, E)[:, None]
            mine = (t >= lo) & (t < hi) & run[None, :]
            writes[b0:E] += mine
            for out, r in zip(wrote, res):
                out[b0:E] = torch.where(mine, r.reshape(E - b0, S), out[b0:E])
        prev = (raw, wrote[1:])
    acc = wrote[0]
    silent = ~slices[0][3]  # groups with no read start: the zero, written once
    acc[:, silent] = zero
    writes[:, silent] += 1
    assert bool((writes == 1).all()), "an element written by no slice or by two"
    return acc


def _chain_batch(seed, rows, K):
    """(q [S, K*128] int8, sk [T, S] int8) for a chain at `rows`: the
    query (7 bases short of K tiles, sentinel-padded) on every stream; the
    first LIVE of S_STREAMS streams hold reads of 10-70 bases, the rest
    pads only.  Stream 0's second read starts at step 64, stream 1's at 64
    plus the kernel's lag and stream 2's at 64 + SL - 1, so a slice
    boundary at 64 lies on a read start, a lag before one and a handover
    before one; from K = 2 on, every third read is a window of the query
    across a tile boundary, so that alignments cross it.  The streams end
    at different steps; T leaves the chain's (SL - 1) x K drain steps."""
    rng = np.random.default_rng(seed)
    SL = port.LANES // rows
    query = rng.integers(0, 4, size=128 * K - 7).astype(np.int8)
    firsts = {0: 64, 1: 64 + port.CHAR_CHUNK * port.chain_lag_chunks(rows), 2: 64 + SL - 1}
    chains = []
    for s in range(LIVE):
        reads, fill = [], 0
        goal = int(rng.integers(100, 170))
        while fill < goal:
            n = int(rng.integers(10, 71)) if reads or s not in firsts else firsts[s]
            read = rng.integers(0, 4, size=n).astype(np.int8)
            if K > 1 and len(reads) % 3 == 1:
                at = 128 * int(rng.integers(1, K))
                read = query[at - int(rng.integers(5, 40)) : at + int(rng.integers(5, 40))].copy()
            read[0] |= port.FLAG_BIT
            reads.append(read)
            fill += len(read)
        chains.append(np.concatenate(reads))
    T = -(-(max(map(len, chains)) + (SL - 1) * K) // port.STEP_CHUNK) * port.STEP_CHUNK
    sk = np.full((T, S_STREAMS), 4, dtype=np.int8)
    for s, c in enumerate(chains):
        sk[: len(c), s] = c
    q = np.full((S_STREAMS, 128 * K), 5, dtype=np.int8)
    q[:, : len(query)] = query
    return _t(q), _t(sk)


def _slicings(T):
    """A case's slicings (boundaries): the kernel's at 3 slices; a boundary
    at step 64 (a read start, a lag and a handover before one, see
    _chain_batch); the shortest slices (32 steps, shorter than most
    reads)."""
    return [("3 slices", kernel_starts(T, 3)),
            ("at step 64", [0, 64, T]),
            ("32-step slices", kernel_starts(T, T // port.STEP_CHUNK))]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("rows", port.ROWS)
def test_fused_chain_equals_plain_chain(rows, K, mode):
    pen = CUSTOM if (rows + K) % 2 else DEFAULT_PENALTIES
    q, sk = _chain_batch(rows * 10 + K, rows, K)
    want = port._long_strip(q, sk, pen, rows, **MODES[mode])
    qks = port.tile_registers(q, rows)
    for label, starts in _slicings(sk.shape[0]):
        got = fused_chain(qks, sk, pen, rows, starts, **MODES[mode])
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=label)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("rows", [1, 16])
def test_fused_chain_through_the_wrap_strips_equals_plain_chain(rows, mode):
    """Past RING_WARPS tiles the ring's first warp is fed the tile above's
    row 127 through the strips of what it wrote in every slice: K = 5, one
    wrap, in each slicing of the small cases."""
    K = port.RING_WARPS + 1
    q, sk = _chain_batch(rows * 10 + K, rows, K)
    want = port._long_strip(q, sk, DEFAULT_PENALTIES, rows, **MODES[mode])
    qks = port.tile_registers(q, rows)
    for label, starts in _slicings(sk.shape[0]):
        got = fused_chain(qks, sk, DEFAULT_PENALTIES, rows, starts, **MODES[mode])
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=label)


def _swtpu_chain(q, sk, penalties, rows, score_width=None, state_dtype="int32"):
    """swtpu's interpret-mode chain (pallas_stream._long_impl's tiles and
    shifts) -> its last accumulator strip [T, S], biased at score_width.
    Its kernel runs at a 2-step grid chunk, whose trace is short."""
    K, SL = q.shape[1] // port.LANES, port.LANES // rows
    bias = 0 if score_width is None else 1 << (score_width - 1)
    bD = bG = bH = jnp.full(sk.shape, bias, jnp.int32)
    for p in range(K):
        qk = ref._q_kernel_layout(jnp.asarray(q[:, p * 128 : (p + 1) * 128].numpy()), 1, rows)
        acc, oD, oG, oH = ref._strip_call_chained(
            qk, jnp.asarray(sk.numpy()), bD, bG, bH, *penalties.astuple(), True,
            state_dtype=state_dtype, rows=rows, chunk=2, score_width=score_width)
        bD = ref._shift_steps(oD, SL - 2, fill=bias)
        bG = ref._shift_steps(oG, SL - 1, fill=bias)
        bH = ref._shift_steps(oH, SL - 1, fill=bias)
    return np.asarray(acc)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("rows,K", [(1, 2), (2, 3), (4, 2), (8, 3), (16, 2)])
def test_fused_chain_equals_swtpu_interpret_chain(rows, K, mode):
    q, sk = _chain_batch(rows * 10 + K, rows, K)
    got = fused_chain(port.tile_registers(q, rows), sk, DEFAULT_PENALTIES, rows,
                      kernel_starts(sk.shape[0], 3), **MODES[mode])
    want = _swtpu_chain(q, sk, DEFAULT_PENALTIES, rows, **MODES[mode])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("rows", [1, 16])
def test_all_pad_stream_chain_is_the_boundary_zero(rows, mode):
    """A stream of pads only (the kernel skips such groups in slice 0 and
    writes the zero): the plain chain's last accumulator is the boundary
    zero, 0 or 2^(W-1), at every step, beside streams that hold reads."""
    K = 3
    q, sk = _chain_batch(rows + 70, rows, K)
    acc = port._long_strip(q, sk, DEFAULT_PENALTIES, rows, **MODES[mode])
    zero = port._bias(MODES[mode].get("score_width"))
    assert bool((sk[:, LIVE:] == 4).all()) and bool((sk[:, :LIVE] >= 8).any(0).all())
    np.testing.assert_array_equal(acc[:, LIVE:].numpy(),
                                  np.full((sk.shape[0], S_STREAMS - LIVE), zero))
    assert bool((acc[:, :LIVE] != zero).any())


# a positive mismatch (and gap open): pads alone raise every state
POSITIVE = Penalties(match=3, mismatch=1, gap_open=2, gap_extend=-1)


@pytest.mark.parametrize("state_dtype,penalties,want", [
    ("int32", DEFAULT_PENALTIES, True), ("int32", CUSTOM, True),
    ("int32", POSITIVE, False), ("float32", Penalties(2, 0, 0, 0), True),
    ("float32", Penalties(2, -1, -2, 1), False), ("int16", DEFAULT_PENALTIES, True),
    ("bfloat16", POSITIVE, False), ("uint16", Penalties(5, 0, 0, 0), True),
    ("uint16", Penalties(5, -4, 0, 0), False), ("uint16", Penalties(5, 0, -65536, 0), True),
])
def test_pads_stay_at_zero_reads_the_penalties_in_the_state(state_dtype, penalties, want):
    """No penalty a pad's cell adds (mismatch, open, extend) positive in the
    state's arithmetic; uint16 wraps a negative one (-4 is 65532), and -2^16
    is 0 there."""
    assert port.pads_stay_at_zero(penalties, state_dtype) is want


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("rows", [1, 16])
def test_fused_chain_with_positive_penalties_equals_plain_chain(rows, mode):
    """With a positive mismatch the pad-only streams' accumulator rises off
    the zero, so a group with no read start must run in slice 0 too: the
    rule (pads_stay_at_zero) gives the plain chain's strip in each
    slicing, and writing the zero there would not."""
    K = 2
    q, sk = _chain_batch(rows * 10 + K + 100, rows, K)
    want = port._long_strip(q, sk, POSITIVE, rows, **MODES[mode])
    zero = port._bias(MODES[mode].get("score_width"))
    assert bool((want[:, LIVE:] != zero).any())
    qks = port.tile_registers(q, rows)
    for label, starts in _slicings(sk.shape[0]):
        got = fused_chain(qks, sk, POSITIVE, rows, starts, **MODES[mode])
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=label)


# (S, rows, T, K) of chip_smoke.py's long cases: (d), (e), (q) and the
# longest job of (s), and the chain's geometry on a card of 132 SMs
CHAIN_SHAPES = [
    ((512, 16, 72064, 2), port.ChainGeometry(2, 2, 4, 32, 4, 128, 64, 16, False)),  # (d)
    ((512, 16, 16448, 4), port.ChainGeometry(4, 2, 4, 32, 4, 128, 128, 8, False)),  # (e)
    ((512, 16, 16640, 32), port.ChainGeometry(4, 2, 4, 32, 4, 128, 128, 8, True)),  # (q)
    ((512, 16, 2272, 32), port.ChainGeometry(4, 2, 4, 32, 4, 128, 128, 2, True)),  # (s)
]


@pytest.mark.parametrize("shape,want", CHAIN_SHAPES)
def test_chain_geometry_at_the_main_shapes(shape, want):
    S, rows, T, K = shape
    got = port.chain_geometry(S, rows, T, K, 132)
    assert got == want
    # the slices of the grid a slice holds at once: the streams' warps
    # times the ring's, K tiles in passes of the ring
    assert got.slices == port.choose_slices(S, rows, T, 132, tiles=got.ring)
    assert got.blocks * got.streams_per_warp >= S


@pytest.mark.parametrize("rows", port.ROWS)
def test_chain_lag_covers_the_shift_and_the_staging(rows):
    """A tile's row 0 reads the tile above's step t + SL - 1 for t up to a
    chunk's last step, which the tile above finished before; the ring's
    first warp stages the wrap strips two chunks ahead; the ring holds
    every step from the lowest one read in a chunk to the highest one
    stored in it."""
    SL, C = port.LANES // rows, port.CHAR_CHUNK
    lag, wrap = port.chain_lag_chunks(rows), port.chain_wrap_lag_chunks(rows)
    assert C * lag > SL + C - 2 >= C * (lag - 1)  # enough, and no chunk more
    assert C * wrap > SL + 3 * C - 3 >= C * (wrap - 1)
    assert C * lag - SL + 10 <= port.RING_STEPS
    assert port.chain_geometry(40, rows, 1024, port.RING_WARPS + 1, 132).wrap
    assert not port.chain_geometry(40, rows, 1024, port.RING_WARPS, 132).wrap


def test_greedy_packer_puts_few_reads_on_the_first_streams():
    """64 long reads on 512 streams, as one of (s)'s jobs packs them, land
    on streams 0-63: whole warps of reads (4 streams a warp at rows 16),
    the other warps pads only, which the chain kernel skips."""
    rng = np.random.default_rng(7)
    targets = [rng.integers(0, 4, size=int(n)).astype(np.int8)
               for n in rng.integers(513, 2049, size=64)]
    b = streams.pack_streams_long(rng.integers(0, 4, size=3000).astype(np.int8), targets,
                                  n_streams=512, rows=16)
    np.testing.assert_array_equal(b.emit_stream, np.arange(64))
    assert bool((b.stream[64:] == 4).all())


def test_chain_wrapper_refuses_cpu_tensors_and_16bit_states():
    """CPU tensors raise in every state; a 16-bit state is taken at rows up
    to 8 and refused at rows 16 with swtpu's ValueError (no rows-16
    instantiation of it exists)."""
    qks = torch.zeros((2, 128, 8), dtype=torch.int8)
    sk = torch.zeros((32, 8), dtype=torch.int8)
    launches = port.stream_chain_cuda.launches
    with pytest.raises(ValueError, match="qks must be a CUDA int8 tensor"):
        port.stream_chain_cuda(qks, sk, DEFAULT_PENALTIES, 16)
    for dtype in port.SIXTEEN_BIT_STATES:
        pen = Penalties(5, 0, 0, 0)
        with pytest.raises(ValueError, match="qks must be a CUDA int8 tensor"):
            port.stream_chain_cuda(qks, sk, pen, 8, state_dtype=dtype)
        with pytest.raises(ValueError, match="rows=16 requires a 32-bit state dtype"):
            port.stream_chain_cuda(qks, sk, pen, 16, state_dtype=dtype)
    assert port.stream_chain_cuda.launches == launches


def test_long_strip_on_the_cpu_runs_the_plain_tiles(monkeypatch):
    """_long_strip with no tile given takes the plain tile for CPU tensors,
    once a tile; the chain kernel only for CUDA tensors."""
    q, sk = _chain_batch(5, 16, 3)
    calls = []
    plain = port.stream_chained_reference

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(port, "stream_chained_reference", counted)
    launches = port.stream_chain_cuda.launches
    port._long_strip(q, sk, DEFAULT_PENALTIES, 16)
    assert len(calls) == 3 and port.stream_chain_cuda.launches == launches
