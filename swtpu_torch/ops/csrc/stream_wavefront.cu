// Streamed anti-diagonal Smith-Waterman wavefront for Hopper (sm_90a).
//
// Replaces the TPU kernels swtpu/ops/pallas_stream.py:_stream_kernel_mr
// (query rows folded R per sublane), pallas_stream.py:_stream_kernel in
// both its forms (R = 1: tail accumulator, or ripple-H) and
// pallas_stream.py:_stream_kernel_mr_chained (one 128-row tile of a
// long-query chain).  The plain PyTorch versions of the same recurrences
// are swtpu_torch/ops/stream.py:stream_strip_reference and
// stream_chained_reference; kernel and plain version must agree bit for
// bit.
//
// Contract.  qk [128, S] int8 is the query register in kernel layout
// (query row k*R + r of segment g of physical stream s at row
// r*(128/R) + g*SLg + k, column s).  sk [T, seg*S] int8 holds the packed
// streams: codes 0-3, +8 on a read's first char, 4 = pad.  strip
// [T, seg*S] int32 receives, for every step t, each segment's tail
// accumulator: strip[t, g*S + s].  No lengths or masks: the sentinel codes
// (query pad 5, stream pad 4) never match.
//
// Ripple-H form (R = 1, tail_acc = 0): each row's H also keeps its own
// previous H, reset at a read's first char, and the strip row is the
// segment tail's H itself.
//
// Chained tiles (B3, seg = 1, stream_chain_kernel; in a 16-bit state
// stream_chain_x2_kernel, the same schedule).  A query of K x 128
// bases is K tiles of 128 query rows.  Tile p+1's row 0 reads tile p's row
// 127 in place of the zero boundary: at step t, diag = f0 ? 0 :
// D127[t + SL - 2], G_up = G127[t + SL - 1], H_up = H127[t + SL - 1] (the
// same column of the same read; SL = 128/R).  One launch runs a chain, in
// every state mode:
//   - a block is P = min(K, 4) warps on one group of streams (the 32/W
//     streams of a warp, twice as many in a 16-bit state, two a thread);
//     warp w runs tiles w, w + P, w + 2P, ..., each
//     kLag char chunks behind the tile above, all warps in lockstep with
//     one __syncthreads a chunk;
//   - warp w hands its row 127 to warp w + 1 through a ring of kRing steps
//     in shared memory, written at every step it computes and read by the
//     next warp's head lanes at the step they use it; the wrap from tile p
//     to tile p + 1 with p + 1 a multiple of P goes through [T, S] strips
//     in device memory, written where the tile writes its outputs, which
//     warp 0 stages into shared memory a chunk of steps at a time, two
//     chunks ahead, 3 values a lane; past the step the tiles stopped at,
//     the boundary is the zero, so no tile waits for steps its producer
//     will not make;
//   - only the last tile writes the accumulator strip.
// kLag covers the shift of SL - 1 steps: floor((SL + 6) / 8) + 1 chunks,
// 2 at rows 16 and 17 at rows 1; the wrap's lag adds the staging's two
// chunks (kWrapLag, 4 at rows 16).  A chain takes about its slice's steps
// plus (P - 1) x kLag chunks a pass of P tiles on the clock.  The
// per-tile contract (swtpu_stream_chained: bD/bG/bH [T, S], the tile
// above's row 127 shifted by the host, in; acc, oD, oG, oH [T, S] out
// wherever the tile writes) is the same kernel at K = 1 with those strips
// switched on (kOneTile), which serves no main path: it is the card's
// witness that the chain equals the per-tile chain.  A tile moves at most 12 bytes
// in and 16 out a stream-step against 128 cells, so the chain is bound by
// the dependent integer chain of each tile.  In a 16-bit state the ring
// holds one packed value a stream pair, so its bytes do not grow, and warp
// 0 packs two int32 strip values into each staged one (Arith::load).
//
// What bounds it.  Per stream-step a segment head reads 1 byte and a
// segment tail writes 4, so the card's memory bandwidth is far from the
// limit.  The limit is the chain of dependent integer ops per step: inside
// a sublane the gap state G of row r feeds row r+1 in the same step, and
// the sublane hand-off feeds the next step.  There is no product and no
// tile to stage, so tensor cores, TMA and wgmma do not apply; what this
// card offers the chain is SMs, warps a scheduler to hide its latency, and
// registers to hold the state.  The design keeps the whole DP state in
// registers and spends nothing else per step:
//   - one stream is W consecutive threads of one warp: W = 8 in the
//     one-tile kernel's 32-bit states (B1) at R = 4, 8, 16, so that each
//     thread owns V = 16/R consecutive wavefront sublanes, 16 query rows,
//     with their D/G/H state and query codes in registers; 16 and 32 at
//     R = 2 and 1, 4 sublanes a thread (kStreamLanesOf, below); the
//     16-bit kernel the same at R = 4 and 8 (8 threads a stream pair) and
//     32 threads a pair at R = 2 and 1; W = min(128/R, 32) threads a
//     stream in the 32-bit chain kernel, min(64/R, 32) a stream pair in
//     the 16-bit one but on the per-tile contract (kChainPairLanes);
//   - the one-sublane shift of the char pipe, D (two steps back), G and H
//     is four __shfl_up_sync per step at width W, and a register move
//     between the V sublanes inside a thread;
//   - a thread loops over the steps itself, so no state crosses blocks
//     (the TPU's sequential grid becomes this loop), and the head thread
//     loads each step's stream char (and a chained tile's boundary values)
//     kChunk steps ahead of its use.
//
// Slices.  S streams of W threads fill few SMs (at S = 512 and W = 8,
// 4,096 threads: 32 blocks for 132 SMs, one warp a scheduler, each step a
// full chain latency).  So each stream's T steps are cut into C time
// slices (blockIdx.y), run side by side, and the grid is S x W x C threads.
// It is exact because the wavefront forgets everything at a read's first
// char (+8 flag): the flag zeroes the diagonal, each row's own D and G, the
// tail accumulator (and in the ripple-H form the row's own H), and what a
// sublane reads from the one above comes from the same flagged char one
// step earlier.  A slice owns nominal steps [b0, b1) and starts at b0 with
// zero state and a pad-filled pipe, as the whole kernel starts at step 0.
// Per segment, from the step its tail sees the first flag that entered at
// or after b0 (slice 0: from step 0), the slice computes exactly what one
// unsliced pass computes, so:
//   - a segment tail writes its column (and in B3 its row 127) from its
//     first flag on, and stops at the first flag that entered at or after
//     b1, that is at a step t >= b1 + SLg - 1; the next slice starts
//     writing at exactly that step (its pipe holds pads until then), so
//     every element is written once, with no communication;
//   - a slice runs past b1 until every tail of its warp has stopped (one
//     __all_sync a char chunk, since the shuffles need the whole warp),
//     or to T; a slice that sees no flag writes nothing, and the one before
//     it runs on to the next flag;
//   - consecutive streams of one slice share a warp, so char loads and
//     strip stores stay as coalesced as with one slice.
// The overlap costs at most a read plus SLg - 1 steps a slice.  The
// wrapper picks C from S, W, T, SLg and the SM count, and where the caller
// gives it the batch's longest read, slices of at least three such reads
// in whole waves of blocks (ops/stream.py choose_slices).
// In a chain every tile of a block uses the same slice and stops at the
// same step (its tails see the same chars), so slice c of tile p+1 needs
// only slice c of tile p: tile p's values from before its first read
// start feed only columns that tile p+1 does not write either.  A chain's
// block first looks for a read start at or after b0 in its streams: with
// none it writes nothing in a slice after the first, and in slice 0 (zero
// boundary, pads only, so every tile's accumulator is the zero where no
// penalty is positive in the state's arithmetic: not with a positive one,
// nor in uint16 with a negative one, which wraps; the host decides and
// picks the instantiation, kQuiet) it writes the zero into the strip and
// computes nothing.
//
// State modes (kState), each form in each, as the TPU kernels have them:
//   - kExact: int32 state, the boundary zero 0, M = max(diag + s, 0);
//   - kBiased: the RTL's W-bit wrap-parity (SCORE_WIDTH) on int32 state
//     (pallas_stream.py's biased_width): every value is biased by
//     zbit = 2^(W-1), which is the boundary zero (initial state, segment
//     heads, read starts), and only M wraps: M = (diag + s) & (2^W - 1),
//     or zbit where that has its sign bit zbit clear, which is
//     max((diag + s) & (2^W - 1), zbit).  I, G, D, H and the
//     accumulator need no mask (the I/G chain cannot wrap: each cell's I
//     has an M + open + extend candidate with M >= zbit).  B1 and B2 store
//     acc - zbit (or H - zbit); B3 reads biased boundary strips and stores
//     all four outputs biased, and the chain unbiases at its gather.  A
//     slice starts from zbit, the same value a read's first char resets
//     to, so the slicing rule above holds unchanged;
//   - kFloat: float32 state (fmaxf, no fused add-max), the same integer
//     values as kExact (all far below 2^24), stored as int32; a chained
//     tile's boundary strips stay int32 in memory;
//   - kInt16, kUint16, kBf16: 16-bit state, two streams a thread (below);
//     int16 and uint16 adds wrap modulo 2^16, so the match and mismatch
//     scores are cut the same way (uint16's -4 is 65532), and the uint16 M
//     update max(x, 0) is x; the host refuses an open or extend penalty the
//     type cannot hold (swtpu's OverflowError).  bfloat16 adds round once to
//     nearest even (as the plain version's and XLA's bfloat16 adds round);
//     the strips store its integer values as int32, and a chained tile
//     rounds its int32 boundary values in.
// The 16-bit modes run at rows <= 8 (swtpu refuses rows 16 with them), and
// every mode's zero is 0 but kBiased's, so the slicing rule holds as it is.
// Each mode is its own instantiation, so the exact kernel's code is what
// it was before the other modes existed; a 32-bit mode adds its own
// arithmetic through Arith's add() and cst(), which are plain + and the
// identity for the first three; the 16-bit modes have kernels of their
// own (stream_wavefront_x2_kernel, stream_chain_x2_kernel).
//
// Two streams a register (the 16-bit modes: stream_wavefront_x2_kernel for
// B1 and B2, stream_chain_x2_kernel for B3).  A
// thread holds the same sublanes of two adjacent streams, 2p in the low
// half of each 32-bit register and 2p + 1 in the high half, and runs the
// step on both at once with Hopper's 16x2 instructions (packed16.cuh): the
// grid is ceil(S/2) stream pairs x W threads x C slices, a shuffle carries
// two streams' state, and one instruction does two cells.  The selects of
// the step become masks (sublane_step_x2): a read start is 0xFFFF in its
// half, and zeroing is an AND.  Both halves share the geometry (segment
// heads and tails, the slice, a chain's tiles and ring), so only the
// chars, the query codes and what the chars decide differ: a tail's
// accumulator reset, whether it writes and whether it is done are per
// half, and a slice stops when both halves of every lane are done.  A dead
// high half (S odd) reads pads and query pads, is done from the start and
// never writes.  The chars and strip values of the two streams are
// adjacent in memory; each is loaded and stored on its own (S odd puts a
// pair at any alignment), once a step and stream, beside the step's 2 x R
// x V cells.  A step's two chars are packed into their slot one step after
// they are loaded, when they have arrived (packing them at once made every
// step wait for its loads: the one-slice tile ran 3x slower).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "packed16.cuh"

namespace {

constexpr int kLanes = 128;   // query rows of the wavefront
constexpr int kFlag = 8;      // first-char marker
constexpr int kPad = 4;       // stream pad char, the pipe's initial fill
constexpr int kQueryPad = 5;  // query pad code
constexpr int kChunk = 8;     // steps whose chars are loaded together
constexpr int kBlock = 128;   // threads per block
// resident blocks an SM must hold (12 warps): caps a thread at 168
// registers.  The chained tile at R = 16 takes 132; at a cap of 128 (4
// blocks) it spilled and ran 6-11 % slower sliced.
constexpr int kMinBlocks = 3;
constexpr int kSliceQuantum = 32;  // slice starts are multiples of this
constexpr unsigned kFull = 0xffffffffu;

// the state modes; the values are the host's state codes (ops/stream.py)
enum StateMode { kExact, kBiased, kFloat, kInt16, kUint16, kBf16 };

__device__ __forceinline__ int mx(int a, int b) { return max(a, b); }
__device__ __forceinline__ float mx(float a, float b) { return fmaxf(a, b); }

// The arithmetic of each state mode: the state type T, a penalty as T
// (cst), the boundary zero, an add, the M update, what a one-tile form
// stores (emit) and what a chained tile stores (store) and reads (load).
template <int kState>
struct Arith;

template <>
struct Arith<kExact> {
  using T = int;
  __device__ explicit Arith(int) {}
  __device__ int cst(int x) const { return x; }
  __device__ int zero() const { return 0; }
  __device__ int add(int x, int y) const { return x + y; }
  __device__ int m(int x) const { return max(x, 0); }
  __device__ int emit(int x) const { return x; }
  __device__ int store(int x) const { return x; }
  __device__ int load(int x) const { return x; }
};

template <>
struct Arith<kBiased> {
  using T = int;
  int zbit, mask;
  __device__ explicit Arith(int width)
      : zbit(1 << (width - 1)), mask((1 << width) - 1) {}
  __device__ int cst(int x) const { return x; }
  __device__ int zero() const { return zbit; }
  __device__ int add(int x, int y) const { return x + y; }
  // the W-bit adder's wrap, then the sign-bit clamp: x & mask lies in
  // [0, 2^W), so "ms if its sign bit zbit is set, else zbit" is max(ms, zbit)
  __device__ int m(int x) const { return max(x & mask, zbit); }
  __device__ int emit(int x) const { return x - zbit; }
  __device__ int store(int x) const { return x; }
  __device__ int load(int x) const { return x; }
};

template <>
struct Arith<kFloat> {
  using T = float;
  __device__ explicit Arith(int) {}
  __device__ float cst(int x) const { return static_cast<float>(x); }
  __device__ float zero() const { return 0.f; }
  __device__ float add(float x, float y) const { return x + y; }
  __device__ float m(float x) const { return fmaxf(x, 0.f); }
  __device__ int emit(float x) const { return static_cast<int>(x); }
  __device__ int store(float x) const { return static_cast<int>(x); }
  __device__ float load(int x) const { return static_cast<float>(x); }
};

// The 16-bit states hold two streams a thread: T is a 32-bit register of
// two 16-bit values (packed16.cuh), the arithmetic is X's, a chained tile
// reads two int32 boundary values into one register (load) and emit and
// store give half h as an int32.  int16 and uint16 cut a penalty and a
// boundary value to 16 bits, as the plain version's casts do.
template <class X>
struct Packed : X {
  using T = unsigned;
  __device__ T zero() const { return 0u; }
  __device__ int emit(T x, int h) const { return this->widen(x, h); }
  __device__ int store(T x, int h) const { return this->widen(x, h); }
};

template <>
struct Arith<kInt16> : Packed<Int16x2> {
  __device__ explicit Arith(int) {}
  __device__ T cst(int x) const { return splat16(x); }
  __device__ T load(int lo, int hi) const { return pack16(lo, hi); }
};

template <>
struct Arith<kUint16> : Packed<Uint16x2> {
  __device__ explicit Arith(int) {}
  __device__ T cst(int x) const { return splat16(x); }
  __device__ T load(int lo, int hi) const { return pack16(lo, hi); }
};

template <>
struct Arith<kBf16> : Packed<Bf16x2> {
  __device__ explicit Arith(int) {}
  __device__ T cst(int x) const { return bf16_bits(x) * 0x10001u; }
  __device__ T load(int lo, int hi) const {
    return bf16_bits(lo) | static_cast<unsigned>(bf16_bits(hi)) << 16;
  }
};

// whether a state mode holds two streams a thread
template <int kState>
constexpr bool kPacked = kState == kInt16 || kState == kUint16 || kState == kBf16;

// One step of one sublane: R query rows, one char.  g_up, h_up and d_diag
// are the sublane above's G[R-1] and H from the previous step and its
// D[R-1] from two steps back.  Updates D, G (rows 0..R-1), d2l (this
// sublane's D[R-1] from the previous step, which the sublane below reads
// next step) and h; returns whether the char starts a read.  kRipple keeps
// the sublane's own previous h too (the ripple-H form, R = 1).
template <int R, bool kRipple, class A, class T = typename A::T>
__device__ __forceinline__ bool sublane_step(
    const A& ar, int c, bool seghead, T g_up, T h_up, T d_diag,
    const int (&q)[R], T (&D)[R], T (&G)[R], T& d2l, T& h, T ma, T mi, T go,
    T ge) {
  const bool f0 = c >= kFlag;
  const int cv = c & 7;
  const T z = ar.zero();
  const T diag = (seghead || f0) ? z : d_diag;
  T M = ar.m(ar.add(diag, cv == q[0] ? ma : mi));
  T I = ar.add(mx(seghead ? z : g_up, f0 ? z : G[0]), ge);
  T hc = mx(seghead ? z : h_up, M);
  if (kRipple) hc = mx(hc, f0 ? z : h);
  T dprev = D[0];
  d2l = D[R - 1];
  D[0] = mx(M, I);
  T g = mx(ar.add(M, go), I);
  G[0] = g;
#pragma unroll
  for (int r = 1; r < R; ++r) {
    const T dr = f0 ? z : dprev;
    dprev = D[r];
    M = ar.m(ar.add(dr, cv == q[r] ? ma : mi));
    I = ar.add(mx(g, f0 ? z : G[r]), ge);
    hc = mx(hc, M);
    D[r] = mx(M, I);
    g = mx(ar.add(M, go), I);
    G[r] = g;
  }
  h = hc;
  return f0;
}

// The same step on two streams at once (a packed 16-bit state): c and q
// hold each stream's char and query codes in their halves.  Returns the
// read starts, 0xFFFF in each half whose char starts a read: its bit 3,
// moved to the half's top bit.  seghead is the same for both halves.
template <int R, bool kRipple, class A>
__device__ __forceinline__ unsigned sublane_step_x2(
    const A& ar, unsigned c, bool seghead, unsigned g_up, unsigned h_up,
    unsigned d_diag, const unsigned (&q)[R], unsigned (&D)[R], unsigned (&G)[R],
    unsigned& d2l, unsigned& h, unsigned ma, unsigned mi, unsigned go,
    unsigned ge) {
  const unsigned f0 = sign_halves(c << 12);
  const unsigned keep = ~f0;
  const unsigned diag = seghead ? 0u : d_diag & keep;
  unsigned M = ar.m(diag, score16x2(c, q[0], ma, mi));
  unsigned I = ar.add(ar.max(seghead ? 0u : g_up, G[0] & keep), ge);
  unsigned hc = ar.max(seghead ? 0u : h_up, M);
  if (kRipple) hc = ar.max(hc, h & keep);
  unsigned dprev = D[0];
  d2l = D[R - 1];
  D[0] = ar.max(M, I);
  unsigned g = ar.addmax(M, go, I);
  G[0] = g;
#pragma unroll
  for (int r = 1; r < R; ++r) {
    const unsigned dr = dprev & keep;
    dprev = D[r];
    M = ar.m(dr, score16x2(c, q[r], ma, mi));
    I = ar.add(ar.max(g, G[r] & keep), ge);
    hc = ar.max(hc, M);
    D[r] = ar.max(M, I);
    g = ar.addmax(M, go, I);
    G[r] = g;
  }
  h = hc;
  return f0;
}

// What a launch computes: the strip of tail accumulators (B1, B2), the
// strip of tail H (B2 ripple-H), or one chained tile (B3); kChainMode
// and kChainAllGroups name the whole chain (stream_chain_kernel or
// stream_chain_x2_kernel) to swtpu_stream_kernel_info, with the pad
// shortcut (kQuiet) and without it.
enum Mode { kTailAcc, kRippleH, kChained, kChainMode, kChainAllGroups };

struct Args {
  const int8_t* qk;
  const int8_t* sk;
  int32_t* strip;
  int S, T, seg, ma, mi, go, ge;
  int width;  // kBiased only: W
};

// Threads a stream of stream_wavefront_kernel (B1, B2) in a 32-bit state:
// a thread holds V = min(16 / R, kMaxSublanes) sublanes, so 16 query rows
// at rows 4, 8 and 16 (W = 8 threads a stream), and pays the step's fixed
// work (the four shuffles, the char slot, the tail's selects and store,
// the loop) once for 16 cells, as rows 16 did alone before; the V
// sublanes of a thread are independent within a step, which adds
// instruction-level parallelism where rows 16 has one chain of 16 rows.
// At rows 2 and 1 more sublanes spilled registers (8 sublanes at rows 2,
// 16 at rows 1), and rows 1's 127-step pipe fill a slice wants the threads
// (on an H100, B2 on E2's [4096, 512] strip took 0.541 ms at its best slice
// count with 8 threads a stream, 0.343 with 32), so there a thread holds 4
// sublanes: 16 and 32 threads a stream.  A segment
// holds SLg = 128 / (R x seg) sublanes, a multiple of V, so a segment's
// head and tail are a thread's first and last sublanes.  The 16-bit
// kernel (two streams a thread) takes the same mapping at R = 4 and 8, 8
// threads a stream pair of 2 x 16 query rows each, and keeps 32 threads a
// pair at R = 2 and 1 (V = 2 and 4), where more sublanes spilled in the
// 32-bit kernel.  The chain kernels have their own mappings.
constexpr int kRowsPerThread = 16;
constexpr int kMaxSublanes = 4;

template <int R>
constexpr int kSublanesOf =
    kRowsPerThread / R < kMaxSublanes ? kRowsPerThread / R : kMaxSublanes;

template <int R, bool kPackedState>
constexpr int kStreamLanesOf = kPackedState && R < 4 ? 32 : kLanes / R / kSublanesOf<R>;

template <int R, int kMode, int kState>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    stream_wavefront_kernel(const Args a) {
  static_assert(kMode != kChained, "the 32-bit chained tile is stream_chain_kernel");
  using A = Arith<kState>;
  using T = typename A::T;
  const A ar(a.width);
  const T ma = ar.cst(a.ma), mi = ar.cst(a.mi), go = ar.cst(a.go),
          ge = ar.cst(a.ge), z = ar.zero();
  constexpr int SL = kLanes / R;                   // wavefront sublanes per stream
  constexpr int W = kStreamLanesOf<R, false>;      // threads per stream
  constexpr int V = SL / W;                        // sublanes per thread
  static_assert(W * V == SL && V == kSublanesOf<R>, "V sublanes a thread");
  constexpr bool kRipple = kMode == kRippleH;
  const int S = a.S;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = tid / W;
  const int lane = tid % W;
  // threads past the last stream run the loop (the shuffles need the
  // whole warp) but read and write nothing
  const bool live = s < S;
  const int SLg = SL / a.seg;  // sublanes per segment; a multiple of V
  const int p0 = lane * V;     // this thread's first sublane
  const int pt = p0 + V - 1;   // and last
  const bool head = live && p0 % SLg == 0;
  const bool tail = live && pt % SLg == SLg - 1;
  const size_t ld = (size_t)a.seg * S;
  const int8_t* src = a.sk + (size_t)(p0 / SLg) * S + s;
  int32_t* dst = a.strip + (size_t)(pt / SLg) * S + s;

  // this block's slice: nominal steps [b0, b1)
  const int slice = blockIdx.y;
  const int quanta = a.T / kSliceQuantum;
  const int b0 = kSliceQuantum * (int)((long long)slice * quanta / gridDim.y);
  const int b1 = slice + 1 == (int)gridDim.y
                     ? a.T
                     : kSliceQuantum * (int)((long long)(slice + 1) * quanta / gridDim.y);
  // a tail flag at this step or later entered at or after b1: the next
  // slice's to write
  const int handover = b1 + SLg - 1;
  // slice 0 writes from step 0, the others from their first tail flag;
  // a thread that is no segment tail never writes and is always done
  bool writing = tail && slice == 0;
  bool done = !tail;

  int q[V][R], C[V];
  T D[V][R], G[V][R], D2L[V], H[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    C[v] = kPad;
    D2L[v] = z;
    H[v] = z;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      D[v][r] = z;
      G[v][r] = z;
      q[v][r] = live ? a.qk[(size_t)(r * SL + p0 + v) * S + s] : kQueryPad;
    }
  }
  T acc = z;

  // slot k holds the head's char of step t0 + k (a pad off the head); once
  // used it is refilled with step t0 + kChunk + k, so each load is issued a
  // chunk ahead of its use and across the slice's early exit (loading each
  // chunk at its top instead left the one-slice kernel 24-29 % slower).  A
  // chunk never straddles T (T % 8 == 0, b0 % 32 == 0), so one test covers
  // a chunk.
  int cin[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) cin[k] = head ? src[(size_t)(b0 + k) * ld] : kPad;
  for (int t0 = b0; t0 < a.T; t0 += kChunk) {
    if (t0 >= b1 && __all_sync(kFull, done)) break;
    const bool next = head && t0 + kChunk < a.T;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int c_in = cin[k];
      cin[k] = next ? src[(size_t)(t0 + kChunk + k) * ld] : kPad;
      // the sublane above this thread's first one lives in lane - 1
      const int nC = __shfl_up_sync(kFull, C[V - 1], 1, W);
      const T nG = __shfl_up_sync(kFull, G[V - 1][R - 1], 1, W);
      const T nH = __shfl_up_sync(kFull, H[V - 1], 1, W);
      const T nD = __shfl_up_sync(kFull, D2L[V - 1], 1, W);
      bool f0_tail = false;
      // last sublane first, so each one still reads its upper
      // neighbour's state from the previous step
#pragma unroll
      for (int v = V - 1; v >= 1; --v) {
        C[v] = C[v - 1];
        const bool f0 = sublane_step<R, kRipple>(
            ar, C[v], false, G[v - 1][R - 1], H[v - 1], D2L[v - 1], q[v],
            D[v], G[v], D2L[v], H[v], ma, mi, go, ge);
        if (v == V - 1) f0_tail = f0;
      }
      C[0] = head ? c_in : nC;
      // a segment head sees zero boundaries
      const bool f0 = sublane_step<R, kRipple>(
          ar, C[0], head, nG, nH, nD, q[0], D[0], G[0], D2L[0], H[0], ma, mi,
          go, ge);
      if (V == 1) f0_tail = f0;
      // branch-free, so that the tail lanes do not split the warp: every
      // lane keeps an accumulator, only a writing tail stores.  Every flag
      // from the handover on is the next slice's, so a flag's step alone
      // says whether this slice writes on.
      const int t = t0 + k;
      if (!kRipple) acc = mx(f0_tail ? z : acc, H[V - 1]);
      writing = f0_tail ? tail && t < handover : writing;
      done = f0_tail ? !writing : done;
      if (writing) dst[(size_t)t * ld] = ar.emit(kRipple ? H[V - 1] : acc);
    }
  }
}

// The chars of streams s and s + 1 at step t of a segment head, as loaded
// (src at the head's stream s, ld the step's stride): pads off the head
// and in a dead high half.
__device__ __forceinline__ void fetch_x2(const int8_t* src, size_t ld, bool in, bool in_hi,
                                         int t, int (&c)[2]) {
  const int8_t* p = src + (size_t)t * ld;
  c[0] = in ? p[0] : kPad;
  c[1] = in && in_hi ? p[1] : kPad;
}

// The chained tiles of a long query (B3) in a 32-bit state: one launch a
// chain, a block's P warps on one group of streams, warp w running tiles
// w, w + P, ... kLag chunks behind the tile above (see the header).
// kQuiet: pads alone leave every state at the boundary zero (no penalty
// is positive; the host's pads_stay_at_zero), so that a chain's group with
// no read start writes the zero in slice 0 and computes nothing.  It is a
// template argument, not a test of ChainArgs: a runtime test moved ptxas's
// register allocation in 10 of the 30 instantiations (up to 13 registers)
// and the int32 chain at rows 8 ran 6 % slower on an H100.
constexpr int kRingWarps = kBlock / 32;  // P at most: tiles a block runs side by side
constexpr int kRing = 32;                // steps of row 127 a ring holds
constexpr int kGroupMax = 4;             // streams (pairs) a warp holds at most
constexpr int kScanLoads = 4;            // chars a thread loads a round of the scan

struct ChainArgs {
  const int8_t* qk;   // [K, 128, S]: tile p's register at qk + p * 128 * S
  const int8_t* sk;   // [T, S]
  const int32_t* bD;  // one tile: the tile above's row 127, shifted by the host
  const int32_t* bG;
  const int32_t* bH;
  int32_t* strip;  // [T, S]: the last tile's accumulator
  int32_t* oD;     // one tile: its own row 127; a chain: the wrap strips
  int32_t* oG;
  int32_t* oH;
  int S, T, K, ma, mi, go, ge;
  int width;  // kBiased only: W
};

// kOneTile: one tile on the per-tile contract (K = 1, the strips in and out)
template <int R, int kState, bool kOneTile, bool kQuiet>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    stream_chain_kernel(const ChainArgs a) {
  using A = Arith<kState>;
  using T = typename A::T;
  const A ar(a.width);
  const T ma = ar.cst(a.ma), mi = ar.cst(a.mi), go = ar.cst(a.go),
          ge = ar.cst(a.ge), z = ar.zero();
  constexpr int SL = kLanes / R;        // wavefront sublanes per stream
  constexpr int W = SL < 32 ? SL : 32;  // threads per stream
  constexpr int V = SL / W;             // sublanes per thread
  constexpr int NG = 32 / W;            // streams a warp holds
  // chunks a tile runs behind the tile above in the ring: its row 0 reads
  // the producer's step t + SL - 1 for t up to a chunk's last step, which
  // the producer finished an iteration before
  constexpr int kLag = (SL + kChunk - 2) / kChunk + 1;
  // and behind the wrap strips: warp 0 stages them two chunks ahead
  constexpr int kWrapLag = (SL + 3 * kChunk - 3) / kChunk + 1;
  // the ring holds every step from the lowest one a consumer reads in an
  // iteration to the highest one its producer stores in it
  static_assert(kChunk * kLag - SL + 10 <= kRing, "the ring is too short for the lag");
  static_assert(NG <= kGroupMax, "a warp holds more streams than the ring");
  const int S = a.S, nT = a.T;
  const int P = blockDim.x / 32;
  const int w = threadIdx.x / 32;      // this warp's place in the ring
  const int g = threadIdx.x % 32 / W;  // its stream in the group
  const int lane = threadIdx.x % W;
  const int s0 = blockIdx.x * NG;  // the group's first stream
  const int s = s0 + g;
  // threads past the last stream run the loop (the shuffles need the
  // whole warp) but read and write nothing
  const bool live = s < S;
  const int p0 = lane * V;  // this thread's first sublane
  const bool head = live && p0 == 0;
  const bool tail = live && p0 + V - 1 == SL - 1;
  const int8_t* src = a.sk + s;

  // this block's slice: nominal steps [b0, b1), as in stream_wavefront_kernel
  const int slice = blockIdx.y;
  const int quanta = nT / kSliceQuantum;
  const int b0 = kSliceQuantum * (int)((long long)slice * quanta / gridDim.y);
  const int b1 = slice + 1 == (int)gridDim.y
                     ? nT
                     : kSliceQuantum * (int)((long long)(slice + 1) * quanta / gridDim.y);
  const int handover = b1 + SL - 1;

  // row 127's D, G and H by step: ring[w] is warp w's for warp w + 1; the
  // last, kStage, holds warp 0's row-0 boundary staged from device memory
  // (the wrap strips, or the per-tile contract's strips)
  constexpr int kStage = kRingWarps - 1;
  __shared__ T ring[kRingWarps][kRing][kGroupMax][3];
  __shared__ int s_end;  // the step the block's tiles stopped at (T before)

  // a read start in the group's streams at or after b0?  Without one a
  // slice after the first writes nothing, and slice 0 of a chain (zero
  // boundary, pads only) writes the zero that every tile's accumulator
  // holds where kQuiet (else it runs as it is); the per-tile contract's
  // slice 0 runs as it is
  if (slice > 0 || (!kOneTile && kQuiet)) {
    const int per = blockDim.x / NG;  // steps one load of the block covers
    const int ts = threadIdx.x / NG, ss = s0 + threadIdx.x % NG;
    bool any = false;
    for (int tb = b0; tb < nT && !any; tb += kScanLoads * per) {
      bool f = false;
#pragma unroll
      for (int u = 0; u < kScanLoads; ++u) {
        const int t = tb + u * per + ts;
        if (t < nT && ss < S && a.sk[(size_t)t * S + ss] >= kFlag) f = true;
      }
      any = __syncthreads_or(f);
    }
    if (!any) {
      if (slice == 0) {
        for (int t = ts; t < nT; t += per) {
          if (ss < S) a.strip[(size_t)t * S + ss] = ar.store(z);
        }
      }
      return;
    }
  }
  if (threadIdx.x == 0) s_end = nT;
  __syncthreads();
  volatile int* const end_at = &s_end;

  // row 0 reads the tile above's row 127 at t + shd (D) and t + shg (G, H);
  // the per-tile contract's strips are shifted by the host
  constexpr int shd = kOneTile ? 0 : SL - 2, shg = kOneTile ? 0 : SL - 1;
  // the strips warp 0 stages: D, G and H (a select, not an array: a
  // runtime index would put the array in local memory)
  auto strip_of = [&](int v) {
    return v == 0 ? (kOneTile ? a.bD : a.oD) : v == 1 ? (kOneTile ? a.bG : a.oG)
                                                       : (kOneTile ? a.bH : a.oH);
  };
  const int wl = threadIdx.x % 32;  // lane in the warp
  // Warp 0 stages the strips a chunk of steps at a time: staging chunk m
  // is row 127 at steps b0 + 8m + shd + j, j < 8; chunk c of a tile reads
  // staging chunks c and c + 1.  A lane loads up to 3 of its 24 x NG
  // values (D, G, H of 8 steps of NG streams), streams fastest, the zero
  // past `lim`; the loads of one chunk are stored a chunk later.
  int staged[3];
  auto stage_load = [&](int m, int lim) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int i = wl + 32 * u;
      const int gs = i % NG, j = i / NG % kChunk, v = i / (NG * kChunk);
      const int x = b0 + kChunk * m + shd + j;
      staged[u] = i < 3 * kChunk * NG && x < lim && s0 + gs < S
                      ? strip_of(v)[(size_t)x * S + s0 + gs]
                      : ar.store(z);
    }
  };
  auto stage_store = [&](int m) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int i = wl + 32 * u;
      const int gs = i % NG, j = i / NG % kChunk, v = i / (NG * kChunk);
      const int x = b0 + kChunk * m + shd + j;
      if (i < 3 * kChunk * NG) ring[kStage][(x - b0) & (kRing - 1)][gs][v] = ar.load(staged[u]);
    }
    __syncwarp();
  };

  int q[V][R], C[V];
  T D[V][R], G[V][R], D2L[V], H[V];
  T acc = z;
  bool writing = false, done = true;
  // slot k holds the head's char of step t0 + k, refilled a chunk ahead as
  // in stream_wavefront_kernel
  int cin[kChunk];
  // this warp's tile p, which starts at iteration `start` and is at its
  // chunk c (-1 between tiles); where its row 0 reads: the ring of the
  // warp above, or its staged strips (warp 0 below tile 0, or one tile),
  // up to step `lim` (b0 for a chain's tile 0: the zero boundary)
  int p = w, start = w * kLag, c = -1;
  const int from = w > 0 ? w - 1 : kStage;
  const bool staging = w == 0 && (kOneTile || P < a.K);

  for (int it = 0;; ++it) {
    if (c < 0 && p < a.K && it == start) {  // tile p starts
      const int8_t* qk = a.qk + (size_t)p * kLanes * S;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        C[v] = kPad;
        D2L[v] = z;
        H[v] = z;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          D[v][r] = z;
          G[v][r] = z;
          q[v][r] = live ? qk[(size_t)(r * SL + p0 + v) * S + s] : kQueryPad;
        }
      }
      acc = z;
      // slice 0 writes from step 0, the others from their first tail flag;
      // a thread that is no tail never writes and is always done
      writing = tail && slice == 0;
      done = !tail;
      c = 0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) cin[k] = head ? src[(size_t)(b0 + k) * S] : kPad;
      if (staging && (kOneTile || p > 0)) {
        const int lim = *end_at;
        stage_load(0, lim);
        stage_store(0);
        stage_load(1, lim);
        stage_store(1);
        stage_load(2, lim);
      }
    }
    if (c >= 0) {
      const int t0 = b0 + kChunk * c;
      if (t0 >= nT || (t0 >= b1 && __all_sync(kFull, done))) {
        // the tile stops where every tile of the block stops (its tails
        // see the same chars); the warp's next tile starts once this run
        // and the lags allow
        if (wl == 0) *end_at = t0;
        p += P;
        start = max(it + 1, it - c + (P - 1) * kLag + kWrapLag);
        c = -1;
      } else {
        const bool next = head && t0 + kChunk < nT;
        const int lim = kOneTile || p > 0 ? *end_at : b0;
        if (staging && (kOneTile || p > 0) && c > 0) {
          stage_store(c + 1);
          stage_load(c + 2, lim);
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int t = t0 + k;
          const int c_in = cin[k];
          cin[k] = next ? src[(size_t)(t + kChunk) * S] : kPad;
          // the tile above's row 127: D at t + shd, G and H at t + shg
          T d_in = z, g_in = z, h_in = z;
          if (head && t + shd < lim) d_in = ring[from][(t + shd - b0) & (kRing - 1)][g][0];
          if (head && t + shg < lim) {
            g_in = ring[from][(t + shg - b0) & (kRing - 1)][g][1];
            h_in = ring[from][(t + shg - b0) & (kRing - 1)][g][2];
          }
          // the sublane above this thread's first one lives in lane - 1
          const int nC = __shfl_up_sync(kFull, C[V - 1], 1, W);
          const T nG = __shfl_up_sync(kFull, G[V - 1][R - 1], 1, W);
          const T nH = __shfl_up_sync(kFull, H[V - 1], 1, W);
          const T nD = __shfl_up_sync(kFull, D2L[V - 1], 1, W);
          bool f0_tail = false;
#pragma unroll
          for (int v = V - 1; v >= 1; --v) {
            C[v] = C[v - 1];
            const bool f0 = sublane_step<R, false>(
                ar, C[v], false, G[v - 1][R - 1], H[v - 1], D2L[v - 1], q[v],
                D[v], G[v], D2L[v], H[v], ma, mi, go, ge);
            if (v == V - 1) f0_tail = f0;
          }
          C[0] = head ? c_in : nC;
          // the tile's row 0 reads the tile above's row 127
          const bool f0 = sublane_step<R, false>(
              ar, C[0], false, head ? g_in : nG, head ? h_in : nH,
              head ? d_in : nD, q[0], D[0], G[0], D2L[0], H[0], ma, mi, go, ge);
          if (V == 1) f0_tail = f0;
          acc = mx(f0_tail ? z : acc, H[V - 1]);
          writing = f0_tail ? tail && t < handover : writing;
          done = f0_tail ? !writing : done;
          // the last tile writes the accumulator; a tile above the last one
          // hands its row 127 to the next warp every step, or if it is the
          // ring's last warp writes it to the wrap strips
          const bool last = kOneTile || p == a.K - 1;
          if (!kOneTile && !last && w < P - 1 && tail) {
            T* r = ring[w][(t - b0) & (kRing - 1)][g];
            r[0] = D[V - 1][R - 1];
            r[1] = G[V - 1][R - 1];
            r[2] = H[V - 1];
          }
          if (writing) {
            const size_t o = (size_t)t * S + s;
            if (last) a.strip[o] = ar.store(acc);
            if (kOneTile || (!last && w == P - 1)) {
              a.oD[o] = ar.store(D[V - 1][R - 1]);
              a.oG[o] = ar.store(G[V - 1][R - 1]);
              a.oH[o] = ar.store(H[V - 1]);
            }
          }
        }
        ++c;
      }
    }
    if (!__syncthreads_or(p < a.K)) break;
  }
}

// The chained tiles of a long query (B3) in a 16-bit state: the same
// schedule as stream_chain_kernel (slices, a block's P warps on one group
// of streams, each kLag chunks behind the tile above, the ring, the wrap
// strips, the skipped groups), with two adjacent streams a thread, one in
// each half of its registers, as stream_wavefront_x2_kernel holds them,
// and two sublanes of them at R = 2 to 8: W = min(64 / R, 32) threads a
// stream pair (kChainPairLanes; 8 at R = 8, so a warp's group is 4
// pairs).  A thread's fixed work a step (shuffles, ring, char slot, the
// tails' selects) is paid for 2 x 2 x R cells, and its row-0 read of the
// ring has two sublanes' work to hide behind: at one sublane, rows 8, the
// chain ran no faster than the per-tile launches it replaced; four
// sublanes, B1's mapping at rows 4, spilled.  The ring holds one packed
// value a pair, so its bytes do not grow; warp 0 packs a staged pair of
// int32 strip values as it loads it (Arith::load: one register held, not
// two, at the register cap); a tail's accumulator reset, writes and done
// are per half.  The per-tile contract (kOneTile) serves no main path: it
// is the card's witness that the chain equals the per-tile chain.  It
// keeps one sublane a thread, min(128 / R, 32) threads a pair: it stages
// and stores all four strips every step, and at two sublanes it spilled in
// uint16 at rows 8 (8 bytes), or at 2 blocks an SM fell short of the
// resident warps that the slice rule counts on.  kQuiet as in
// stream_chain_kernel.
template <int R, bool kOneTile>
constexpr int kChainPairLanes = kOneTile ? (kLanes / R < 32 ? kLanes / R : 32)
                                         : (kLanes / R / 2 < 32 ? kLanes / R / 2 : 32);

template <int R, int kState, bool kOneTile, bool kQuiet>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    stream_chain_x2_kernel(const ChainArgs a) {
  using A = Arith<kState>;
  const A ar(a.width);
  const unsigned ma = ar.cst(a.ma), mi = ar.cst(a.mi), go = ar.cst(a.go),
                 ge = ar.cst(a.ge), z = 0u;
  constexpr int SL = kLanes / R;                // wavefront sublanes per stream
  constexpr int W = kChainPairLanes<R, kOneTile>;  // threads per stream pair
  constexpr int V = SL / W;                     // sublanes per thread
  constexpr int NG = 32 / W;                    // stream pairs a warp holds
  constexpr int NS = 2 * NG;                    // streams a warp holds
  // the lags and the ring as in stream_chain_kernel
  constexpr int kLag = (SL + kChunk - 2) / kChunk + 1;
  constexpr int kWrapLag = (SL + 3 * kChunk - 3) / kChunk + 1;
  static_assert(kChunk * kLag - SL + 10 <= kRing, "the ring is too short for the lag");
  static_assert(NG <= kGroupMax, "a warp holds more stream pairs than the ring");
  const int S = a.S, nT = a.T;
  const int P = blockDim.x / 32;
  const int w = threadIdx.x / 32;      // this warp's place in the ring
  const int g = threadIdx.x % 32 / W;  // its stream pair in the group
  const int lane = threadIdx.x % W;
  const int s0 = blockIdx.x * NS;  // the group's first stream
  const int s = s0 + 2 * g;        // this thread's first stream
  // threads past the last stream run the loop (the shuffles need the
  // whole warp) but read and write nothing; a high half past S is dead
  const bool live = s < S;
  const bool live_hi = s + 1 < S;
  const int p0 = lane * V;  // this thread's first sublane
  const bool head = live && p0 == 0;
  const bool tail = live && p0 + V - 1 == SL - 1;
  const int8_t* src = a.sk + s;

  // this block's slice: nominal steps [b0, b1), as in stream_wavefront_kernel
  const int slice = blockIdx.y;
  const int quanta = nT / kSliceQuantum;
  const int b0 = kSliceQuantum * (int)((long long)slice * quanta / gridDim.y);
  const int b1 = slice + 1 == (int)gridDim.y
                     ? nT
                     : kSliceQuantum * (int)((long long)(slice + 1) * quanta / gridDim.y);
  const int handover = b1 + SL - 1;

  // row 127's D, G and H by step, a stream pair a value (see
  // stream_chain_kernel)
  constexpr int kStage = kRingWarps - 1;
  __shared__ unsigned ring[kRingWarps][kRing][kGroupMax][3];
  __shared__ int s_end;  // the step the block's tiles stopped at (T before)

  // a read start in the group's streams at or after b0?  As in
  // stream_chain_kernel; the zero a 16-bit strip holds is 0
  if (slice > 0 || (!kOneTile && kQuiet)) {
    const int per = blockDim.x / NS;  // steps one load of the block covers
    const int ts = threadIdx.x / NS, ss = s0 + threadIdx.x % NS;
    bool any = false;
    for (int tb = b0; tb < nT && !any; tb += kScanLoads * per) {
      bool f = false;
#pragma unroll
      for (int u = 0; u < kScanLoads; ++u) {
        const int t = tb + u * per + ts;
        if (t < nT && ss < S && a.sk[(size_t)t * S + ss] >= kFlag) f = true;
      }
      any = __syncthreads_or(f);
    }
    if (!any) {
      if (slice == 0) {
        for (int t = ts; t < nT; t += per) {
          if (ss < S) a.strip[(size_t)t * S + ss] = 0;
        }
      }
      return;
    }
  }
  if (threadIdx.x == 0) s_end = nT;
  __syncthreads();
  volatile int* const end_at = &s_end;

  // row 0 reads the tile above's row 127 at t + shd (D) and t + shg (G, H);
  // the per-tile contract's strips are shifted by the host
  constexpr int shd = kOneTile ? 0 : SL - 2, shg = kOneTile ? 0 : SL - 1;
  auto strip_of = [&](int v) {
    return v == 0 ? (kOneTile ? a.bD : a.oD) : v == 1 ? (kOneTile ? a.bG : a.oG)
                                                       : (kOneTile ? a.bH : a.oH);
  };
  const int wl = threadIdx.x % 32;  // lane in the warp
  // Warp 0 stages the strips as stream_chain_kernel does, a lane up to 3
  // of the 24 x NG packed values of a chunk (D, G, H of 8 steps of NG
  // pairs), each pair's two int32 values packed as they are loaded
  unsigned staged[3];
  auto stage_load = [&](int m, int lim) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int i = wl + 32 * u;
      const int gs = i % NG, j = i / NG % kChunk, v = i / (NG * kChunk);
      const int x = b0 + kChunk * m + shd + j;
      const bool in = i < 3 * kChunk * NG && x < lim;
      const int sh = s0 + 2 * gs;
      const int32_t* src2 = strip_of(v) + (size_t)x * S + sh;
      staged[u] = ar.load(in && sh < S ? src2[0] : 0, in && sh + 1 < S ? src2[1] : 0);
    }
  };
  auto stage_store = [&](int m) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int i = wl + 32 * u;
      const int gs = i % NG, j = i / NG % kChunk, v = i / (NG * kChunk);
      const int x = b0 + kChunk * m + shd + j;
      if (i < 3 * kChunk * NG) ring[kStage][(x - b0) & (kRing - 1)][gs][v] = staged[u];
    }
    __syncwarp();
  };

  unsigned q[V][R], C[V];
  unsigned D[V][R], G[V][R], D2L[V], H[V];
  unsigned acc = z;
  bool writing[2] = {false, false}, done[2] = {true, true};
  // slot k holds the head's two chars of step t0 + k, refilled a chunk
  // ahead; `pend` holds the last step's two loads until they are packed
  // into their slot, a step after they were issued (the header)
  unsigned cin[kChunk];
  int pend[2];
  // the warp's tile p, as in stream_chain_kernel
  int p = w, start = w * kLag, c = -1;
  const int from = w > 0 ? w - 1 : kStage;
  const bool staging = w == 0 && (kOneTile || P < a.K);

  for (int it = 0;; ++it) {
    if (c < 0 && p < a.K && it == start) {  // tile p starts
      const int8_t* qk = a.qk + (size_t)p * kLanes * S;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        C[v] = splat16(kPad);
        D2L[v] = z;
        H[v] = z;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          D[v][r] = z;
          G[v][r] = z;
          const int8_t* qp = qk + (size_t)(r * SL + p0 + v) * S + s;
          q[v][r] = pack16(live ? qp[0] : kQueryPad, live_hi ? qp[1] : kQueryPad);
        }
      }
      acc = z;
      // slice 0 writes from step 0, the others from their first tail flag;
      // a thread that is no tail, or a dead high half, never writes and is
      // always done
      writing[0] = tail && slice == 0;
      done[0] = !tail;
      writing[1] = tail && live_hi && slice == 0;
      done[1] = !(tail && live_hi);
      c = 0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        fetch_x2(src, S, head, live_hi, b0 + k, pend);
        if (k + 1 < kChunk) cin[k] = pack16(pend[0], pend[1]);
      }
      if (staging && (kOneTile || p > 0)) {
        const int lim = *end_at;
        stage_load(0, lim);
        stage_store(0);
        stage_load(1, lim);
        stage_store(1);
        stage_load(2, lim);
      }
    }
    if (c >= 0) {
      const int t0 = b0 + kChunk * c;
      if (t0 >= nT || (t0 >= b1 && __all_sync(kFull, done[0] && done[1]))) {
        if (wl == 0) *end_at = t0;
        p += P;
        start = max(it + 1, it - c + (P - 1) * kLag + kWrapLag);
        c = -1;
      } else {
        const bool next = head && t0 + kChunk < nT;
        const int lim = kOneTile || p > 0 ? *end_at : b0;
        if (staging && (kOneTile || p > 0) && c > 0) {
          stage_store(c + 1);
          stage_load(c + 2, lim);
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int t = t0 + k;
          const unsigned c_in = cin[k];
          // the last step's loads into the slot they refill
          cin[(k + kChunk - 1) % kChunk] = pack16(pend[0], pend[1]);
          fetch_x2(src, S, next, live_hi, t + kChunk, pend);
          // the tile above's row 127: D at t + shd, G and H at t + shg
          unsigned d_in = z, g_in = z, h_in = z;
          if (head && t + shd < lim) d_in = ring[from][(t + shd - b0) & (kRing - 1)][g][0];
          if (head && t + shg < lim) {
            g_in = ring[from][(t + shg - b0) & (kRing - 1)][g][1];
            h_in = ring[from][(t + shg - b0) & (kRing - 1)][g][2];
          }
          // the sublane above this thread's first one lives in lane - 1
          const unsigned nC = __shfl_up_sync(kFull, C[V - 1], 1, W);
          const unsigned nG = __shfl_up_sync(kFull, G[V - 1][R - 1], 1, W);
          const unsigned nH = __shfl_up_sync(kFull, H[V - 1], 1, W);
          const unsigned nD = __shfl_up_sync(kFull, D2L[V - 1], 1, W);
          unsigned f0_tail = 0u;  // 0xFFFF in each half whose tail char starts a read
#pragma unroll
          for (int v = V - 1; v >= 1; --v) {
            C[v] = C[v - 1];
            const unsigned f0 = sublane_step_x2<R, false>(
                ar, C[v], false, G[v - 1][R - 1], H[v - 1], D2L[v - 1], q[v], D[v], G[v],
                D2L[v], H[v], ma, mi, go, ge);
            if (v == V - 1) f0_tail = f0;
          }
          C[0] = head ? c_in : nC;
          // the tile's row 0 reads the tile above's row 127
          const unsigned f0 = sublane_step_x2<R, false>(
              ar, C[0], false, head ? g_in : nG, head ? h_in : nH, head ? d_in : nD, q[0],
              D[0], G[0], D2L[0], H[0], ma, mi, go, ge);
          if (V == 1) f0_tail = f0;
          acc = ar.max(acc & ~f0_tail, H[V - 1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool f0h = (f0_tail >> (16 * h)) & 1;
            writing[h] = f0h ? tail && t < handover : writing[h];
            done[h] = f0h ? !writing[h] : done[h];
          }
          // as in stream_chain_kernel: the last tile writes the
          // accumulator, a tile above it hands its row 127 on
          const bool last = kOneTile || p == a.K - 1;
          if (!kOneTile && !last && w < P - 1 && tail) {
            unsigned* r = ring[w][(t - b0) & (kRing - 1)][g];
            r[0] = D[V - 1][R - 1];
            r[1] = G[V - 1][R - 1];
            r[2] = H[V - 1];
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (writing[h]) {
              const size_t o = (size_t)t * S + s + h;
              if (last) a.strip[o] = ar.store(acc, h);
              if (kOneTile || (!last && w == P - 1)) {
                a.oD[o] = ar.store(D[V - 1][R - 1], h);
                a.oG[o] = ar.store(G[V - 1][R - 1], h);
                a.oH[o] = ar.store(H[V - 1], h);
              }
            }
          }
        }
        ++c;
      }
    }
    if (!__syncthreads_or(p < a.K)) break;
  }
}

// stream_wavefront_kernel (B1, B2) in a 16-bit state, two streams a
// thread: the same slices, the state of streams 2p and 2p + 1 in the
// halves of each register, and per stream the tail's accumulator reset,
// whether it writes and whether it is done.  At R = 4 and 8 the 32-bit
// kernel's mapping (8 threads a pair, 16 query rows of each stream a
// thread), at R = 2 and 1 32 threads a pair.
template <int R, int kMode, int kState>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    stream_wavefront_x2_kernel(const Args a) {
  static_assert(kMode != kChained, "a chained tile is stream_chain_x2_kernel");
  using A = Arith<kState>;
  const A ar(a.width);
  const unsigned ma = ar.cst(a.ma), mi = ar.cst(a.mi), go = ar.cst(a.go),
                 ge = ar.cst(a.ge), z = 0u;
  constexpr int SL = kLanes / R;               // wavefront sublanes per stream
  constexpr int W = kStreamLanesOf<R, true>;   // threads per stream pair
  constexpr int V = SL / W;                    // sublanes per thread
  static_assert(W * V == SL && 32 % W == 0, "V sublanes a thread, whole pairs a warp");
  constexpr bool kRipple = kMode == kRippleH;
  const int S = a.S;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = tid / W * 2;  // the pair's first stream
  const int lane = tid % W;
  // threads past the last pair run the loop (the shuffles need the whole
  // warp) but read and write nothing; a high half past S is dead
  const bool live = s < S;
  const bool live_hi = s + 1 < S;
  const int SLg = SL / a.seg;  // sublanes per segment; a multiple of V
  const int p0 = lane * V;     // this thread's first sublane
  const int pt = p0 + V - 1;   // and last
  const bool head = live && p0 % SLg == 0;
  const bool tail = live && pt % SLg == SLg - 1;
  const size_t ld = (size_t)a.seg * S;
  const int8_t* src = a.sk + (size_t)(p0 / SLg) * S + s;
  int32_t* dst = a.strip + (size_t)(pt / SLg) * S + s;

  // this block's slice: nominal steps [b0, b1)
  const int slice = blockIdx.y;
  const int quanta = a.T / kSliceQuantum;
  const int b0 = kSliceQuantum * (int)((long long)slice * quanta / gridDim.y);
  const int b1 = slice + 1 == (int)gridDim.y
                     ? a.T
                     : kSliceQuantum * (int)((long long)(slice + 1) * quanta / gridDim.y);
  // a tail flag at this step or later entered at or after b1: the next
  // slice's to write
  const int handover = b1 + SLg - 1;
  // per stream, as in stream_wavefront_kernel; a dead high half is done
  bool writing[2] = {tail && slice == 0, tail && live_hi && slice == 0};
  bool done[2] = {!tail, !(tail && live_hi)};

  unsigned q[V][R], C[V];
  unsigned D[V][R], G[V][R], D2L[V], H[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    C[v] = splat16(kPad);
    D2L[v] = z;
    H[v] = z;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      D[v][r] = z;
      G[v][r] = z;
      const int8_t* qp = a.qk + (size_t)(r * SL + p0 + v) * S + s;
      q[v][r] = pack16(live ? qp[0] : kQueryPad, live_hi ? qp[1] : kQueryPad);
    }
  }
  unsigned acc = z;

  // slot k holds the chars of step t0 + k, loaded a chunk ahead as in
  // stream_wavefront_kernel and packed into their slot a step after their
  // loads were issued (the header)
  unsigned cin[kChunk];
  int pend[2];  // the last step's loads, for slot kChunk - 1 at first
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    fetch_x2(src, ld, head, live_hi, b0 + k, pend);
    if (k + 1 < kChunk) cin[k] = pack16(pend[0], pend[1]);
  }
  for (int t0 = b0; t0 < a.T; t0 += kChunk) {
    if (t0 >= b1 && __all_sync(kFull, done[0] && done[1])) break;
    const bool next = head && t0 + kChunk < a.T;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const unsigned c_in = cin[k];
      cin[(k + kChunk - 1) % kChunk] = pack16(pend[0], pend[1]);
      fetch_x2(src, ld, next, live_hi, t0 + kChunk + k, pend);
      // the sublane above this thread's first one lives in lane - 1
      const unsigned nC = __shfl_up_sync(kFull, C[V - 1], 1, W);
      const unsigned nG = __shfl_up_sync(kFull, G[V - 1][R - 1], 1, W);
      const unsigned nH = __shfl_up_sync(kFull, H[V - 1], 1, W);
      const unsigned nD = __shfl_up_sync(kFull, D2L[V - 1], 1, W);
      unsigned f0_tail = 0u;  // 0xFFFF in each half whose tail char starts a read
#pragma unroll
      for (int v = V - 1; v >= 1; --v) {
        C[v] = C[v - 1];
        const unsigned f0 = sublane_step_x2<R, kRipple>(
            ar, C[v], false, G[v - 1][R - 1], H[v - 1], D2L[v - 1], q[v],
            D[v], G[v], D2L[v], H[v], ma, mi, go, ge);
        if (v == V - 1) f0_tail = f0;
      }
      C[0] = head ? c_in : nC;
      // a segment head sees zero boundaries
      const unsigned f0 = sublane_step_x2<R, kRipple>(
          ar, C[0], head, nG, nH, nD, q[0], D[0], G[0], D2L[0], H[0], ma, mi, go, ge);
      if (V == 1) f0_tail = f0;
      const int t = t0 + k;
      if (!kRipple) acc = ar.max(acc & ~f0_tail, H[V - 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool f0h = (f0_tail >> (16 * h)) & 1;
        writing[h] = f0h ? tail && t < handover : writing[h];
        done[h] = f0h ? !writing[h] : done[h];
        if (writing[h]) dst[(size_t)t * ld + h] = ar.emit(kRipple ? H[V - 1] : acc, h);
      }
    }
  }
}

// The kernel of a mode and a state mode: a chained tile is the chain
// kernel at K = 1 (ChainArgs); a 16-bit state takes the kernels of two
// streams a thread.
template <int R, int kMode, int kState>
constexpr auto kernel_of() {
  if constexpr (kMode == kChained && kPacked<kState>) {
    return stream_chain_x2_kernel<R, kState, true, true>;
  } else if constexpr (kMode == kChained) {
    return stream_chain_kernel<R, kState, true, true>;
  } else if constexpr (kPacked<kState>) {
    return stream_wavefront_x2_kernel<R, kMode, kState>;
  } else {
    return stream_wavefront_kernel<R, kMode, kState>;
  }
}

template <int R, int kMode, int kState>
cudaError_t launch(const Args& a, int slices, cudaStream_t stream) {
  constexpr int W = kStreamLanesOf<R, kPacked<kState>>;
  constexpr int P = kPacked<kState> ? 2 : 1;  // streams a thread holds
  const long long threads = ((long long)a.S + P - 1) / P * W;
  const int blocks = (int)((threads + kBlock - 1) / kBlock);
  kernel_of<R, kMode, kState>()<<<dim3(blocks, slices), kBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

// A chain (or one tile): a block of `ring` warps a group of streams, a
// slice a grid row; in a 16-bit state two streams a thread.
template <int R, int kState, bool kOneTile, bool kQuiet>
cudaError_t launch_chain(const ChainArgs& a, int ring, int slices, cudaStream_t stream) {
  if constexpr (kPacked<kState>) {
    constexpr int NS = 2 * 32 / kChainPairLanes<R, kOneTile>;  // streams a warp holds
    stream_chain_x2_kernel<R, kState, kOneTile, kQuiet>
        <<<dim3((a.S + NS - 1) / NS, slices), 32 * ring, 0, stream>>>(a);
  } else {
    constexpr int SL = kLanes / R;
    constexpr int NG = 32 / (SL < 32 ? SL : 32);  // streams a warp holds
    stream_chain_kernel<R, kState, kOneTile, kQuiet>
        <<<dim3((a.S + NG - 1) / NG, slices), 32 * ring, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// f(std::integral_constant<int, R>{}) for R = rows.
template <typename F>
cudaError_t with_rows(int rows, F f) {
  switch (rows) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(std::integral_constant<int, kState>{}) for a state code (StateMode)
// and a score width, which kBiased alone takes (2..30).
template <typename F>
cudaError_t with_state(int width, int state, F f) {
  if ((state == kBiased) != (width != 0)) return cudaErrorInvalidValue;
  switch (state) {
    case kExact: return f(std::integral_constant<int, kExact>{});
    case kBiased:
      return width < 2 || width > 30 ? cudaErrorInvalidValue
                                     : f(std::integral_constant<int, kBiased>{});
    case kFloat: return f(std::integral_constant<int, kFloat>{});
    case kInt16: return f(std::integral_constant<int, kInt16>{});
    case kUint16: return f(std::integral_constant<int, kUint16>{});
    case kBf16: return f(std::integral_constant<int, kBf16>{});
    default: return cudaErrorInvalidValue;
  }
}

// The 32-bit states take every row count, the 16-bit ones rows <= 8 (no
// rows-16 instantiation of them exists).
template <int kState, int R>
constexpr bool kInstantiated = R < 16 || kState == kExact ||
                               kState == kBiased || kState == kFloat;

template <int kMode>
cudaError_t launch_rows(int rows, int width, int state, const Args& a,
                        int slices, cudaStream_t stream) {
  return with_state(width, state, [&](auto st) {
    return with_rows(rows, [&](auto r) {
      constexpr int K = decltype(st)::value, R = decltype(r)::value;
      if constexpr (kInstantiated<K, R>) {
        return launch<R, kMode, K>(a, slices, stream);
      } else {
        return cudaErrorInvalidValue;
      }
    });
  });
}

// Registers a thread, local (spill) bytes a thread, resident blocks an SM
// of kBlock threads and static shared bytes a block of a kernel.
template <class F>
cudaError_t func_info(F* kernel, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[3] = (int)fa.sharedSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, kBlock, 0);
}

template <int R, int kMode, int kState>
cudaError_t kernel_info(int* out) {
  return func_info(kernel_of<R, kMode, kState>(), out);
}

}  // namespace

// rows in {1, 2, 4, 8, 16} (at most 8 in a 16-bit state); seg in
// {1, 2, 4, 8} with (128/rows) % seg == 0; T % 8 == 0; 1 <= slices, and
// slices * 32 <= T when slices > 1 (slice k owns steps from
// 32 * floor(k * floor(T/32) / slices)).  tail_acc = 0 takes the ripple-H
// form at rows = 1 and is ignored otherwise.  state is a StateMode code;
// width = W in 2..30 goes with kBiased and 0 with the others.  The caller
// checks these (an instantiation that does not exist returns
// cudaErrorInvalidValue).  Returns the launch's CUDA error.
extern "C" int swtpu_stream_wavefront(const void* qk, const void* sk,
                                      void* strip, int S, int T, int seg,
                                      int rows, int tail_acc, int ma, int mi,
                                      int go, int ge, void* stream,
                                      int slices, int width, int state) {
  const Args a{static_cast<const int8_t*>(qk), static_cast<const int8_t*>(sk),
               static_cast<int32_t*>(strip), S, T, seg, ma, mi, go, ge, width};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tail_acc && rows == 1) {
    return with_state(width, state, [&](auto m) {
      return launch<1, kRippleH, decltype(m)::value>(a, slices, st);
    });
  }
  return launch_rows<kTailAcc>(rows, width, state, a, slices, st);
}

// One chained tile at segments 1: qk [128, S] int8, sk [T, S] int8,
// bD/bG/bH [T, S] int32 -> acc, oD, oG, oH [T, S] int32 (biased in the
// biased mode).  rows in {1, 2, 4, 8, 16} (at most 8 in a 16-bit state);
// T % 8 == 0; slices, width and state as for swtpu_stream_wavefront.
// Every state runs its chain kernel at K = 1 with the strips switched on.
// The caller checks these.  Returns the launch's CUDA error.
extern "C" int swtpu_stream_chained(const void* qk, const void* sk,
                                    const void* bD, const void* bG,
                                    const void* bH, void* acc, void* oD,
                                    void* oG, void* oH, int S, int T,
                                    int rows, int ma, int mi, int go, int ge,
                                    void* stream, int slices, int width,
                                    int state) {
  const auto* q8 = static_cast<const int8_t*>(qk);
  const auto* s8 = static_cast<const int8_t*>(sk);
  const auto *d = static_cast<const int32_t*>(bD), *g = static_cast<const int32_t*>(bG),
             *h = static_cast<const int32_t*>(bH);
  auto *o = static_cast<int32_t*>(acc), *od = static_cast<int32_t*>(oD),
       *og = static_cast<int32_t*>(oG), *oh = static_cast<int32_t*>(oH);
  const ChainArgs c{q8, s8, d, g, h, o, od, og, oh, S, T, 1, ma, mi, go, ge, width};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_state(width, state, [&](auto m) {
    return with_rows(rows, [&](auto r) {
      constexpr int M = decltype(m)::value, R = decltype(r)::value;
      if constexpr (!kInstantiated<M, R>) {
        return cudaErrorInvalidValue;
      } else {
        return launch_chain<R, M, true, true>(c, 1, slices, st);
      }
    });
  });
}

// A whole chain of K tiles: qk [K, 128, S] int8 (tile p's register at p x
// 128 x S), sk [T, S] int8 -> strip [T, S] int32, the last tile's
// accumulator (biased in the biased mode).  `ring` warps a block in 1..4,
// at most K; wrap: [3, T, S] int32 scratch, the strips through which
// every ring-th tile hands its row 127 on (null when K <= ring).  rows,
// T, slices, width and state as for swtpu_stream_chained; quiet = 1 where
// pads alone leave every state at the zero (kQuiet).  The caller checks
// these.  Returns the launch's CUDA error.
extern "C" int swtpu_stream_chain(const void* qk, const void* sk, void* strip,
                                  void* wrap, int S, int T, int K, int rows,
                                  int ma, int mi, int go, int ge, void* stream,
                                  int slices, int ring, int width, int state,
                                  int quiet) {
  if (ring < 1 || ring > kRingWarps || ring > K || (K > ring && wrap == nullptr)) {
    return cudaErrorInvalidValue;
  }
  int32_t* w = static_cast<int32_t*>(wrap);
  const size_t n = (size_t)T * S;
  const ChainArgs a{static_cast<const int8_t*>(qk), static_cast<const int8_t*>(sk),
                    nullptr, nullptr, nullptr, static_cast<int32_t*>(strip),
                    w, w ? w + n : nullptr, w ? w + 2 * n : nullptr,
                    S, T, K, ma, mi, go, ge, width};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_state(width, state, [&](auto m) {
    return with_rows(rows, [&](auto r) {
      constexpr int M = decltype(m)::value, R = decltype(r)::value;
      if constexpr (!kInstantiated<M, R>) {
        return cudaErrorInvalidValue;
      } else {
        return quiet ? launch_chain<R, M, false, true>(a, ring, slices, st)
                     : launch_chain<R, M, false, false>(a, ring, slices, st);
      }
    });
  });
}

// out[4] = registers a thread, local bytes a thread, resident blocks an SM
// of kBlock threads and static shared bytes a block of the instantiation
// for `rows` in `mode` (0 tail accumulator, 1 ripple-H at rows 1, 2
// chained tile, 3 the whole chain, 4 the whole chain without the pad
// shortcut) and the state mode of width and state.  Returns the CUDA
// error.
extern "C" int swtpu_stream_kernel_info(int rows, int mode, int width,
                                        int state, int* out) {
  return with_state(width, state, [&](auto m) {
    constexpr int K = decltype(m)::value;
    if (mode == kRippleH) {
      return rows == 1 ? kernel_info<1, kRippleH, K>(out)
                       : cudaErrorInvalidValue;
    }
    return with_rows(rows, [&](auto r) {
      constexpr int R = decltype(r)::value;
      if constexpr (!kInstantiated<K, R>) {
        return cudaErrorInvalidValue;
      } else if (mode == kChainMode || mode == kChainAllGroups) {
        if constexpr (kPacked<K>) {
          return mode == kChainMode ? func_info(stream_chain_x2_kernel<R, K, false, true>, out)
                                    : func_info(stream_chain_x2_kernel<R, K, false, false>, out);
        } else {
          return mode == kChainMode ? func_info(stream_chain_kernel<R, K, false, true>, out)
                                    : func_info(stream_chain_kernel<R, K, false, false>, out);
        }
      } else {
        return mode == kChained ? kernel_info<R, kChained, K>(out)
                                : kernel_info<R, kTailAcc, K>(out);
      }
    });
  });
}

extern "C" const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
