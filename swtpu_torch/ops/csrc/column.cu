// Bucketed column Smith-Waterman for Hopper (sm_90a).
//
// Replaces the TPU kernels swtpu/ops/pallas_kernel.py:_sw_kernel (B4: a
// batch of pairs, one DP column per step, query of at most 256 rows) and
// pallas_kernel.py:_sw_kernel_chained (B5: one 256-row query tile of a
// longer query, reading the tile above's last-row M/I strips and writing
// its own).  The plain PyTorch versions of the same recurrences are
// swtpu_torch/ops/column.py:column_scores_reference and
// column_chained_reference; kernel and plain version must agree bit for
// bit.
//
// Contract.  q [B, m] int8 and t [B, n] int8 are sentinel-padded (query
// pad 5, target pad 4: they never match, so padding never raises a score
// and the kernel has no lengths or masks).  m is a multiple of 8 and at
// most 256 (exactly 256 for a tile); n is a multiple of 32.  A tile also
// takes ms, is [B, n] int32 (the tile above's row 255 M and I per column)
// and h [B] int32 (the running high score), and writes the same three.
// Under wrap-parity (score_width W > 0) every state value is the RTL's
// biased W-bit register, score + 2^(W-1): the M update wraps modulo 2^W
// and clamps on the sign bit; I is never masked (pallas_kernel.py:70-80:
// its chain provably never wraps step by step, and masking a k-row jump
// would be wrong).  The scores kernel subtracts the bias from its result;
// a tile keeps h and its strips biased and the host subtracts once.
//
// State modes (kState, the host's state codes), each its own
// instantiation: kExact int32; kBiased the W-bit wrap-parity above;
// kFloat float32 state (fmaxf, the strips converted at the load and the
// store); kInt16 int16 state, two pairs a warp (column_x2_kernel, below),
// every add wrapping at 16 bits.  swtpu's float32 and int16 kernels fill their
// prefix scan with floors of -2^23 and -2^13; this scan has no fill (lane
// 0 takes no candidate from above), and a floor never wins there (every
// candidate from above is at least open + extend), so all three exact
// modes give the same integers while no value nears 2^15 (scores are at
// most match x 4,095).
//
// The recurrence (pallas_kernel.py:97-119), per target column j:
//   M[i]  = max(max(M, I)[i-1, j-1] + s(i, j), 0)
//   base  = max(max(M_up, M[i, j-1]) + open + extend, I[i, j-1] + extend)
//   I[i]  = max(base[i], I[i-1] + extend)          (down the column)
//   H     = max(H, M)
// with M_up = M[i-1, j].  The TPU evaluates the I chain as a log2(m)
// max-plus prefix scan; any exact evaluation gives the same integers.
//
// B4 (column_scores_kernel; int32, wrap-parity and float32 state).  A pair
// takes L lanes of a warp, 1 to 32, the fewest that cover its query at
// kRows = 8 rows a lane, so a warp holds 32 / L pairs (two at (f)'s query
// of 128; a bucketed batch pads every pair to one m and n, so the loop is
// the same for all of them).  Lane l of a pair owns rows 8l .. 8l + 7 with
// their M, I and query codes in registers, and reads its pair's 32 target
// bytes a run of 32 columns as two 16-byte loads.  Each lane keeps
// A = I - (open + extend) in place of I, which folds the extend of the I
// candidate into the other adds: a cell is diag = max(A + open + extend, M),
// M = max(diag + s, 0), y = max(A + extend, max(M_up, M)), the chain
// A = max(y, A_above + extend) and H = max(H, M), eight operations with
// Hopper's DPX add-max (VIADDMNMX).  Per column:
//   - one __shfl_up_sync brings the lane above's last-row diagonal (from
//     column j-1), one its new M; lane 0 of a pair takes the zero boundary;
//   - the I chain ripples down the lane's own rows, from its own rows only;
//   - the carry from the lanes above is propagated lazily: one shuffle hands
//     each lane the last-row A of the lane above, and a lane whose own last
//     row that carry raises hands its new value one lane further, repeated
//     while __any_sync says some lane's last row rose.  The loop is exact
//     (it stops at the fixed point of the lanes' recurrence, in integers, or
//     in float32 below 2^24).  On random reads a carry raises a lane's first
//     rows at about one boundary in six but its last row (8 rows and 32 of
//     extend below) almost never, so one shuffle and one vote replace the
//     warp-wide scan (five dependent shuffles, an add-max and a select
//     each).  A gap that runs k rows down the column costs about k / 8
//     more rounds of that column, one shuffle and one vote each;
//   - the carry goes into every row with one add-max a row (lane 0's carry
//     is a floor that never wins, so no select).
// What bounds it.  Per cell it reads nothing from memory (a byte of target
// a column a pair), so it is bound by the integer pipe: the eight
// operations a cell, the carry's one a row, and a lane-column's target
// byte, boundary selects and lazy step (seven over eight rows).  All state
// stays in registers for the whole target; a warp loops over all n columns
// itself, so no state crosses blocks (the TPU's sequential grid becomes
// this loop).  A warp's pairs past B (the ragged edge) rescore pair B - 1
// and write nothing.
//
// B5 (column_scores_kernel<32, kState, true>; int32, wrap-parity and
// float32 state) is B4's loop at 32 lanes of 8 rows, one pair a warp, on
// one 256-row tile of a longer query.  Only row 0 and row 255 differ:
//   - row 0's inputs come from the tile above's row 255 (the strips ms and
//     is, the running high h): its diagonal is max(ms, is) of column j-1
//     (zero at column -1), its M from above ms[j], and its I seed
//     is[j] + extend, in A form is[j] - open, which lane 0 folds into row 0
//     as B4 folds the boundary's zero + extend; lane 0's carry stays the
//     floor that never wins;
//   - row 255's M and I go out per column, I as A + open + extend (exact: a
//     biased I is never masked, and float32 stays below 2^24);
//   - h out is max(h in, the tile's high), biased under wrap-parity;
//   - the carry is B4's lazy one for at most kTileRounds rounds, then the
//     warp-wide max-plus scan (five shuffles, offset k lanes adding
//     k x 8 x extend) and one shuffle more.  A cell of score S sends its I
//     chain about S / 4 rows down a column, so a long high-scoring
//     alignment (a read that is a window of the query) would cost B4's
//     one-lane rounds up to 31 a column; random reads stop after one.
// The strips stay off the column's shuffles: at a run's start lane c
// stages column c's three row-0 inputs and its target code in shared
// memory (16 bytes a column, one shuffle for the diagonal's column j-1),
// so a column reads all four with one broadcast 16-byte load; lane 31
// stores row 255's M and A there with one 8-byte store a column, and lane
// c writes column c out at the run's end, one coalesced store per strip.
// The next run's target codes and strip values are loaded a run ahead, so
// no run starts on an exposed global load.  With the target codes in
// shared memory no column needs a byte of a register picked by its
// number, so the tile unrolls kTileUnroll = 4 columns where B4 unrolls its
// run of 32: the loop's code shrinks eightfold (with the scan in every
// column, 32 unrolled columns ran 8 % slower at (g)).  What bounds it:
// B4's integer pipe (its operations a cell, and a load and a store a
// column over 256 rows) where the card holds enough warps; a batch of
// about a thousand pairs gives an SM 8 warps, 2 a scheduler, and then the
// column's dependent chain sets the pace (the shared load, two shuffles,
// the ripple down 8 rows, the carry's shuffle and vote).  A tile reads 8
// bytes of strip and writes 8 a column, against 256 cells of eight
// operations: never bound by memory.
//
// int16 (column_x2_kernel) keeps the warp-wide form: one pair a half of
// each register, rows 1-8 a lane over all 32 lanes, the I chain's carry a
// 5-step Hillis-Steele max-plus scan across lanes (offset k lanes adds
// k * rows * extend) and one more shuffle, merged into every row with a
// select for lane 0; its tile's strips are handed to and from lane 0 with
// shuffles.  Each of its shuffles serves two pairs, so the scan costs it
// half as much a cell as it cost the one-value tile, and folding it into
// B4's template is queued (ROADMAP.md).
//
// Two pairs a warp (kInt16, column_x2_kernel).  The warp holds pairs 2w
// and 2w + 1 in the low and high halves of each 32-bit register and runs the
// column on both with Hopper's 16x2 instructions (packed16.cuh), so each
// shuffle and each instruction serves two pairs.  A bucketed batch pads
// every pair to one m and n, so the column loop, each lane's rows and the
// selects on the lane stay the same for both; only the codes, the target
// bytes (two 32-byte runs, one PRMT a column puts byte c of each in its
// half) and the match decision differ.  The score is each half's high
// score, written as two int32.  An odd B leaves the last warp a dead high
// half: it reads query and target pads, never loads a strip and writes
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "packed16.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kQueryPad = 5;   // query pad code
constexpr int kTileRows = 256; // rows of a chained tile: 8 per lane
constexpr int kRun = 32;       // target columns read together
constexpr int kBlock = 128;    // threads per block: 4 warps
constexpr int kRows = 8;       // B4's rows a lane
constexpr int kFloor = -(1 << 30);  // lane 0's carry: never wins, never overflows
constexpr int kTileRounds = 4;  // B5's carry rounds of one lane before its scan
constexpr int kTileUnroll = 4;  // B5's columns unrolled together (B4: a run, 32)
constexpr unsigned kFull = 0xffffffffu;

struct ColumnArgs {
  const int8_t* q;
  const int8_t* t;
  const int32_t* ms;  // tile only: the tile above's row 255 M per column
  const int32_t* is;  // and I
  const int32_t* h;   // tile only: the running high score
  int32_t* h_out;     // score (scores kernel) or high score (tile)
  int32_t* ms_out;    // tile only: this tile's row 255 M and I
  int32_t* is_out;
  int B, m, n, ma, mi, go, ge, width;  // width: 0 = exact int32
};

// the state modes; the values are the host's state codes (ops/column.py)
enum ColumnState { kExact, kBiased, kFloat, kInt16 };

__device__ __forceinline__ int mx(int a, int b) { return max(a, b); }
__device__ __forceinline__ float mx(float a, float b) { return fmaxf(a, b); }

// The arithmetic of each state mode: the state type T, a constant as T
// (cst), the boundary zero, an add, addmax(x, y, z) = max(x + y, z), the
// M update, a strip value read (load) and written (store).
template <int kState>
struct ColumnArith {  // kExact, kBiased
  using T = int;
  int mask, zbit;  // kBiased: 2^W - 1 and 2^(W-1), the biased score 0
  __device__ explicit ColumnArith(int width)
      : mask(kState == kBiased ? (1 << width) - 1 : 0),
        zbit(kState == kBiased ? 1 << (width - 1) : 0) {}
  __device__ int cst(int x) const { return x; }
  __device__ int zero() const { return zbit; }
  __device__ int add(int x, int y) const { return x + y; }
  __device__ int addmax(int x, int y, int z) const { return __viaddmax_s32(x, y, z); }
  __device__ int m(int x) const {
    if (kState != kBiased) return max(x, 0);
    const int w = x & mask;
    return (w & zbit) ? w : zbit;  // sign-bit clamp
  }
  __device__ int load(int x) const { return x; }
  __device__ int store(int x) const { return x; }
};

template <>
struct ColumnArith<kFloat> {
  using T = float;
  __device__ explicit ColumnArith(int) {}
  __device__ float cst(int x) const { return static_cast<float>(x); }
  __device__ float zero() const { return 0.f; }
  __device__ float add(float x, float y) const { return x + y; }
  __device__ float addmax(float x, float y, float z) const { return fmaxf(x + y, z); }
  __device__ float m(float x) const { return fmaxf(x, 0.f); }
  __device__ float load(int x) const { return static_cast<float>(x); }
  __device__ int store(float x) const { return static_cast<int>(x); }
};

// int16: two pairs' values a register; a strip value is cut to 16 bits
// as it is read, as the plain version's cast does
template <>
struct ColumnArith<kInt16> : Int16x2 {
  using T = unsigned;
  __device__ explicit ColumnArith(int) {}
  __device__ T cst(int x) const { return splat16(x); }
  __device__ T zero() const { return 0u; }
  __device__ T load(int lo, int hi) const { return pack16(lo, hi); }
  __device__ int store(T x, int h) const { return widen(x, h); }
};

// B5's strips, staged in shared memory a run at a time: lane 0's inputs
// of column c (its diagonal, its M from above and its I seed in A form)
// beside column c's target code, and row 255's M and A of column c.
template <typename T>
struct alignas(16) TileEdge {
  T d, up, seed;
  int t;  // the column's target code
};
template <typename T>
struct alignas(8) TileLast { T m, a; };
template <typename T>
struct TileStage {
  TileEdge<T> in[kRun];
  TileLast<T> out[kRun];
};

// the calling warp's stage (a tile's block is 4 warps, one pair each)
template <typename T>
__device__ __forceinline__ TileStage<T>& tile_stage() {
  __shared__ TileStage<T> stage[kBlock / kWarp];
  return stage[threadIdx.x / kWarp];
}

// B4 in the one-value states: 32 / LANES pairs a warp, LANES lanes of
// kRows rows a pair, the lazy carry (see the note at the top).  kTile: B5,
// one 256-row tile at LANES = 32, its row 0 fed from the strips of the
// tile above and its row 255 written out.
template <int LANES, int kState, bool kTile>
__global__ void __launch_bounds__(kBlock) column_scores_kernel(const ColumnArgs a) {
  using A = ColumnArith<kState>;
  using T = typename A::T;
  static_assert(!kTile || LANES * kRows == kTileRows, "a tile is 32 lanes of 8 rows");
  constexpr int P = kWarp / LANES;  // pairs a warp
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % LANES;  // the lane's place in its pair
  const long long w = (long long)blockIdx.x * (kBlock / kWarp) + threadIdx.x / kWarp;
  if (w * P >= a.B) return;  // w is the same for the whole warp
  const long long b = w * P + lane / LANES;
  const bool live = b < a.B;  // a dead pair rescores pair B - 1 and writes nothing
  const long long bb = live ? b : a.B - 1;
  const A ar(a.width);
  const T zero = ar.zero();
  const T oe = ar.cst(a.go + a.ge);
  const T ge = ar.cst(a.ge);
  const T ma = ar.cst(a.ma), mi = ar.cst(a.mi);
  const T seed = ar.add(zero, ar.cst(-a.go));  // row 0's zero + extend, less oe
  const T low = ar.cst(kFloor);  // lane 0's carry
  const T step = ar.cst(kRows * a.ge);  // a carry's extend over a lane's rows
  const int n = a.n;
  const int8_t* qb = a.q + bb * a.m;
  const int8_t* tb = a.t + bb * n;

  int q[kRows];
  T M[kRows], Ad[kRows];  // Ad = I - (open + extend)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = sub * kRows + r;
    q[r] = i < a.m ? qb[i] : kQueryPad;
    M[r] = zero;
    Ad[r] = ar.add(zero, ar.cst(-(a.go + a.ge)));  // boundary column I = 0 (RTL ZERO tie)
  }
  T h = zero;
  // a tile's next run, loaded a run ahead: lane c's target code and ms/is
  // of the run's column c; dlast, max(ms, is) of the run before's last
  // column (zero at column -1)
  [[maybe_unused]] int t_next, ms_next, is_next;
  [[maybe_unused]] T dlast = zero;
  if constexpr (kTile) {
    if (n > 0) {
      t_next = tb[lane];
      ms_next = a.ms[bb * n + lane];
      is_next = a.is[bb * n + lane];
    }
  }

  for (int j0 = 0; j0 < n; j0 += kRun) {
    [[maybe_unused]] int tw[8];  // B4: the run's 32 target bytes
    if constexpr (kTile) {
      TileStage<T>& st = tile_stage<T>();
      const int tc = t_next;
      const T ms = ar.load(ms_next), is = ar.load(is_next);
      const int jn = min(j0 + kRun, n - kRun);  // the last run reloads itself
      t_next = tb[jn + lane];
      ms_next = a.ms[bb * n + jn + lane];
      is_next = a.is[bb * n + jn + lane];
      // lane 0's diagonal at column c is max(ms, is) of column c - 1
      const T dc = mx(ms, is);
      T dp = __shfl_up_sync(kFull, dc, 1);
      if (lane == 0) dp = dlast;
      dlast = __shfl_sync(kFull, dc, kWarp - 1);
      st.in[lane] = TileEdge<T>{dp, ms, ar.add(is, ar.cst(-a.go)), tc};
      __syncwarp();
    } else {
      const int4* tp = reinterpret_cast<const int4*>(tb + j0);
      const int4 lo = tp[0];
      const int4 hi = tp[1];
      tw[0] = lo.x, tw[1] = lo.y, tw[2] = lo.z, tw[3] = lo.w;
      tw[4] = hi.x, tw[5] = hi.y, tw[6] = hi.z, tw[7] = hi.w;
    }
#pragma unroll (kTile ? kTileUnroll : kRun)
    for (int c = 0; c < kRun; ++c) {
      // the target code; row 0's diagonal, M from above and I seed: the
      // boundary, or a tile's strips
      int tj;
      T e_d = zero, e_up = zero, e_seed = seed;
      if constexpr (kTile) {
        const TileEdge<T> e = tile_stage<T>().in[c];
        tj = e.t;
        e_d = e.d;
        e_up = e.up;
        e_seed = e.seed;
      } else {
        tj = static_cast<int8_t>(tw[c / 4] >> (8 * (c % 4)));
      }
      // max(M, I) of column j-1: each row's diagonal for the row below
      T D[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) D[r] = ar.addmax(Ad[r], oe, M[r]);
      T dup = __shfl_up_sync(kFull, D[kRows - 1], 1, LANES);
      if (sub == 0) dup = e_d;
      T Mn[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        Mn[r] = ar.m(ar.add(r == 0 ? dup : D[r - 1], q[r] == tj ? ma : mi));
      }
      T mup = __shfl_up_sync(kFull, Mn[kRows - 1], 1, LANES);
      if (sub == 0) mup = e_up;
      // the I chain inside the lane, from its own rows only
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        T y = ar.addmax(Ad[r], ge, mx(r == 0 ? mup : Mn[r - 1], M[r]));
        if (r == 0 && sub == 0) y = mx(y, e_seed);
        Ad[r] = r == 0 ? y : ar.addmax(Ad[r - 1], ge, y);
      }
      if constexpr (kTile) {
        // the carry: B4's lazy rounds, at most kTileRounds, then the scan
        const T own = Ad[kRows - 1];
        T last = own, carry;
        for (int round = 1;; ++round) {
          carry = __shfl_up_sync(kFull, last, 1);
          if (sub == 0) carry = low;
          const T next = ar.addmax(carry, step, own);
          if (!__any_sync(kFull, next != last)) break;
          if (round == kTileRounds) {
            // max-plus inclusive scan of the lanes' last rows
            T v = next;
#pragma unroll
            for (int k = 1; k < kWarp; k <<= 1) {
              const T u = __shfl_up_sync(kFull, v, k);
              if (sub >= k) v = ar.addmax(u, ar.cst(k * kRows * a.ge), v);
            }
            carry = __shfl_up_sync(kFull, v, 1);
            if (sub == 0) carry = low;
            break;
          }
          last = next;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) Ad[r] = ar.addmax(carry, ar.cst((r + 1) * a.ge), Ad[r]);
      } else if constexpr (LANES > 1) {
        // the carry: the lane above's last row, passed on while it raises one
        const T own = Ad[kRows - 1];
        T last = own, carry;
        for (;;) {
          carry = __shfl_up_sync(kFull, last, 1, LANES);
          if (sub == 0) carry = low;
          const T next = ar.addmax(carry, step, own);
          if (!__any_sync(kFull, next != last)) break;
          last = next;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) Ad[r] = ar.addmax(carry, ar.cst((r + 1) * a.ge), Ad[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        M[r] = Mn[r];
        h = mx(h, Mn[r]);
      }
      if constexpr (kTile) {
        if (lane == kWarp - 1) tile_stage<T>().out[c] = TileLast<T>{M[kRows - 1], Ad[kRows - 1]};
      }
    }
    if constexpr (kTile) {
      // row 255 of the run's columns, lane c storing column c
      __syncwarp();
      const TileLast<T> o = tile_stage<T>().out[lane];
      a.ms_out[bb * n + j0 + lane] = ar.store(o.m);
      a.is_out[bb * n + j0 + lane] = ar.store(ar.add(o.a, oe));
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    h = mx(h, __shfl_xor_sync(kFull, h, off));
  if (sub == 0 && live) {
    if constexpr (kTile) {
      a.h_out[b] = max(a.h[b], ar.store(h));  // biased under wrap-parity
    } else {
      a.h_out[b] = ar.store(h) - ar.store(zero);
    }
  }
}

// The warp-wide form in int16, two pairs a warp: pairs 2w and 2w + 1 in
// the halves of each register (B4 at rows 1-8 a lane, and B5).  Both share
// m and n, so the loop and the lane selects are the same for both; the
// codes, the target bytes, the match and the strips are per half.
template <int RPL, bool kTile>
__global__ void __launch_bounds__(kBlock) column_x2_kernel(const ColumnArgs a) {
  using A = ColumnArith<kInt16>;
  const int lane = threadIdx.x % kWarp;
  const long long b =
      2 * ((long long)blockIdx.x * (kBlock / kWarp) + threadIdx.x / kWarp);
  if (b >= a.B) return;  // b is the same for the whole warp
  const bool b1 = b + 1 < a.B;  // the high half holds pair b + 1, or is dead
  const A ar(a.width);
  const unsigned zero = 0u;
  const unsigned oe = ar.cst(a.go + a.ge);
  const unsigned ge = ar.cst(a.ge);
  const unsigned ma = ar.cst(a.ma), mi = ar.cst(a.mi);
  const int n = a.n;
  const int8_t* qb = a.q + b * a.m;
  const int8_t* tb = a.t + b * n;

  unsigned q[RPL], M[RPL], I[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane * RPL + r;
    q[r] = pack16(i < a.m ? qb[i] : kQueryPad, b1 && i < a.m ? qb[a.m + i] : kQueryPad);
    M[r] = zero;
    I[r] = zero;  // boundary column I = 0 (RTL ZERO tie)
  }
  unsigned h = zero;
  unsigned dprev = zero;  // tile: max(ms, is) of column j-1; zero at column -1

  for (int j0 = 0; j0 < n; j0 += kRun) {
    // both pairs' 32 target bytes (target pads for a dead high half)
    const int4* tp = reinterpret_cast<const int4*>(tb + j0);
    const int4* tp1 = reinterpret_cast<const int4*>(tb + n + j0);
    const int4 pad = {0x04040404, 0x04040404, 0x04040404, 0x04040404};
    const int4 lo = tp[0], hi = tp[1];
    const int4 lo1 = b1 ? tp1[0] : pad, hi1 = b1 ? tp1[1] : pad;
    const int tw[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const int tw1[8] = {lo1.x, lo1.y, lo1.z, lo1.w, hi1.x, hi1.y, hi1.z, hi1.w};
    unsigned ms_run = zero, is_run = zero, ms_keep = zero, is_keep = zero;
    if (kTile) {
      const long long o = b * n + j0 + lane;
      ms_run = ar.load(a.ms[o], b1 ? a.ms[o + n] : 0);
      is_run = ar.load(a.is[o], b1 ? a.is[o + n] : 0);
    }
#pragma unroll
    for (int c = 0; c < kRun; ++c) {
      // byte c of each pair's run in its half (score16x2 reads 3 bits)
      const unsigned tj = __byte_perm(tw[c / 4], tw1[c / 4], (c % 4) | (4 + c % 4) << 8);
      unsigned msj = zero, isj = zero;
      if (kTile) {
        msj = __shfl_sync(kFull, ms_run, c);
        isj = __shfl_sync(kFull, is_run, c);
      }
      // the diagonal of row 0 of this lane: the lane above's last row at j-1
      unsigned dup = __shfl_up_sync(kFull, ar.max(M[RPL - 1], I[RPL - 1]), 1);
      if (lane == 0) dup = dprev;
      unsigned Mn[RPL];
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const unsigned d = r == 0 ? dup : ar.max(M[r - 1], I[r - 1]);
        Mn[r] = ar.m(d, score16x2(tj, q[r], ma, mi));
      }
      unsigned mup = __shfl_up_sync(kFull, Mn[RPL - 1], 1);
      if (lane == 0) mup = msj;
      // the I chain inside the lane, from its own rows only
      unsigned acc[RPL];
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const unsigned up = r == 0 ? mup : Mn[r - 1];
        unsigned base = ar.addmax(ar.max(up, M[r]), oe, ar.add(I[r], ge));
        if (r == 0 && lane == 0) base = ar.addmax(isj, ge, base);  // row 0's seed
        acc[r] = r == 0 ? base : ar.addmax(acc[r - 1], ge, base);
      }
      // max-plus inclusive scan of the lanes' last rows across the warp
      unsigned v = acc[RPL - 1];
#pragma unroll
      for (int k = 1; k < kWarp; k <<= 1) {
        const unsigned u = __shfl_up_sync(kFull, v, k);
        if (lane >= k) v = ar.addmax(u, ar.cst(k * RPL * a.ge), v);
      }
      const unsigned carry = __shfl_up_sync(kFull, v, 1);  // I of the row above
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        I[r] = lane == 0 ? acc[r] : ar.addmax(carry, ar.cst((r + 1) * a.ge), acc[r]);
        M[r] = Mn[r];
        h = ar.max(h, Mn[r]);
      }
      if (kTile) {
        dprev = ar.max(msj, isj);
        const unsigned om = __shfl_sync(kFull, M[RPL - 1], kWarp - 1);
        const unsigned oi = __shfl_sync(kFull, I[RPL - 1], kWarp - 1);
        if (lane == c) {
          ms_keep = om;
          is_keep = oi;
        }
      }
    }
    if (kTile) {
      const long long o = b * n + j0 + lane;
      a.ms_out[o] = ar.store(ms_keep, 0);
      a.is_out[o] = ar.store(is_keep, 0);
      if (b1) {
        a.ms_out[o + n] = ar.store(ms_keep, 1);
        a.is_out[o + n] = ar.store(is_keep, 1);
      }
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    h = ar.max(h, __shfl_xor_sync(kFull, h, off));
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 0 || b1) {
        a.h_out[b + k] = kTile ? max(a.h[b + k], ar.store(h, k)) : ar.store(h, k);
      }
    }
  }
}

// An instantiation: G is B4's lanes a pair in a one-value state, or the
// int16 kernel's rows a lane; a tile (B5) ignores it (32 lanes, 8 rows).
template <int G, int kState, bool kTile>
constexpr auto kernel_of() {
  if constexpr (kState == kInt16) {
    return column_x2_kernel<kTile ? kTileRows / kWarp : G, kTile>;
  } else {
    return column_scores_kernel<kTile ? kWarp : G, kState, kTile>;
  }
}
// its pairs a warp, lanes a pair and rows a lane
template <int G, int kState, bool kTile>
constexpr int kPairsPerWarp = kState == kInt16 ? 2 : kTile ? 1 : kWarp / G;
template <int G, int kState, bool kTile>
constexpr int kLanesPerPair = kTile || kState == kInt16 ? kWarp : G;
template <int G, int kState, bool kTile>
constexpr int kRowsPerLane = kTile ? kTileRows / kWarp : kState == kInt16 ? G : kRows;

template <int N>
using Int = std::integral_constant<int, N>;

// f(Int<kState>{}) for a state code (ColumnState).
template <typename F>
cudaError_t with_state(int state, F f) {
  switch (state) {
    case kExact: return f(Int<kExact>{});
    case kBiased: return f(Int<kBiased>{});
    case kFloat: return f(Int<kFloat>{});
    case kInt16: return f(Int<kInt16>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(Int<G>{}) for B4's instantiation at a query of m rows (ops/column.py's
// column_geometry is the same rule): the fewest lanes of kRows rows that
// cover m, or in int16 the fewest rows a lane over 32 lanes.
template <int kState, typename F>
cudaError_t with_geometry(int m, F f) {
  if constexpr (kState == kInt16) {
    if (m <= 32) return f(Int<1>{});
    if (m <= 64) return f(Int<2>{});
    if (m <= 128) return f(Int<4>{});
    if (m <= kTileRows) return f(Int<8>{});
  } else {
    if (m <= kRows) return f(Int<1>{});
    if (m <= 2 * kRows) return f(Int<2>{});
    if (m <= 4 * kRows) return f(Int<4>{});
    if (m <= 8 * kRows) return f(Int<8>{});
    if (m <= 16 * kRows) return f(Int<16>{});
    if (m <= kTileRows) return f(Int<32>{});
  }
  return cudaErrorInvalidValue;
}

template <int G, int kState, bool kTile>
cudaError_t launch(const ColumnArgs& a, cudaStream_t stream) {
  constexpr long long P = kPairsPerWarp<G, kState, kTile>, kWarps = kBlock / kWarp;
  const unsigned blocks = (unsigned)(((a.B + P - 1) / P + kWarps - 1) / kWarps);
  kernel_of<G, kState, kTile>()<<<blocks, kBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

// Registers a thread, local (spill) bytes a thread, resident blocks an SM,
// lanes a pair and rows a lane of one instantiation.
template <int G, int kState, bool kTile>
cudaError_t kernel_info(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel_of<G, kState, kTile>());
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[3] = kLanesPerPair<G, kState, kTile>;
  out[4] = kRowsPerLane<G, kState, kTile>;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kernel_of<G, kState, kTile>(), kBlock, 0);
}

}  // namespace

// B4: q [B, m] int8, t [B, n] int8 -> out [B] int32 scores.  m % 8 == 0,
// m <= 256, n % 32 == 0, t 16-byte aligned; state a ColumnState code,
// score_width 2..30 with kBiased and 0 with the others.  The caller checks
// these.  Returns the launch's CUDA error.
extern "C" int swtpu_column_scores(const void* q, const void* t, void* out,
                                   int B, int m, int n, int ma, int mi,
                                   int go, int ge, int score_width, int state,
                                   void* stream) {
  const ColumnArgs a{static_cast<const int8_t*>(q),
                     static_cast<const int8_t*>(t),
                     nullptr, nullptr, nullptr,
                     static_cast<int32_t*>(out), nullptr, nullptr,
                     B, m, n, ma, mi, go, ge, score_width};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((state == kBiased) != (score_width != 0)) return cudaErrorInvalidValue;
  return with_state(state, [&](auto k) {
    constexpr int K = decltype(k)::value;
    return with_geometry<K>(m, [&](auto g) { return launch<decltype(g)::value, K, false>(a, st); });
  });
}

// B5, one tile: q [B, 256] int8, t [B, n] int8, ms/is [B, n] int32, h [B]
// int32 -> h_out [B], ms_out/is_out [B, n] int32, all biased when
// score_width > 0.  n % 32 == 0, t 16-byte aligned; state and score_width
// as for swtpu_column_scores.  The caller checks these.  Returns the
// launch's CUDA error.
extern "C" int swtpu_column_chained(const void* q, const void* t,
                                    const void* ms, const void* is,
                                    const void* h, void* h_out, void* ms_out,
                                    void* is_out, int B, int n, int ma,
                                    int mi, int go, int ge, int score_width,
                                    int state, void* stream) {
  const ColumnArgs a{static_cast<const int8_t*>(q),
                     static_cast<const int8_t*>(t),
                     static_cast<const int32_t*>(ms),
                     static_cast<const int32_t*>(is),
                     static_cast<const int32_t*>(h),
                     static_cast<int32_t*>(h_out),
                     static_cast<int32_t*>(ms_out),
                     static_cast<int32_t*>(is_out),
                     B, kTileRows, n, ma, mi, go, ge, score_width};
  if ((state == kBiased) != (score_width != 0)) return cudaErrorInvalidValue;
  return with_state(state, [&](auto k) {
    return launch<kRows, decltype(k)::value, true>(a, static_cast<cudaStream_t>(stream));
  });
}

// out[5] = registers a thread, local bytes a thread, resident blocks an
// SM, lanes a pair and rows a lane of the instantiation that a query of m
// rows (1-256) takes in state code `state`, or of the chained tile if
// `tile`.  Returns the CUDA error.
extern "C" int swtpu_column_kernel_info(int m, int state, int tile, int* out) {
  return with_state(state, [&](auto k) {
    constexpr int K = decltype(k)::value;
    if (tile) return kernel_info<kRows, K, true>(out);
    if (m < 1) return cudaErrorInvalidValue;
    return with_geometry<K>(m, [&](auto g) { return kernel_info<decltype(g)::value, K, false>(out); });
  });
}
