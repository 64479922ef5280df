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
// Thread mapping.  One pair per warp.  Lane L owns query rows
// L*RPL .. L*RPL + RPL - 1 (RPL = rows per lane, 1/2/4/8 so 32*RPL >= m;
// rows past m are pad rows at the bottom, which never feed a row above
// and never raise H) with their M, I and query codes in registers.  Per
// column:
//   - one __shfl_up_sync brings the diagonal max(M, I) of the lane above's
//     last row from column j-1, and one brings this column's M of that row
//     (M_up); lane 0 row 0 takes the boundary instead (zero, or for a tile
//     dprev = max(ms, is)[j-1], ms[j] and the seed is[j] + extend);
//   - the I chain ripples down the lane's own rows, then a 5-step
//     Hillis-Steele max-plus scan across lanes (offset k lanes adds
//     k*RPL*extend) and one more shuffle give each lane the I of the row
//     above its first;
//   - every lane reads the same 32 target bytes per 32 columns as two
//     16-byte loads (one broadcast transaction) and takes byte c at column
//     c; a tile's lane c loads ms/is of column c of the run (coalesced)
//     and __shfl_sync hands them to lane 0, and lane 31's row 255 M and I
//     go back to lane c the same way, stored once per run.
// What bounds it.  Per cell it reads nothing from memory (the target is
// one byte per column per pair, the strips 8 bytes in and 8 out per column
// per pair), so it is bound by the dependent integer chain per column and
// the eight shuffles that carry it across lanes.  All state stays in
// registers for the whole target; a warp loops over all n columns itself,
// so no state crosses blocks (the TPU's sequential grid becomes this loop).
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
constexpr int kBlock = 128;    // threads per block: 4 pairs
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
// (cst), the boundary zero, an add, the M update, a strip value read (load)
// and written (store).
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

template <int RPL, int kState, bool kTile>
__global__ void __launch_bounds__(kBlock) column_kernel(const ColumnArgs a) {
  using A = ColumnArith<kState>;
  using T = typename A::T;
  const int lane = threadIdx.x % kWarp;
  const long long b =
      (long long)blockIdx.x * (kBlock / kWarp) + threadIdx.x / kWarp;
  if (b >= a.B) return;  // b is the same for the whole warp
  const A ar(a.width);
  const T zero = ar.zero();
  const T oe = ar.cst(a.go + a.ge);
  const T ge = ar.cst(a.ge);
  const T ma = ar.cst(a.ma), mi = ar.cst(a.mi);
  const int n = a.n;
  const int8_t* qb = a.q + b * a.m;
  const int8_t* tb = a.t + b * n;

  int q[RPL];
  T M[RPL], I[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane * RPL + r;
    q[r] = i < a.m ? qb[i] : kQueryPad;
    M[r] = zero;
    I[r] = zero;  // boundary column I = 0 (RTL ZERO tie)
  }
  T h = zero;
  T dprev = zero;  // tile: max(ms, is) of column j-1; zero at column -1

  for (int j0 = 0; j0 < n; j0 += kRun) {
    const int4* tp = reinterpret_cast<const int4*>(tb + j0);
    const int4 lo = tp[0];
    const int4 hi = tp[1];
    const int tw[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    T ms_run = zero, is_run = zero, ms_keep = zero, is_keep = zero;
    if (kTile) {
      ms_run = ar.load(a.ms[b * n + j0 + lane]);
      is_run = ar.load(a.is[b * n + j0 + lane]);
    }
#pragma unroll
    for (int c = 0; c < kRun; ++c) {
      const int tj = static_cast<int8_t>(tw[c / 4] >> (8 * (c % 4)));
      T msj = zero, isj = zero;
      if (kTile) {
        msj = __shfl_sync(kFull, ms_run, c);
        isj = __shfl_sync(kFull, is_run, c);
      }
      // the diagonal of row 0 of this lane: the lane above's last row at j-1
      T dup = __shfl_up_sync(kFull, mx(M[RPL - 1], I[RPL - 1]), 1);
      if (lane == 0) dup = dprev;
      T Mn[RPL];
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const T d = r == 0 ? dup : mx(M[r - 1], I[r - 1]);
        Mn[r] = ar.m(ar.add(d, q[r] == tj ? ma : mi));
      }
      T mup = __shfl_up_sync(kFull, Mn[RPL - 1], 1);
      if (lane == 0) mup = msj;
      // the I chain inside the lane, from its own rows only
      T acc[RPL];
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const T up = r == 0 ? mup : Mn[r - 1];
        T base = mx(ar.add(mx(up, M[r]), oe), ar.add(I[r], ge));
        if (r == 0 && lane == 0) base = mx(base, ar.add(isj, ge));  // row 0's seed
        acc[r] = r == 0 ? base : mx(base, ar.add(acc[r - 1], ge));
      }
      // max-plus inclusive scan of the lanes' last rows across the warp
      T v = acc[RPL - 1];
#pragma unroll
      for (int k = 1; k < kWarp; k <<= 1) {
        const T u = __shfl_up_sync(kFull, v, k);
        if (lane >= k) v = mx(v, ar.add(u, ar.cst(k * RPL * a.ge)));
      }
      const T carry = __shfl_up_sync(kFull, v, 1);  // I of the row above
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        I[r] = lane == 0 ? acc[r] : mx(acc[r], ar.add(carry, ar.cst((r + 1) * a.ge)));
        M[r] = Mn[r];
        h = mx(h, Mn[r]);
      }
      if (kTile) {
        dprev = mx(msj, isj);
        const T om = __shfl_sync(kFull, M[RPL - 1], kWarp - 1);
        const T oi = __shfl_sync(kFull, I[RPL - 1], kWarp - 1);
        if (lane == c) {
          ms_keep = om;
          is_keep = oi;
        }
      }
    }
    if (kTile) {
      a.ms_out[b * n + j0 + lane] = ar.store(ms_keep);
      a.is_out[b * n + j0 + lane] = ar.store(is_keep);
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    h = mx(h, __shfl_xor_sync(kFull, h, off));
  if (lane == 0) {
    a.h_out[b] = kTile ? max(a.h[b], ar.store(h)) : ar.store(h) - ar.store(zero);
  }
}

// column_kernel in int16, two pairs a warp: pairs 2w and 2w + 1 in the
// halves of each register.  Both share m and n, so the loop and the lane
// selects are column_kernel's; the codes, the target bytes, the match and
// the strips are per half.
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

// The kernel of a state mode, and the pairs a warp of it holds: two in
// int16.
template <int RPL, int kState, bool kTile>
constexpr auto kernel_of() {
  if constexpr (kState == kInt16) {
    return column_x2_kernel<RPL, kTile>;
  } else {
    return column_kernel<RPL, kState, kTile>;
  }
}
template <int kState>
constexpr long long kPairsPerWarp = kState == kInt16 ? 2 : 1;

// f(std::integral_constant<int, kState>{}) for a state code (ColumnState).
template <typename F>
cudaError_t with_state(int state, F f) {
  switch (state) {
    case kExact: return f(std::integral_constant<int, kExact>{});
    case kBiased: return f(std::integral_constant<int, kBiased>{});
    case kFloat: return f(std::integral_constant<int, kFloat>{});
    case kInt16: return f(std::integral_constant<int, kInt16>{});
    default: return cudaErrorInvalidValue;
  }
}

template <int RPL, bool kTile>
cudaError_t launch(const ColumnArgs& a, int state, cudaStream_t stream) {
  if ((state == kBiased) != (a.width != 0)) return cudaErrorInvalidValue;
  return with_state(state, [&](auto st) {
    constexpr int K = decltype(st)::value;
    constexpr long long P = kPairsPerWarp<K>, kWarps = kBlock / kWarp;
    const unsigned blocks = (unsigned)(((a.B + P - 1) / P + kWarps - 1) / kWarps);
    kernel_of<RPL, K, kTile>()<<<blocks, kBlock, 0, stream>>>(a);
    return cudaGetLastError();
  });
}

// Registers a thread, local (spill) bytes a thread and resident blocks an
// SM of one instantiation.
template <int RPL, int kState, bool kTile>
cudaError_t kernel_info(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel_of<RPL, kState, kTile>());
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kernel_of<RPL, kState, kTile>(), kBlock, 0);
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
  if (m <= 32) return launch<1, false>(a, state, st);
  if (m <= 64) return launch<2, false>(a, state, st);
  if (m <= 128) return launch<4, false>(a, state, st);
  if (m <= kTileRows) return launch<8, false>(a, state, st);
  return cudaErrorInvalidValue;
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
  return launch<8, true>(a, state, static_cast<cudaStream_t>(stream));
}

// out[3] = registers a thread, local bytes a thread, resident blocks an SM
// of the instantiation for `rpl` rows a lane (1, 2, 4 or 8; a tile: 8) in
// state code `state`, the chained tile if `tile`.  Returns the CUDA error.
extern "C" int swtpu_column_kernel_info(int rpl, int state, int tile, int* out) {
  return with_state(state, [&](auto st) {
    constexpr int K = decltype(st)::value;
    if (tile) return rpl == 8 ? kernel_info<8, K, true>(out) : cudaErrorInvalidValue;
    switch (rpl) {
      case 1: return kernel_info<1, K, false>(out);
      case 2: return kernel_info<2, K, false>(out);
      case 4: return kernel_info<4, K, false>(out);
      case 8: return kernel_info<8, K, false>(out);
      default: return cudaErrorInvalidValue;
    }
  });
}
