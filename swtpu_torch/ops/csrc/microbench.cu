// The two microbenchmarks' kernels for Hopper (sm_90a): per-op costs (E1)
// and ablations of the wavefront step (E2).
//
// Replaces the TPU kernels experiments/microbench_ops.py:make_kernel (E1)
// and experiments/kernel_ablate.py:make_kernel (E2).  Their plain PyTorch
// versions are swtpu_torch/ops/microbench.py:microbench_ops_reference and
// stream_ablate_reference; kernel and plain version must agree bit for bit
// (every value is a small integer, exact in all four types).  This source
// is separate from stream_wavefront.cu so that the production kernels'
// code does not move.
//
// E1.  `steps` steps of 8 dependent ops of one pattern on a [512, 128]
// array, then y -= (y // 7) * 7 on every element:
//   addmax     y = max(y + c, y)
//   select     y = where(y > c, y, y + c)
//   roll_lane  y = max(y, roll(y, 1, axis=1) + c)     (cyclic over 128)
//   roll_sub   y = max(y, roll(y, 1, axis=0) + c)     (cyclic over 512)
// c = 1 arrives as a kernel argument, so the compiler cannot fold
// max(y + c, y) into y + c.  The whole array stays in registers for all
// steps; where each axis lies:
//   - axis 1 (128 columns): across the 32 lanes of a warp, 4 consecutive
//     columns per lane, held in 4 registers (int32, float32) or packed two
//     to a register (int16 as __vadd2/__vmaxs2 halves, bfloat16 as
//     __nv_bfloat162), so roll_lane is one __shfl_sync from lane l - 1
//     (cyclic) plus in-register moves (__byte_perm for the packed types);
//   - axis 0 (512 rows): across the warps, consecutive rows per warp in
//     registers, 32 registers of state a thread.  16-bit types (128 KB):
//     a cluster of two blocks of 16 warps, 16 rows per warp.  32-bit types
//     (256 KB, the whole register file of one SM): a cluster of four
//     blocks of 16 warps, 8 rows per warp.  Blocks of 512 threads leave a
//     thread 128 registers; at 1,024 threads (one block holding the 16-bit
//     array, two the 32-bit one) the cap is 64, and ptxas spilled 4-168
//     bytes a thread in 11 of the 16 kernels, so the timings would have
//     counted local-memory traffic.  roll_sub moves inside a thread but
//     for each warp's first row, which takes the last row of the warp
//     above through shared memory (double-buffered), and for each block's
//     first warp, which takes the previous block's last row (cyclic)
//     through distributed shared memory: one cluster barrier per op.  No
//     grid-wide sync: a cluster barrier is what one roll_sub op costs on
//     this layout.
// So "ns/op" is one op over the whole array on 2 SMs (16-bit) or 4 SMs
// (32-bit), at 512 threads an SM.
//
// E2.  B2's wavefront step (128 rows, one segment, tail accumulator) with
// op groups removed, state in int32, int16 (wrapping, as JAX and torch
// wrap it), float32 or bfloat16; the penalties are kernel_ablate.py's
// constants (+5/-4, open -12, extend -4).  `full` is B2 (its int32 strip
// equals stream_wavefront.cu's at rows 1, bit for bit); `norolls` replaces
// every roll by the identity (the char pipe included); `nosel` drops the
// boundary selects; `arith` keeps the max/add core; `minimal` is one
// max + add per plane.  The TPU's pltpu.roll is cyclic and unmasked, so in
// `nosel` and `arith` row 0 takes row 127's values: the roll here is a
// rotate (__shfl_sync from lane (l - 1) & 31), not __shfl_up_sync.  One
// stream is one warp, 4 consecutive rows a thread in registers (the
// wavefront's mapping at rows 1); lane 0 loads the chars a chunk of 8
// steps ahead and lane 31 writes the strip.
//
// What bounds them.  Both keep all state in registers and touch memory
// only to load the input and store the result, so both are bound by
// instruction issue: E1 by one op's instructions over 2-4 SMs, E2 by the
// dependent integer or float chain of a step.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;

// ---------------------------------------------------------------- E1 ---

constexpr int kRows = 512;     // array rows (axis 0)
constexpr int kCols = 128;     // array columns (axis 1)
constexpr int kE1Threads = 512;
constexpr int kE1Warps = kE1Threads / kWarp;
constexpr int kColsPerLane = kCols / kWarp;  // 4
constexpr int kOpsPerStep = 8;

enum Pattern { kAddMax, kSelect, kRollLane, kRollSub };

__device__ __forceinline__ unsigned perm_hi_lo(unsigned x, unsigned y) {
  // (x's high half, y's low half): one element to the right across words
  return __byte_perm(x, y, 0x5432);
}

struct OpI32 {
  using W = int;
  static constexpr int kPer = 1;  // elements per 32-bit word
  static constexpr int kBlocks = 4;  // the cluster holding the array
  __device__ static W splat(int c) { return c; }
  __device__ static W add(W a, W b) { return a + b; }
  __device__ static W vmax(W a, W b) { return max(a, b); }
  __device__ static W sel(W y, W c) { return y > c ? y : y + c; }
  __device__ static W mod7(W y) { return y - y / 7 * 7; }  // y >= 0: floor
  __device__ static unsigned bits(W v) { return static_cast<unsigned>(v); }
  __device__ static W from_bits(unsigned u) { return static_cast<int>(u); }
};

struct OpF32 {
  using W = float;
  static constexpr int kPer = 1;
  static constexpr int kBlocks = 4;
  __device__ static W splat(int c) { return static_cast<float>(c); }
  __device__ static W add(W a, W b) { return a + b; }
  __device__ static W vmax(W a, W b) { return fmaxf(a, b); }
  __device__ static W sel(W y, W c) { return y > c ? y : y + c; }
  __device__ static W mod7(W y) { return y - floorf(y / 7.f) * 7.f; }
  __device__ static unsigned bits(W v) { return __float_as_uint(v); }
  __device__ static W from_bits(unsigned u) { return __uint_as_float(u); }
};

struct OpI16x2 {  // two int16 lanes in a word, low half the lower column
  using W = unsigned;
  static constexpr int kPer = 2;
  static constexpr int kBlocks = 2;
  __device__ static W splat(int c) { return (c & 0xffffu) * 0x10001u; }
  __device__ static W add(W a, W b) { return __vadd2(a, b); }
  __device__ static W vmax(W a, W b) { return __vmaxs2(a, b); }
  __device__ static W sel(W y, W c) {
    const unsigned m = __vcmpgts2(y, c);  // 0xffff where y > c
    return (y & m) | (__vadd2(y, c) & ~m);
  }
  __device__ static W mod7(W y) {
    const int lo = static_cast<short>(y & 0xffffu);
    const int hi = static_cast<short>(y >> 16);
    const unsigned l = static_cast<unsigned short>(lo - lo / 7 * 7);
    const unsigned h = static_cast<unsigned short>(hi - hi / 7 * 7);
    return l | (h << 16);
  }
  __device__ static unsigned bits(W v) { return v; }
  __device__ static W from_bits(unsigned u) { return u; }
};

struct OpBF16x2 {
  using W = __nv_bfloat162;
  static constexpr int kPer = 2;
  static constexpr int kBlocks = 2;
  __device__ static W splat(int c) { return __float2bfloat162_rn(static_cast<float>(c)); }
  __device__ static W add(W a, W b) { return __hadd2(a, b); }
  __device__ static W vmax(W a, W b) { return __hmax2(a, b); }
  __device__ static W sel(W y, W c) {
    const unsigned m = __hgt2_mask(y, c);
    return from_bits((bits(y) & m) | (bits(__hadd2(y, c)) & ~m));
  }
  __device__ static W mod7(W y) {
    float2 f = __bfloat1622float2(y);
    f.x -= floorf(f.x / 7.f) * 7.f;
    f.y -= floorf(f.y / 7.f) * 7.f;
    return __floats2bfloat162_rn(f.x, f.y);
  }
  __device__ static unsigned bits(W v) {
    return *reinterpret_cast<const unsigned*>(&v);
  }
  __device__ static W from_bits(unsigned u) {
    return *reinterpret_cast<const W*>(&u);
  }
};

template <class Op, int kPattern>
__global__ void __launch_bounds__(kE1Threads, 1)
    microbench_kernel(const unsigned* __restrict__ x, unsigned* __restrict__ y,
                      int steps, int c_arg) {
  using W = typename Op::W;
  constexpr int NB = Op::kBlocks;
  constexpr int WPR = kColsPerLane / Op::kPer;  // words of a row per lane
  constexpr int R = kRows / NB / kE1Warps;      // rows per warp
  __shared__ unsigned edge[2][kE1Warps][WPR][kWarp];  // each warp's last row

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int row0 = rank * (kRows / NB) + warp * R;
  const W c = Op::splat(c_arg);

  W v[R][WPR];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < WPR; ++k)
      v[r][k] = Op::from_bits(x[((row0 + r) * kCols + lane * kColsPerLane) / Op::kPer + k]);

  int parity = 0;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int op = 0; op < kOpsPerStep; ++op) {
      if constexpr (kPattern == kAddMax) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int k = 0; k < WPR; ++k) v[r][k] = Op::vmax(Op::add(v[r][k], c), v[r][k]);
      } else if constexpr (kPattern == kSelect) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int k = 0; k < WPR; ++k) v[r][k] = Op::sel(v[r][k], c);
      } else if constexpr (kPattern == kRollLane) {
        const int src = (lane + kWarp - 1) % kWarp;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned prev = __shfl_sync(kFull, Op::bits(v[r][WPR - 1]), src);
          W rolled[WPR];
          if constexpr (Op::kPer == 1) {
            rolled[0] = Op::from_bits(prev);
#pragma unroll
            for (int k = 1; k < WPR; ++k) rolled[k] = v[r][k - 1];
          } else {
            rolled[0] = Op::from_bits(perm_hi_lo(prev, Op::bits(v[r][0])));
#pragma unroll
            for (int k = 1; k < WPR; ++k)
              rolled[k] = Op::from_bits(perm_hi_lo(Op::bits(v[r][k - 1]), Op::bits(v[r][k])));
          }
#pragma unroll
          for (int k = 0; k < WPR; ++k) v[r][k] = Op::vmax(v[r][k], Op::add(rolled[k], c));
        }
      } else {  // kRollSub
#pragma unroll
        for (int k = 0; k < WPR; ++k) edge[parity][warp][k][lane] = Op::bits(v[R - 1][k]);
        cg::this_cluster().sync();
        unsigned prev[WPR];
        if (warp > 0) {
#pragma unroll
          for (int k = 0; k < WPR; ++k) prev[k] = edge[parity][warp - 1][k][lane];
        } else {
          // the previous block's last warp: the rows above this block, cyclic
          const unsigned* above = cg::this_cluster().map_shared_rank(
              &edge[parity][0][0][0], (rank + NB - 1) % NB);
#pragma unroll
          for (int k = 0; k < WPR; ++k)
            prev[k] = above[((kE1Warps - 1) * WPR + k) * kWarp + lane];
        }
#pragma unroll
        for (int r = R - 1; r >= 1; --r)
#pragma unroll
          for (int k = 0; k < WPR; ++k) v[r][k] = Op::vmax(v[r][k], Op::add(v[r - 1][k], c));
#pragma unroll
        for (int k = 0; k < WPR; ++k)
          v[0][k] = Op::vmax(v[0][k], Op::add(Op::from_bits(prev[k]), c));
        parity ^= 1;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < WPR; ++k) v[r][k] = Op::mod7(v[r][k]);
  }
  // no block may leave while the other still reads its shared memory
  if constexpr (kPattern == kRollSub) cg::this_cluster().sync();
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < WPR; ++k)
      y[((row0 + r) * kCols + lane * kColsPerLane) / Op::kPer + k] = Op::bits(v[r][k]);
}

template <class Op, int kPattern>
cudaError_t launch_e1(const void* x, void* y, int steps, int c, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Op::kBlocks);
  cfg.blockDim = dim3(kE1Threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Op::kBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, microbench_kernel<Op, kPattern>, static_cast<const unsigned*>(x),
      static_cast<unsigned*>(y), steps, c);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class Op>
cudaError_t launch_pattern(int pattern, const void* x, void* y, int steps, int c,
                           cudaStream_t stream) {
  switch (pattern) {
    case kAddMax: return launch_e1<Op, kAddMax>(x, y, steps, c, stream);
    case kSelect: return launch_e1<Op, kSelect>(x, y, steps, c, stream);
    case kRollLane: return launch_e1<Op, kRollLane>(x, y, steps, c, stream);
    case kRollSub: return launch_e1<Op, kRollSub>(x, y, steps, c, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- E2 ---

constexpr int kLanes = 128;  // wavefront rows
constexpr int kV = kLanes / kWarp;  // rows per thread
constexpr int kChunk = 8;    // steps whose chars are loaded together
constexpr int kE2Block = 128;  // threads: 4 streams
constexpr int kMa = 5, kMi = -4, kGo = -12, kGe = -4;  // kernel_ablate.py:37
constexpr int kPadChar = 4, kFlag = 8;

enum Variant { kVFull, kVNoRolls, kVNoSel, kVArith, kVMinimal };

template <class D>
struct Ar;
template <>
struct Ar<int> {
  __device__ static int of(int v) { return v; }
  __device__ static int add(int a, int b) { return a + b; }
  __device__ static int vmax(int a, int b) { return max(a, b); }
  __device__ static int to_int(int a) { return a; }
};
template <>
struct Ar<short> {  // wraps in two's complement, as JAX and torch do
  __device__ static short of(int v) { return static_cast<short>(v); }
  __device__ static short add(short a, short b) { return static_cast<short>(a + b); }
  __device__ static short vmax(short a, short b) { return a > b ? a : b; }
  __device__ static int to_int(short a) { return a; }
};
template <>
struct Ar<float> {
  __device__ static float of(int v) { return static_cast<float>(v); }
  __device__ static float add(float a, float b) { return a + b; }
  __device__ static float vmax(float a, float b) { return fmaxf(a, b); }
  __device__ static int to_int(float a) { return static_cast<int>(a); }
};
template <>
struct Ar<__nv_bfloat16> {
  __device__ static __nv_bfloat16 of(int v) { return __int2bfloat16_rn(v); }
  __device__ static __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) { return __hadd(a, b); }
  __device__ static __nv_bfloat16 vmax(__nv_bfloat16 a, __nv_bfloat16 b) { return __hmax(a, b); }
  __device__ static int to_int(__nv_bfloat16 a) { return __bfloat162int_rz(a); }
};

template <class D>
__device__ __forceinline__ D shfl(D v, int src) {
  return __shfl_sync(kFull, v, src);
}
template <>
__device__ __forceinline__ short shfl(short v, int src) {
  return static_cast<short>(__shfl_sync(kFull, static_cast<int>(v), src));
}

template <class D, int kVariant>
__global__ void __launch_bounds__(kE2Block) stream_ablate_kernel(
    const int8_t* qk, const int8_t* sk, int32_t* out, int S, int T) {
  using A = Ar<D>;
  constexpr bool kRoll = kVariant != kVNoRolls;
  constexpr bool kSel = kVariant == kVFull || kVariant == kVNoRolls;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = tid / kWarp;
  const int lane = tid % kWarp;
  const bool live = s < S;  // the whole warp runs the loop (shuffles)
  const int src = (lane + kWarp - 1) % kWarp;
  const D zero = A::of(0), ma = A::of(kMa), mi = A::of(kMi);
  const D go = A::of(kGo), ge = A::of(kGe);

  int q[kV], C[kV];
  D D1[kV], D2[kV], Gp[kV], Hp[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    q[k] = live ? qk[(size_t)(lane * kV + k) * S + s] : 0;
    C[k] = kPadChar;
    D1[k] = D2[k] = Gp[k] = Hp[k] = zero;
  }
  D acc = zero;
  // lane 0 loads the chars a chunk ahead: a load issued where it is used
  // puts its latency on the step's dependent chain
  const bool head = live && lane == 0;
  int cnext[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) cnext[i] = head ? sk[(size_t)i * S + s] : kPadChar;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    int cin[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      cin[i] = cnext[i];
      cnext[i] = head && t0 + kChunk < T ? sk[(size_t)(t0 + kChunk + i) * S + s] : kPadChar;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      D emit;
      if constexpr (kVariant == kVMinimal) {
#pragma unroll
        for (int k = 0; k < kV; ++k) {
          D1[k] = A::vmax(A::add(D1[k], ge), D2[k]);
          D2[k] = D1[k];
        }
        emit = D1[kV - 1];
      } else {
        // As in stream_wavefront.cu: the row above this thread's first row
        // comes from lane - 1 (a rotate: lane 0 takes lane 31's, row 127),
        // then the rows update last to first, in place, so each one reads
        // its upper neighbour's state from the previous step.
        int nC = C[kV - 1];
        D nD2 = D2[kV - 1], nG = Gp[kV - 1], nH = Hp[kV - 1];
        if constexpr (kRoll) {
          nC = shfl(nC, src);
          nD2 = shfl(nD2, src);
          nG = shfl(nG, src);
          nH = shfl(nH, src);
        }
#pragma unroll
        for (int k = kV - 1; k >= 0; --k) {
          // the rolled planes at row k: row k - 1's values (row k itself
          // under norolls)
          const int j = kRoll ? k - 1 : k;
          const int jj = j < 0 ? 0 : j;
          int c = j < 0 ? nC : C[jj];
          const D rD2 = j < 0 ? nD2 : D2[jj];
          const D rG = j < 0 ? nG : Gp[jj];
          const D rH = j < 0 ? nH : Hp[jj];
          const bool seghead = lane == 0 && k == 0;
          if (seghead) c = cin[i];
          C[k] = c;
          const bool f0 = c >= kFlag;
          const D sc = (c & 7) == q[k] ? ma : mi;
          D Mc, Ic, Hc;
          if constexpr (kVariant == kVArith) {
            Mc = A::vmax(A::add(rD2, sc), zero);
            Ic = A::add(A::vmax(rG, Gp[k]), ge);
            Hc = A::vmax(rH, Mc);
          } else {
            const D diag = kSel && (seghead || f0) ? zero : rD2;
            Mc = A::vmax(A::add(diag, sc), zero);
            const D gup = kSel && seghead ? zero : rG;
            const D gleft = kSel && f0 ? zero : Gp[k];
            Ic = A::add(A::vmax(gup, gleft), ge);
            Hc = A::vmax(kSel && seghead ? zero : rH, Mc);
          }
          if (k == kV - 1) {
            // the tail row 127 lives in lane 31's last register
            acc = A::vmax(kSel && f0 ? zero : acc, Hc);
            emit = acc;
          }
          D2[k] = D1[k];
          D1[k] = A::vmax(Mc, Ic);
          Gp[k] = A::vmax(A::add(Mc, go), Ic);
          Hp[k] = Hc;
        }
      }
      if (live && lane == kWarp - 1) out[(size_t)(t0 + i) * S + s] = A::to_int(emit);
    }
  }
}

template <class D>
cudaError_t launch_variant(int variant, const void* qk, const void* sk, void* out,
                           int S, int T, cudaStream_t stream) {
  const long long threads = (long long)S * kWarp;
  const unsigned blocks = (unsigned)((threads + kE2Block - 1) / kE2Block);
  const auto* q = static_cast<const int8_t*>(qk);
  const auto* c = static_cast<const int8_t*>(sk);
  auto* o = static_cast<int32_t*>(out);
  switch (variant) {
    case kVFull: stream_ablate_kernel<D, kVFull><<<blocks, kE2Block, 0, stream>>>(q, c, o, S, T); break;
    case kVNoRolls: stream_ablate_kernel<D, kVNoRolls><<<blocks, kE2Block, 0, stream>>>(q, c, o, S, T); break;
    case kVNoSel: stream_ablate_kernel<D, kVNoSel><<<blocks, kE2Block, 0, stream>>>(q, c, o, S, T); break;
    case kVArith: stream_ablate_kernel<D, kVArith><<<blocks, kE2Block, 0, stream>>>(q, c, o, S, T); break;
    case kVMinimal: stream_ablate_kernel<D, kVMinimal><<<blocks, kE2Block, 0, stream>>>(q, c, o, S, T); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes shared by both entries: 0 int32, 1 int16, 2 float32,
// 3 bfloat16.

// E1: x [512, 128] of dtype -> y, the same; pattern 0 addmax, 1 select,
// 2 roll_lane, 3 roll_sub; c the op's constant (1).  Returns the launch's
// CUDA error.
extern "C" int swtpu_microbench_ops(const void* x, void* y, int dtype, int pattern,
                                    int steps, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_pattern<OpI32>(pattern, x, y, steps, c, st);
    case 1: return launch_pattern<OpI16x2>(pattern, x, y, steps, c, st);
    case 2: return launch_pattern<OpF32>(pattern, x, y, steps, c, st);
    case 3: return launch_pattern<OpBF16x2>(pattern, x, y, steps, c, st);
    default: return cudaErrorInvalidValue;
  }
}

// E2: qk [128, S] int8, sk [T, S] int8 -> out [T, S] int32; variant 0 full,
// 1 norolls, 2 nosel, 3 arith, 4 minimal; T % 8 == 0.  The caller checks
// these.  Returns the launch's CUDA error.
extern "C" int swtpu_stream_ablate(const void* qk, const void* sk, void* out, int S,
                                   int T, int dtype, int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_variant<int>(variant, qk, sk, out, S, T, st);
    case 1: return launch_variant<short>(variant, qk, sk, out, S, T, st);
    case 2: return launch_variant<float>(variant, qk, sk, out, S, T, st);
    case 3: return launch_variant<__nv_bfloat16>(variant, qk, sk, out, S, T, st);
    default: return cudaErrorInvalidValue;
  }
}
