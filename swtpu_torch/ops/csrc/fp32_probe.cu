// Throughput probe of the float32 opcodes that the float32 recurrences run
// on (FADD, FMNMX, FSEL), alone and mixed in the float32 wavefront step's
// proportions, and of the bfloat16 ones that the packed bfloat16 state
// runs on (HADD2.BF16, HFMA2.BF16 with .RELU, HMNMX2.BF16), alone and mixed
// in the bfloat16 wavefront step's proportions, two values a register, for
// swtpu_torch/tools/fp32_rates.py.  Not a kernel of any
// scoring path and not part of the kernel library: the tool builds it on
// its own.
//
// Each thread keeps kValues independent values, so no dependency chain
// bounds the rate, and the tool launches as many blocks of 256 threads an
// SM as it holds at once, one wave.  Thread 0 of each block records the SM clocks
// and the nanoseconds of its loop, from which the tool reads the clock.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kValues = 8;
constexpr int kRounds = 4;  // rounds a loop trip: the loop's own ops stay a small share

enum Variant {
  kFadd = 0, kFmnmx = 1, kFsel = 2, kMix = 3,
  kHadd2 = 4, kHfma2 = 5, kHmnmx2 = 6, kBf16Mix = 7,
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// a < b ? x : y as one FSETP and one FSEL, so the compiler cannot turn the
// select into a branch or a move
__device__ __forceinline__ float select_lt(float a, float b, float x, float y) {
  float r;
  asm("{\n .reg .pred p;\n setp.lt.f32 p, %1, %2;\n selp.f32 %0, %3, %4, p;\n}"
      : "=f"(r) : "f"(a), "f"(b), "f"(x), "f"(y));
  return r;
}

template <int kVariant>
__global__ void __launch_bounds__(256) fp32_probe_kernel(float* out, long long* clocks,
                                                         int trips, float step) {
  float x[kValues];
#pragma unroll
  for (int j = 0; j < kValues; ++j) x[j] = (threadIdx.x + 37 * j) * 0.001f;
  const float lo = -step, hi = 1e30f;
  __syncthreads();
  const long long c0 = clock64();
  const unsigned long long t0 = global_ns();
#pragma unroll 1
  for (int it = 0; it < trips; ++it) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      float y[kValues];
      if (kVariant == kFadd) {  // 1 FADD a value
#pragma unroll
        for (int j = 0; j < kValues; ++j) y[j] = x[j] + step;
      } else if (kVariant == kFmnmx) {  // 1 FMNMX a value, partners rotating
#pragma unroll
        for (int j = 0; j < kValues; ++j)
          y[j] = (j & 1) ? fminf(x[j], x[(j + r + 1) % kValues])
                         : fmaxf(x[j], x[(j + r + 1) % kValues]);
      } else if (kVariant == kFsel) {  // 1 FSETP and 1 FSEL a value
#pragma unroll
        for (int j = 0; j < kValues; ++j)
          y[j] = select_lt(x[j], x[(j + r + 1) % kValues], x[(j + 2) % kValues], x[j]);
      } else {  // the float32 bound's mix: 3 FADD, 5 FMNMX, 1 FSETP, 1 FSEL a value
#pragma unroll
        for (int j = 0; j < kValues; ++j) {
          const float a = x[j] + step;
          const float b = x[(j + 1) % kValues] + lo;
          const float c = x[(j + 2) % kValues] + step;
          float m = fmaxf(fmaxf(a, b), fmaxf(c, x[(j + 3) % kValues]));
          m = fmaxf(fminf(m, hi), lo);
          y[j] = select_lt(m, c, a, m);
        }
      }
#pragma unroll
      for (int j = 0; j < kValues; ++j) x[j] = y[j];
    }
  }
  const unsigned long long t1 = global_ns();
  const long long c1 = clock64();
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kValues; ++j) sum += x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
  if (threadIdx.x == 0) {
    clocks[2 * blockIdx.x] = c1 - c0;
    clocks[2 * blockIdx.x + 1] = static_cast<long long>(t1 - t0);
  }
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const unsigned*>(&x);
}
__device__ __forceinline__ __nv_bfloat162 of_bits(unsigned x) {
  return *reinterpret_cast<const __nv_bfloat162*>(&x);
}

// 0xFFFF in each half whose sign bit is set: the wavefront's mask (PRMT)
__device__ __forceinline__ unsigned sign_halves(unsigned x) {
  unsigned r;
  asm("prmt.b32 %0, %1, %2, 0xBB99;" : "=r"(r) : "r"(x), "r"(0u));
  return r;
}

template <int kVariant>
__global__ void __launch_bounds__(256) bf16_probe_kernel(float* out, long long* clocks,
                                                         int trips, float step) {
  __nv_bfloat162 x[kValues];
#pragma unroll
  for (int j = 0; j < kValues; ++j)
    x[j] = __floats2bfloat162_rn((threadIdx.x + 37 * j) * 0.001f, (threadIdx.x + 11 * j) * 0.001f);
  __nv_bfloat162 d[kValues];  // the mix's diagonals
#pragma unroll
  for (int j = 0; j < kValues; ++j) d[j] = x[(j + 5) % kValues];
  const __nv_bfloat162 s2 = __float2bfloat162_rn(step), lo = __float2bfloat162_rn(-step),
                       one = __float2bfloat162_rn(1.f);
  __syncthreads();
  const long long c0 = clock64();
  const unsigned long long t0 = global_ns();
#pragma unroll 1
  for (int it = 0; it < trips; ++it) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      __nv_bfloat162 y[kValues];
      if (kVariant == kHadd2) {  // 1 HADD2.BF16 a register
#pragma unroll
        for (int j = 0; j < kValues; ++j) y[j] = __hadd2(x[j], s2);
      } else if (kVariant == kHfma2) {  // 1 HFMA2.BF16.RELU: the M update's form
#pragma unroll
        for (int j = 0; j < kValues; ++j) y[j] = __hfma2_relu(x[j], one, s2);
      } else if (kVariant == kHmnmx2) {  // 1 HMNMX2.BF16 a register, partners rotating
#pragma unroll
        for (int j = 0; j < kValues; ++j)
          y[j] = (j & 1) ? __hmin2(x[j], x[(j + r + 1) % kValues])
                         : __hmax2(x[j], x[(j + r + 1) % kValues]);
      } else {  // the bfloat16 wavefront's mix a register of two cells, in
                // the step's own form: M = relu(D + s) (HFMA2) on the
                // diagonal d, I = max + extend, G = max(M + open, I),
                // D = max(M, I), H = max(h, M): 1 HFMA2, 2 HADD2, 4 HMNMX2;
                // the score's select: a sign mask (PRMT) and a bit select
                // (LOP3).  D becomes the next M's diagonal, as the kernel's
                // does, so no max result feeds only another max (ptxas
                // would merge two such maxes into one 3-input VHMNMX)
#pragma unroll
        for (int j = 0; j < kValues; ++j) {
          const __nv_bfloat162 m = __hfma2_relu(d[j], one, s2);
          const __nv_bfloat162 i = __hadd2(__hmax2(x[(j + 1) % kValues], x[(j + 2) % kValues]), lo);
          const __nv_bfloat162 g = __hmax2(__hadd2(m, lo), i);
          d[j] = __hmax2(m, i);
          const __nv_bfloat162 h = __hmax2(x[(j + 3) % kValues], m);
          const unsigned k = sign_halves(bits(x[(j + 4) % kValues]));
          y[j] = of_bits((bits(h) & k) | (bits(g) & ~k));
        }
      }
#pragma unroll
      for (int j = 0; j < kValues; ++j) x[j] = y[j];
    }
  }
  const unsigned long long t1 = global_ns();
  const long long c1 = clock64();
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kValues; ++j)
    sum += __low2float(x[j]) + __high2float(x[j]) + __low2float(d[j]) + __high2float(d[j]);
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
  if (threadIdx.x == 0) {
    clocks[2 * blockIdx.x] = c1 - c0;
    clocks[2 * blockIdx.x + 1] = static_cast<long long>(t1 - t0);
  }
}

}  // namespace

// Blocks of `variant` that one SM holds at once (a grid of that many an SM
// runs as one wave), or a negative cudaError_t.
extern "C" int swtpu_fp32_probe_blocks_per_sm(int variant) {
  int n = 0;
  cudaError_t e = cudaErrorInvalidValue;
  switch (variant) {
    case kFadd: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fp32_probe_kernel<kFadd>, 256, 0); break;
    case kFmnmx: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fp32_probe_kernel<kFmnmx>, 256, 0); break;
    case kFsel: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fp32_probe_kernel<kFsel>, 256, 0); break;
    case kMix: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fp32_probe_kernel<kMix>, 256, 0); break;
    case kHadd2: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bf16_probe_kernel<kHadd2>, 256, 0); break;
    case kHfma2: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bf16_probe_kernel<kHfma2>, 256, 0); break;
    case kHmnmx2: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bf16_probe_kernel<kHmnmx2>, 256, 0); break;
    case kBf16Mix: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bf16_probe_kernel<kBf16Mix>, 256, 0); break;
    default: break;
  }
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// out: [blocks * 256] float; clocks: [blocks, 2] (SM clocks, ns) of each
// block's loop.  Returns a cudaError_t.
extern "C" int swtpu_fp32_probe(int variant, float* out, long long* clocks, int blocks,
                                int trips, float step, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFadd: fp32_probe_kernel<kFadd><<<blocks, 256, 0, s>>>(out, clocks, trips, step); break;
    case kFmnmx: fp32_probe_kernel<kFmnmx><<<blocks, 256, 0, s>>>(out, clocks, trips, step); break;
    case kFsel: fp32_probe_kernel<kFsel><<<blocks, 256, 0, s>>>(out, clocks, trips, step); break;
    case kMix: fp32_probe_kernel<kMix><<<blocks, 256, 0, s>>>(out, clocks, trips, step); break;
    case kHadd2: bf16_probe_kernel<kHadd2><<<blocks, 256, 0, s>>>(out, clocks, trips, step); break;
    case kHfma2: bf16_probe_kernel<kHfma2><<<blocks, 256, 0, s>>>(out, clocks, trips, step); break;
    case kHmnmx2: bf16_probe_kernel<kHmnmx2><<<blocks, 256, 0, s>>>(out, clocks, trips, step); break;
    case kBf16Mix: bf16_probe_kernel<kBf16Mix><<<blocks, 256, 0, s>>>(out, clocks, trips, step); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
