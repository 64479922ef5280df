// Streamed anti-diagonal Smith-Waterman wavefront for Hopper (sm_90a).
//
// Replaces the TPU kernels swtpu/ops/pallas_stream.py:_stream_kernel_mr
// (query rows folded R per sublane) and pallas_stream.py:_stream_kernel in
// its tail-accumulator form (R = 1).  The plain PyTorch version of the same
// recurrence is swtpu_torch/ops/stream.py:stream_strip_reference; the two
// must agree bit for bit.
//
// Contract.  qk [128, S] int8 is the query register in kernel layout
// (query row k*R + r of segment g of physical stream s at row
// r*(128/R) + g*SLg + k, column s).  sk [T, seg*S] int8 holds the packed
// streams: codes 0-3, +8 on a read's first char, 4 = pad.  strip
// [T, seg*S] int32 receives, for every step t, each segment's tail
// accumulator: strip[t, g*S + s].  No lengths or masks: the sentinel codes
// (query pad 5, stream pad 4) never match.
//
// What bounds it.  Per stream-step a segment head reads 1 byte and a
// segment tail writes 4, so the card's memory bandwidth is far from the
// limit.  The limit is the chain of dependent integer ops per step: inside
// a sublane the gap state G of row r feeds row r+1 in the same step, and
// the sublane hand-off feeds the next step.  The design keeps the whole DP
// state in registers for the length of the stream and spends nothing
// else per step:
//   - one stream is W = min(128/R, 32) consecutive threads of one warp;
//     each thread owns V = (128/R)/W consecutive wavefront sublanes, each
//     of R query rows, with their D/G/H state and query codes in registers;
//   - the one-sublane shift of the char pipe, D (two steps back), G and H
//     is four __shfl_up_sync per step at width W, and a register move
//     between the V sublanes inside a thread;
//   - a thread loops over all T steps itself, so no state crosses blocks
//     (the TPU's sequential grid becomes this loop), and the head thread
//     loads the stream chars kChunk steps ahead.
// Occupancy is what it costs: at S = 512 and R = 16 the grid is 4096
// threads.  Tuning threads per stream is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;   // query rows of the wavefront
constexpr int kFlag = 8;      // first-char marker
constexpr int kPad = 4;       // stream pad char, the pipe's initial fill
constexpr int kQueryPad = 5;  // query pad code
constexpr int kChunk = 8;     // steps whose chars are loaded together
constexpr int kBlock = 128;   // threads per block
constexpr unsigned kFull = 0xffffffffu;

// One step of one sublane: R query rows, one char.  g_up, h_up and d_diag
// are the sublane above's G[R-1] and H from the previous step and its
// D[R-1] from two steps back.  Updates D, G (rows 0..R-1), d2l (this
// sublane's D[R-1] from the previous step, which the sublane below reads
// next step) and h; returns whether the char starts a read.
template <int R>
__device__ __forceinline__ bool sublane_step(
    int c, bool seghead, int g_up, int h_up, int d_diag, const int (&q)[R],
    int (&D)[R], int (&G)[R], int& d2l, int& h, int ma, int mi, int go,
    int ge) {
  const bool f0 = c >= kFlag;
  const int cv = c & 7;
  const int diag = (seghead || f0) ? 0 : d_diag;
  int M = max(diag + (cv == q[0] ? ma : mi), 0);
  int I = max(seghead ? 0 : g_up, f0 ? 0 : G[0]) + ge;
  int hc = max(seghead ? 0 : h_up, M);
  int dprev = D[0];
  d2l = D[R - 1];
  D[0] = max(M, I);
  int g = max(M + go, I);
  G[0] = g;
#pragma unroll
  for (int r = 1; r < R; ++r) {
    const int dr = f0 ? 0 : dprev;
    dprev = D[r];
    M = max(dr + (cv == q[r] ? ma : mi), 0);
    I = max(g, f0 ? 0 : G[r]) + ge;
    hc = max(hc, M);
    D[r] = max(M, I);
    g = max(M + go, I);
    G[r] = g;
  }
  h = hc;
  return f0;
}

template <int R>
__global__ void __launch_bounds__(kBlock) stream_wavefront_kernel(
    const int8_t* __restrict__ qk, const int8_t* __restrict__ sk,
    int32_t* __restrict__ strip, int S, int T, int seg, int ma, int mi,
    int go, int ge) {
  constexpr int SL = kLanes / R;        // wavefront sublanes per stream
  constexpr int W = SL < 32 ? SL : 32;  // threads per stream
  constexpr int V = SL / W;             // sublanes per thread
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = tid / W;
  const int lane = tid % W;
  // threads past the last stream run the loop (the shuffles need the
  // whole warp) but read and write nothing
  const bool live = s < S;
  const int SLg = SL / seg;  // sublanes per segment; a multiple of V
  const int p0 = lane * V;   // this thread's first sublane
  const int pt = p0 + V - 1;  // and last
  const bool head = live && p0 % SLg == 0;
  const bool tail = live && pt % SLg == SLg - 1;
  const size_t ld = (size_t)seg * S;
  const int8_t* src = sk + (size_t)(p0 / SLg) * S + s;
  int32_t* dst = strip + (size_t)(pt / SLg) * S + s;

  int q[V][R], D[V][R], G[V][R], C[V], D2L[V], H[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    C[v] = kPad;
    D2L[v] = 0;
    H[v] = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      D[v][r] = 0;
      G[v][r] = 0;
      q[v][r] = live ? qk[(size_t)(r * SL + p0 + v) * S + s] : kQueryPad;
    }
  }
  int acc = 0;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    int cin[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      cin[k] = head ? src[(size_t)(t0 + k) * ld] : kPad;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      // the sublane above this thread's first one lives in lane - 1
      const int nC = __shfl_up_sync(kFull, C[V - 1], 1, W);
      const int nG = __shfl_up_sync(kFull, G[V - 1][R - 1], 1, W);
      const int nH = __shfl_up_sync(kFull, H[V - 1], 1, W);
      const int nD = __shfl_up_sync(kFull, D2L[V - 1], 1, W);
      bool f0_tail = false;
      // last sublane first, so each one still reads its upper
      // neighbour's state from the previous step
#pragma unroll
      for (int v = V - 1; v >= 1; --v) {
        C[v] = C[v - 1];
        const bool f0 = sublane_step<R>(
            C[v], false, G[v - 1][R - 1], H[v - 1], D2L[v - 1], q[v], D[v],
            G[v], D2L[v], H[v], ma, mi, go, ge);
        if (v == V - 1) f0_tail = f0;
      }
      C[0] = head ? cin[k] : nC;
      const bool f0 = sublane_step<R>(
          C[0], head, nG, nH, nD, q[0], D[0], G[0], D2L[0], H[0], ma, mi, go,
          ge);
      if (V == 1) f0_tail = f0;
      if (tail) {
        acc = max(f0_tail ? 0 : acc, H[V - 1]);
        dst[(size_t)(t0 + k) * ld] = acc;
      }
    }
  }
}

template <int R>
cudaError_t launch(const void* qk, const void* sk, void* strip, int S, int T,
                   int seg, int ma, int mi, int go, int ge,
                   cudaStream_t stream) {
  constexpr int SL = kLanes / R;
  constexpr int W = SL < 32 ? SL : 32;
  const long long threads = (long long)S * W;
  const int blocks = (int)((threads + kBlock - 1) / kBlock);
  stream_wavefront_kernel<R><<<blocks, kBlock, 0, stream>>>(
      static_cast<const int8_t*>(qk), static_cast<const int8_t*>(sk),
      static_cast<int32_t*>(strip), S, T, seg, ma, mi, go, ge);
  return cudaGetLastError();
}

}  // namespace

// rows in {1, 2, 4, 8, 16}; seg in {1, 2, 4, 8} with (128/rows) % seg == 0;
// T % 8 == 0.  The caller checks these.  Returns the launch's CUDA error.
extern "C" int swtpu_stream_wavefront(const void* qk, const void* sk,
                                      void* strip, int S, int T, int seg,
                                      int rows, int ma, int mi, int go, int ge,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return launch<1>(qk, sk, strip, S, T, seg, ma, mi, go, ge, st);
    case 2: return launch<2>(qk, sk, strip, S, T, seg, ma, mi, go, ge, st);
    case 4: return launch<4>(qk, sk, strip, S, T, seg, ma, mi, go, ge, st);
    case 8: return launch<8>(qk, sk, strip, S, T, seg, ma, mi, go, ge, st);
    case 16: return launch<16>(qk, sk, strip, S, T, seg, ma, mi, go, ge, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
