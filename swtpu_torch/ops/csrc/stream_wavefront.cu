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
// Chained tile (seg = 1): bD/bG/bH [T, S] int32 are the tile above's row
// 127, already shifted by the host, so the tile's row 0 reads them in
// place of the zero boundary: diag = f0 ? 0 : bD[t], G_up = bG[t],
// H_up = bH[t].  The tile writes its tail accumulator and its own row 127
// (oD, oG, oH [T, S] int32) every step.  Per stream-step that is 12 bytes
// read and 16 written against 128 cells, so the chained tile is bound by
// the same dependent integer chain as the plain one.
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
//   - one stream is W = min(128/R, 32) consecutive threads of one warp;
//     each thread owns V = (128/R)/W consecutive wavefront sublanes, each
//     of R query rows, with their D/G/H state and query codes in registers;
//   - the one-sublane shift of the char pipe, D (two steps back), G and H
//     is four __shfl_up_sync per step at width W, and a register move
//     between the V sublanes inside a thread;
//   - a thread loops over the steps itself, so no state crosses blocks
//     (the TPU's sequential grid becomes this loop), and the head thread
//     loads each step's stream char (and a chained tile's boundary values)
//     kChunk steps ahead of its use.
//
// Slices.  S streams of W threads fill few SMs (at S = 512 and R = 16,
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
// wrapper picks C from S, W, T, SLg and the SM count (ops/stream.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// One step of one sublane: R query rows, one char.  g_up, h_up and d_diag
// are the sublane above's G[R-1] and H from the previous step and its
// D[R-1] from two steps back.  Updates D, G (rows 0..R-1), d2l (this
// sublane's D[R-1] from the previous step, which the sublane below reads
// next step) and h; returns whether the char starts a read.  kRipple keeps
// the sublane's own previous h too (the ripple-H form, R = 1).
template <int R, bool kRipple>
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
  if (kRipple) hc = max(hc, f0 ? 0 : h);
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

// What a launch computes: the strip of tail accumulators (B1, B2), the
// strip of tail H (B2 ripple-H), or one chained tile (B3).
enum Mode { kTailAcc, kRippleH, kChained };

struct Args {
  const int8_t* qk;
  const int8_t* sk;
  const int32_t* bD;  // kChained only: the tile above's shifted row 127
  const int32_t* bG;
  const int32_t* bH;
  int32_t* strip;
  int32_t* oD;  // kChained only: this tile's row 127
  int32_t* oG;
  int32_t* oH;
  int S, T, seg, ma, mi, go, ge;
};

// The head's char of step t and, for a chained tile, the tile above's
// shifted row 127 at step t; a pad and zeros where `in` is false (off the
// head, or past T).
template <bool kChain>
__device__ __forceinline__ void fetch(const Args& a, const int8_t* src,
                                      size_t ld, int s, bool in, int t,
                                      int& c, int& d, int& g, int& h) {
  c = in ? src[(size_t)t * ld] : kPad;
  if (kChain) {
    const size_t o = (size_t)t * a.S + s;
    d = in ? a.bD[o] : 0;
    g = in ? a.bG[o] : 0;
    h = in ? a.bH[o] : 0;
  }
}

template <int R, int kMode>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    stream_wavefront_kernel(const Args a) {
  constexpr int SL = kLanes / R;        // wavefront sublanes per stream
  constexpr int W = SL < 32 ? SL : 32;  // threads per stream
  constexpr int V = SL / W;             // sublanes per thread
  constexpr bool kRipple = kMode == kRippleH;
  constexpr bool kChain = kMode == kChained;
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
  // a segment head sees zero boundaries, a chained tile's row 0 the strips
  const bool seghead = head && !kChain;
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
      q[v][r] = live ? a.qk[(size_t)(r * SL + p0 + v) * S + s] : kQueryPad;
    }
  }
  int acc = 0;

  // slot k holds the inputs of step t0 + k; once used it is refilled with
  // step t0 + kChunk + k, so each load is issued a chunk ahead of its use
  // and across the slice's early exit (loading each chunk at its top
  // instead left the one-slice kernel 24-29 % slower).  A chunk never
  // straddles T (T % 8 == 0, b0 % 32 == 0), so one test covers a chunk.
  int cin[kChunk], bd[kChunk], bg[kChunk], bh[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    fetch<kChain>(a, src, ld, s, head, b0 + k, cin[k], bd[k], bg[k], bh[k]);
  }
  for (int t0 = b0; t0 < a.T; t0 += kChunk) {
    if (t0 >= b1 && __all_sync(kFull, done)) break;
    const bool next = head && t0 + kChunk < a.T;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int c_in = cin[k];
      const int d_in = kChain ? bd[k] : 0;
      const int g_in = kChain ? bg[k] : 0;
      const int h_in = kChain ? bh[k] : 0;
      fetch<kChain>(a, src, ld, s, next, t0 + kChunk + k, cin[k], bd[k], bg[k],
                    bh[k]);
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
        const bool f0 = sublane_step<R, kRipple>(
            C[v], false, G[v - 1][R - 1], H[v - 1], D2L[v - 1], q[v], D[v],
            G[v], D2L[v], H[v], a.ma, a.mi, a.go, a.ge);
        if (v == V - 1) f0_tail = f0;
      }
      C[0] = head ? c_in : nC;
      const bool row0 = kChain && head;
      const bool f0 = sublane_step<R, kRipple>(
          C[0], seghead, row0 ? g_in : nG, row0 ? h_in : nH,
          row0 ? d_in : nD, q[0], D[0], G[0], D2L[0], H[0], a.ma, a.mi,
          a.go, a.ge);
      if (V == 1) f0_tail = f0;
      // branch-free, so that the tail lanes do not split the warp: every
      // lane keeps an accumulator, only a writing tail stores.  Every flag
      // from the handover on is the next slice's, so a flag's step alone
      // says whether this slice writes on.
      const int t = t0 + k;
      if (!kRipple) acc = max(f0_tail ? 0 : acc, H[V - 1]);
      writing = f0_tail ? tail && t < handover : writing;
      done = f0_tail ? !writing : done;
      if (writing) {
        const size_t o = (size_t)t * ld;
        dst[o] = kRipple ? H[V - 1] : acc;
        if (kChain) {  // seg = 1: o is (t, s)
          a.oD[o + s] = D[V - 1][R - 1];
          a.oG[o + s] = G[V - 1][R - 1];
          a.oH[o + s] = H[V - 1];
        }
      }
    }
  }
}

template <int R, int kMode>
cudaError_t launch(const Args& a, int slices, cudaStream_t stream) {
  constexpr int SL = kLanes / R;
  constexpr int W = SL < 32 ? SL : 32;
  const long long threads = (long long)a.S * W;
  const int blocks = (int)((threads + kBlock - 1) / kBlock);
  stream_wavefront_kernel<R, kMode>
      <<<dim3(blocks, slices), kBlock, 0, stream>>>(a);
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

template <int kMode>
cudaError_t launch_rows(int rows, const Args& a, int slices,
                        cudaStream_t stream) {
  return with_rows(rows, [&](auto r) {
    return launch<decltype(r)::value, kMode>(a, slices, stream);
  });
}

// Registers a thread, local (spill) bytes a thread and resident blocks an
// SM of one instantiation.
template <int R, int kMode>
cudaError_t kernel_info(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, stream_wavefront_kernel<R, kMode>);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], stream_wavefront_kernel<R, kMode>, kBlock, 0);
}

}  // namespace

// rows in {1, 2, 4, 8, 16}; seg in {1, 2, 4, 8} with (128/rows) % seg == 0;
// T % 8 == 0; 1 <= slices, and slices * 32 <= T when slices > 1 (slice k
// owns steps from 32 * floor(k * floor(T/32) / slices)).  tail_acc = 0
// takes the ripple-H form at rows = 1 and is ignored otherwise.  The caller
// checks these.  Returns the launch's CUDA error.
extern "C" int swtpu_stream_wavefront(const void* qk, const void* sk,
                                      void* strip, int S, int T, int seg,
                                      int rows, int tail_acc, int ma, int mi,
                                      int go, int ge, void* stream,
                                      int slices) {
  const Args a{static_cast<const int8_t*>(qk), static_cast<const int8_t*>(sk),
               nullptr, nullptr, nullptr, static_cast<int32_t*>(strip),
               nullptr, nullptr, nullptr, S, T, seg, ma, mi, go, ge};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tail_acc && rows == 1) return launch<1, kRippleH>(a, slices, st);
  return launch_rows<kTailAcc>(rows, a, slices, st);
}

// One chained tile at segments 1: qk [128, S] int8, sk [T, S] int8,
// bD/bG/bH [T, S] int32 -> acc, oD, oG, oH [T, S] int32.  rows in
// {1, 2, 4, 8, 16}; T % 8 == 0; slices as for swtpu_stream_wavefront.
// The caller checks these.  Returns the launch's CUDA error.
extern "C" int swtpu_stream_chained(const void* qk, const void* sk,
                                    const void* bD, const void* bG,
                                    const void* bH, void* acc, void* oD,
                                    void* oG, void* oH, int S, int T,
                                    int rows, int ma, int mi, int go, int ge,
                                    void* stream, int slices) {
  const Args a{static_cast<const int8_t*>(qk), static_cast<const int8_t*>(sk),
               static_cast<const int32_t*>(bD), static_cast<const int32_t*>(bG),
               static_cast<const int32_t*>(bH), static_cast<int32_t*>(acc),
               static_cast<int32_t*>(oD), static_cast<int32_t*>(oG),
               static_cast<int32_t*>(oH), S, T, 1, ma, mi, go, ge};
  return launch_rows<kChained>(rows, a, slices,
                              static_cast<cudaStream_t>(stream));
}

// out[3] = registers a thread, local bytes a thread, resident blocks an SM
// of the instantiation for `rows` in `mode` (0 tail accumulator, 1 ripple-H
// at rows 1, 2 chained tile).  Returns the CUDA error.
extern "C" int swtpu_stream_kernel_info(int rows, int mode, int* out) {
  if (mode == kRippleH) {
    return rows == 1 ? kernel_info<1, kRippleH>(out) : cudaErrorInvalidValue;
  }
  return with_rows(rows, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return mode == kChained ? kernel_info<R, kChained>(out)
                            : kernel_info<R, kTailAcc>(out);
  });
}

extern "C" const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
