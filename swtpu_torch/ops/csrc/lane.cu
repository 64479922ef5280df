// Lane-major column Smith-Waterman for Hopper (sm_90a): one pair per thread.
//
// Replaces the TPU kernel swtpu/ops/pallas_lane.py:_sw_kernel_lane (B6:
// B4's column-per-step recurrence with pairs on sublanes and the query on
// lanes, queries of at most 128 bases).  The plain PyTorch version of the
// same recurrence is swtpu_torch/ops/lane.py:lane_scores_reference; kernel
// and plain version must agree bit for bit.
//
// Contract.  q [B, 128] int32 (as swtpu passes it) and t [B, n] int8 are
// sentinel-padded (query pad 5, target pad 4: they never match, so padding
// never raises a score and the kernel has no lengths or masks); n is a
// multiple of 16 and both start on 16-byte boundaries.  bm, bi [n, B]
// int32 are scratch for the strip hand-off.  out [B] int32 gets the scores.
//
// The recurrence (pallas_lane.py:49-68), per target column j and row i:
//   M[i]  = max(max(M, I)[i-1, j-1] + s(i, j), 0)
//   I[i]  = max(max(M[i-1, j], M[i, j-1]) + open + extend,
//               max(I[i-1, j], I[i, j-1]) + extend)
//   H     = max(H, M)
// with zero M and I above row 0 and left of column 0.  The TPU evaluates
// the I chain as a log2(128) max-plus prefix scan along the lanes; any
// exact evaluation gives the same integers.
//
// Design.  The TPU's question was which axis carries the pairs; on the GPU
// it is intra-task against inter-task.  B4's port (column.cu) is
// intra-task: a warp per pair, I as a shuffle scan across lanes.  This is
// the inter-task design: a thread per pair, and no thread talks to another.
//   - The thread sweeps its query in 128/R strips of R = 32 rows (kRows)
//     and keeps each strip's query codes, M and I in registers, with one
//     running high score.
//   - Within a strip, I is an in-register ripple down the rows, cell by
//     cell in the order of the recurrence above.
//   - Strip hand-off: a strip writes its last row's M and I for every
//     target column to bm/bi [n, B] and the next strip reads them back as
//     the row above (B5's ms/is contract at R rows); adjacent threads hold
//     adjacent pairs, so these accesses are coalesced.  The first strip
//     takes the zero boundary (diag 0, M_up 0, I seed 0 + extend: the
//     i0_bias of pallas_lane.py:45) and reads nothing; the last writes
//     nothing.
//   - The target is read in 16-byte loads of the pair's own row (a byte
//     per thread at stride n would be uncoalesced), once per strip.
// What bounds it.  Integer issue.  At the shootout's 65,536 pairs of
// 128 x 128, q and t read once are 33.6 + 8.4 = 42 MB, about 13 us at
// 3.35 TB/s; the 1.07 G cells at 9 integer operations each (the loop body
// below, with an add and the max after it one DPX VIADDMNMX) need about
// 0.58 ms at 132 SMs x 64 int32 lanes x 1.98 GHz.  The strip buffer moves
// 16 bytes per pair and column per strip boundary: (128/R - 1) x n x B x 16
// bytes, 403 MB at R = 32 (each of its two [n, B] planes is 33.6 MB, so
// the pair of them, 67 MB, exceeds the 50 MB L2 and the hand-off goes to
// device memory: about 0.12 ms at 3.35 TB/s, under the issue time).
// Occupancy is what one pair per thread costs: 65,536 pairs are 512 blocks
// of 128, about four per SM.  R = 32 was chosen by measurement on the H100
// (PERF.md): ptxas gives it 186 registers; R = 16 ran 8 % slower and R = 64
// spilled at 255 registers and ran 1.8x slower.  Building with
// -DSWTPU_LANE_ROWS=16 (or 64) brings another height back for a sweep.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuery = 128;  // query rows: one TPU lane tile
constexpr int kRun = 16;     // target columns read together (one int4)
constexpr int kBlock = 128;  // threads (pairs) per block
#ifndef SWTPU_LANE_ROWS
#define SWTPU_LANE_ROWS 32
#endif
constexpr int kRows = SWTPU_LANE_ROWS;  // query rows per strip, in registers
static_assert(kRows % 4 == 0 && kQuery % kRows == 0, "strips load 4 rows at a time");

struct LaneArgs {
  const int32_t* q;
  const int8_t* t;
  int32_t* out;
  int32_t* bm;  // [n, B]: the last row's M of the strip above, per column
  int32_t* bi;  // and its I
  int B, n, ma, mi, go, ge;
};

__global__ void __launch_bounds__(kBlock) lane_kernel(const LaneArgs a) {
  const long long b = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (b >= a.B) return;  // no thread talks to another: nothing to keep alive
  const int n = a.n;
  const long long B = a.B;
  const int oe = a.go + a.ge;
  const int ge = a.ge;
  const int32_t* qb = a.q + b * kQuery;
  const int8_t* tb = a.t + b * n;
  int h = 0;

#pragma unroll 1
  for (int i0 = 0; i0 < kQuery; i0 += kRows) {
    const bool first = i0 == 0;
    const bool last = i0 + kRows == kQuery;
    int q[kRows], M[kRows], I[kRows];
#pragma unroll
    for (int r = 0; r < kRows; r += 4) {
      const int4 v = *reinterpret_cast<const int4*>(qb + i0 + r);
      q[r] = v.x;
      q[r + 1] = v.y;
      q[r + 2] = v.z;
      q[r + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      M[r] = 0;  // column -1: the zero boundary
      I[r] = 0;
    }
    int dprev = 0;  // max(M, I) of the row above at column j - 1

#pragma unroll 1
    for (int j0 = 0; j0 < n; j0 += kRun) {
      const int4 tv = *reinterpret_cast<const int4*>(tb + j0);
      const int tw[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
      for (int c = 0; c < kRun; ++c) {
        const int tj = static_cast<int8_t>(tw[c / 4] >> (8 * (c % 4)));
        const long long o = (long long)(j0 + c) * B + b;
        // the row above this strip at column j: zero above row 0
        const int upm = first ? 0 : a.bm[o];
        const int upi = first ? 0 : a.bi[o];
        int mup = upm, iup = upi, dg = dprev;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int dnext = max(M[r], I[r]);  // row r + 1's diagonal
          const int mn = max(dg + (q[r] == tj ? a.ma : a.mi), 0);
          const int in = max(max(mup, M[r]) + oe, max(I[r] + ge, iup + ge));
          M[r] = mn;
          I[r] = in;
          h = max(h, mn);
          mup = mn;
          iup = in;
          dg = dnext;
        }
        dprev = max(upm, upi);
        if (!last) {
          a.bm[o] = M[kRows - 1];
          a.bi[o] = I[kRows - 1];
        }
      }
    }
  }
  a.out[b] = h;
}

}  // namespace

// B6: q [B, 128] int32, t [B, n] int8 -> out [B] int32 scores; bm, bi
// [n, B] int32 scratch.  n % 16 == 0, q and t 16-byte aligned.  The
// caller checks these.  Returns the launch's CUDA error.
extern "C" int swtpu_lane_scores(const void* q, const void* t, void* out,
                                 void* bm, void* bi, int B, int n,
                                 int ma, int mi, int go, int ge,
                                 void* stream) {
  const LaneArgs a{static_cast<const int32_t*>(q), static_cast<const int8_t*>(t),
                   static_cast<int32_t*>(out), static_cast<int32_t*>(bm),
                   static_cast<int32_t*>(bi), B, n, ma, mi, go, ge};
  const long long blocks = (a.B + kBlock - 1) / kBlock;
  lane_kernel<<<(unsigned)blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
