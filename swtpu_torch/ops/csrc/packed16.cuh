// Two 16-bit values in one 32-bit register, for the 16-bit state modes of
// the wavefront (stream_wavefront.cu) and the column kernels (column.cu).
//
// Hopper runs the recurrences' operations on both halves of a register in
// one instruction: VIADD.16x2 (__vadd2), VIMNMX.S16x2 / .U16x2 (__vmaxs2,
// __vmaxu2), the DPX add-max VIADDMNMX.S16x2 / .U16x2 (__viaddmax_s16x2,
// __viaddmax_u16x2), and for bfloat16 HMNMX2.BF16 (__hmax2) and the
// BF16x2 add and fused multiply-add (__hadd2, __hfma2_relu).  Each half's
// add wraps modulo 2^16 as a 16-bit adder does (the DPX add-max too: its
// add wraps before the max), and a bfloat16 add rounds each half once to
// nearest even.  So a packed register holds, half by half, what two
// registers of the one-value form held, with one instruction for two cells.
//
// Selects become masks: a half's condition is 0xFFFF or 0x0000 in that
// half, made by PRMT's sign-replicating byte selectors (sign_halves), and
// `cond ? 0 : x` is an AND (zero is 0x0000 in every 16-bit state, bfloat16
// +0 included).  The halves never carry into each other: every add is a
// 16x2 instruction, and the one 32-bit add (in score16x2) cannot carry.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// 0xFFFF in each half whose top bit (bit 15, bit 31) is set, else 0x0000:
// PRMT's selector nibbles 9 and B replicate the sign of bytes 1 and 3
__device__ __forceinline__ unsigned sign_halves(unsigned x) {
  unsigned r;
  asm("prmt.b32 %0, %1, %2, 0xBB99;" : "=r"(r) : "r"(x), "r"(0u));
  return r;
}

// x's low 16 bits in both halves
__device__ __forceinline__ unsigned splat16(int x) {
  return (static_cast<unsigned>(x) & 0xFFFFu) * 0x10001u;
}

// lo's low 16 bits in the low half, hi's in the high half
__device__ __forceinline__ unsigned pack16(int lo, int hi) {
  return (static_cast<unsigned>(lo) & 0xFFFFu) | static_cast<unsigned>(hi) << 16;
}

// Half h (0 low, 1 high) of x as a 16-bit pattern.
__device__ __forceinline__ unsigned short half16(unsigned x, int h) {
  return static_cast<unsigned short>(x >> (16 * h));
}

// The score of each half: `ma` where its char's code (the low 3 bits of
// c's half) equals its query code (q's half), else `mi`.  Codes are below
// 8, so (c & 7) ^ q is 0 on a match and 1-7 otherwise, and adding 0x7FFF
// sets the half's top bit exactly on a mismatch, with no carry out of it.
__device__ __forceinline__ unsigned score16x2(unsigned c, unsigned q, unsigned ma,
                                              unsigned mi) {
  const unsigned miss = sign_halves(((c & 0x00070007u) ^ q) + 0x7FFF7FFFu);
  return (mi & miss) | (ma & ~miss);
}

// The arithmetic of the three packed states on unsigned registers: add,
// max, addmax(x, y, z) = max(x + y, z) and the M update m(d, s) =
// max(d + s, 0), each half as the one-value state computed it.
struct Int16x2 {
  __device__ unsigned add(unsigned x, unsigned y) const { return __vadd2(x, y); }
  __device__ unsigned max(unsigned x, unsigned y) const { return __vmaxs2(x, y); }
  __device__ unsigned addmax(unsigned x, unsigned y, unsigned z) const {
    return __viaddmax_s16x2(x, y, z);
  }
  __device__ unsigned m(unsigned d, unsigned s) const { return __viaddmax_s16x2(d, s, 0u); }
  // half h sign-extended
  __device__ int widen(unsigned x, int h) const {
    return static_cast<int16_t>(half16(x, h));
  }
};

// uint16: unsigned max, and max(x, 0) of an unsigned x is x
struct Uint16x2 {
  __device__ unsigned add(unsigned x, unsigned y) const { return __vadd2(x, y); }
  __device__ unsigned max(unsigned x, unsigned y) const { return __vmaxu2(x, y); }
  __device__ unsigned addmax(unsigned x, unsigned y, unsigned z) const {
    return __viaddmax_u16x2(x, y, z);
  }
  __device__ unsigned m(unsigned d, unsigned s) const { return __vadd2(d, s); }
  __device__ int widen(unsigned x, int h) const { return half16(x, h); }
};

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(unsigned x) {
  return *reinterpret_cast<const __nv_bfloat162*>(&x);
}
__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<const unsigned*>(&x);
}
__device__ __forceinline__ unsigned short bf16_bits(int x) {
  return __bfloat16_as_ushort(__int2bfloat16_rn(x));
}

// bfloat16 has no fused add-max; the M update is one fused multiply-add
// d * 1 + s, rounded once as the add alone rounds, and clamped at 0
struct Bf16x2 {
  __device__ unsigned add(unsigned x, unsigned y) const {
    return as_u32(__hadd2(as_bf16x2(x), as_bf16x2(y)));
  }
  __device__ unsigned max(unsigned x, unsigned y) const {
    return as_u32(__hmax2(as_bf16x2(x), as_bf16x2(y)));
  }
  __device__ unsigned addmax(unsigned x, unsigned y, unsigned z) const {
    return max(add(x, y), z);
  }
  __device__ unsigned m(unsigned d, unsigned s) const {
    return as_u32(__hfma2_relu(as_bf16x2(d), as_bf16x2(0x3F803F80u), as_bf16x2(s)));
  }
  // every value is an integer: the conversion is exact
  __device__ int widen(unsigned x, int h) const {
    return __bfloat162int_rz(__ushort_as_bfloat16(half16(x, h)));
  }
};

}  // namespace
