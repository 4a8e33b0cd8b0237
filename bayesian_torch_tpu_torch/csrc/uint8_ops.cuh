// The uint8 arithmetic of ops/int8.py (quantize_uint8, qmul, qadd) and
// ops/qtensor.py (QTensor.requantize) on f32 registers, bit for bit what
// torch computes, for the INT8 Flipout chain of K-F's Flipout epilogue
// (qmatmul.cu) and K-H3 (flipout_signs.cu).
//
// Each torch op rounds once in f32: the multiplies and adds go through
// __fmul_rn / __fadd_rn / __fsub_rn, so none contracts into an FMA. The
// conversions go around the card's conversion unit (I2F, F2I and FRND
// issue 16 a clock on an SM, an eighth of the rate of an FADD; K-H3 with
// conversions ran three of them an element): a byte b becomes the f32
// 2^23 + b by a byte permute, and back by an FADD towards zero onto 2^23;
// torch.round (half to even) is an add and a subtract of 1.5 * 2^23.
#pragma once

#include <stdint.h>

namespace btt_u8 {

constexpr float kTwo23 = 8388608.f;   // 2^23: its ulp is 1
constexpr float kRound = 12582912.f;  // 1.5 * 2^23

// Byte j of w, the word 0x4B0000bb: the f32 2^23 + b.
__device__ __forceinline__ float byte_biased(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4Bu, 0x4550u | (uint32_t)j));
}

// Byte j of w as an f32 (exact).
__device__ __forceinline__ float byte_f32(uint32_t w, int j) {
  return __fsub_rn(byte_biased(w, j), kTwo23);
}

// torch.round(x), half to even, exact for |x| <= 2^22. Beyond that it
// gives a value of x's sign and at least 2^22 - 2 in magnitude, so after
// a zero point within +-2^21 is added, the clamp to [0, 255] that follows
// every rounding here gives what torch gives.
__device__ __forceinline__ float round_even(float x) {
  return __fsub_rn(__fadd_rn(x, kRound), kRound);
}

__device__ __forceinline__ float clamp255(float v) {
  return fminf(fmaxf(v, 0.f), 255.f);
}

// v in [0, 255] -> .to(torch.uint8) of it (truncation): the word
// 0x4B0000bb, b in its low byte.
__device__ __forceinline__ uint32_t to_u8(float v) {
  return __float_as_uint(__fadd_rz(v, kTwo23));
}

// The f32 value of such a word's byte.
__device__ __forceinline__ float u8_value(uint32_t biased) {
  return __fsub_rn(__uint_as_float(biased), kTwo23);
}

// The low bytes of four words packed into one.
__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1,
                                          uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040u), __byte_perm(b2, b3, 0x0040u),
                     0x5410u);
}

// qmul(a, sign_q) of ops/int8.py for one element, the operand a (an f32
// holding an integer in [0, 255]) at integer zero point a_zp and the sign's
// centred uint8 value sgn: clamp(round(f32((a - a_zp) * sgn) * mult) +
// out_zp, 0, 255) before the cast. The product of the two small integers is
// exact in f32, as torch's int32 product converted to f32 is.
__device__ __forceinline__ float qmul_sign(float a, float a_zp, float sgn,
                                           float mult, float out_zp) {
  const float prod = __fmul_rn(__fsub_rn(a, a_zp), sgn);
  return clamp255(__fadd_rn(round_even(__fmul_rn(prod, mult)), out_zp));
}

}  // namespace btt_u8
