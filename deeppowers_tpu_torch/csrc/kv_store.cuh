#pragma once

// One kv head's row of a KV-cache store written from the model's bf16
// values by one warp. The row writers of kv_append.cu (#2, #6, #8) and the
// attention launch that writes a step's new rows before it reads them
// (decode_attention.cuh) share this code, so both store the same bytes:
// quant/kvquant.py's arithmetic, bit for bit. f32 absmax, fmaxf(absmax,
// 1e-8f), IEEE division by 127 (or 7) and by the scale (the library builds
// without --use_fast_math; keep it so), rintf (half to even), clamp, and
// int4 nibbles as (hi << 4) | (lo & 0xF), byte j of a head holding feature
// j in its low nibble and feature j + D/2 in its high one.
#include "common.cuh"

namespace {

__device__ __forceinline__ int quant_to(float x, float s, float lo, float hi) {
  return (int)fminf(fmaxf(rintf(x / s), lo), hi);
}

// The D values x of one kv head into its stored form at `out` (the head's
// bytes of the row), by the 32 lanes of one warp: BITS 16 copies them; 8
// quantizes to int8 with one scale, written by lane 0 at *s0; 4 to packed
// int4 with two sub-block scales, of features [0, D/2) at *s0 and of
// [D/2, D) at *s1.
template <int BITS>
__device__ __forceinline__ void store_head(const bf16* __restrict__ x,
                                           void* out, float* s0, float* s1,
                                           int D, int lane) {
  if constexpr (BITS == 16) {
    bf16* o = (bf16*)out;
    for (int j = lane; j < D; j += 32) o[j] = x[j];
  } else if constexpr (BITS == 8) {
    int8_t* o = (int8_t*)out;
    float am = 0.f;
    for (int j = lane; j < D; j += 32) am = fmaxf(am, fabsf(bf2f(x[j])));
    am = warp_max(am);
    const float s = fmaxf(am, 1e-8f) / 127.0f;
    if (lane == 0) *s0 = s;
    for (int j = lane; j < D; j += 32)
      o[j] = (int8_t)quant_to(bf2f(x[j]), s, -128.f, 127.f);
  } else {
    static_assert(BITS == 4, "stores are 16, 8 or 4 bits");
    int8_t* o = (int8_t*)out;
    const int hd = D / 2;
    float a0 = 0.f, a1 = 0.f;
    for (int j = lane; j < hd; j += 32) {
      a0 = fmaxf(a0, fabsf(bf2f(x[j])));
      a1 = fmaxf(a1, fabsf(bf2f(x[hd + j])));
    }
    a0 = warp_max(a0);
    a1 = warp_max(a1);
    const float c0 = fmaxf(a0, 1e-8f) / 7.0f;
    const float c1 = fmaxf(a1, 1e-8f) / 7.0f;
    if (lane == 0) {
      *s0 = c0;
      *s1 = c1;
    }
    for (int j = lane; j < hd; j += 32) {
      const unsigned lo = (unsigned)quant_to(bf2f(x[j]), c0, -8.f, 7.f);
      const unsigned hi = (unsigned)quant_to(bf2f(x[hd + j]), c1, -8.f, 7.f);
      o[j] = (int8_t)(uint8_t)(((hi & 0xFu) << 4) | (lo & 0xFu));
    }
  }
}

}  // namespace
