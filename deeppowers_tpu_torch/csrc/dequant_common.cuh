// Helpers of the fused dequant matmul's two kernels (dequant_matmul.cu's
// tensor-core kernel and gemv.cu's decode GEMV): the fused transforms of
// the activations, the exact int8 / int4 conversions, the stage layout
// both write by TMA or cp.async, and the GEMV's entry from the matmul's
// launcher.
#pragma once

#include "common.cuh"

namespace {

constexpr int MODE_PLAIN = 0;
constexpr int MODE_RMS = 1;
constexpr int MODE_GLU = 2;

__device__ __forceinline__ float act_fn(float g, int gelu) {
  if (gelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
  return g / (1.f + expf(-g));
}

// act(x) as XLA's unfused bf16 ops compute it (ops/activation.py), every
// op rounded to bf16: silu = x * (1 / (1 + exp(-x))), the tanh GELU with
// its constants in bf16 and the cube as x * x * x. act_fn above is the f32
// function of the Pallas fold, rounded once after the product with up.
__device__ __forceinline__ float act_ops(float x, int gelu) {
  if (gelu) {
    const float c = 0.796875f;         // bf16(sqrt(2 / pi))
    const float a = 0.044677734375f;   // bf16(0.044715)
    const float x3 = round_bf16(round_bf16(x * x) * x);
    const float u = round_bf16(c * round_bf16(x + round_bf16(a * x3)));
    const float h = round_bf16(0.5f * round_bf16(1.f + round_bf16(tanhf(u))));
    return round_bf16(x * h);
  }
  const float d = round_bf16(1.f + round_bf16(expf(-x)));
  return round_bf16(x * round_bf16(__frcp_rn(d)));   // 1 / d, IEEE-rounded
}

// One staged activation value: x (plain), bf16(x * g) (RMSNorm folded in),
// or bf16(act(gate) * up) (GLU; the row holds gate | up, 2K wide).
__device__ __forceinline__ float stage_value(const bf16* xrow, const bf16* g,
                                             int mode, int gelu, int K, int k) {
  if (mode == MODE_GLU) {
    const float gt = bf2f(xrow[k]);
    const float up = bf2f(xrow[K + k]);
    return round_bf16(act_fn(gt, gelu) * up);
  }
  const float v = bf2f(xrow[k]);
  if (mode == MODE_RMS) return round_bf16(v * bf2f(g[k]));
  return v;
}

constexpr int MMA_NT = 128;      // weight columns a tile of either kernel

// Byte offset of 16-byte chunk c of weight row r in a stage: row-major 128-
// byte rows, the chunk index XORed with r % 8 (TMA's 128-byte swizzle, on a
// 1024-byte-aligned tile), so that the eight rows ldmatrix reads at once
// fall in eight distinct bank groups (two for the a8 row order).
__device__ __forceinline__ int wt_offset(int r, int c) {
  return r * MMA_NT + ((c ^ (r & 7)) << 4);
}

// Two sign-extended bytes (lo, hi) of u as a bf16 pair, exactly: each byte,
// biased to 0..255, becomes the low byte of the f32 2^23 + b. With a zero
// point z, c = 2^23 + 128 + z (zp_sub) makes the pair bf16(q - z): the f32
// difference is exact while |z| < 2^23 - 256, so the one rounding is the
// bf16 conversion's, that of JAX's (q - z).astype(bfloat16).
__device__ __forceinline__ unsigned bf16x2_of(unsigned u, unsigned lo,
                                              unsigned hi,
                                              float c = 8388736.f) {
  const unsigned b = u ^ 0x80808080u;
  const float f0 =
      __int_as_float(__byte_perm(b, 0x4B000000u, 0x7440u | lo)) - c;
  const float f1 =
      __int_as_float(__byte_perm(b, 0x4B000000u, 0x7440u | hi)) - c;
  const __nv_bfloat162 h = __floats2bfloat162_rn(f0, f1);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Two nibbles of u (biased by 8: u = packed ^ 0x88888888), those at bits
// sh and sh + 16, as an exact bf16 pair: each becomes the mantissa of 128
// + n (0x4300 | n), and one fused multiply-add takes 136 off.
__device__ __forceinline__ unsigned bf16x2_nibbles(unsigned u, int sh) {
  const unsigned v = ((u >> sh) & 0x000F000Fu) | 0x43004300u;
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// bf16x2_of's subtrahend for zero point z: 2^23 + 128 + z, exact in f32
__device__ __forceinline__ float zp_sub(int z) {
  return __fadd_rn(8388736.f, __int2float_rn(z));
}

// sign-extend the four nibbles (0..15, one per byte) of v to int8 bytes
__device__ __forceinline__ unsigned sext_nibbles(unsigned v) {
  return __vsub4(v ^ 0x08080808u, 0x08080808u);
}

}  // namespace

// The GEMV route of dpt_dequant_matmul (gemv.cu): x bf16 (M, K) rows, or
// (M, 2K) gate|up with mode MODE_GLU, or a8's int8 rows when xs is given;
// w (rows, N) int8 or packed int4; zp null, or the (K / group, N) int32
// zero points of an asymmetric weight-only weight; kchunk stored rows a
// split, sub rows staged at once.
cudaError_t gemv_route(const void* x, long long x_sm, const float* xs,
                       const int8_t* w, const float* scales, const int* zp,
                       bool int4, int group, const bf16* g,
                       const float* bias, const bf16* res, long long res_sm,
                       void* out, int out_f32, int M, int K, int N,
                       int kchunk, int sub, int mode, int gelu, float eps,
                       cudaStream_t st);
// The tensor-core route of an asymmetric weight-only weight
// (dequant_matmul_zp.cu): dpt_dequant_matmul's MMA route with zp, the
// (K / group, N) int32 zero points, beside the scales.
cudaError_t mma_zp_route(const void* x, long long x_sm, const int8_t* w,
                         const float* scales, const int* zp, const float* rf,
                         const float* bias, const bf16* res, long long res_sm,
                         void* out, int out_f32, float* ws, int M, int K,
                         int N, int group, int kchunk, bool int4, int bn,
                         int bk, int splits, cudaStream_t st);
