// The kt-mirror entry point of decode / verify attention (kernel #7):
// decode_attention.cuh's kernel template over its mirror layout, one
// launch a call that also flushes the whole tail chunks into the mirror.
#include "decode_attention.cuh"

// q: (B, Kh*rows, D) bf16 query rows (rows = rep * tokens a kv head,
// ordered (kv head, query head, window token)), contiguous rows, slot
// stride q_sb. kt: (B, C, Kh*D, 128) int8, updated in place; k: (B, C*128,
// Kh*D) int8; v: (B, C*128, FV) int8 (v_bits 8) or packed int4 (v_bits 4,
// FV = Kh*D/2); ks: (B, Kh, C*128), vs: (B, Kh | 2*Kh, C*128) f32; all
// contiguous, kt, k and v 16-byte aligned. lens: (B,) int32 on the device,
// cached rows including all `tokens` window rows. The plan (nsplit, chunk,
// tile, pw, mg, stages) comes from `attention_plan`. out: (B, Kh*rows, D)
// bf16 contiguous. D is 64 or 128; rows <= 64.
extern "C" int dpt_decode_attention_kt(
    const void* q, long long q_sb, void* kt, const void* k, const void* v,
    const void* ks, const void* vs, const void* lens, int B, int C, int Kh,
    int rows, int tokens, int D, int v_bits, int nsplit, int chunk, int tile,
    int pw, int mg, int stages, float scale, void* out, void* stream) {
  const int S = C * KT_CHUNK;
  const Args a{(const bf16*)q, q_sb, (const int*)lens, S, Kh, rows, tokens,
               nsplit, chunk, tile, pw, mg, stages, 0, scale, (bf16*)out,
               (cudaStream_t)stream};
  const int kw = store_width(Kh, D, 8), vw = store_width(Kh, D, v_bits);
  const Side kside{k, (long long)S * kw, kw, (const float*)ks,
                   (long long)Kh * S, S};
  const Side vside{v, (long long)S * vw, vw, (const float*)vs,
                   (long long)scale_rows(Kh, v_bits) * S, S};
  MirrorRows mirror;
  mirror.kt = (int8_t*)kt;
  mirror.kt_sb = (long long)C * Kh * D * KT_CHUNK;
  mirror.F = Kh * D;
  if ((uintptr_t)kt % 16 || KT_CHUNK % tile) return (int)cudaErrorInvalidValue;
  return dispatch(a, kside, vside, mirror, NewRows{}, B, D, 8, v_bits, 4);
}
