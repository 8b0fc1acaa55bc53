// The int8-dot entry point of contiguous decode / verify attention (#3's
// variant "3i", the TPU kernel's default for a K stored as int8 bytes):
// decode_attention.cuh's kernel template with I8 set, a source of its own
// so that nvcc builds it beside decode_attention.cu.
#include "decode_attention.cuh"

// As dpt_decode_attention (decode_attention.cu) over int8, int4 or k8v4
// stores (k_bits 8 or 4), and block_s: the positions of one S block of the
// TPU kernel's grid (`int8_dots_block`), over which p is requantized as
// one granule; it covers S or is a multiple of `tile`; keep: the tiles of
// a block a position group keeps the scores of (`int8_dots_keep`).
extern "C" int dpt_decode_attention_i8(
    const void* q, long long q_sb, const void* kc, long long k_sb,
    const void* vc, long long v_sb, const void* ks, long long ks_sb,
    long long ks_rs, const void* vs, long long vs_sb, long long vs_rs,
    const void* lens, int B, int S, int Kh, int rows, int tokens, int D,
    int k_bits, int v_bits, int nsplit, int chunk, int tile, int pw, int mg,
    int stages, float scale, void* out, const void* nk, long long nk_sb,
    long long nk_ts, const void* nv, long long nv_sb, long long nv_ts,
    const void* npos, int block_s, int keep, void* stream) {
  const Args a{(const bf16*)q, q_sb, (const int*)lens, S, Kh, rows, tokens,
               nsplit, chunk, tile, pw, mg, stages, 0, scale, (bf16*)out,
               (cudaStream_t)stream, block_s, keep};
  const Side k{kc, k_sb, store_width(Kh, D, k_bits), (const float*)ks, ks_sb,
               ks_rs};
  const Side v{vc, v_sb, store_width(Kh, D, v_bits), (const float*)vs, vs_sb,
               vs_rs};
  const NewRows nr{(const bf16*)nk, (const bf16*)nv, nk_sb, nk_ts, nv_sb,
                   nv_ts, (const int*)npos, nullptr, nullptr, 0};
  return dispatch<true>(a, k, v, ContiguousRows{}, nr, B, D, k_bits, v_bits,
                        4);
}
