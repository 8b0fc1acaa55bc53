// The contiguous and paged entry points of GQA decode / verify attention
// (kernels #3, #5 and, through the contiguous one, #11); the kernel
// template and its design are decode_attention.cuh's.
#include "decode_attention.cuh"

// q: (B, O, D) bf16 query rows, O = Kh * rows (rows = rep * tokens a kv
// head, ordered (kv head, query head, window token)), contiguous, slot
// stride q_sb. kc, vc: (B, S, F') stores per k_bits / v_bits (16 bf16, 8
// int8, 4 packed int4), rows contiguous, slot strides k_sb, v_sb in
// elements (a window view of a longer cache; equal when k_bits ==
// v_bits), 16-byte aligned. ks, vs: (B, R', S') f32 head-major scales
// with slot and row strides (ks_sb, ks_rs), (vs_sb, vs_rs), or null for
// bf16. lens: (B,) int32 on the device, the cached rows of each slot
// including all `tokens` rows of its window; window token t sees the first
// lens - (tokens - 1) + t. The plan (nsplit, chunk, tile, pw, mg, stages)
// comes from `attention_plan`. out: (B, O, D) bf16 contiguous. D is 64 or 128;
// rows <= 64. nk, nv: the step's new rows, written before they are read
// (decode_attention.cuh, "the step's new rows"): (B, tokens, Kh*D) bf16
// with slot and token strides (nk_sb, nk_ts), (nv_sb, nv_ts) in elements,
// contiguous features; npos: (B, tokens) int32 positions, below 0 for
// none; npos null: no new rows.
extern "C" int dpt_decode_attention(
    const void* q, long long q_sb, const void* kc, long long k_sb,
    const void* vc, long long v_sb, const void* ks, long long ks_sb,
    long long ks_rs, const void* vs, long long vs_sb, long long vs_rs,
    const void* lens, int B, int S, int Kh, int rows, int tokens, int D,
    int k_bits, int v_bits, int nsplit, int chunk, int tile, int pw, int mg,
    int stages, float scale, void* out, const void* nk, long long nk_sb,
    long long nk_ts, const void* nv, long long nv_sb, long long nv_ts,
    const void* npos, void* stream) {
  const Args a{(const bf16*)q, q_sb, (const int*)lens, S, Kh, rows, tokens,
               nsplit, chunk, tile, pw, mg, stages, 0, scale, (bf16*)out,
               (cudaStream_t)stream};
  const Side k{kc, k_sb, store_width(Kh, D, k_bits), (const float*)ks, ks_sb,
               ks_rs};
  const Side v{vc, v_sb, store_width(Kh, D, v_bits), (const float*)vs, vs_sb,
               vs_rs};
  const NewRows nr{(const bf16*)nk, (const bf16*)nv, nk_sb, nk_ts, nv_sb,
                   nv_ts, (const int*)npos, nullptr, nullptr, 0};
  return dispatch(a, k, v, ContiguousRows{}, nr, B, D, k_bits, v_bits, 4);
}

// As dpt_decode_attention over paged pools: kp, vp: (P, page, F') stores,
// contiguous; ks, vs: (P, R', page) f32 scale pools, contiguous, or null
// for bf16; tab: (B, WP) int32 page ids, row stride tab_sb; the virtual
// length is S = WP * page. Only page ids of rows below lens[b] are read.
// New rows as dpt_decode_attention's, and their pool rows nrow (B,
// tokens) int32 with validity nvalid (B, tokens) bool (`row_ids`); the
// pool holds P pages.
extern "C" int dpt_decode_attention_paged(
    const void* q, long long q_sb, const void* kp, const void* vp,
    const void* ks, const void* vs, const void* tab, int tab_sb, int page,
    const void* lens, int B, int WP, int Kh, int rows, int tokens, int D,
    int k_bits, int v_bits, int nsplit, int chunk, int tile, int pw, int mg,
    int stages, float scale, void* out, int P, const void* nk,
    long long nk_sb, long long nk_ts, const void* nv, long long nv_sb,
    long long nv_ts, const void* npos, const void* nrow, const void* nvalid,
    void* stream) {
  const Args a{(const bf16*)q, q_sb, (const int*)lens, WP * page, Kh, rows,
               tokens, nsplit, chunk, tile, pw, mg, stages, 0, scale,
               (bf16*)out, (cudaStream_t)stream};
  const int kw = store_width(Kh, D, k_bits), vw = store_width(Kh, D, v_bits);
  const Side k{kp, (long long)page * kw, kw, (const float*)ks,
               (long long)scale_rows(Kh, k_bits) * page, page};
  const Side v{vp, (long long)page * vw, vw, (const float*)vs,
               (long long)scale_rows(Kh, v_bits) * page, page};
  const NewRows nr{(const bf16*)nk, (const bf16*)nv, nk_sb, nk_ts,
                   nv_sb, nv_ts, (const int*)npos, (const int*)nrow,
                   (const bool*)nvalid, (long long)P * page};
  if (npos && (!nrow || !nvalid)) return (int)cudaErrorInvalidValue;
  return dispatch(a, k, v, PagedRows{(const int*)tab, tab_sb, page}, nr, B,
                  D, k_bits, v_bits, page);
}
