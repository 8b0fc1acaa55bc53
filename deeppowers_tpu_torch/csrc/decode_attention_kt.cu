// Decode / verify attention over the chunk-transposed int8 K mirror ("kt"),
// flushing the chunks that the row-major tail completes into the mirror in
// place. Replaces the Pallas TPU kernel
// deeppowers_tpu/ops/pallas/decode_attention.py (`decode_attention_kt`
// :1081, body `_kt_kernel` :845, pallas_call :1132; `verify_attention_kt`
// :1148 folds a verify window into query rows).
//
// Layout (runtime/kvcache.py): kt (B, C, F, 128) int8, chunk c holding
// positions [c*128, (c+1)*128) feature-major (F = Kh*D), beside the
// row-major int8 k (B, S, F), the source of truth, S = C*128; v (B, S, FV)
// int8 (FV = F) or packed int4 (FV = F/2, low nibble feature j, high nibble
// j + D/2 of each head); k_scale (B, Kh, S), v_scale (B, Kh | 2*Kh, S) f32,
// head-major. For slot b with lens[b] = cached rows + the T window rows,
// full = max((lens[b] - T) / 128, 0) chunks are committed: read from kt;
// positions [full*128, lens[b]) come from the row-major k. Query rows
// are ordered (kv head, query head, window token t), R = rep*T a kv head;
// row t sees positions below lens[b] - (T - 1) + t (every committed
// position, as full*128 <= lens[b] - T).
//
// The function is the TPU kernel's: q rounded to bf16 after the scale,
// scores (q . k_int) * k_scale in f32, p = exp(s - max) in f32, the softmax
// sum over p, and bf16(p * v_scale) against the V values (per V half with
// its sub-scale for int4), f32 sums, out = acc / sum. It differs in one
// place, on purpose: a position at or past a row's bound is excluded by a
// select, and its V scale never multiplies p = 0 (the TPU kernel's
// 0 * stale scale gives NaN for a NaN scale).
//
// What bounds it on an H100: bytes. The live K bytes once (from kt for
// committed chunks, from k for the tail), the live V bytes and both scales,
// q and the output; plus 128 * F bytes written per chunk flushed.
//
// Design: the TPU kernel runs one sequential loop over the batch's live
// 128-row units through a DMA ring (`kt_group`, `nbuf`: DMA tuning of the
// TPU, not part of the function). Here the grid is (slot, kv head, chunk),
// each block owning one 128-position chunk for all R rows of its kv head,
// with the log-sum-exp combine of the split decode kernel
// (attention_combine.cuh); at TinyLlama's 4 kv heads 8 slots alone would
// make 32 blocks for 132 SMs. A block stages its head's K chunk in shared
// memory feature-major as int8 [D][128]: from kt a straight copy of D
// 128-byte lines, from the row-major tail a transpose through shared
// memory. In the score loop each lane owns 4 consecutive positions and
// reads one 32-bit word of a feature line (a warp: one 128-byte line), the
// R query rows sit in shared memory, and the per-position K scales
// multiply the dots. V is staged as f32 rows; lanes own features in the
// p.V product.
//
// The flush, and why it is race-free: a block whose tail chunk c lies
// whole below lens[b] ((c+1)*128 <= lens[b], the TPU kernel's condition)
// writes its staged tile to kt[b, c, h*D:(h+1)*D, :]. Only tail chunks
// flush (c >= full) and only committed chunks are read from kt (c < full),
// so no block reads a chunk that a block of the same launch writes; blocks
// of one chunk write disjoint feature rows (one kv head each); the staged
// bytes come from k, which nothing in the launch writes. Chunks that a
// rejected speculative window or a prefix copy left stale heal this way
// before they become committed (runtime/kvcache.py, the mirror's
// invariant).
#include "attention_combine.cuh"

namespace {

constexpr int CH = 128;          // positions a chunk
constexpr int NT = 256;          // threads a block
constexpr int NW = NT / 32;

// grid (B, Kh, C), NT threads; warp w serves rows w, w + NW, ... (RPW at
// most). Dynamic shared memory: R*D + CH*D + NV*NW*RPW*CH floats, then
// D*CH int8.
template <int D, int VB, int RPW>
__global__ void __launch_bounds__(NT) kt_partial_kernel(
    const bf16* __restrict__ q, long long q_sb, int8_t* __restrict__ kt,
    const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ lens, int C, int Kh, int R, int T, float scale,
    float* __restrict__ pm, float* __restrict__ pl,
    float* __restrict__ pacc) {
  constexpr int NV = VB == 4 ? 2 : 1;
  constexpr int VW = VB == 4 ? D / 2 : D;   // stored V bytes of a head
  constexpr int DJ = D / 32;
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(16) float ksc[CH];
  __shared__ __align__(16) float vsc[2][CH];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int b = blockIdx.x, h = blockIdx.y, c = blockIdx.z;
  const int S = C * CH, F = Kh * D, FV = Kh * VW, O = Kh * R;
  const int lb = lens[b];
  const int len = min(lb, S);
  const int full = max((lb - T) / CH, 0);
  const int s0 = c * CH;
  const long long base = ((long long)b * O + (long long)h * R) * C + c;

  if (s0 >= len) {                 // past the slot's rows: read nothing
    for (int i = tid; i < R; i += NT) {
      pm[base + (long long)i * C] = DPT_NEG_INF;
      pl[base + (long long)i * C] = 0.f;
    }
    for (int i = tid; i < R * D; i += NT)
      pacc[(base + (long long)(i / D) * C) * D + i % D] = 0.f;
    return;
  }
  const int n = min(CH, len - s0);
  const bool committed = c < full;
  float* qs = sm;                               // [R][D]
  float* vf = qs + R * D;                       // [CH][D]
  float* ps = vf + CH * D;                      // [NV][NW*RPW][CH]
  int8_t* k8 = (int8_t*)(ps + NV * NW * RPW * CH);   // [D][CH]
  int8_t* kt_c = kt + (((long long)b * C + c) * F + (long long)h * D) * CH;

  for (int i = tid; i < R * D; i += NT)
    qs[i] = round_bf16(bf2f(q[(long long)b * q_sb + (long long)h * R * D + i]) *
                       scale);
  for (int p = tid; p < CH; p += NT) {
    const bool ok = p < n;
    const long long pos = s0 + p;
    ksc[p] = ok ? ks[((long long)b * Kh + h) * S + pos] : 0.f;
#pragma unroll
    for (int hf = 0; hf < NV; ++hf)
      vsc[hf][p] =
          ok ? vs[((long long)b * Kh * NV + h * NV + hf) * S + pos] : 0.f;
  }
  if (committed) {
    const int4* src = (const int4*)kt_c;
    int4* dst = (int4*)k8;
    for (int i = tid; i < D * CH / 16; i += NT) dst[i] = src[i];
  } else {
    // transpose the row-major rows [s0, s0 + n) through shared memory:
    // lanes take consecutive positions, 16 features each
    const int8_t* krow = k + ((long long)b * S + s0) * F + (long long)h * D;
    for (int i = tid; i < CH * (D / 16); i += NT) {
      const int p = i % CH, j = i / CH;
      int4 val = make_int4(0, 0, 0, 0);
      if (p < n) val = *(const int4*)(krow + (long long)p * F + 16 * j);
      const int8_t* by = (const int8_t*)&val;
#pragma unroll
      for (int e = 0; e < 16; ++e) k8[(16 * j + e) * CH + p] = by[e];
    }
  }
  const int8_t* vrow = v + ((long long)b * S + s0) * FV + (long long)h * VW;
  for (int i = tid; i < CH * VW; i += NT) {
    const int p = i / VW, j = i - p * VW;
    const int x = p < n ? (int)vrow[(long long)p * FV + j] : 0;
    if constexpr (VB == 8) {
      vf[p * D + j] = (float)x;
    } else {
      vf[p * D + j] = (float)(((x & 0xF) ^ 8) - 8);
      vf[p * D + j + D / 2] = (float)(x >> 4);
    }
  }
  __syncthreads();

  // the flush: this tail chunk lies whole below lens[b]
  if (!committed && s0 + CH <= lb) {
    const int4* src = (const int4*)k8;
    int4* dst = (int4*)kt_c;
    for (int i = tid; i < D * CH / 16; i += NT) dst[i] = src[i];
  }

  int row[RPW];
  float sc[RPW][4];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    row[rr] = min(w + rr * NW, R - 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[rr][e] = 0.f;
  }
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const char4 kc = *(const char4*)(k8 + d * CH + 4 * lane);
    const float k0 = kc.x, k1 = kc.y, k2 = kc.z, k3 = kc.w;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const float qv = qs[row[rr] * D + d];
      sc[rr][0] = fmaf(qv, k0, sc[rr][0]);
      sc[rr][1] = fmaf(qv, k1, sc[rr][1]);
      sc[rr][2] = fmaf(qv, k2, sc[rr][2]);
      sc[rr][3] = fmaf(qv, k3, sc[rr][3]);
    }
  }
  const float4 kq = *(const float4*)(ksc + 4 * lane);
  const float kqe[4] = {kq.x, kq.y, kq.z, kq.w};
  const float4 v0 = *(const float4*)(vsc[0] + 4 * lane);
  const float4 v1 = *(const float4*)(vsc[1] + 4 * lane);
  const float vq0[4] = {v0.x, v0.y, v0.z, v0.w};
  const float vq1[4] = {v1.x, v1.y, v1.z, v1.w};
  float m[RPW], l[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    // committed chunks: every position; the tail: the row's own bound
    const int bound = committed ? full * CH : lb - (T - 1) + row[rr] % T;
    bool ok[4];
    float s[4], mx = DPT_NEG_INF;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 4 * lane + e;
      ok[e] = p < n && s0 + p < bound;
      s[e] = ok[e] ? sc[rr][e] * kqe[e] : DPT_NEG_INF;
      mx = fmaxf(mx, s[e]);
    }
    mx = warp_max(mx);
    float p0[4], p1[4], sum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ok[e] ? expf(s[e] - mx) : 0.f;
      sum += p;
      p0[e] = ok[e] ? round_bf16(p * vq0[e]) : 0.f;
      p1[e] = ok[e] ? round_bf16(p * vq1[e]) : 0.f;
    }
    m[rr] = mx;
    l[rr] = warp_sum(sum);
    *(float4*)(ps + (w * RPW + rr) * CH + 4 * lane) =
        make_float4(p0[0], p0[1], p0[2], p0[3]);
    if constexpr (NV == 2)
      *(float4*)(ps + (NW * RPW + w * RPW + rr) * CH + 4 * lane) =
          make_float4(p1[0], p1[1], p1[2], p1[3]);
  }
  __syncwarp();

  float acc[RPW][DJ];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[rr][jj] = 0.f;
  for (int p = 0; p < n; ++p) {
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int half = (NV == 2 && jj >= DJ / 2) ? NW * RPW : 0;
      const float vv = vf[p * D + lane + 32 * jj];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr)
        acc[rr][jj] = fmaf(ps[(half + w * RPW + rr) * CH + p], vv, acc[rr][jj]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    if (w + rr * NW >= R) continue;
    const long long idx = base + (long long)row[rr] * C;
    if (lane == 0) {
      pm[idx] = m[rr];
      pl[idx] = l[rr];
    }
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      pacc[idx * D + lane + 32 * jj] = acc[rr][jj];
  }
}

struct KtArgs {
  const bf16* q;
  long long q_sb;
  int8_t* kt;
  const int8_t *k, *v;
  const float *ks, *vs;
  const int* lens;
  int B, C, Kh, R, T;
  float scale;
  float *pm, *pl, *pacc;
  bf16* out;
  cudaStream_t st;
};

template <int D, int VB, int RPW>
int launch(const KtArgs& a) {
  constexpr int NV = VB == 4 ? 2 : 1;
  const size_t smem =
      (size_t)(a.R * D + CH * D + NV * NW * RPW * CH) * sizeof(float) +
      (size_t)D * CH;
  auto kern = kt_partial_kernel<D, VB, RPW>;
  // past 48 KB with the kernel's static 1.5 KB of scales, the opt-in
  if (smem + 2048 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(a.B, a.Kh, a.C), NT, smem, a.st>>>(
      a.q, a.q_sb, a.kt, a.k, a.v, a.ks, a.vs, a.lens, a.C, a.Kh, a.R, a.T,
      a.scale, a.pm, a.pl, a.pacc);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<<<a.B * a.Kh * a.R, D, 0, a.st>>>(a.pm, a.pl, a.pacc, a.C,
                                                   D, a.out);
  return (int)cudaGetLastError();
}

template <int D, int VB>
int by_rows(const KtArgs& a) {
  if (a.R <= NW) return launch<D, VB, 1>(a);
  if (a.R <= 2 * NW) return launch<D, VB, 2>(a);
  if (a.R <= 4 * NW) return launch<D, VB, 4>(a);
  if (a.R <= 8 * NW) return launch<D, VB, 8>(a);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int by_bits(const KtArgs& a, int v_bits) {
  if (v_bits == 8) return by_rows<D, 8>(a);
  if (v_bits == 4) return by_rows<D, 4>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (B, Kh*rows, D) bf16 query rows (rows = rep * tokens a kv head,
// ordered (kv head, query head, window token)), contiguous rows, slot
// stride q_sb. kt: (B, C, Kh*D, 128) int8, updated in place; k: (B, C*128,
// Kh*D) int8; v: (B, C*128, FV) int8 (v_bits 8) or packed int4 (v_bits 4,
// FV = Kh*D/2); ks: (B, Kh, C*128), vs: (B, Kh | 2*Kh, C*128) f32; all
// contiguous, kt and k 16-byte aligned. lens: (B,) int32 on the device,
// cached rows including all `tokens` window rows. pm, pl: (B*Kh*rows*C) f32
// and pacc: (B*Kh*rows*C*D) f32 scratch. out: (B, Kh*rows, D) bf16
// contiguous. D is 64 or 128; rows <= 64.
extern "C" int dpt_decode_attention_kt(
    const void* q, long long q_sb, void* kt, const void* k, const void* v,
    const void* ks, const void* vs, const void* lens, int B, int C, int Kh,
    int rows, int tokens, int D, int v_bits, float scale, void* pm, void* pl,
    void* pacc, void* out, void* stream) {
  const KtArgs a{(const bf16*)q, q_sb, (int8_t*)kt, (const int8_t*)k,
                 (const int8_t*)v, (const float*)ks, (const float*)vs,
                 (const int*)lens, B, C, Kh, rows, tokens, scale,
                 (float*)pm, (float*)pl, (float*)pacc, (bf16*)out,
                 (cudaStream_t)stream};
  if (D == 64) return by_bits<64>(a, v_bits);
  if (D == 128) return by_bits<128>(a, v_bits);
  return (int)cudaErrorInvalidValue;
}
