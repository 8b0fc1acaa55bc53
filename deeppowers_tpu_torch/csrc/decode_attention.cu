// GQA single-token decode attention over a bf16 KV cache, reading only the
// first lengths[b] positions of each slot (flash-decoding), in two row
// layouts that share one kernel template:
//
//   contiguous  flat (B, S, Kh*D) caches. Replaces the Pallas TPU kernel
//               deeppowers_tpu/ops/pallas/decode_attention.py
//               (`decode_attention_mxu` :341, body `_kernel_mxu` :123,
//               pallas_call :470), bf16, tokens = 1, no `layer` operand.
//   paged       (P, page, Kh*D) pools read through a (B, WP) page table.
//               Replaces `decode_attention_paged_mxu` :706 (body
//               `_kernel_mxu_paged_db` :526, pallas_call :780), bf16,
//               tokens = 1.
//
// What bounds it on an H100: bytes, the live K and V rows,
// 2 * sum_b(lengths[b]) * F * 2, read once (TinyLlama F = 256: 1 KB per
// token per layer), plus q and the output.
//
// Design: the TPU grid walks S in order per slot (the paged kernel with a
// double-buffered multi-page DMA), which on a GPU would give 8 slots x 4 kv
// heads = 32 blocks for 132 SMs. Here the grid is (slot, kv head, S split):
// each block owns `chunk` consecutive positions (64; a page of 128 rows is
// two blocks) and serves all `rep` query heads of its kv head, so every K/V
// row is read once per group. The template parameter is the row
// addressing: a block first resolves the absolute offsets of its 32-row
// tile (through the page table when paged, so a block looks up only the
// page ids of its own rows), then stages the tile in shared memory (rows
// past the length load as zero), warp r scores query head r against the
// tile (lane = position), keeps an online softmax in f32 and accumulates
// p.V. Positions at or past lengths[b] are excluded by a select, never by
// multiplying by zero: pages are reused after release and hold a previous
// occupant's rows, and padded prompt writes leave rows past the length, so
// garbage or NaN there cannot leak. A block whose split starts at or past
// the slot's length exits without reading anything. A second small kernel
// combines the per-split (max, sum, acc) partials.
#include "common.cuh"

namespace {

constexpr int TS = 32;

// Row addressing of the contiguous layout: slot b's rows at stride F from
// b * c_sb.
struct ContiguousRows {
  long long c_sb;
  __device__ long long operator()(int b, int s, int F) const {
    return (long long)b * c_sb + (long long)s * F;
  }
};

// Row addressing of the paged layout: virtual row s of slot b lives in row
// s % page of page tab[b, s / page] of the (P, page, F) pool.
struct PagedRows {
  const int* __restrict__ tab;
  int tab_sb, page;
  __device__ long long operator()(int b, int s, int F) const {
    const int pid = tab[(long long)b * tab_sb + s / page];
    return ((long long)pid * page + s % page) * F;
  }
};

// grid (B, Kh, nsplit), 32 * rep threads; dynamic shared memory
// (rep*D + TS*(D+1) + TS*D + rep*TS) floats.
template <int D, typename Rows>
__global__ void partial_kernel(const bf16* __restrict__ q, long long q_sb,
                               const bf16* __restrict__ kc,
                               const bf16* __restrict__ vc, Rows rows,
                               const int* __restrict__ lens, int S, int Kh,
                               int rep, int chunk, int nsplit, float scale,
                               float* __restrict__ pm, float* __restrict__ pl,
                               float* __restrict__ pacc) {
  constexpr int DJ = D / 32;
  extern __shared__ float sm[];
  __shared__ long long rowoff[TS];
  float* qs = sm;                  // [rep][D]
  float* ks = qs + rep * D;        // [TS][D + 1]
  float* vs = ks + TS * (D + 1);   // [TS][D]
  float* ps = vs + TS * D;         // [rep][TS]
  const int b = blockIdx.x, kh = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, r = tid >> 5;
  const int nthr = blockDim.x;
  const int H = Kh * rep, F = Kh * D;
  const int len = min(lens[b], S);
  const int s0 = sp * chunk;
  const int s1 = min(s0 + chunk, len);
  const long long idx = ((long long)b * H + kh * rep + r) * nsplit + sp;

  if (s0 >= len) {                 // past the slot's live rows: read nothing
    if (lane == 0) {
      pm[idx] = DPT_NEG_INF;
      pl[idx] = 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) pacc[idx * D + lane + 32 * jj] = 0.f;
    return;
  }

  for (int i = tid; i < rep * D; i += nthr)
    qs[i] = bf2f(q[(long long)b * q_sb + (long long)kh * rep * D + i]) * scale;

  float m = DPT_NEG_INF, l = 0.f;
  float acc[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) acc[j] = 0.f;

  for (int t0 = s0; t0 < s1; t0 += TS) {
    if (tid < TS && t0 + tid < s1) rowoff[tid] = rows(b, t0 + tid, F) + kh * D;
    __syncthreads();
    for (int i = tid; i < TS * D; i += nthr) {
      const int j = i / D, d = i - j * D;
      const int s = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < s1) {
        const long long off = rowoff[j] + d;
        kv = bf2f(kc[off]);
        vv = bf2f(vc[off]);
      }
      ks[j * (D + 1) + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();
    const bool valid = t0 + lane < s1;
    float sc = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) sc = fmaf(qs[r * D + d], ks[lane * (D + 1) + d], sc);
    sc = valid ? sc : DPT_NEG_INF;
    const float mn = fmaxf(m, warp_max(sc));
    const float p = valid ? expf(sc - mn) : 0.f;
    const float alpha = expf(m - mn);
    l = l * alpha + warp_sum(p);
    ps[r * TS + lane] = p;
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = lane + 32 * jj;
      float a = acc[jj] * alpha;
#pragma unroll 8
      for (int j = 0; j < TS; ++j) a = fmaf(ps[r * TS + j], vs[j * D + d], a);
      acc[jj] = a;
    }
    m = mn;
    __syncthreads();
  }

  if (lane == 0) {
    pm[idx] = m;
    pl[idx] = l;
  }
#pragma unroll
  for (int jj = 0; jj < DJ; ++jj) pacc[idx * D + lane + 32 * jj] = acc[jj];
}

// grid (B * H), D threads.
__global__ void combine_kernel(const float* __restrict__ pm,
                               const float* __restrict__ pl,
                               const float* __restrict__ pacc, int nsplit,
                               int D, bf16* __restrict__ out) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* m = pm + bh * nsplit;
  const float* l = pl + bh * nsplit;
  float mx = DPT_NEG_INF;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, m[s]);
  float L = 0.f, a = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(m[s] - mx);
    L += l[s] * w;
    a += pacc[(bh * nsplit + s) * D + d] * w;
  }
  out[bh * D + d] = f2bf(a / fmaxf(L, 1e-30f));
}

template <int D, typename Rows>
int launch(const bf16* q, long long q_sb, const bf16* kc, const bf16* vc,
           Rows rows, const int* lens, int B, int S, int Kh, int rep,
           int chunk, float scale, float* pm, float* pl, float* pacc, bf16* out,
           cudaStream_t st) {
  const int nsplit = (S + chunk - 1) / chunk;
  const size_t smem =
      (size_t)(rep * D + TS * (D + 1) + TS * D + rep * TS) * sizeof(float);
  const dim3 grid(B, Kh, nsplit);
  partial_kernel<D, Rows><<<grid, 32 * rep, smem, st>>>(
      q, q_sb, kc, vc, rows, lens, S, Kh, rep, chunk, nsplit, scale, pm, pl,
      pacc);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<<<B * Kh * rep, D, 0, st>>>(pm, pl, pacc, nsplit, D, out);
  return (int)cudaGetLastError();
}

template <typename Rows>
int dispatch(const void* q, long long q_sb, const void* kc, const void* vc,
             Rows rows, const void* lens, int B, int S, int Kh, int rep, int D,
             int chunk, float scale, void* pm, void* pl, void* pacc, void* out,
             void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return launch<64>((const bf16*)q, q_sb, (const bf16*)kc, (const bf16*)vc,
                      rows, (const int*)lens, B, S, Kh, rep, chunk, scale,
                      (float*)pm, (float*)pl, (float*)pacc, (bf16*)out, st);
  if (D == 128)
    return launch<128>((const bf16*)q, q_sb, (const bf16*)kc, (const bf16*)vc,
                       rows, (const int*)lens, B, S, Kh, rep, chunk, scale,
                       (float*)pm, (float*)pl, (float*)pacc, (bf16*)out, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (B, H, D) bf16, heads contiguous, slot stride q_sb. kc, vc: (B, S, Kh*D)
// bf16, rows contiguous, slot stride c_sb (a window view of a longer
// cache). lens: (B,) int32 on the device. pm, pl: (B*H*nsplit) f32
// and pacc: (B*H*nsplit*D) f32 scratch, nsplit = ceil(S / chunk).
// out: (B, H, D) bf16 contiguous. D is 64 or 128; rep <= 16.
extern "C" int dpt_decode_attention(const void* q, long long q_sb,
                                    const void* kc, const void* vc,
                                    long long c_sb, const void* lens, int B,
                                    int S, int Kh, int rep, int D, int chunk,
                                    float scale,
                                    void* pm, void* pl, void* pacc, void* out,
                                    void* stream) {
  return dispatch(q, q_sb, kc, vc, ContiguousRows{c_sb}, lens, B, S, Kh, rep,
                  D, chunk, scale, pm, pl, pacc, out, stream);
}

// As dpt_decode_attention over paged pools: kp, vp: (P, page, Kh*D) bf16
// contiguous; tab: (B, WP) int32 page ids, row stride tab_sb; the virtual
// length is S = WP * page. Only page ids of rows below lens[b] are read.
extern "C" int dpt_decode_attention_paged(const void* q, long long q_sb,
                                          const void* kp, const void* vp,
                                          const void* tab, int tab_sb,
                                          int page, const void* lens, int B,
                                          int WP, int Kh, int rep, int D,
                                          int chunk, float scale, void* pm,
                                          void* pl, void* pacc, void* out,
                                          void* stream) {
  return dispatch(q, q_sb, kp, vp, PagedRows{(const int*)tab, tab_sb, page},
                  lens, B, WP * page, Kh, rep, D, chunk, scale, pm, pl, pacc,
                  out, stream);
}
