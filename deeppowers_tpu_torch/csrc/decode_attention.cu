// GQA single-token decode attention over a flat bf16 KV cache, reading only
// the first lengths[b] positions of each slot (flash-decoding).
//
// Replaces the Pallas TPU kernel deeppowers_tpu/ops/pallas/decode_attention.py
// (`decode_attention_mxu` :341, body `_kernel_mxu` :123, pallas_call :470),
// bf16 cache, tokens = 1, no `layer` (stacked) operand.
//
// What bounds it on an H100: bytes, the live K and V rows,
// 2 * sum_b(lengths[b]) * F * 2, read once (TinyLlama F = 256: 1 KB per
// token per layer), plus q and the output.
//
// Design: the TPU grid walks S in order per slot, which on a GPU would give
// 8 slots x 4 kv heads = 32 blocks for 132 SMs. Here the grid is
// (slot, kv head, S split); each block serves all `rep` query heads of its
// kv head, so every K/V row is read once per group. A block stages a
// 32-row K/V tile in shared memory (rows past the length load as zero),
// warp r scores query head r against the tile (lane = position), keeps an
// online softmax in f32 and accumulates p.V; positions at or past
// lengths[b] are excluded by a select, never by multiplying by zero, so
// garbage or NaN in unread rows cannot leak. A second small kernel combines
// the per-split (max, sum, acc) partials.
#include "common.cuh"

namespace {

constexpr int TS = 32;

// grid (B, Kh, nsplit), 32 * rep threads; dynamic shared memory
// (rep*D + TS*(D+1) + TS*D + rep*TS) floats.
template <int D>
__global__ void partial_kernel(const bf16* __restrict__ q, long long q_sb,
                               const bf16* __restrict__ kc,
                               const bf16* __restrict__ vc, long long c_sb,
                               const int* __restrict__ lens, int S, int Kh,
                               int rep, int chunk, int nsplit, float scale,
                               float* __restrict__ pm, float* __restrict__ pl,
                               float* __restrict__ pacc) {
  constexpr int DJ = D / 32;
  extern __shared__ float sm[];
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

  for (int i = tid; i < rep * D; i += nthr)
    qs[i] = bf2f(q[(long long)b * q_sb + (long long)kh * rep * D + i]) * scale;
  __syncthreads();

  float m = DPT_NEG_INF, l = 0.f;
  float acc[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) acc[j] = 0.f;

  for (int t0 = s0; t0 < s1; t0 += TS) {
    for (int i = tid; i < TS * D; i += nthr) {
      const int j = i / D, d = i - j * D;
      const int s = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < s1) {
        const long long off =
            (long long)b * c_sb + (long long)s * F + kh * D + d;
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

  const long long idx = ((long long)b * H + kh * rep + r) * nsplit + sp;
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

template <int D>
int launch(const bf16* q, long long q_sb, const bf16* kc, const bf16* vc,
           long long c_sb, const int* lens, int B, int S, int Kh, int rep,
           int chunk, float scale, float* pm, float* pl, float* pacc, bf16* out,
           cudaStream_t st) {
  const int nsplit = (S + chunk - 1) / chunk;
  const size_t smem =
      (size_t)(rep * D + TS * (D + 1) + TS * D + rep * TS) * sizeof(float);
  const dim3 grid(B, Kh, nsplit);
  partial_kernel<D><<<grid, 32 * rep, smem, st>>>(
      q, q_sb, kc, vc, c_sb, lens, S, Kh, rep, chunk, nsplit, scale, pm, pl,
      pacc);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<<<B * Kh * rep, D, 0, st>>>(pm, pl, pacc, nsplit, D, out);
  return (int)cudaGetLastError();
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return launch<64>((const bf16*)q, q_sb, (const bf16*)kc, (const bf16*)vc,
                      c_sb, (const int*)lens, B, S, Kh, rep, chunk, scale,
                      (float*)pm, (float*)pl, (float*)pacc, (bf16*)out, st);
  if (D == 128)
    return launch<128>((const bf16*)q, q_sb, (const bf16*)kc, (const bf16*)vc,
                       c_sb, (const int*)lens, B, S, Kh, rep, chunk, scale,
                       (float*)pm, (float*)pl, (float*)pacc, (bf16*)out, st);
  return (int)cudaErrorInvalidValue;
}
