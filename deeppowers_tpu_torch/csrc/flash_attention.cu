// Causal, length-masked flash attention for prefill, GQA-aware.
//
// Replaces the Pallas TPU kernel deeppowers_tpu/ops/pallas/flash_attention.py
// (`flash_attention_prefill` :79, body `_kernel` :33, pallas_call :140).
//
// What bounds it on an H100: operations. Causal attention over a prompt of
// length L costs about 2 * H * L^2 * D operations per sequence (4.3
// GFLOP per TinyLlama layer at L = 1024) against q, k, v and the output
// read or written once.
//
// Design: grid (B * H, ceil(S / 64)); a block owns 64 query rows, two
// threads per row, each holding half of the row's head dims (interleaved, so
// the pair reads adjacent shared-memory words). The block walks key tiles
// only up to its causal frontier and the slot's length, staging each K/V
// tile of the query head's kv head (h / rep; the cache is never repeated)
// in shared memory, and keeps the online softmax (max, sum, acc) in f32
// registers. Keys past the frontier or at/after lengths[b] are excluded by
// a select; rows past lengths[b] still attend the valid keys, so they stay
// finite. The S axis needs no padding: edges are masked in the kernel.
// CUDA-core arithmetic for now; tensor-core tiles are later work.
#include "common.cuh"

namespace {

constexpr int BQ = 64;

template <int D, int BK>
__global__ void __launch_bounds__(128) flash_kernel(
    const bf16* __restrict__ q, long long q_sb, long long q_ss,
    const bf16* __restrict__ k, long long k_sb, long long k_ss,
    const bf16* __restrict__ v, long long v_sb, long long v_ss,
    const int* __restrict__ lens, int S, int H, int Kh, float scale,
    bf16* __restrict__ out) {
  constexpr int DH = D / 2;
  __shared__ float Ks[BK][D];
  __shared__ float Vs[BK][D];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kh = h / (H / Kh);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int row = tid >> 1, half = tid & 1;
  const int qi = q0 + row;
  const int len = min(lens[b], S);

  float qv[DH], acc[DH];
  {
    const bf16* qp = q + (long long)b * q_sb + (long long)min(qi, S - 1) * q_ss +
                     (long long)h * D;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      qv[i] = bf2f(qp[2 * i + half]) * scale;
      acc[i] = 0.f;
    }
  }
  float m = DPT_NEG_INF, l = 0.f;
  const int kend = min(min(q0 + BQ, S), len);

  for (int kt = 0; kt < kend; kt += BK) {
    for (int i = tid; i < BK * D; i += 128) {
      const int j = i / D, d = i - j * D;
      const int s = kt + j;
      float kv = 0.f, vv = 0.f;
      if (s < kend) {
        kv = bf2f(k[(long long)b * k_sb + (long long)s * k_ss + kh * D + d]);
        vv = bf2f(v[(long long)b * v_sb + (long long)s * v_ss + kh * D + d]);
      }
      Ks[j][d] = kv;
      Vs[j][d] = vv;
    }
    __syncthreads();
    float sc[BK];
    float mt = DPT_NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) p = fmaf(qv[i], Ks[j][2 * i + half], p);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      const int s = kt + j;
      const bool valid = (s <= qi) && (s < len);
      sc[j] = valid ? p : DPT_NEG_INF;
      mt = fmaxf(mt, sc[j]);
    }
    const float mn = fmaxf(m, mt);
    const float alpha = expf(m - mn);
#pragma unroll
    for (int i = 0; i < DH; ++i) acc[i] *= alpha;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int s = kt + j;
      const bool valid = (s <= qi) && (s < len);
      const float p = valid ? expf(sc[j] - mn) : 0.f;
      ls += p;
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] = fmaf(p, Vs[j][2 * i + half], acc[i]);
    }
    l = l * alpha + ls;
    m = mn;
    __syncthreads();
  }

  if (qi < S) {
    bf16* op = out + (((long long)b * S + qi) * H + h) * D;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DH; ++i) op[2 * i + half] = f2bf(acc[i] * inv);
  }
}

}  // namespace

// q: (B, S, H, D), k, v: (B, S, Kh, D) bf16 with element strides per slot
// (*_sb) and per position (*_ss); heads and dims contiguous. lens: (B,)
// int32 on the device. out: (B, S, H, D) bf16 contiguous. D is 64 or 128.
extern "C" int dpt_flash_attention(const void* q, long long q_sb, long long q_ss,
                                   const void* k, long long k_sb, long long k_ss,
                                   const void* v, long long v_sb, long long v_ss,
                                   const void* lens, int B, int S, int H, int Kh,
                                   int D, float scale, void* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  if (D == 64)
    flash_kernel<64, 64><<<grid, 128, 0, st>>>(
        (const bf16*)q, q_sb, q_ss, (const bf16*)k, k_sb, k_ss, (const bf16*)v,
        v_sb, v_ss, (const int*)lens, S, H, Kh, scale, (bf16*)out);
  else if (D == 128)
    flash_kernel<128, 32><<<grid, 128, 0, st>>>(
        (const bf16*)q, q_sb, q_ss, (const bf16*)k, k_sb, k_ss, (const bf16*)v,
        v_sb, v_ss, (const int*)lens, S, H, Kh, scale, (bf16*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
