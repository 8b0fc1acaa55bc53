// The second pass of the split decode-attention kernels
// (decode_attention.cu, decode_attention_kt.cu): each query row's per-split
// (max, sum, p.V) partials, combined by their log-sum-exp weights.
#pragma once

#include "common.cuh"

namespace {

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

}  // namespace
