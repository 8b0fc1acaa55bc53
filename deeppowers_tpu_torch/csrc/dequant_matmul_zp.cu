// #1's tensor-core kernel for asymmetric weight-only weights (zero points):
// mma_kernel's ZP instantiations (mma_kernel.cuh), in a source of their own
// so that nvcc builds them beside dequant_matmul.cu's. Reached through
// dpt_dequant_matmul's MMA route when it is handed zero points; the design
// note ("Zero points") is at the top of dequant_matmul.cu.
#include "mma_kernel.cuh"

cudaError_t mma_zp_route(const void* x, long long x_sm, const int8_t* w,
                         const float* scales, const int* zp, const float* rf,
                         const float* bias, const bf16* res, long long res_sm,
                         void* out, int out_f32, float* ws, int M, int K,
                         int N, int group, int kchunk, bool int4, int bn,
                         int bk, int splits, cudaStream_t st) {
  const MmaArgs a = mma_args(w, scales, rf, bias, res, res_sm, out, out_f32,
                             ws, M, K, N, group, kchunk, int4);
  return launch_mma<false, true>(x, x_sm, a, bn, bk, splits, st, zp);
}
