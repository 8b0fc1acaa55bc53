// In-place KV-cache row append: cache[b, positions[b], :] = row[b, :] for the
// K and the V cache of one layer, one decode token per slot.
//
// Replaces the Pallas TPU kernel deeppowers_tpu/ops/pallas/kv_append.py
// (`scatter_rows` :116 -> `_scatter_one` :69, body `_kernel` :43,
// pallas_call :104), flat bf16 (B, S, F) caches.
//
// What bounds it on an H100: bytes, 2 * B * F * 2 read and written (8 KB for
// TinyLlama's 8 slots, F = 256), far below a launch's fixed cost; the
// kernel only has to write in place and never touch the rest of the cache.
//
// Design: one block per (slot, array); each thread copies elements of the
// F-wide row. A position outside [0, S) writes nothing, as the TPU kernel's
// select and JAX's scatter drop it. The TPU kernel's 8-row
// read-modify-write exists for the TPU's tiling; a GPU writes the row alone.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(128) kv_append_kernel(
    bf16* __restrict__ kc, bf16* __restrict__ vc, const bf16* __restrict__ kr,
    long long kr_sb, const bf16* __restrict__ vr, long long vr_sb,
    const int* __restrict__ pos, int S, int F) {
  const int b = blockIdx.x;
  const int p = pos[b];
  if (p < 0 || p >= S) return;
  bf16* dst = (blockIdx.y ? vc : kc) + ((long long)b * S + p) * F;
  const bf16* src = blockIdx.y ? vr + (long long)b * vr_sb
                               : kr + (long long)b * kr_sb;
  for (int i = threadIdx.x; i < F; i += blockDim.x) dst[i] = src[i];
}

}  // namespace

// kc, vc: (B, S, F) bf16 contiguous caches, updated in place.
// kr, vr: (B, F) bf16 rows with row strides kr_sb, vr_sb (elements).
// pos: (B,) int32 write positions on the device.
extern "C" int dpt_kv_append(void* kc, void* vc, const void* kr, long long kr_sb,
                             const void* vr, long long vr_sb, const void* pos,
                             int B, int S, int F, void* stream) {
  const dim3 grid(B, 2);
  kv_append_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (bf16*)kc, (bf16*)vc, (const bf16*)kr, kr_sb, (const bf16*)vr, vr_sb,
      (const int*)pos, S, F);
  return (int)cudaGetLastError();
}
