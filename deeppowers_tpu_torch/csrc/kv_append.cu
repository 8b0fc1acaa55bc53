// In-place KV-cache row appends for the K and the V cache of one layer, one
// decode token per slot, bf16.
//
// dpt_kv_append: cache[b, positions[b], :] = row[b, :] over flat (B, S, F)
// caches. Replaces the Pallas TPU kernel deeppowers_tpu/ops/pallas/
// kv_append.py (`scatter_rows` :116 -> `_scatter_one` :69, body `_kernel`
// :43, pallas_call :104).
//
// dpt_kv_append_pool: pool[rows[b], :] = row[b, :] over the flat
// (P * page, F) view of the paged layout's pools, where valid[b]. Replaces
// `scatter_pool_rows` :225 (body `_kernel_pool` :146, pallas_call :207),
// value pools only. An invalid row is not written at all: the TPU kernel
// writes the old content back into its 8-row tile, a tiling artefact.
//
// What bounds it on an H100: bytes, 2 * B * F * 2 read and written (8 KB for
// TinyLlama's 8 slots, F = 256), far below a launch's fixed cost; the
// kernel only has to write in place and never touch the rest of the cache.
//
// Design: one block per (slot, array); each thread copies elements of the
// F-wide row. A position outside [0, S) (a row outside [0, P * page)) writes
// nothing, as the TPU kernel's select and JAX's scatter drop it. The TPU
// kernel's 8-row read-modify-write exists for the TPU's tiling; a GPU writes
// the row alone.
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

__global__ void __launch_bounds__(128) kv_append_pool_kernel(
    bf16* __restrict__ kp, bf16* __restrict__ vp, const bf16* __restrict__ kr,
    long long kr_sb, const bf16* __restrict__ vr, long long vr_sb,
    const int* __restrict__ rows, const bool* __restrict__ valid,
    long long total_rows, int F) {
  const int b = blockIdx.x;
  const long long r = rows[b];
  if (!valid[b] || r < 0 || r >= total_rows) return;
  bf16* dst = (blockIdx.y ? vp : kp) + r * F;
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

// kp, vp: (P, page, F) bf16 contiguous pools, updated in place; total_rows
// = P * page. kr, vr: (B, F) bf16 rows with row strides kr_sb, vr_sb.
// rows: (B,) int32 and valid: (B,) bool (one byte each), on the device.
extern "C" int dpt_kv_append_pool(void* kp, void* vp, const void* kr,
                                  long long kr_sb, const void* vr,
                                  long long vr_sb, const void* rows,
                                  const void* valid, int B,
                                  long long total_rows, int F, void* stream) {
  const dim3 grid(B, 2);
  kv_append_pool_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (bf16*)kp, (bf16*)vp, (const bf16*)kr, kr_sb, (const bf16*)vr, vr_sb,
      (const int*)rows, (const bool*)valid, total_rows, F);
  return (int)cudaGetLastError();
}
