// Hopper building blocks of the tensor-core kernels (#1, #9 and #10 in
// dequant_matmul.cu and gemv.cu, #4 in flash_attention.cu): mbarriers,
// TMA boxes of 2-4 dimensional tensor maps and the host encoder of those
// maps, cp.async into a stage ring, ldmatrix, and the warpgroup matrix
// multiply (wgmma)
// with A from registers or shared memory and B from shared memory, K- or
// MN-major. The device side is PTX for sm_90a.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// -- mbarriers ------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// generic-proxy writes (cp.async, st.shared) made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// an arrival that also expects `bytes` more from TMA copies this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// -- TMA: one box of a tensor map into shared memory, counted on `bar` ----
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- cp.async: BYTES (4, 8 or 16) copied, the last BYTES - src_bytes zero --
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}

// -- ldmatrix: four 8x8 b16 matrices, transposed; lane 8i + j gives the
// address of row j of matrix i -----------------------------------------------
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, not transposed: lane 4r + c gets b16 elements 2c, 2c + 1 of
// row r of each matrix
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// -- clusters and mma.sync ---------------------------------------------------
// every thread of the cluster, its shared-memory writes released to and
// the others' acquired from the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// cluster_sync's two halves, for work between them: arrive (this thread's
// shared-memory writes released) and wait (the others' acquired)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the f32 at this block's shared address p in cluster block `rank`
__device__ __forceinline__ float ld_cluster(const float* p, unsigned rank) {
  uint32_t a;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(a)
               : "memory");
  return v;
}

// D(16 x 8) += A(16 x 16) B(16 x 8): bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D(16 x 8) += A(16 x 16) B(16 x 8): f16 in, f32 sums
__device__ __forceinline__ void mma_f16(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- wgmma ------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across a
// wgmma wait (wgmma writes them asynchronously)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(unsigned (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Descriptor of an operand in shared memory whose rows are one swizzle
// atom wide (128 bytes with B128, 64 with B64, 32 with B32), as TMA's
// swizzles write them, 8-row groups `sbo` bytes apart. K-major (rows along
// the operand's M or N): the start may step along K inside the atom, and
// `lbo` is unused. MN-major (rows along K, read with trans-b): one atom
// holds 64 bf16 of N, and the next 64 start `lbo` bytes on.
constexpr uint64_t DESC_B128 = 1, DESC_B64 = 2, DESC_B32 = 3;
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint64_t layout,
                                              uint32_t lbo = 16) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

#define DPT_D8(i)                                                   \
  DPT_D(i), DPT_D(i + 1), DPT_D(i + 2), DPT_D(i + 3), DPT_D(i + 4), \
      DPT_D(i + 5), DPT_D(i + 6), DPT_D(i + 7)

// D(64 x N) += A(64 x 16, bf16 in registers) * B(16 x N, bf16 through
// desc; K-major, or MN-major with TB = 1), f32 sums
template <int N, int TB = 0>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const unsigned (&a)[4],
              uint64_t desc) {
#define DPT_D(i) "+f"(d[i])
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
        "}\n"
        : DPT_D8(0), DPT_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n"
        "}\n"
        : DPT_D8(0), DPT_D8(8), DPT_D8(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : DPT_D8(0), DPT_D8(8), DPT_D8(16), DPT_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : DPT_D8(0), DPT_D8(8), DPT_D8(16), DPT_D8(24), DPT_D8(32), DPT_D8(40), DPT_D8(48), DPT_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  } else {
    static_assert(N == 32, "no wgmma_bf16 atom for this token tile");
  }
#undef DPT_D
}

// D(64 x N) += A(64 x 32, s8 in registers) * B(32 x N, s8 through desc),
// s32 sums
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], const unsigned (&a)[4],
            uint64_t desc) {
#define DPT_D(i) "+r"(d[i])
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n"
        "}\n"
        : DPT_D8(0), DPT_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p;\n"
        "}\n"
        : DPT_D8(0), DPT_D8(8), DPT_D8(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n"
        "}\n"
        : DPT_D8(0), DPT_D8(8), DPT_D8(16), DPT_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n"
        "}\n"
        : DPT_D8(0), DPT_D8(8), DPT_D8(16), DPT_D8(24), DPT_D8(32), DPT_D8(40), DPT_D8(48), DPT_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else {
    static_assert(N == 32, "no wgmma_s8 atom for this token tile");
  }
#undef DPT_D
}

// D(64 x 128) (+)= A(64 x 16, bf16 through desc_a) * B(16 x 128, bf16
// through desc_b), both K-major, f32 sums; acc = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_bf16_n128(float (&d)[64],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b, int acc) {
#define DPT_D(i) "+f"(d[i])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : DPT_D8(0), DPT_D8(8), DPT_D8(16), DPT_D8(24), DPT_D8(32), DPT_D8(40), DPT_D8(48), DPT_D8(56)
      : "l"(desc_a), "l"(desc_b), "r"(acc));
#undef DPT_D
}

#undef DPT_D8

// -- host: tiled tensor maps for TMA ----------------------------------------

// cuTensorMapEncodeTiled, found once through the runtime (no link to the
// driver library)
static inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// A tiled map of a rank-R tensor (R <= 5): dims[0] contiguous elements,
// dims[i] (i >= 1) `pitches[i - 1]` bytes apart (multiples of 16), boxes of
// box[i] elements; reads past any extent fill zeros.
static inline bool tensor_map(CUtensorMap* m, const void* ptr,
                              CUtensorMapDataType dt, int rank,
                              const uint64_t* dims, const uint64_t* pitches,
                              const uint32_t* box,
                              CUtensorMapSwizzle swizzle) {
  const auto encode = tensor_map_encoder();
  if (!encode) return false;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], steps[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    steps[i] = 1;
    if (i) st[i - 1] = pitches[i - 1];
  }
  return encode(m, dt, rank, const_cast<void*>(ptr), d, st, bx, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
