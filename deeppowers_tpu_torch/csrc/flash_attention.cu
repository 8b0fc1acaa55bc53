// Causal, length-masked flash attention for prefill and for prefill chunks,
// GQA-aware, on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel deeppowers_tpu/ops/pallas/flash_attention.py
// (`flash_attention_prefill` :79, body `_kernel` :33, pallas_call :140).
// With a start offset it also computes chunked prefill's attention
// (ops/attention.py `attention_chunk`, which the JAX package leaves to
// XLA): query row i sits at position start + i.
//
// What bounds it on an H100: operations. Causal attention over a prompt of
// length L costs about 2 * H * L^2 * D operations (two products of H * L^2
// / 2 * D multiply-adds each; 4.3 GFLOP a TinyLlama layer at L = 1024)
// against q, k, v and the output read or written once.
//
// Design (one block: 128 query rows of one (slot, head); 384 threads):
// - Work split. Two consumer warpgroups own 64 query rows each; a producer
//   warpgroup gives its registers to them (setmaxnreg 40 / 232) and one of
//   its threads drives TMA. The grid is (heads, slots, query tiles) with
//   the tile index reversed, so the blocks with the most keys (the
//   diagonal's far end) start first.
// - Copies. q, k and v are strided views (slot and position strides, heads
//   and dims contiguous); each has a 4-D tensor map (D, heads, positions,
//   slots), and a tile of 128 rows x D comes as D / 64 boxes of 128 rows x
//   128 bytes with TMA's 128-byte swizzle. Q comes once; K/V tiles of 128
//   keys stream through a ring of 3 (D = 64) or 2 (D = 128) stages gated by
//   full/empty mbarriers. Rows past the views' extents are zero-filled, so
//   no length needs padding; key tiles past min(frontier, length) are
//   never loaded.
// - S = Q K^T: wgmma m64n128k16 with both operands from shared memory,
//   K-major (Q as A, the K tile as B), f32 sums.
// - Softmax: online (max, sum) on the f32 accumulator fragment in the
//   exp2 domain (scale * log2 e folded in); a row's four lanes meet by
//   quad shuffles. Only tiles that cross the diagonal or a length are
//   masked.
// - O += P V: P is rounded to bf16 in registers, where the accumulator
//   fragment of S is already wgmma's A fragment; the V tile is an MN-major
//   B (trans-b), the second 64 columns of D at the panel's offset.
// - Keys past a length are read with zero weight, as the plain version
//   reads them, so they must be finite; a chunk's view is cut at start + C
//   by the host, so rows past it are zero-filled, not read.
// - A head of 32 dims (moelm_ckpt's) runs the D = 64 kernel: its tensor
//   maps are 32 dims wide and their 64-dim boxes come zero-filled past
//   them, so Q K^T is unchanged and O's last 32 columns are 0 and not
//   written (DO, the stored width).
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int FBQ = 128;              // query rows a block
constexpr int FBK = 128;              // keys a tile
constexpr int F_CONSUMERS = 256;      // two warpgroups of 64 query rows
constexpr int F_THREADS = F_CONSUMERS + 128;
constexpr int F_PANEL_ROW = 128;      // bytes of a row in a 64-column panel

template <int D>
struct FlashCfg {
  static constexpr int PANELS = D / 64;
  static constexpr int QTILE = FBQ * D * 2;
  static constexpr int KTILE = FBK * D * 2;
  static constexpr int STAGES = D == 64 ? 3 : 2;
  // barriers and alignment slack, Q, then the K/V ring
  static constexpr int SMEM = 128 + 1024 + QTILE + STAGES * 2 * KTILE;
};

struct FlashArgs {
  const int* lens;   // (B,) valid keys per slot, or null: all Skv
  bf16* out;         // (B, Sq, H, D) contiguous
  int Sq, Skv, H, Kh, start;
  float scale_log2;  // softmax scale times log2(e)
};

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D, int DO>
__global__ void __launch_bounds__(F_THREADS, 1)
    flash_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const FlashArgs p) {
  using C = FlashCfg<D>;
  constexpr int ST = C::STAGES;
  const float NEG_INF = -__int_as_float(0x7f800000);
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;
  // Q [panel][128 rows][128 bytes], then per stage K and V, the same
  // layout; 1024-byte aligned for the 128-byte swizzle
  const uint32_t base = (smem_u32(smem) + 128 + 1023) & ~1023u;
  unsigned char* qs = reinterpret_cast<unsigned char*>(smem) +
                      (base - smem_u32(smem));
  unsigned char* kvs = qs + C::QTILE;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FBQ;
  const int kh = h / (p.H / p.Kh);
  const int len = p.lens ? min(p.lens[b], p.Skv) : p.Skv;
  // keys any row of the block sees: below the last row's frontier and the
  // length
  const int kend = max(0, min(p.start + q0 + FBQ, len));
  const int nt = (kend + FBK - 1) / FBK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);               // TMA's thread, with the bytes
      mbar_init(&empty[s], F_CONSUMERS);    // each consumer thread
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (__shfl_sync(0xffffffffu, tid / F_CONSUMERS, 0)) {
    // producer: Q once, then the K/V tiles in order, each into its stage
    // after the consumers released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != F_CONSUMERS) return;
    mbar_arrive_expect_tx(qbar, C::QTILE);
    for (int pn = 0; pn < C::PANELS; ++pn)
      tma_load_4d(qs + pn * FBQ * F_PANEL_ROW, &qmap, 64 * pn, h, q0, b,
                  qbar);
    for (int t = 0; t < nt; ++t) {
      const int s = t % ST;
      mbar_wait(&empty[s], ((t / ST) & 1) ^ 1);
      unsigned char* kt = kvs + s * 2 * C::KTILE;
      mbar_arrive_expect_tx(&full[s], 2 * C::KTILE);
      for (int pn = 0; pn < C::PANELS; ++pn) {
        tma_load_4d(kt + pn * FBK * F_PANEL_ROW, &kmap, 64 * pn, kh, t * FBK,
                    b, &full[s]);
        tma_load_4d(kt + C::KTILE + pn * FBK * F_PANEL_ROW, &vmap, 64 * pn,
                    kh, t * FBK, b, &full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // consumers: warp w of warpgroup wg, lane (gr, q) = (lane / 4, lane % 4)
  // holds accumulator i at row 16 w + gr + 8 ((i >> 1) & 1) of the
  // warpgroup's 64 and column 8 (i >> 2) + 2 q + (i & 1)
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gr = lane >> 2, q = lane & 3;
  const int row0 = q0 + 64 * wg + 16 * warp + gr;    // query index
  const int pos0 = p.start + row0, pos1 = pos0 + 8;  // its position
  // the warpgroup's least position, warp-uniform as the compiler sees it
  // (a shuffle from lane 0), so that the mask's branch keeps the wgmmas
  // after it on a converged path
  const int first = __shfl_sync(0xffffffffu, p.start + q0 + 64 * wg, 0);
  const uint32_t qa = smem_u32(qs) + wg * 64 * F_PANEL_ROW;
  const uint32_t kva = smem_u32(kvs);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  mbar_wait(qbar, 0);

  for (int t = 0; t < nt; ++t) {
    const int s = t % ST;
    const uint32_t ka = kva + s * 2 * C::KTILE;
    mbar_wait(&full[s], (t / ST) & 1);
    __syncwarp();
    float sc[FBK / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {      // 16 dims an atom
      const uint32_t off = (j >> 2) * FBQ * F_PANEL_ROW + 32 * (j & 3);
      const uint32_t offk = (j >> 2) * FBK * F_PANEL_ROW + 32 * (j & 3);
      wgmma_ss_bf16_n128(sc, smem_desc(qa + off, 8 * F_PANEL_ROW, DESC_B128),
                         smem_desc(ka + offk, 8 * F_PANEL_ROW, DESC_B128),
                         j > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    const int k0 = t * FBK;
    if (k0 + FBK - 1 > first || k0 + FBK > len) {   // the diagonal or a length
#pragma unroll
      for (int i = 0; i < FBK / 2; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * q + (i & 1);
        const int pos = (i >> 1) & 1 ? pos1 : pos0;
        if (key > pos || key >= len) sc[i] = NEG_INF;
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < FBK / 2; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * p.scale_log2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * p.scale_log2);
    // a row with no valid key yet keeps zero weight everywhere
    const float r0 = mn0 == NEG_INF ? 0.f : mn0;
    const float r1 = mn1 == NEG_INF ? 0.f : mn1;
    const float a0 = exp2f(m0 - r0), a1 = exp2f(m1 - r1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
    unsigned pf[FBK / 16][4];
#pragma unroll
    for (int j = 0; j < FBK / 16; ++j) {
      float e[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        e[u] = exp2f(fmaf(sc[8 * j + u], p.scale_log2, -((u >> 1) & 1 ? r1 : r0)));
        if ((u >> 1) & 1)
          ls1 += e[u];
        else
          ls0 += e[u];
      }
      pf[j][0] = pack_bf16(e[0], e[1]);
      pf[j][1] = pack_bf16(e[2], e[3]);
      pf[j][2] = pack_bf16(e[4], e[5]);
      pf[j][3] = pack_bf16(e[6], e[7]);
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i >> 1) & 1 ? a1 : a0;

    wgmma_fence();
#pragma unroll
    for (int j = 0; j < FBK / 16; ++j)      // 16 keys an atom
      wgmma_bf16<D, 1>(o, pf[j],
                       smem_desc(ka + C::KTILE + 16 * j * F_PANEL_ROW,
                                 8 * F_PANEL_ROW, DESC_B128,
                                 FBK * F_PANEL_ROW));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[s]);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + 8 * e;
    if (row >= p.Sq) continue;
    const float inv = e ? inv1 : inv0;
    bf16* op = p.out + (((long long)b * p.Sq + row) * p.H + h) * DO + 2 * q;
#pragma unroll
    for (int c = 0; c < DO / 8; ++c)
      *reinterpret_cast<unsigned*>(op + 8 * c) =
          pack_bf16(o[4 * c + 2 * e] * inv, o[4 * c + 2 * e + 1] * inv);
  }
}

// the 4-D map (D, heads, positions, slots) of a bf16 view whose heads and
// dims are contiguous, in boxes of 128 rows x 64 dims
bool view_map(CUtensorMap* m, const void* ptr, int d, int heads, int rows,
              int slots, long long ss, long long sb) {
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)heads, (uint64_t)rows,
                            (uint64_t)slots};
  const uint64_t pitches[3] = {(uint64_t)d * 2, (uint64_t)ss * 2,
                               (uint64_t)sb * 2};
  const uint32_t box[4] = {64, 1, 128, 1};
  return tensor_map(m, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, dims, pitches,
                    box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// D: the width the kernel computes at; DO: the stored head's (32 under 64)
template <int D, int DO>
int launch(const void* q, long long q_sb, long long q_ss, const void* k,
           long long k_sb, long long k_ss, const void* v, long long v_sb,
           long long v_ss, int B, const FlashArgs& a, cudaStream_t st) {
  constexpr int SMEM = FlashCfg<D>::SMEM;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<D, DO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  CUtensorMap qm, km, vm;
  if (!view_map(&qm, q, DO, a.H, a.Sq, B, q_ss, q_sb) ||
      !view_map(&km, k, DO, a.Kh, a.Skv, B, k_ss, k_sb) ||
      !view_map(&vm, v, DO, a.Kh, a.Skv, B, v_ss, v_sb))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.H, B, (a.Sq + FBQ - 1) / FBQ);
  flash_kernel<D, DO><<<grid, F_THREADS, SMEM, st>>>(qm, km, vm, a);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, D), k, v: (B, Skv, Kh, D) bf16 with element strides per
// slot (*_sb) and per position (*_ss), multiples of 8, heads and dims
// contiguous, bases 16-byte aligned. Query row i sits at position start +
// i and sees key j iff j <= start + i and j < lens[b] (lens: (B,) int32 on
// the device, or null for Skv). out: (B, Sq, H, D) bf16 contiguous. D is
// 32, 64 or 128.
extern "C" int dpt_flash_attention(const void* q, long long q_sb, long long q_ss,
                                   const void* k, long long k_sb, long long k_ss,
                                   const void* v, long long v_sb, long long v_ss,
                                   const void* lens, int B, int Sq, int Skv,
                                   int H, int Kh, int D, int start,
                                   float scale, void* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Kh <= 0 || H % Kh || start < 0)
    return (int)cudaErrorInvalidValue;
  const FlashArgs a{(const int*)lens, (bf16*)out, Sq, Skv, H, Kh, start,
                    scale * 1.4426950408889634f};
  if (D == 32)
    return launch<64, 32>(q, q_sb, q_ss, k, k_sb, k_ss, v, v_sb, v_ss, B, a,
                          st);
  if (D == 64)
    return launch<64, 64>(q, q_sb, q_ss, k, k_sb, k_ss, v, v_sb, v_ss, B, a,
                          st);
  if (D == 128)
    return launch<128, 128>(q, q_sb, q_ss, k, k_sb, k_ss, v, v_sb, v_ss, B, a,
                            st);
  return (int)cudaErrorInvalidValue;
}
