// #1's tensor-core kernel (mma_kernel) and its launchers, with the
// expert-tile modes of #9 and #10: included by dequant_matmul.cu, which
// instantiates every symmetric variant, and by dequant_matmul_zp.cu,
// which instantiates the zero-point (asymmetric) weight-only ones, so
// that nvcc builds the two beside each other. The design notes are at
// the top of dequant_matmul.cu.
#pragma once

#include <cudaTypedefs.h>

#include <type_traits>

#include "common.cuh"
#include "dequant_common.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// The tensor-core path (every M above the GEMV's): Y^T = W^T X^T on wgmma, the
// weight's columns the 64-row side of the atom and the tokens its N side.
constexpr int MMA_CONSUMERS = 256;
constexpr int MMA_PRODUCERS = 128;               // one producer warpgroup
constexpr int MMA_THREADS = MMA_CONSUMERS + MMA_PRODUCERS;
constexpr int MMA_STAGES = 6;
constexpr int GROUPED_TILE = 64;  // rows of an expert tile (BLOCK_M)

// The kernel's expert-tile modes (its EX template value): none (#1), over
// stacked experts (#9) and over the column blocks of a cat (#10).
constexpr int EX_NONE = 0;
constexpr int EX_STACKED = 1;
constexpr int EX_CAT = 2;

// The expert-tile modes keep the struct at #1's size (a larger parameter
// block changed ptxas's register allocation of #1's instantiations, and
// their speed): the tile table and a8 scales take the slots of the row
// factor and the split-K workspace, the cat's row pitch that of the
// residual's, which they never use; the other expert strides follow from
// K, N and the group.
struct MmaArgs {
  const int8_t* w;      // (K, N) int8 or (K/2, N) packed int4, 16-byte
                        // aligned; EX_STACKED: E of them stacked; EX_CAT:
                        // (K[/2], E * N), expert e's columns e * N..
  const float* scales;  // (K / group, N); EX_STACKED: E tables stacked;
                        // EX_CAT: (K / group, E * N)
  union {
    const float* rf;    // (M,) row factor (RMSNorm or a8 row scale) or null
    const float* qs;    // expert tiles, a8: per-(token, group) scales (K /
  };                    // group, M)
  const float* bias;    // (N,) or null
  const bf16* res;      // (M, N) rows res_sm apart, or null
  union {
    long long res_sm;
    long long ld;       // EX_CAT: the cat's row pitch, E * N
  };
  void* out;            // (M, N), f32 when out_f32 else bf16
  union {
    float* ws;          // (splits, M, N) partial sums when K is split
    const int* te;      // expert tiles: each 64-row token tile's expert, -1
                        // dead
  };
  int M, K, N, group, chunk, int4, out_f32;
  int wtma;             // the weight comes by TMA (else cp.async,
  int wvec;             // wvec = 16, 8, 4 or 1 bytes a copy)
};

// The stage's BK weight rows ku.. (unpacked; int4 rows past K/2 read the
// packed row k - K/2), rows ld bytes apart, 128 columns from n0, V bytes a
// copy (N % V == 0, so a copy is whole or past N and zero-filled); V = 1
// loads bytes.
template <int BK, int V>
__device__ __forceinline__ void copy_weight(unsigned char* wd,
                                            const MmaArgs& p,
                                            const int8_t* w, long long ld,
                                            int ku, int n0, int pt) {
  constexpr int PER_ROW = MMA_NT / V;
  const int half = p.K / 2;
  for (int i = pt; i < BK * PER_ROW; i += MMA_PRODUCERS) {
    const int r = i / PER_ROW, cb = (i - r * PER_ROW) * V;
    const int k = ku + r, n = n0 + cb;
    const int row = p.int4 && k >= half ? k - half : k;
    const bool ok = k < p.K && n < p.N;
    const int8_t* src = w + (ok ? (long long)row * ld + n : 0);
    unsigned char* dst = wd + wt_offset(r, cb >> 4) + (cb & 15);
    if constexpr (V == 1)
      *dst = ok ? (unsigned char)*src : 0;
    else
      cp_async<V>(dst, src, ok ? V : 0);
  }
}

// bytes a stage: the weight tile, and the activation tile 1024-aligned
template <int BK>
__host__ __device__ constexpr int mma_wtile() {
  return BK * MMA_NT;
}
template <int BN, int BK, bool A8>
__host__ __device__ constexpr int mma_xtile() {
  return (BN * BK * (A8 ? 1 : 2) + 1023) & ~1023;
}
template <int BN, int BK, bool A8>
__host__ __device__ constexpr int mma_smem() {  // barriers, slack, the rings
  return 128 + 1024 +
         MMA_STAGES * (mma_wtile<BK>() + mma_xtile<BN, BK, A8>());
}

// grid (ceil(M / BN), ceil(N / 128), splits), MMA_THREADS threads: warps 0-7
// are two consumer warpgroups (64 weight columns each), warps 8-11 the
// producers. A8: int8 activations and s8 x s8 -> s32 atoms (k32); else bf16
// activations and bf16 atoms (k16, f32 sums), the weight converted exactly.
// Each block sums the unpacked K rows [z * chunk, (z + 1) * chunk); a chunk
// never crosses a scale group, and the group sums flush into f32 totals,
// times their column's scale, at every group end and at the chunk's end.
// Expert tiles (EX_STACKED, #9, and EX_CAT, #10: instantiations of their
// own, so that #1's compile as they did): te[blockIdx.x] names the expert
// of the block's token tile, a coordinate of a 3-D weight map: (N, stored
// rows, experts) over stacked experts, (N, experts, stored rows) over a
// cat, whose expert pitch (N) is below its row pitch (E * N), so that
// every pitch of the map follows the one before; scales start at the
// expert's table (stacked) or columns (cat); a dead tile (-1) runs no
// stage and stores nothing. Under A8 each token's group sum is first
// scaled by its own per-(token, group) activation scale: tot += (sum *
// qs) * s. ZP (weight-only #1, instantiated in dequant_matmul_zp.cu): zp
// holds the (K / group, N) int32 zero points, and each weight operand is
// bf16(q - z) (unread otherwise).
template <bool A8, int BN, int BK, int EX, bool ZP = false>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    mma_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap, const MmaArgs p,
               const int* __restrict__ zp) {
  static_assert(!ZP || (!A8 && EX == EX_NONE), "zero points: #1 weight-only");
  constexpr bool GROUPED = EX != EX_NONE;
  constexpr int WTILE = mma_wtile<BK>();
  constexpr int XTILE = mma_xtile<BN, BK, A8>();
  constexpr int U = BK / 32;                       // 32-row units a stage
  constexpr int R = BN / 2;                        // accumulators a thread
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MMA_STAGES;
  // the rings, 1024-byte aligned for TMA's swizzles: wt [stage][BK rows]
  // [128 bytes]; xt [stage][BN tokens][BK activations], one swizzle atom a
  // row (BK * 2 bytes for bf16: B128 or B64; BK for int8: B64 or B32)
  const uint32_t base = (smem_u32(smem) + 128 + 1023) & ~1023u;
  unsigned char* wt = reinterpret_cast<unsigned char*>(smem) +
                      (base - smem_u32(smem));
  unsigned char* xt = wt + MMA_STAGES * WTILE;
  constexpr bool SEGQ = GROUPED && A8;
  int ex = 0;                      // the block's expert (GROUPED)
  if constexpr (GROUPED) ex = p.te[blockIdx.x];
  const int tid = threadIdx.x, lane = tid & 31;
  const int m0 = blockIdx.x * BN, n0 = blockIdx.y * MMA_NT;
  const int k0 = blockIdx.z * p.chunk;
  const int nst = ex < 0 ? 0 : (min(p.K, k0 + p.chunk) - k0 + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < MMA_STAGES; ++s) {
      // TMA's thread (with the stage's bytes); without the weight's TMA
      // also each producer thread's copies and its stores
      mbar_init(&full[s], 1 + (p.wtma ? 0 : 2 * MMA_PRODUCERS));
      mbar_init(&empty[s], MMA_CONSUMERS);     // each consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the role, warp-uniform as the compiler sees it (a shuffle from lane 0),
  // so that no wgmma sits on a path it takes for divergent
  if (__shfl_sync(0xffffffffu, tid / MMA_CONSUMERS, 0)) {
    // producer: the ring's stages in order, each after its consumers
    // released it. One thread asks TMA for the activation box (tokens m0..,
    // unpacked K ku..; past M or K zero-filled) and, when it takes it, the
    // weight box (packed rows for int4's plane, 128 columns from n0; past
    // the rows or N zero-filled); otherwise every producer thread copies
    // the weight with cp.async into the same swizzled layout.
    // the producers give registers to the consumers (2 x 128 x 232 + 128 x
    // 40 = 168 x 384, the block's registers at launch)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - MMA_CONSUMERS;
    if (p.wtma && pt) return;
    const int half = p.K / 2;
    for (int it = 0; it < nst; ++it) {
      const int s = it % MMA_STAGES;
      mbar_wait(&empty[s], ((it / MMA_STAGES) & 1) ^ 1);
      const int ku = k0 + it * BK;
      unsigned char* wd = wt + s * WTILE;
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[s], (p.wtma ? WTILE : 0) +
                                            BN * BK * (A8 ? 1 : 2));
        tma_load_2d(xt + s * XTILE, &xmap, ku, m0, &full[s]);
        if (p.wtma) {
          const int row = p.int4 && ku >= half ? ku - half : ku;
          if constexpr (EX == EX_STACKED)
            tma_load_3d(wd, &wmap, n0, row, ex, &full[s]);
          else if constexpr (EX == EX_CAT)
            tma_load_3d(wd, &wmap, n0, ex, row, &full[s]);
          else
            tma_load_2d(wd, &wmap, n0, row, &full[s]);
        }
      }
      if (!p.wtma) {
        const int8_t* w = p.w;
        long long ld = p.N;
        if constexpr (EX == EX_STACKED)
          w += ex * (long long)(p.int4 ? p.K / 2 : p.K) * p.N;
        if constexpr (EX == EX_CAT) {
          w += ex * (long long)p.N;
          ld = p.ld;
        }
        if (p.wvec == 16)
          copy_weight<BK, 16>(wd, p, w, ld, ku, n0, pt);
        else if (p.wvec == 8)
          copy_weight<BK, 8>(wd, p, w, ld, ku, n0, pt);
        else if (p.wvec == 4)
          copy_weight<BK, 4>(wd, p, w, ld, ku, n0, pt);
        else
          copy_weight<BK, 1>(wd, p, w, ld, ku, n0, pt);
        mbar_arrive_cp_async(&full[s]);
        mbar_arrive(&full[s]);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // consumers: warp w of warpgroup wg owns weight columns n0 + 64 wg + 16 w
  // + [0, 16). ldmatrix (transposed, b16) hands lane (gr, q) = (lane / 4,
  // lane % 4) the two bytes of columns 2 gr, 2 gr + 1 from two weight rows
  // per register, so A row gr is column 2 gr and A row gr + 8 column 2 gr +
  // 1: each thread owns columns na, na + 1.
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int gr = lane >> 2, q = lane & 3;
  const int mi = lane >> 3, mj = lane & 7;      // ldmatrix: matrix, row
  // bf16 (k16 atoms): matrix i holds stage rows 8i..8i+7, so register j
  // holds rows 8j + 2q, + 1. a8 (k32 atoms, 4 K values a register): matrix
  // i holds rows {0,1,4,5,8,9,12,13} + 2 (i & 1) + 16 (i >> 1), so
  // register j holds rows 16 (j >> 1) + 4q + 2 (j & 1), + 1.
  const int lrow = A8 ? (mj >> 1) * 4 + (mj & 1) + 2 * (mi & 1) + 16 * (mi >> 1)
                      : 8 * mi + mj;
  const uint32_t ld_addr = smem_u32(wt) + wt_offset(lrow, 4 * wg + warp);
  const uint32_t xs_addr = smem_u32(xt);
  const int na = n0 + 64 * wg + 16 * warp + 2 * gr;
  typedef typename std::conditional<A8, int, float>::type Acc;
  Acc acc[R];
  float tot[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0, tot[i] = 0.f;
  // The stages of one scale group form an inner loop; the flush follows
  // it. One stage's wgmmas stay in flight while the next stage's fragments
  // are built: the fragments alternate between fa and fb, and a stage is
  // released once the wait for the one after it shows it done. (A flush
  // inside the loop would leave ptxas two wgmma states to merge at its back
  // edge, and it would drain the queue there.)
  // the activation tile's swizzle atom: its rows are BK * ES bytes, the
  // 8-row groups 8 * that apart; each atom of K steps 32 bytes along a row
  constexpr int XROW = BK * (A8 ? 1 : 2);
  constexpr uint64_t XSW = XROW == 128 ? DESC_B128
                           : XROW == 64 ? DESC_B64 : DESC_B32;
  constexpr int NF = U * (A8 ? 4 : 8);
  unsigned fa[NF], fb[NF];
  // ZP: the subtrahends of columns na, na + 1 in the current group
  float ca = 8388736.f, cb = 8388736.f;
  // stage `it` into f: wait for its bytes, build the A fragments, issue
  auto issue = [&](int it, unsigned (&f)[NF]) {
    const int s = it % MMA_STAGES;
    const int ku = k0 + it * BK;
    mbar_wait(&full[s], (it / MMA_STAGES) & 1);
    __syncwarp();                       // converged for the .aligned ops
    if (!p.wtma) fence_async_smem();    // cp.async wrote the weight
#pragma unroll
    for (int u = 0; u < U; ++u) {       // 32 rows: one ldmatrix a warp
      unsigned r[4];
      ldmatrix_x4_trans(ld_addr + s * WTILE + u * 32 * MMA_NT, r);
      if (p.int4) {
        // each row's nibble: low in plane 0 (unpacked row < K/2), else high
        const int half = p.K / 2;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = ku + 32 * u + (A8 ? 16 * (j >> 1) + 4 * q + 2 * (j & 1)
                                            : 8 * j + 2 * q);
          const unsigned hi = (row >= half ? 0x0000FFFFu : 0u) |
                              (row + 1 >= half ? 0xFFFF0000u : 0u);
          r[j] = sext_nibbles((((r[j] >> 4) & hi) | (r[j] & ~hi)) &
                              0x0F0F0F0Fu);
        }
      }
      if constexpr (A8) {
        f[4 * u] = __byte_perm(r[0], r[1], 0x6420);
        f[4 * u + 1] = __byte_perm(r[0], r[1], 0x7531);
        f[4 * u + 2] = __byte_perm(r[2], r[3], 0x6420);
        f[4 * u + 3] = __byte_perm(r[2], r[3], 0x7531);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned* fh = f + 8 * u + 4 * h;
          fh[0] = bf16x2_of(r[2 * h], 0, 2, ca);
          fh[1] = bf16x2_of(r[2 * h], 1, 3, cb);
          fh[2] = bf16x2_of(r[2 * h + 1], 0, 2, ca);
          fh[3] = bf16x2_of(r[2 * h + 1], 1, 3, cb);
        }
      }
    }
    const uint32_t xa = xs_addr + s * XTILE;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NF / 4; ++j) {  // one atom a 32-byte step of K
      const uint64_t d = smem_desc(xa + 32 * j, 8 * XROW, XSW);
      if constexpr (A8)
        wgmma_s8<BN>(acc, *reinterpret_cast<unsigned(*)[4]>(f + 4 * j), d);
      else
        wgmma_bf16<BN>(acc, *reinterpret_cast<unsigned(*)[4]>(f + 4 * j), d);
    }
    wgmma_commit();
  };
  // stage it - 1 (fragments fprev) is done once only one group runs
  auto retire = [&](int it, unsigned (&fprev)[NF]) {
    wgmma_wait<1>();
    fence_regs(fprev);
    mbar_arrive(&empty[(it - 1) % MMA_STAGES]);
  };
  for (int it = 0; it < nst;) {
    const int ku = k0 + it * BK;
    const int grp = ku / p.group;
    const int end = min(nst, ((grp + 1) * p.group - k0 + BK - 1) / BK);
    // the group's scales, ahead of its flush (columns past N never stored)
    const float* sr = p.scales + (long long)grp * (EX == EX_CAT ? p.ld : p.N);
    if constexpr (EX == EX_STACKED) sr += ex * (long long)(p.K / p.group) * p.N;
    if constexpr (EX == EX_CAT) sr += ex * (long long)p.N;
    const float sa = __ldg(sr + min(na, p.N - 1));
    const float sb = __ldg(sr + min(na + 1, p.N - 1));
    if constexpr (ZP) {
      const int* zr = zp + (long long)grp * p.N;
      ca = zp_sub(__ldg(zr + min(na, p.N - 1)));
      cb = zp_sub(__ldg(zr + min(na + 1, p.N - 1)));
    }
    // SEGQ: the activation scales of the thread's tokens 8 j + 2 q + e in
    // this group (the tile's rows are all below M)
    float qv[SEGQ ? BN / 4 : 1];
    if constexpr (SEGQ) {
      const float* qr = p.qs + (long long)grp * p.M + m0 + 2 * q;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        qv[2 * j] = __ldg(qr + 8 * j);
        qv[2 * j + 1] = __ldg(qr + 8 * j + 1);
      }
    }
    issue(it, fa);
    for (++it; it + 1 < end; it += 2) {
      issue(it, fb);
      retire(it, fa);
      issue(it + 1, fa);
      retire(it + 1, fb);
    }
    if (it < end) {
      issue(it, fb);
      retire(it, fa);
      ++it;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(fa);
    fence_regs(fb);
    mbar_arrive(&empty[(it - 1) % MMA_STAGES]);
    // accumulator i: A row gr + 8 ((i >> 1) & 1), i.e. column na or na + 1
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float v = (float)acc[i];
      if constexpr (SEGQ) v = __fmul_rn(v, qv[2 * (i >> 2) + (i & 1)]);
      tot[i] = fmaf(v, (i >> 1) & 1 ? sb : sa, tot[i]);
      acc[i] = 0;
    }
  }

  // accumulator i holds token 8 (i >> 2) + 2q + (i & 1); i and i + 2 are
  // columns na and na + 1 of one token
  const bool two = na + 1 < p.N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = m0 + 8 * j + 2 * q + e;
      if (t >= p.M || na >= p.N || ex < 0) continue;
      float v0 = tot[4 * j + e], v1 = tot[4 * j + 2 + e];
      const long long o = (long long)t * p.N + na;
      if (!GROUPED && gridDim.z > 1) {
        float* wp = p.ws + (long long)blockIdx.z * p.M * p.N + o;
        wp[0] = v0;
        if (two) wp[1] = v1;
        continue;
      }
      if (!GROUPED && p.rf) {
        const float f = p.rf[t];
        v0 *= f;
        v1 *= f;
      }
      if (p.bias) {
        v0 += p.bias[na];
        if (two) v1 += p.bias[na + 1];
      }
      if (p.res) {
        const bf16* rr = p.res + (long long)t * p.res_sm + na;
        v0 += bf2f(rr[0]);
        if (two) v1 += bf2f(rr[1]);
      }
      if (p.out_f32) {
        float* op = reinterpret_cast<float*>(p.out) + o;
        if (two && !(p.N & 1)) {
          *reinterpret_cast<float2*>(op) = make_float2(v0, v1);
        } else {
          op[0] = v0;
          if (two) op[1] = v1;
        }
      } else {
        bf16* op = reinterpret_cast<bf16*>(p.out) + o;
        if (two && !(p.N & 1)) {
          *reinterpret_cast<__nv_bfloat162*>(op) = __floats2bfloat162_rn(v0, v1);
        } else {
          op[0] = f2bf(v0);
          if (two) op[1] = f2bf(v1);
        }
      }
    }
  }
}

// x: (M, K) activations, rows x_sm elements apart, 16-byte aligned;
// EX_STACKED: the weight holds `experts` stacked (K[/2], N) matrices;
// EX_CAT: one (K[/2], experts * N) cat, a.ld = experts * N; ZP: zp the
// zero points
template <bool A8, int BN, int BK, int EX = EX_NONE, bool ZP = false>
cudaError_t launch_mma_bn(const void* x, long long x_sm, MmaArgs a,
                          int splits, int experts, cudaStream_t st,
                          const int* zp = nullptr) {
  constexpr int SMEM = mma_smem<BN, BK, A8>();
  constexpr int XROW = BK * (A8 ? 1 : 2);         // activation bytes a row
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        mma_kernel<A8, BN, BK, EX, ZP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {(uint64_t)a.K, (uint64_t)a.M};
  const uint64_t xpitch[1] = {(uint64_t)x_sm * (A8 ? 1 : 2)};
  const uint32_t xbox[2] = {BK, BN};
  if (!tensor_map(&xmap, x,
                  A8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  2, xdims, xpitch, xbox,
                  XROW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                  : XROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B))
    return cudaErrorInvalidValue;
  // TMA takes the weight when its rows are 16-byte aligned and no stage
  // straddles int4's plane boundary. The cat's map is (N, experts, rows)
  // with pitches (N, E * N) bytes (ops/kernels/grouped_matmul.py
  // `expert_map`): TMA zero-fills columns past N at each expert's edge.
  const uint64_t rows = a.int4 ? a.K / 2 : a.K;
  const uint64_t E = (uint64_t)experts;
  const uint64_t wdims[3] = {(uint64_t)a.N, EX == EX_CAT ? E : rows,
                             EX == EX_CAT ? rows : E};
  const uint64_t wpitch[2] = {(uint64_t)a.N,
                              EX == EX_CAT ? E * a.N : rows * a.N};
  const uint32_t wbox[3] = {MMA_NT, EX == EX_CAT ? 1u : (uint32_t)BK,
                            EX == EX_CAT ? (uint32_t)BK : 1u};
  a.wtma = a.N % 16 == 0 && (!a.int4 || (a.K / 2) % BK == 0) &&
           tensor_map(&wmap, a.w, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                      EX != EX_NONE ? 3 : 2, wdims, wpitch, wbox,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (!a.wtma) wmap = xmap;     // unread
  const dim3 grid((a.M + BN - 1) / BN, (a.N + MMA_NT - 1) / MMA_NT, splits);
  mma_kernel<A8, BN, BK, EX, ZP><<<grid, MMA_THREADS, SMEM, st>>>(
      xmap, wmap, a, zp);
  return cudaGetLastError();
}

template <bool A8, int BK, bool ZP>
cudaError_t launch_mma_bk(const void* x, long long x_sm, const MmaArgs& a,
                          int bn, int splits, cudaStream_t st,
                          const int* zp) {
  switch (bn) {
    case 32:
      return launch_mma_bn<A8, 32, BK, EX_NONE, ZP>(x, x_sm, a, splits, 1,
                                                   st, zp);
    case 48:
      return launch_mma_bn<A8, 48, BK, EX_NONE, ZP>(x, x_sm, a, splits, 1,
                                                   st, zp);
    case 64:
      return launch_mma_bn<A8, 64, BK, EX_NONE, ZP>(x, x_sm, a, splits, 1,
                                                   st, zp);
    case 128:
      return launch_mma_bn<A8, 128, BK, EX_NONE, ZP>(x, x_sm, a, splits, 1,
                                                    st, zp);
    default: return cudaErrorInvalidValue;
  }
}

// #1's launch at token tile bn and stage depth bk; ZP with zp its zero
// points
template <bool A8, bool ZP = false>
cudaError_t launch_mma(const void* x, long long x_sm, const MmaArgs& a,
                       int bn, int bk, int splits, cudaStream_t st,
                       const int* zp = nullptr) {
  return bk == 64 ? launch_mma_bk<A8, 64, ZP>(x, x_sm, a, bn, splits, st, zp)
                  : launch_mma_bk<A8, 32, ZP>(x, x_sm, a, bn, splits, st, zp);
}

// #1's arguments (group 0: per-channel; rf the row factor or null, ws the
// split-K sums or null)
inline MmaArgs mma_args(const int8_t* w, const float* scales, const float* rf,
                        const float* bias, const bf16* res, long long res_sm,
                        void* out, int out_f32, float* ws, int M, int K,
                        int N, int group, int kchunk, bool int4) {
  MmaArgs a{};
  a.w = w;
  a.scales = scales;
  a.rf = rf;
  a.bias = bias;
  a.res = res;
  a.res_sm = res_sm;
  a.out = out;
  a.ws = ws;
  a.M = M;
  a.K = K;
  a.N = N;
  a.group = group ? group : K;
  a.chunk = kchunk;
  a.wvec = N % 16 == 0 ? 16 : N % 8 == 0 ? 8 : N % 4 == 0 ? 4 : 1;
  a.int4 = int4;
  a.out_f32 = out_f32;
  a.wtma = 0;
  return a;
}

}  // namespace
