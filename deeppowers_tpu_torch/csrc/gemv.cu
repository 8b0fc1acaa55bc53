// The fused dequant matmul's decode GEMV (#1 at M <= GEMV_MAX_M = 8; the
// tensor-core kernel of dequant_matmul.cu takes every M above): y =
// act(x) @ dequant(W) [* rms] [+ bias] [+ residual] for every weight
// variant, reached through dpt_dequant_matmul's GEMV route. It replaces
// the decode sizes of the Pallas TPU kernel deeppowers_tpu/ops/pallas/
// dequant_matmul.py (`dequant_matmul` :554, `dequant_matmul_fused` :582,
// pallas_call :528); its own source so that nvcc builds it beside the
// tensor-core kernel. What bounds it and its design are in
// dequant_matmul.cu's notes ("GEMV").
#include <cudaTypedefs.h>

#include <type_traits>

#include "common.cuh"
#include "dequant_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int GV_CONSUMERS = 256;   // 8 warps, 16 weight columns each
constexpr int GV_THREADS = GV_CONSUMERS + 32;  // and one producer warp
constexpr int GV_BK = 64;           // stored weight rows a stage
constexpr int GV_STAGES = 6;
constexpr int GV_WTILE = GV_BK * MMA_NT;       // bytes a stage (8 KB)
constexpr int GV_NT = 1;            // n8 token tiles
constexpr int GV_TOKENS = 8 * GV_NT;  // token rows at most
constexpr int GV_HEADER = 1024;     // the barriers and red
constexpr int GV_SPLITS = 8;        // K splits at most: a portable cluster

struct GemvArgs {
  const void* x;        // bf16 (M, K) rows, (M, 2K) gate|up with GLU; a8:
  long long x_sm;       // int8 (M, K); elements between rows
  const float* xs;      // a8: (M,) row scales, else null
  const bf16* g;        // (K,) RMSNorm weight or null
  const int8_t* w;      // (rows, N): int8, or packed int4 (rows = K / 2)
  const float* scales;  // (K / group, N)
  const int* zp;        // (K / group, N) int32 zero points (ZP) or null
  const float* bias;    // (N,) or null
  const bf16* res;      // (M, N) rows res_sm apart, or null
  long long res_sm;
  void* out;            // (M, N), f32 when out_f32 else bf16
  int M, K, N;
  int group;            // unpacked rows a scale row (K per-channel)
  int seg;              // stored rows between two flushes, % 16 == 0
  int chunk;            // stored rows a split, % 16 == 0
  int sub;              // stored rows staged at once, % 64 == 0
  int pitch;            // bytes between two staged activation rows
  int mode, gelu, out_f32;
  int wtma;             // the weight comes by TMA (else cp.async,
  int wvec;             // wvec = 16, 8, 4 or 1 bytes a copy)
  float eps;
};

__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(GV_CONSUMERS) : "memory");
}

// D(16 x 8) += A(16 x 16) B(16 x 8): s8 in, exact s32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Stored weight rows r.. of a stage (zero past `rows`), 128 columns from
// n0 (zero past N), by the producer warp's 32 lanes, V bytes a copy, into
// the layout TMA's 128-byte swizzle writes.
template <int V>
__device__ __forceinline__ void gv_copy(unsigned char* wd, const int8_t* w,
                                        int r, int rows, int n0, int N,
                                        int lane) {
  constexpr int PER_ROW = MMA_NT / V;
  for (int i = lane; i < GV_BK * PER_ROW; i += 32) {
    const int rr = i / PER_ROW, cb = (i - rr * PER_ROW) * V;
    const int row = r + rr, n = n0 + cb;
    const bool ok = row < rows && n < N;
    const int8_t* src = w + (ok ? (long long)row * N + n : 0);
    unsigned char* dst = wd + wt_offset(rr, cb >> 4) + (cb & 15);
    if constexpr (V == 1)
      *dst = ok ? (unsigned char)*src : 0;
    else
      cp_async<V>(dst, src, ok ? V : 0);
  }
}

__device__ __forceinline__ uint4 pack_bf16x8(const float (&v)[8]) {
  uint4 o;
  unsigned* ow = reinterpret_cast<unsigned*>(&o);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    ow[j] = *reinterpret_cast<const unsigned*>(&h);
  }
  return o;
}

// Eight staged activations, as stage_value computes them, from eight
// values of x (xv) and of up (GLU) or g (RMS) (bv); RMSNorm's sum of
// squares of x gathers in ss.
__device__ __forceinline__ uint4 fold8(const uint4& xv, const uint4& bv,
                                       int mode, int gelu, float& ss) {
  const bf16* xe = reinterpret_cast<const bf16*>(&xv);
  const bf16* be = reinterpret_cast<const bf16*>(&bv);
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float a = bf2f(xe[j]);
    v[j] = mode == MODE_GLU   ? round_bf16(act_fn(a, gelu) * bf2f(be[j]))
           : mode == MODE_RMS ? round_bf16(a * bf2f(be[j]))
                              : a;
    if (mode == MODE_RMS) ss += a * a;
  }
  return pack_bf16x8(v);
}

// The same one value at a time from unpacked k, the first nv valid and
// the rest 0 (a chunk's ragged end, or rows without 16-byte loads).
__device__ __forceinline__ uint4 fold8_scalar(const bf16* xr, const bf16* g,
                                              int mode, int gelu, int K,
                                              int k, int nv, float& ss) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = 0.f;
    if (j < nv) {
      v[j] = stage_value(xr, g, mode, gelu, K, k + j);
      const float a = bf2f(xr[k + j]);
      if (mode == MODE_RMS) ss += a * a;
    }
  }
  return pack_bf16x8(v);
}

// Stage stored rows rs.. (len of them; zeros past len up to `cols`) of
// the activations, both planes, one token row a warp (warp w: row w),
// four 16-byte loads of a lane in flight before any is used. ss[t]: the
// lane's part of row w + 8 t's sum of squares (RMSNorm).
template <bool A8, bool INT4>
__device__ __forceinline__ void gv_stage(const GemvArgs& p, unsigned char* act,
                                         int rs, int len, int cols,
                                         bool vec, float (&ss)[GV_NT]) {
  constexpr int NP = INT4 ? 2 : 1;
  constexpr int MT = 8 * GV_NT;
  constexpr int EL = A8 ? 16 : 8;           // activations an item
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = cols / EL, items = NP * per;
#pragma unroll
  for (int t = 0; t < GV_NT; ++t) {
    const int m = warp + 8 * t;
    const bool live = m < p.M;
    for (int j0 = lane; j0 < items; j0 += 4 * 32) {
      uint4 xv[4], bv[4];
      bool whole[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + 32 * u;
        const int pl = j / per, r = (j - pl * per) * EL;
        const int k = pl * (p.K / 2) + rs + r;
        xv[u] = bv[u] = make_uint4(0u, 0u, 0u, 0u);
        whole[u] = live && j < items && r + EL <= len && vec;
        if constexpr (A8) {
          const int8_t* xr = (const int8_t*)p.x + (long long)m * p.x_sm + k;
          if (whole[u]) {
            xv[u] = __ldg(reinterpret_cast<const uint4*>(xr));
          } else if (live && j < items && r < len) {
            unsigned* w4 = reinterpret_cast<unsigned*>(&xv[u]);
#pragma unroll
            for (int c = 0; c < 4; ++c)  // rows % 4 == 0 (the wrapper's)
              if (r + 4 * c < len)
                w4[c] = __ldg(reinterpret_cast<const unsigned*>(xr + 4 * c));
          }
        } else if (whole[u]) {
          const bf16* xr = (const bf16*)p.x + (long long)m * p.x_sm;
          xv[u] = __ldg(reinterpret_cast<const uint4*>(xr + k));
          if (p.mode == MODE_GLU)
            bv[u] = __ldg(reinterpret_cast<const uint4*>(xr + p.K + k));
          else if (p.mode == MODE_RMS)
            bv[u] = __ldg(reinterpret_cast<const uint4*>(p.g + k));
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + 32 * u;
        if (j >= items) break;
        const int pl = j / per, r = (j - pl * per) * EL;
        unsigned char* dst = act + (pl * MT + m) * p.pitch + r * (A8 ? 1 : 2);
        uint4 o = xv[u];
        if constexpr (!A8) {
          if (whole[u]) {
            o = fold8(xv[u], bv[u], p.mode, p.gelu, ss[t]);
          } else if (live && r < len) {
            const bf16* xr = (const bf16*)p.x + (long long)m * p.x_sm;
            o = fold8_scalar(xr, p.g, p.mode, p.gelu, p.K,
                             pl * (p.K / 2) + rs + r, min(8, len - r), ss[t]);
          }
        }
        *reinterpret_cast<uint4*>(dst) = o;
      }
    }
  }
}

// One output value of row m, column n (or two, n and n + 1 < N, when
// `two`): plus bias and residual, cast once.
__device__ __forceinline__ void gv_store(const GemvArgs& p, int m, int n,
                                         float v0, float v1, bool two) {
  if (p.bias) {
    v0 += p.bias[n];
    if (two) v1 += p.bias[n + 1];
  }
  if (p.res) {
    const bf16* rr = p.res + (long long)m * p.res_sm + n;
    v0 += bf2f(rr[0]);
    if (two) v1 += bf2f(rr[1]);
  }
  const long long o = (long long)m * p.N + n;
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

// grid (ceil(N / 128), splits), GV_THREADS threads, clusters of (1,
// splits): warps 0-7 consume, warp 8 produces. Block (x, y) takes weight
// columns 128 x.. and stored rows y * chunk..; one n8 token tile. A8:
// int8 activations (the row quantizer's) and s8 atoms; else bf16
// activations, staged folded, and bf16 atoms. INT4: packed rows, both
// nibble planes of each byte (plane 1 against the activations K / 2 on).
// ZP (weight-only): zero points, each weight operand bf16(q - z).
template <bool A8, bool INT4, bool ZP = false>
__global__ void __launch_bounds__(GV_THREADS, 2)
    gemv_kernel(const __grid_constant__ CUtensorMap wmap, const GemvArgs p) {
  static_assert(!(ZP && A8), "zero points are weight-only");
  constexpr int NP = INT4 ? 2 : 1;        // nibble planes
  constexpr int MT = 8 * GV_NT;           // staged token rows
  constexpr int ES = A8 ? 1 : 2;          // bytes an activation
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + GV_STAGES;
  float* red = smem + 32;                 // [GV_TOKENS] sums of squares
  // the weight ring, 1024-byte aligned for TMA's swizzle: [stage][64
  // rows][128 bytes]; then the activations [plane][MT tokens][pitch bytes]
  const uint32_t base = (smem_u32(smem) + GV_HEADER + 1023) & ~1023u;
  unsigned char* wt = reinterpret_cast<unsigned char*>(smem) +
                      (base - smem_u32(smem));
  unsigned char* act = wt + GV_STAGES * GV_WTILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = INT4 ? p.K / 2 : p.K;
  const int n0 = blockIdx.x * MMA_NT;
  const int split = blockIdx.y, splits = gridDim.y;  // the cluster's rank
  const int r0 = split * p.chunk;
  const int kl = max(0, min(rows, r0 + p.chunk) - r0);  // the split's rows
  const int nst = (kl + GV_BK - 1) / GV_BK;
  if (tid == 0) {
    for (int s = 0; s < GV_STAGES; ++s) {
      // TMA's thread, or each producer lane's copies and its arrival
      mbar_init(&full[s], p.wtma ? 1 : 64);
      mbar_init(&empty[s], GV_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == GV_CONSUMERS / 32) {
    // producer: the split's stages in order, each after its consumers
    // released it
    for (int it = 0; it < nst && (!p.wtma || lane == 0); ++it) {
      const int s = it % GV_STAGES;
      mbar_wait(&empty[s], ((it / GV_STAGES) & 1) ^ 1);
      unsigned char* wd = wt + s * GV_WTILE;
      const int r = r0 + it * GV_BK;
      if (p.wtma) {
        mbar_arrive_expect_tx(&full[s], GV_WTILE);
        tma_load_2d(wd, &wmap, n0, r, &full[s]);
        continue;
      }
      if (p.wvec == 16)
        gv_copy<16>(wd, p.w, r, rows, n0, p.N, lane);
      else if (p.wvec == 8)
        gv_copy<8>(wd, p.w, r, rows, n0, p.N, lane);
      else if (p.wvec == 4)
        gv_copy<4>(wd, p.w, r, rows, n0, p.N, lane);
      else
        gv_copy<1>(wd, p.w, r, rows, n0, p.N, lane);
      mbar_arrive_cp_async(&full[s]);
      mbar_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (splits > 1) {
      cluster_sync();                     // the partial sums are written
      cluster_sync();                     // and read
    }
    return;
  }

  // consumers. Warp w owns weight columns n0 + 16 w + [0, 16). The
  // transposed ldmatrix of 32 stage rows hands lane (gr, q) = (lane / 4,
  // lane % 4) bytes of columns 2 gr and 2 gr + 1 (A rows gr and gr + 8),
  // as in the tensor-core kernel: bf16 rows 8 j + 2 q, + 1 in register j;
  // a8 rows 16 (j >> 1) + 4 q + 2 (j & 1), + 1. Accumulator i of token
  // tile t holds column na + (i >> 1) of token 8 t + 2 q + (i & 1).
  const int gr = lane >> 2, q = lane & 3;
  const int mi = lane >> 3, mj = lane & 7;
  const int lrow = A8 ? (mj >> 1) * 4 + (mj & 1) + 2 * (mi & 1) + 16 * (mi >> 1)
                      : 8 * mi + mj;
  const uint32_t wa = smem_u32(wt) + wt_offset(lrow, warp);
  // B fragments: token row lane & 7, each matrix 16 bytes on
  const uint32_t xa = smem_u32(act) + (lane & 7) * p.pitch + (lane >> 3) * 16;
  const int na = n0 + 16 * warp + 2 * gr;
  const bool rms = !A8 && p.mode == MODE_RMS;
  // 16-byte activation loads keep their alignment (rows staged from
  // multiples of 64)
  const bool vec = A8 ? (INT4 ? (p.K / 2) % 16 : p.K % 16) == 0 &&
                            p.x_sm % 16 == 0 && (uintptr_t)p.x % 16 == 0
                      : (INT4 ? p.K % 16 : p.K % 8) == 0 &&
                            p.x_sm % 8 == 0 && (uintptr_t)p.x % 16 == 0 &&
                            (!p.g || (uintptr_t)p.g % 16 == 0);
  float ss[GV_NT];
#pragma unroll
  for (int t = 0; t < GV_NT; ++t) ss[t] = 0.f;
  typedef typename std::conditional<A8, int, float>::type Acc;
  Acc acc[NP][GV_NT][4];
  float tot[GV_NT][4];
#pragma unroll
  for (int t = 0; t < GV_NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tot[t][i] = 0.f;
#pragma unroll
      for (int pl = 0; pl < NP; ++pl) acc[pl][t][i] = 0;
    }
  // the segment's column scales (na, na + 1) per plane, and under ZP
  // bf16x2_of's subtrahends of their zero points; columns past N read
  // column N - 1 and are never stored
  float sc[NP][2], zc[NP][2];
  auto load_scales = [&](int r) {
#pragma unroll
    for (int pl = 0; pl < NP; ++pl) {
      const long long o = (long long)((pl * (p.K / 2) + r) / p.group) * p.N;
      sc[pl][0] = __ldg(p.scales + o + min(na, p.N - 1));
      sc[pl][1] = __ldg(p.scales + o + min(na + 1, p.N - 1));
      if constexpr (ZP) {
        zc[pl][0] = zp_sub(__ldg(p.zp + o + min(na, p.N - 1)));
        zc[pl][1] = zp_sub(__ldg(p.zp + o + min(na + 1, p.N - 1)));
      }
    }
  };
  // the segment's sums, times their scales, into the f32 totals
  auto flush = [&]() {
#pragma unroll
    for (int pl = 0; pl < NP; ++pl)
#pragma unroll
      for (int t = 0; t < GV_NT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tot[t][i] = fmaf((float)acc[pl][t][i], sc[pl][i >> 1], tot[t][i]);
          acc[pl][t][i] = 0;
        }
  };
  if (kl > 0) load_scales(r0);
  int left = p.seg - r0 % p.seg;          // stored rows to the next flush
  const int sub_st = p.sub / GV_BK;       // stages staged at once
  for (int it = 0; it < nst; ++it) {
    const int s = it % GV_STAGES, st = it % sub_st;
    if (st == 0) {
      // the next rows' activations, once every warp is done with the last
      if (it) bar_consumers();
      const int rs = r0 + it * GV_BK;
      const int len = min(kl - it * GV_BK, p.sub);
      gv_stage<A8, INT4>(p, act, rs, len, (len + GV_BK - 1) / GV_BK *
                             GV_BK, vec, ss);
      bar_consumers();
    }
    // the stage's activations: bf16 two x4 loads (32 k each), a8 one (64)
    unsigned b[NP][GV_NT][A8 ? 4 : 8];
#pragma unroll
    for (int pl = 0; pl < NP; ++pl)
#pragma unroll
      for (int t = 0; t < GV_NT; ++t) {
        const uint32_t xr = xa + (pl * MT + 8 * t) * p.pitch +
                            st * GV_BK * ES;
        ldmatrix_x4(xr, *reinterpret_cast<unsigned(*)[4]>(&b[pl][t][0]));
        if constexpr (!A8)
          ldmatrix_x4(xr + 64, *reinterpret_cast<unsigned(*)[4]>(&b[pl][t][4]));
      }
    mbar_wait(&full[s], (it / GV_STAGES) & 1);
    __syncwarp();                         // converged for the .aligned ops
#pragma unroll
    for (int u = 0; u < 2; ++u) {        // 32 rows: one ldmatrix a warp
      unsigned r[4];
      ldmatrix_x4_trans(wa + s * GV_WTILE + u * 32 * MMA_NT, r);
      // f[pl][h]: the A fragment of plane pl's rows 16 h.. of the unit
      // (under ZP built just before its atoms, after the flush before them)
      unsigned f[NP][2][4];
#pragma unroll
      for (int pl = 0; pl < NP && !ZP; ++pl) {
        if constexpr (A8) {
          unsigned c[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            c[j] = INT4 ? sext_nibbles((r[j] >> (4 * pl)) & 0x0F0F0F0Fu) : r[j];
          f[pl][0][0] = __byte_perm(c[0], c[1], 0x6420);
          f[pl][0][1] = __byte_perm(c[0], c[1], 0x7531);
          f[pl][1][0] = __byte_perm(c[2], c[3], 0x6420);
          f[pl][1][1] = __byte_perm(c[2], c[3], 0x7531);
        } else if constexpr (INT4) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned u0 = r[2 * h] ^ 0x88888888u;
            const unsigned u1 = r[2 * h + 1] ^ 0x88888888u;
            f[pl][h][0] = bf16x2_nibbles(u0, 4 * pl);
            f[pl][h][1] = bf16x2_nibbles(u0, 8 + 4 * pl);
            f[pl][h][2] = bf16x2_nibbles(u1, 4 * pl);
            f[pl][h][3] = bf16x2_nibbles(u1, 8 + 4 * pl);
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            f[pl][h][0] = bf16x2_of(r[2 * h], 0, 2);
            f[pl][h][1] = bf16x2_of(r[2 * h], 1, 3);
            f[pl][h][2] = bf16x2_of(r[2 * h + 1], 0, 2);
            f[pl][h][3] = bf16x2_of(r[2 * h + 1], 1, 3);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {      // 16 rows: one atom a plane, tile
        const int j = 2 * u + h;         // the stage's k16 step
        if constexpr (ZP) {
#pragma unroll
          for (int pl = 0; pl < NP; ++pl) {
            unsigned c0 = r[2 * h], c1 = r[2 * h + 1];
            if constexpr (INT4) {
              c0 = sext_nibbles((c0 >> (4 * pl)) & 0x0F0F0F0Fu);
              c1 = sext_nibbles((c1 >> (4 * pl)) & 0x0F0F0F0Fu);
            }
            f[pl][h][0] = bf16x2_of(c0, 0, 2, zc[pl][0]);
            f[pl][h][1] = bf16x2_of(c0, 1, 3, zc[pl][1]);
            f[pl][h][2] = bf16x2_of(c1, 0, 2, zc[pl][0]);
            f[pl][h][3] = bf16x2_of(c1, 1, 3, zc[pl][1]);
          }
        }
#pragma unroll
        for (int pl = 0; pl < NP; ++pl)
#pragma unroll
          for (int t = 0; t < GV_NT; ++t) {
            if constexpr (A8)
              mma_s8(acc[pl][t], f[pl][h][0], f[pl][h][1], b[pl][t][j]);
            else
              mma_bf16(acc[pl][t], f[pl][h], b[pl][t][2 * j],
                       b[pl][t][2 * j + 1]);
          }
        left -= 16;
        if (left == 0) {
          flush();
          left = p.seg;
          const int rn = r0 + it * GV_BK + 16 * j + 16;
          if (rn < rows) load_scales(rn);
        }
      }
    }
    mbar_arrive(&empty[s]);
  }
  flush();
  if (rms) {
#pragma unroll
    for (int t = 0; t < GV_NT; ++t) {
      const float v = warp_sum(ss[t]);
      if (lane == 0) red[warp + 8 * t] = v;
    }
  }
  bar_consumers();                        // red is whole, the ring is free

  if (splits == 1) {
    // the whole K in this block: row factor, bias, residual, cast
#pragma unroll
    for (int t = 0; t < GV_NT; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * t + 2 * q + e;
        if (m >= p.M || na >= p.N) continue;
        const float rf = A8    ? p.xs[m]
                         : rms ? rsqrtf(red[m] / (float)p.K + p.eps)
                               : 1.f;
        gv_store(p, m, na, tot[t][e] * rf, tot[t][2 + e] * rf,
                 na + 1 < p.N);
      }
    return;
  }

  // split K: the cluster's blocks (one a split) meet in distributed
  // shared memory. Each writes its sums [token][128 columns] over its
  // ring; then block rank r sums every r-th share of the tile's outputs
  // over the splits in rank order, applies the row factor (RMSNorm's from
  // the splits' sums of squares), bias and residual, and casts.
  float* part = reinterpret_cast<float*>(wt);
  const int cl = 16 * warp + 2 * gr;
#pragma unroll
  for (int t = 0; t < GV_NT; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * t + 2 * q + e;
      part[m * MMA_NT + cl] = tot[t][e];
      part[m * MMA_NT + cl + 1] = tot[t][2 + e];
    }
  cluster_sync();
  for (int i = split * GV_CONSUMERS + tid; i < p.M * MMA_NT;
       i += splits * GV_CONSUMERS) {
    const int m = i / MMA_NT, n = n0 + i % MMA_NT;
    if (n >= p.N) continue;
    float v = 0.f, ssum = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) {
      v += ld_cluster(part + i, sp);
      if (rms) ssum += ld_cluster(red + m, sp);
    }
    const float rf = A8    ? p.xs[m]
                     : rms ? rsqrtf(ssum / (float)p.K + p.eps)
                           : 1.f;
    gv_store(p, m, n, v * rf, 0.f, false);
  }
  cluster_sync();                         // no block leaves while read
}

int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The GEMV's launch, a cluster of the K splits of each column tile: the
// staged activations' pitch and the shared memory follow from the rows
// staged at once; TMA takes the weight when its rows are 16-byte aligned
// (else cp.async, as wide as N allows).
template <bool A8, bool INT4, bool ZP = false>
cudaError_t launch_gemv(GemvArgs a, int splits, cudaStream_t st) {
  constexpr int NP = INT4 ? 2 : 1;
  const int rows = INT4 ? a.K / 2 : a.K;
  // 16 bytes past whole 128-byte lines: ldmatrix's 8 token rows meet no
  // bank twice
  a.pitch = (a.sub * (A8 ? 1 : 2) + 127) / 128 * 128 + 16;
  const int smem = GV_HEADER + 1024 + GV_STAGES * GV_WTILE +
                   NP * 8 * GV_NT * a.pitch;
  static int sized = 0;
  if (smem > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemv_kernel<A8, INT4, ZP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    sized = smem;
  }
  CUtensorMap wmap;
  const uint64_t dims[2] = {(uint64_t)a.N, (uint64_t)rows};
  const uint64_t pitch[1] = {(uint64_t)a.N};
  const uint32_t box[2] = {MMA_NT, GV_BK};
  a.wtma = a.N % 16 == 0 &&
           tensor_map(&wmap, a.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, dims,
                      pitch, box, CU_TENSOR_MAP_SWIZZLE_128B);
  a.wvec = a.N % 16 == 0 ? 16 : a.N % 8 == 0 ? 8 : a.N % 4 == 0 ? 4 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + MMA_NT - 1) / MMA_NT, splits);
  cfg.blockDim = dim3(GV_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gemv_kernel<A8, INT4, ZP>, wmap, a);
}

}  // namespace

cudaError_t gemv_route(const void* x, long long x_sm, const float* xs,
                       const int8_t* w, const float* scales, const int* zp,
                       bool int4, int group, const bf16* g,
                       const float* bias, const bf16* res, long long res_sm,
                       void* out, int out_f32, int M, int K, int N,
                       int kchunk, int sub, int mode, int gelu, float eps,
                       cudaStream_t st) {
  const int rows = int4 ? K / 2 : K;
  if (kchunk <= 0 || kchunk % 16 || sub <= 0 || sub % GV_BK ||
      (uintptr_t)w % 16 || (rows + kchunk - 1) / kchunk > GV_SPLITS)
    return cudaErrorInvalidValue;
  GemvArgs a{};
  a.x = x;
  a.x_sm = x_sm;
  a.xs = xs;
  a.g = g;
  a.w = w;
  a.scales = scales;
  a.zp = zp;
  a.bias = bias;
  a.res = res;
  a.res_sm = res_sm;
  a.out = out;
  a.M = M;
  a.K = K;
  a.N = N;
  a.group = group ? group : K;
  // a group's rows in either plane are whole multiples of seg (int4: a
  // group may straddle the planes); per-channel, one flush at the end
  a.seg = group ? (int4 ? gcd_int(group, rows) : group)
                : (rows + 15) / 16 * 16;
  a.chunk = kchunk;
  a.sub = sub;
  a.mode = mode;
  a.gelu = gelu;
  a.out_f32 = out_f32;
  a.eps = eps;
  if (a.seg % 16) return cudaErrorInvalidValue;
  if (xs && zp) return cudaErrorInvalidValue;
  auto gemv = xs   ? (int4 ? launch_gemv<true, true>
                           : launch_gemv<true, false>)
              : zp ? (int4 ? launch_gemv<false, true, true>
                           : launch_gemv<false, false, true>)
                   : (int4 ? launch_gemv<false, true>
                           : launch_gemv<false, false>);
  return gemv(a, (rows + kchunk - 1) / kchunk, st);
}
