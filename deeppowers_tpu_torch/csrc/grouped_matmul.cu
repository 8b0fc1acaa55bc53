// Grouped dequant matmul over the cat experts for MoE: rows sorted by
// expert, in tiles of 64 rows that each belong to one expert, times that
// expert's column block of one concatenated quantized weight (int8, or
// int4 in half-split nibbles; group scales; bf16 or dynamic int8
// activations), f32 accumulation.
//
// Replaces the Pallas TPU kernel of deeppowers_tpu/ops/pallas/
// dequant_matmul.py `grouped_dequant_matmul_ncat` :775 (pallas_call :911,
// #10), on the body `_make_kernel` :152 with its a8 `qdot` :198. (#9, over
// stacked experts, runs on the tensor-core kernel of dequant_matmul.cu.)
//
// What bounds it on an H100: at a prefill's row counts the 2*rows*K*N
// operations over the int8 (a8) or bf16 tensor-core peak (Mixtral-8x7B's
// gate|up at 1024 routed rows: 240 GOP, 0.12 ms at 1979 TOP/s); the packed
// weights of the experts that have rows, read once, are a few hundred MB.
//
// Design:
// - Grid (ceil(N / 128), M / 64): a block owns 64 rows x 128 columns. It
//   reads its expert from the device tile table (the TPU kernel's scalar
//   prefetch has no counterpart) and returns at once for a dead tail tile
//   (-1), and offsets its columns by e * n_e in the cat.
// - K is walked inside the block in steps of 32 unpacked rows; unpacked
//   row k of an int4 weight is the low nibble of stored row k (k < K/2) or
//   the high nibble of row k - K/2, so the walk is the same for both widths
//   and a group may straddle the two planes (weight-only). Each step stages
//   the activation tile (64 x 32) and the weight tile (32 x 128, codes
//   sign-extended, transposed so that a fragment's k pairs are adjacent) in
//   shared memory, then 8 warps (2 x 4, each 32 x 32) run mma.sync on it.
// - Weight-only: bf16 x bf16 -> f32 (m16n8k16); codes are exact in bf16.
//   At the end of each scale group the block adds its group sums times the
//   group's column scales into f32 totals.
// - a8: the Pallas body quantizes the activations per (row, nibble plane,
//   scale group), so the quantization happens here, at the start of each
//   group: 4 threads a row take the group's absmax, qs = max(amax, 1e-30) *
//   fl(1/127), and the staging of each activation tile writes
//   rint(x / qs) clipped to +-127 as int8. Products are s8 x s8 -> s32
//   (m16n8k32), exact; at the group's end each sum adds (sum * qs) * s in one
//   fused multiply-add, as the TPU kernel's body adds it.
//   The host takes only weights whose Pallas segments are their groups.
// Simple and right; TMA + wgmma pipelines are later work.
#include "common.cuh"

namespace {

constexpr int GBM = 64;          // rows of a tile (grouped_matmul.BLOCK_M)
constexpr int GBN = 128;         // columns of a block
constexpr int GBK = 32;          // unpacked K rows per step
constexpr int GTHREADS = 256;
constexpr int LD16 = GBK + 8;    // bf16 tile row stride (elements), 80 B
constexpr int LD8 = GBK + 16;    // int8 tile row stride (bytes), 48 B

struct GroupedArgs {
  const bf16* x;         // (M, K) rows
  const int8_t* w;       // stored rows with row stride w_ld
  const float* scales;   // (K / group, ...) with row stride s_ld
  const int* te;         // expert of each 64-row tile, -1 dead
  long long col_es;      // columns between two experts' blocks
  long long w_ld, s_ld;
  int group;
  void* out;             // (M, N) f32 or bf16
  int out_f32;
  int M, K, N;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// code j (0..15) of 16 packed bytes: int8, or the nibble of plane `hi`
template <bool INT4>
__device__ __forceinline__ int code_at(const uint4& u, int j, int hi) {
  const unsigned wv = j < 4 ? u.x : j < 8 ? u.y : j < 12 ? u.z : u.w;
  const int b = j & 3;
  if constexpr (INT4)
    return (int)(wv << (28 - 8 * b - 4 * hi)) >> 28;
  else
    return (int)(wv << (24 - 8 * b)) >> 24;
}

template <bool A8, bool INT4>
__global__ void __launch_bounds__(GTHREADS) grouped_kernel(GroupedArgs a) {
  constexpr int A_BYTES = A8 ? GBM * LD8 : GBM * LD16 * 2;
  constexpr int B_BYTES = A8 ? GBN * LD8 : GBN * LD16 * 2;
  __shared__ __align__(16) unsigned char As[A_BYTES];
  __shared__ __align__(16) unsigned char Bs[B_BYTES];
  __shared__ float qs_s[GBM];

  const int tile = blockIdx.y;
  const int e = a.te[tile];
  if (e < 0) return;
  const int m0 = tile * GBM, n0 = blockIdx.x * GBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm0 = (warp >> 2) * 32, wn0 = (warp & 3) * 32;
  const int8_t* w = a.w + e * a.col_es;
  const float* sc = a.scales + e * a.col_es;
  const int K = a.K, N = a.N, g = a.group;
  const int kst = INT4 ? K / 2 : K;

  float tot[2][4][4];
  float accf[2][4][4];
  int acci[2][4][4];
  float qreg[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        tot[i][j][r] = 0.f;
        accf[i][j][r] = 0.f;
        acci[i][j][r] = 0;
      }

  // activation staging: row ar, 8 columns from ac
  const int ar = tid >> 2, ac = (tid & 3) * 8;
  const bf16* xrow = a.x + (long long)(m0 + ar) * K;
  // weight staging: stored row bk of the step, 16 columns from bc
  const int bk = tid & 31, bc = (tid >> 5) * 16;

  for (int k0 = 0; k0 < K; k0 += GBK) {
    if constexpr (A8) {
      if (k0 % g == 0) {           // a new group: its per-row scales
        float amax = 0.f;
        for (int c = ac; c < g; c += GBK) {
          const uint4 u = *reinterpret_cast<const uint4*>(xrow + k0 + c);
          const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
          for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(bf2f(v[j])));
        }
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
        if ((tid & 3) == 0) qs_s[ar] = fmaxf(amax, 1e-30f) * (1.0f / 127.0f);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) qreg[i][h] = qs_s[wm0 + 16 * i + gid + 8 * h];
      }
    }
    {
      const uint4 u = *reinterpret_cast<const uint4*>(xrow + k0 + ac);
      if constexpr (A8) {
        const bf16* v = reinterpret_cast<const bf16*>(&u);
        const float qs = qs_s[ar];
        unsigned packed[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float q = fminf(fmaxf(rintf(bf2f(v[j]) / qs), -127.f), 127.f);
          packed[j >> 2] |= ((unsigned)(int)q & 0xffu) << (8 * (j & 3));
        }
        *reinterpret_cast<uint2*>(As + ar * LD8 + ac) =
            make_uint2(packed[0], packed[1]);
      } else {
        *reinterpret_cast<uint4*>(As + (ar * LD16 + ac) * 2) = u;
      }
    }
    {
      const int plane = INT4 ? k0 / kst : 0;
      const int srow = k0 - plane * kst + bk;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + bc < N)
        u = *reinterpret_cast<const uint4*>(w + (long long)srow * a.w_ld + n0 +
                                            bc);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = code_at<INT4>(u, j, plane);
        if constexpr (A8)
          Bs[(bc + j) * LD8 + bk] = (unsigned char)(signed char)c;
        else
          reinterpret_cast<bf16*>(Bs)[(bc + j) * LD16 + bk] =
              __int2bfloat16_rn(c);
      }
    }
    __syncthreads();
    if constexpr (A8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned char* ap = As + (wm0 + 16 * i + gid) * LD8 + tig * 4;
        const unsigned af[4] = {*reinterpret_cast<const unsigned*>(ap),
                                *reinterpret_cast<const unsigned*>(ap + 8 * LD8),
                                *reinterpret_cast<const unsigned*>(ap + 16),
                                *reinterpret_cast<const unsigned*>(ap + 8 * LD8 + 16)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned char* bp = Bs + (wn0 + 8 * j + gid) * LD8 + tig * 4;
          mma_s8(acci[i][j], af, *reinterpret_cast<const unsigned*>(bp),
                 *reinterpret_cast<const unsigned*>(bp + 16));
        }
      }
    } else {
      const bf16* A16 = reinterpret_cast<const bf16*>(As);
      const bf16* B16 = reinterpret_cast<const bf16*>(Bs);
#pragma unroll
      for (int ks = 0; ks < GBK; ks += 16) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bf16* ap = A16 + (wm0 + 16 * i + gid) * LD16 + ks + tig * 2;
          const unsigned af[4] = {
              *reinterpret_cast<const unsigned*>(ap),
              *reinterpret_cast<const unsigned*>(ap + 8 * LD16),
              *reinterpret_cast<const unsigned*>(ap + 8),
              *reinterpret_cast<const unsigned*>(ap + 8 * LD16 + 8)};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bf16* bp = B16 + (wn0 + 8 * j + gid) * LD16 + ks + tig * 2;
            mma_bf16(accf[i][j], af, *reinterpret_cast<const unsigned*>(bp),
                     *reinterpret_cast<const unsigned*>(bp + 8));
          }
        }
      }
    }
    __syncthreads();
    if ((k0 + GBK) % g == 0) {     // the end of a group: scale and add
      const float* srow_p = sc + (long long)(k0 / g) * a.s_ld;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn0 + 8 * j + tig * 2;
        float s[2] = {0.f, 0.f};
        if (col < N) {
          s[0] = srow_p[col];
          s[1] = srow_p[col + 1];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if constexpr (A8) {
              tot[i][j][r] = fmaf(__fmul_rn((float)acci[i][j][r],
                                            qreg[i][r >> 1]),
                                  s[r & 1], tot[i][j][r]);
              acci[i][j][r] = 0;
            } else {
              tot[i][j][r] = fmaf(accf[i][j][r], s[r & 1], tot[i][j][r]);
              accf[i][j][r] = 0.f;
            }
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn0 + 8 * j + tig * 2;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long o = (long long)(m0 + wm0 + 16 * i + gid + 8 * h) * N + col;
        if (a.out_f32)
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(a.out) + o) =
              make_float2(tot[i][j][2 * h], tot[i][j][2 * h + 1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(a.out) + o) =
              __floats2bfloat162_rn(tot[i][j][2 * h], tot[i][j][2 * h + 1]);
      }
    }
}

int launch(const GroupedArgs& a, int bits, int a8, void* stream) {
  const dim3 grid((a.N + GBN - 1) / GBN, a.M / GBM);
  const cudaStream_t st = (cudaStream_t)stream;
  if (a8)
    (bits == 4 ? grouped_kernel<true, true> : grouped_kernel<true, false>)
        <<<grid, GTHREADS, 0, st>>>(a);
  else
    (bits == 4 ? grouped_kernel<false, true> : grouped_kernel<false, false>)
        <<<grid, GTHREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// #10. x: (M, K) bf16, contiguous, M a multiple of 64. w: the 2-D cat
// (K[/2], n_total) int8 or packed int4, contiguous, 16-byte aligned, whose
// columns e * n_e .. (e + 1) * n_e are expert e's; scales (K / group,
// n_total) f32. te: (M / 64,) int32 expert per tile, -1 for a dead tile
// (its rows are not written). group: the scale group in unpacked rows (K
// when per-channel), a multiple of 32; a8 weights need every group inside
// one nibble plane. n_e % 16 == 0. out: (M, n_e) f32 when out_f32, else
// bf16.
extern "C" int dpt_grouped_matmul_ncat(const void* x, const void* w,
                                       const void* scales, const void* te,
                                       int bits, int group, int a8, void* out,
                                       int out_f32, int M, int K, int n_e,
                                       int n_total, void* stream) {
  GroupedArgs a{(const bf16*)x, (const int8_t*)w, (const float*)scales,
                (const int*)te, n_e, n_total, n_total, group, out,
                out_f32, M, K, n_e};
  return launch(a, bits, a8, stream);
}
