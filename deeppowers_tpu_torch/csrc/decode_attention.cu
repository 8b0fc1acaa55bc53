// GQA decode attention over a KV cache, reading only the first lengths[b]
// positions of each slot (flash-decoding), for one token a slot (decode) or
// a speculative verify window of T tokens a slot folded into extra query
// rows, in two row layouts and four store variants that share one kernel
// template:
//
//   contiguous  flat (B, S, F) caches. Replaces the Pallas TPU kernel
//               deeppowers_tpu/ops/pallas/decode_attention.py
//               (`decode_attention_mxu` :341, body `_kernel_mxu` :123,
//               pallas_call :470; `verify_attention_mxu` :501 for T > 1),
//               no `layer` operand.
//   paged       (P, page, F) pools read through a (B, WP) page table.
//               Replaces `decode_attention_paged_mxu` :706 (body
//               `_kernel_mxu_paged_db` :526, pallas_call :780;
//               `verify_attention_paged_mxu` :1235 for T > 1).
//
// Store variants (K bits, V bits): bf16 (16, 16); int8 (8, 8) with one f32
// scale per (position, kv head); int4 (4, 4), packed two to a byte
// half-split along D (low nibble feature j, high nibble feature j + D/2)
// with two sub-block scales per (position, head), scale rows 2*head + half;
// k8v4 (8, 4). Scales are head-major: (B, R, S) contiguous, (P, R, page)
// paged, R = Kh or 2*Kh.
//
// What bounds it on an H100: bytes, the live K and V rows read once
// (2 * sum_b(lengths[b]) * F * 2 for bf16; F and F/2 bytes a row for int8
// and int4) plus their scales, q and the output; a verify window reads the
// same rows once for all its T tokens, so its byte bound is decode's.
//
// Design: the TPU grid walks S in order per slot (the paged kernel with a
// double-buffered multi-page DMA), which on a GPU would give 8 slots x 4 kv
// heads = 32 blocks for 132 SMs. Here the grid is (slot, kv head, S split):
// each block owns `chunk` consecutive positions (64; a page of 128 rows is
// two blocks) and serves all R = rep * T query rows of its kv head, so
// every K/V row is read once per group (one warp a row up to 16 rows,
// else four rows a warp, up to 64: a TinyLlama verify window of K + 1 = 5
// tokens has 8 * 5 = 40 rows a kv head, over the 1024 threads a block
// may hold at a warp a row). The `Rows` template parameter maps a virtual
// row to (major, minor): (slot, position) contiguous, (page id, row in
// page) paged. A block first resolves its 32-row tile's rows (through the
// page table when paged, once per tile, into shared memory) together with
// their scales, then stages the tile's K and V in shared memory as f32
// (int8 and nibbles converted exactly; rows past the length load as zero),
// each warp scores its rows against the tile (lane = position; each staged
// K value is read once for all of them), keeps an online softmax per row
// in f32 and accumulates p.V. Quantized stores fold their
// scales: score = (q . k_int) * ks[pos], summed over the two halves with
// their own sub-scales for int4 K, and p * vs[pos] (per V half for int4)
// goes into the p.V product while the softmax sums use p. The arithmetic
// is f32 throughout: the TPU kernel's int8_dots branch, which requantizes q
// and p to int8 for the MXU, is not carried over (int8 mma dots are a
// later redesign). Positions at or past a row's bound (lengths[b], or
// lengths[b] - (T - 1) + t for window token t) are excluded by a select,
// never by multiplying by zero; a row with no visible position in a split
// leaves an empty partial (max -1e30, sum 0) that the combine weighs 0: pages are reused after release and
// padded prompt writes leave rows past the length, so garbage or NaN
// there, in values or in f32 scales, cannot leak (their values and scales
// are staged as zero). A block whose split starts at or past the slot's
// length exits without reading anything. A second small kernel combines
// the per-split (max, sum, acc) partials.
#include "attention_combine.cuh"

namespace {

constexpr int TS = 32;

// Contiguous layout: virtual row s of slot b is (major b, minor s).
struct ContiguousRows {
  __device__ void operator()(int b, int s, long long& major, int& minor) const {
    major = b;
    minor = s;
  }
};

// Paged layout: virtual row s of slot b is row s % page of page
// tab[b, s / page].
struct PagedRows {
  const int* __restrict__ tab;
  int tab_sb, page;
  __device__ void operator()(int b, int s, long long& major, int& minor) const {
    major = tab[(long long)b * tab_sb + s / page];
    minor = s % page;
  }
};

// One cache side. Row (major, minor) starts at element major * msb + minor
// * width of `data` (bf16, int8 or packed bytes; width = the stored row
// width). Its scale of group g is scale[major * ssb + g * srs + minor].
struct Side {
  const void* data;
  long long msb;
  int width;
  const float* scale;
  long long ssb, srs;
};

// Stored elements of one kv head in a row: D, or D/2 packed int4 bytes.
template <int BITS, int D>
__host__ __device__ constexpr int head_width() {
  return BITS == 4 ? D / 2 : D;
}

// Feature d of the kv head whose stored elements start at `off`, as f32.
template <int BITS, int D>
__device__ __forceinline__ float load_val(const void* data, long long off,
                                          int d) {
  if constexpr (BITS == 16) {
    return bf2f(((const bf16*)data)[off + d]);
  } else if constexpr (BITS == 8) {
    return (float)((const int8_t*)data)[off + d];
  } else {
    constexpr int HD = D / 2;
    const int p = ((const int8_t*)data)[off + (d < HD ? d : d - HD)];
    return (float)(d < HD ? ((p & 0xF) ^ 8) - 8 : p >> 4);
  }
}

template <int BITS>
__host__ __device__ constexpr int n_scales() {
  return BITS == 16 ? 0 : (BITS == 4 ? 2 : 1);
}

// Query rows: O = Kh * R rows a slot, R = rep * T per kv head, ordered
// (kv head, query head, window token t) as the TPU kernel folds a verify
// window into its output rows (`_fold_tokens` :488); T = 1 is decode. Row
// t of a window sees the positions below len - (T - 1) + t, where len =
// lens[b] counts the cached rows and the whole window (:262-266).
//
// grid (B, Kh, nsplit), 32 * W threads: warp w serves rows w, w + W, ...
// (at most RPW of them, W * RPW >= R), so the block reads each staged K/V
// tile once for all R rows. Dynamic shared memory (R*D + TS*(D+1) + TS*D
// + 2*W*RPW*TS) floats.
template <int D, int KB, int VB, int RPW, typename Rows>
__global__ void partial_kernel(const bf16* __restrict__ q, long long q_sb,
                               Side k, Side v, Rows rows,
                               const int* __restrict__ lens, int S, int Kh,
                               int R, int T, int chunk, int nsplit,
                               float scale, float* __restrict__ pm,
                               float* __restrict__ pl,
                               float* __restrict__ pacc) {
  constexpr int DJ = D / 32;
  constexpr int NK = n_scales<KB>(), NV = n_scales<VB>();
  // K and V stores of one width share their row offsets (the callers pass
  // equal strides then), so the staging loop reads one offset per element
  constexpr bool SAME = KB == VB;
  extern __shared__ float sm[];
  __shared__ long long koff[TS], voff[TS];
  __shared__ float ksc[TS][2], vsc[TS][2];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nthr = blockDim.x, W = nthr >> 5;
  float* qs = sm;                  // [R][D]
  float* ks = qs + R * D;          // [TS][D + 1]
  float* vs = ks + TS * (D + 1);   // [TS][D]
  float* ps = vs + TS * D;         // [2][W*RPW][TS]: p (times vs, half 0|1)
  const int b = blockIdx.x, kh = blockIdx.y, sp = blockIdx.z;
  const int O = Kh * R;
  const int len = min(lens[b], S);
  const int s0 = sp * chunk;
  const int s1 = min(s0 + chunk, len);
  const long long base = ((long long)b * O + kh * R) * nsplit + sp;

  if (s0 >= len) {                 // past the slot's live rows: read nothing
    for (int i = tid; i < R; i += nthr) {
      pm[base + (long long)i * nsplit] = DPT_NEG_INF;
      pl[base + (long long)i * nsplit] = 0.f;
    }
    for (int i = tid; i < R * D; i += nthr)
      pacc[(base + (long long)(i / D) * nsplit) * D + i % D] = 0.f;
    return;
  }

  for (int i = tid; i < R * D; i += nthr)
    qs[i] = bf2f(q[(long long)b * q_sb + (long long)kh * R * D + i]) * scale;

  // this warp's rows (a row past R repeats row R - 1 and is not stored)
  int row[RPW], vend[RPW];
  float m[RPW], l[RPW], acc[RPW][DJ];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    row[rr] = min(w + rr * W, R - 1);
    // the window token's own bound, cut to this split
    vend[rr] = min(lens[b] - (T - 1) + row[rr] % T, s1);
    m[rr] = DPT_NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[rr][j] = 0.f;
  }

  for (int t0 = s0; t0 < s1; t0 += TS) {
    if (tid < TS) {
      float kq[2] = {0.f, 0.f}, vq[2] = {0.f, 0.f};
      if (t0 + tid < s1) {
        long long major;
        int minor;
        rows(b, t0 + tid, major, minor);
        koff[tid] = major * k.msb + (long long)minor * k.width +
                    kh * head_width<KB, D>();
        if constexpr (!SAME)
          voff[tid] = major * v.msb + (long long)minor * v.width +
                      kh * head_width<VB, D>();
#pragma unroll
        for (int hf = 0; hf < NK; ++hf)
          kq[hf] = k.scale[major * k.ssb + (kh * NK + hf) * k.srs + minor];
#pragma unroll
        for (int hf = 0; hf < NV; ++hf)
          vq[hf] = v.scale[major * v.ssb + (kh * NV + hf) * v.srs + minor];
      }
      ksc[tid][0] = kq[0];
      ksc[tid][1] = kq[1];
      vsc[tid][0] = vq[0];
      vsc[tid][1] = vq[1];
    }
    __syncthreads();
    for (int i = tid; i < TS * D; i += nthr) {
      const int j = i / D, d = i - j * D;
      float kv = 0.f, vv = 0.f;
      if (t0 + j < s1) {
        const long long ko = koff[j];
        kv = load_val<KB, D>(k.data, ko, d);
        vv = load_val<VB, D>(v.data, SAME ? ko : voff[j], d);
      }
      ks[j * (D + 1) + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();
    // scores of every row of the warp against the tile (lane = position):
    // each staged K value is read once for all of them
    float sc[RPW];
    if constexpr (KB == 4) {
      float a0[RPW], a1[RPW];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) a0[rr] = a1[rr] = 0.f;
#pragma unroll 16
      for (int d = 0; d < D / 2; ++d) {
        const float kv = ks[lane * (D + 1) + d];
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr)
          a0[rr] = fmaf(qs[row[rr] * D + d], kv, a0[rr]);
      }
#pragma unroll 16
      for (int d = D / 2; d < D; ++d) {
        const float kv = ks[lane * (D + 1) + d];
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr)
          a1[rr] = fmaf(qs[row[rr] * D + d], kv, a1[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr)
        sc[rr] = a0[rr] * ksc[lane][0] + a1[rr] * ksc[lane][1];
    } else {
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) sc[rr] = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        const float kv = ks[lane * (D + 1) + d];
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr)
          sc[rr] = fmaf(qs[row[rr] * D + d], kv, sc[rr]);
      }
      if constexpr (KB == 8) {
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr) sc[rr] *= ksc[lane][0];
      }
    }
    float alpha[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      // a position at or past the row's bound is excluded by a select; a
      // row whose bound lies before this tile keeps m = NEG_INF, l = 0
      const bool valid = t0 + lane < vend[rr];
      const float s = valid ? sc[rr] : DPT_NEG_INF;
      const float mn = fmaxf(m[rr], warp_max(s));
      const float p = valid ? expf(s - mn) : 0.f;
      alpha[rr] = expf(m[rr] - mn);
      l[rr] = l[rr] * alpha[rr] + warp_sum(p);
      m[rr] = mn;
      float* p0 = ps + (w * RPW + rr) * TS;
      float* p1 = ps + (W * RPW + w * RPW + rr) * TS;
      p0[lane] = NV ? p * vsc[lane][0] : p;
      if constexpr (NV == 2) p1[lane] = p * vsc[lane][1];
    }
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = lane + 32 * jj;
      const int half = (NV == 2 && jj >= DJ / 2) ? W * RPW : 0;
      float a[RPW];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) a[rr] = acc[rr][jj] * alpha[rr];
#pragma unroll 8
      for (int j = 0; j < TS; ++j) {
        const float vv = vs[j * D + d];
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr)
          a[rr] = fmaf(ps[(half + w * RPW + rr) * TS + j], vv, a[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) acc[rr][jj] = a[rr];
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    if (w + rr * W >= R) continue;
    const long long idx = base + (long long)row[rr] * nsplit;
    if (lane == 0) {
      pm[idx] = m[rr];
      pl[idx] = l[rr];
    }
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      pacc[idx * D + lane + 32 * jj] = acc[rr][jj];
  }
}

struct Args {
  const bf16* q;
  long long q_sb;
  const int* lens;
  int B, S, Kh, R, T, chunk;
  float scale;
  float *pm, *pl, *pacc;
  bf16* out;
  cudaStream_t st;
};

// most warps a block runs, and rows a warp serves at most
constexpr int MAX_WARPS = 16, MAX_RPW = 4;

template <int D, int KB, int VB, int RPW, typename Rows>
int launch(const Args& a, const Side& k, const Side& v, Rows rows) {
  const int nsplit = (a.S + a.chunk - 1) / a.chunk;
  const int W = (a.R + RPW - 1) / RPW;
  const size_t smem = (size_t)(a.R * D + TS * (D + 1) + TS * D +
                               2 * W * RPW * TS) * sizeof(float);
  auto kern = partial_kernel<D, KB, VB, RPW, Rows>;
  // past 48 KB with the kernel's static 1 KB (koff, voff, ksc, vsc), the
  // block needs the opt-in (a verify window at D = 128)
  if (smem + 1024 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a.B, a.Kh, nsplit);
  kern<<<grid, 32 * W, smem, a.st>>>(a.q, a.q_sb, k, v, rows, a.lens, a.S,
                                     a.Kh, a.R, a.T, a.chunk, nsplit, a.scale,
                                     a.pm, a.pl, a.pacc);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<<<a.B * a.Kh * a.R, D, 0, a.st>>>(a.pm, a.pl, a.pacc,
                                                   nsplit, D, a.out);
  return (int)cudaGetLastError();
}

// One row a warp while the rows fit in MAX_WARPS warps (decode: R = rep),
// else MAX_RPW (a verify window's folded rows, up to MAX_WARPS * MAX_RPW).
template <int D, int KB, int VB, typename Rows>
int by_rows(const Args& a, const Side& k, const Side& v, Rows rows) {
  if (a.R <= MAX_WARPS) return launch<D, KB, VB, 1>(a, k, v, rows);
  if (a.R <= MAX_WARPS * MAX_RPW)
    return launch<D, KB, VB, MAX_RPW>(a, k, v, rows);
  return (int)cudaErrorInvalidValue;
}

template <int D, typename Rows>
int by_bits(const Args& a, const Side& k, const Side& v, Rows rows, int kb,
            int vb) {
  if (kb == 16 && vb == 16) return by_rows<D, 16, 16>(a, k, v, rows);
  if (kb == 8 && vb == 8) return by_rows<D, 8, 8>(a, k, v, rows);
  if (kb == 4 && vb == 4) return by_rows<D, 4, 4>(a, k, v, rows);
  if (kb == 8 && vb == 4) return by_rows<D, 8, 4>(a, k, v, rows);
  return (int)cudaErrorInvalidValue;
}

template <typename Rows>
int dispatch(const Args& a, const Side& k, const Side& v, Rows rows, int D,
             int kb, int vb) {
  if (D == 64) return by_bits<64>(a, k, v, rows, kb, vb);
  if (D == 128) return by_bits<128>(a, k, v, rows, kb, vb);
  return (int)cudaErrorInvalidValue;
}

// Stored row width of a side: Kh*D (bf16, int8) or Kh*D/2 (packed int4).
int store_width(int Kh, int D, int bits) {
  return bits == 4 ? Kh * D / 2 : Kh * D;
}

// Scale rows of a side: Kh (int8), 2*Kh (int4), 0 (bf16).
int scale_rows(int Kh, int bits) {
  return bits == 16 ? 0 : (bits == 4 ? 2 * Kh : Kh);
}

}  // namespace

// q: (B, O, D) bf16 query rows, O = Kh * rows (rows = rep * tokens a kv
// head, ordered (kv head, query head, window token)), contiguous, slot
// stride q_sb. kc, vc: (B, S, F') stores per k_bits / v_bits (16 bf16, 8
// int8, 4 packed int4), rows contiguous, slot strides k_sb, v_sb in
// elements (a window view of a longer cache; equal when k_bits ==
// v_bits). ks, vs: (B, R', S') f32 head-major scales with slot and row
// strides (ks_sb, ks_rs), (vs_sb, vs_rs), or null for bf16. lens: (B,)
// int32 on the device, the cached rows of each slot including all
// `tokens` rows of its window; window token t sees the first
// lens - (tokens - 1) + t. pm, pl: (B*O*nsplit) f32 and pacc:
// (B*O*nsplit*D) f32 scratch, nsplit = ceil(S / chunk). out: (B, O, D)
// bf16 contiguous. D is 64 or 128; rows <= 64.
extern "C" int dpt_decode_attention(
    const void* q, long long q_sb, const void* kc, long long k_sb,
    const void* vc, long long v_sb, const void* ks, long long ks_sb,
    long long ks_rs, const void* vs, long long vs_sb, long long vs_rs,
    const void* lens, int B, int S, int Kh, int rows, int tokens, int D,
    int k_bits, int v_bits, int chunk, float scale, void* pm, void* pl,
    void* pacc, void* out, void* stream) {
  const Args a{(const bf16*)q, q_sb, (const int*)lens, B, S, Kh, rows,
               tokens, chunk, scale, (float*)pm, (float*)pl, (float*)pacc,
               (bf16*)out, (cudaStream_t)stream};
  const Side k{kc, k_sb, store_width(Kh, D, k_bits), (const float*)ks, ks_sb,
               ks_rs};
  const Side v{vc, v_sb, store_width(Kh, D, v_bits), (const float*)vs, vs_sb,
               vs_rs};
  return dispatch(a, k, v, ContiguousRows{}, D, k_bits, v_bits);
}

// As dpt_decode_attention over paged pools: kp, vp: (P, page, F') stores,
// contiguous; ks, vs: (P, R', page) f32 scale pools, contiguous, or null
// for bf16; tab: (B, WP) int32 page ids, row stride tab_sb; the virtual
// length is S = WP * page. Only page ids of rows below lens[b] are read.
extern "C" int dpt_decode_attention_paged(
    const void* q, long long q_sb, const void* kp, const void* vp,
    const void* ks, const void* vs, const void* tab, int tab_sb, int page,
    const void* lens, int B, int WP, int Kh, int rows, int tokens, int D,
    int k_bits, int v_bits, int chunk, float scale, void* pm, void* pl,
    void* pacc, void* out, void* stream) {
  const Args a{(const bf16*)q, q_sb, (const int*)lens, B, WP * page, Kh,
               rows, tokens, chunk, scale, (float*)pm, (float*)pl,
               (float*)pacc, (bf16*)out, (cudaStream_t)stream};
  const int kw = store_width(Kh, D, k_bits), vw = store_width(Kh, D, v_bits);
  const Side k{kp, (long long)page * kw, kw, (const float*)ks,
               (long long)scale_rows(Kh, k_bits) * page, page};
  const Side v{vp, (long long)page * vw, vw, (const float*)vs,
               (long long)scale_rows(Kh, v_bits) * page, page};
  return dispatch(a, k, v, PagedRows{(const int*)tab, tab_sb, page}, D,
                  k_bits, v_bits);
}
