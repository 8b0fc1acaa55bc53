#pragma once

// GQA decode attention over a KV cache, reading only the first lengths[b]
// positions of each slot (flash-decoding), for one token a slot (decode) or
// a speculative verify window of T tokens a slot folded into extra query
// rows, in three row layouts and four store variants that share one kernel
// template (this header; the entry points are decode_attention.cu's and
// decode_attention_kt.cu's, each source its own nvcc process):
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
//   mirror      the contiguous int8-K caches with the chunk-transposed K
//               mirror kt (B, C, F, 128) beside them (runtime/kvcache.py):
//               chunk c holds positions [128c, 128c + 128) feature-major.
//               Replaces `decode_attention_kt` :1081 (body `_kt_kernel`
//               :845, pallas_call :1132; `verify_attention_kt` :1148 for
//               T > 1). The chunks below full = max((lens[b] - T) / 128,
//               0) are committed: their K is read from kt; everything else
//               (the tail's K, V, the head-major scales, the query rows and
//               their bounds) is the contiguous layout's. Every tail tile
//               whose chunk lies whole below lens[b] ((c + 1) * 128 <=
//               lens[b], the TPU kernel's condition) is written into kt
//               (the flush, below).
//
// Store variants (K bits, V bits): bf16 (16, 16); int8 (8, 8) with one f32
// scale per (position, kv head); int4 (4, 4), packed two to a byte
// half-split along D (low nibble feature j, high nibble feature j + D/2)
// with two sub-block scales per (position, head), scale rows 2*head + half;
// k8v4 (8, 4). Scales are head-major: (B, R, S) contiguous, (P, R, page)
// paged, R = Kh or 2*Kh.
//
// Head dims: 64 and 128, and on the contiguous layout a narrow head of 32
// computed at 64 (template DR = 32, `stored_feature`): the tiles hold each
// stored head's bytes followed by as many zeros, q and the output go
// through the same feature map, and no absmax, code, sum or scale moves.
//
// What bounds it on an H100: bytes, the live K and V rows read once
// (2 * sum_b(lengths[b]) * F * 2 for bf16; F and F/2 bytes a row for int8
// and int4) plus their scales, q and the output; a verify window reads the
// same rows once for all its T tokens, so its byte bound is decode's. The
// arithmetic (4 * D operations a query row and position, on the tensor
// cores) stays far below the 295 operations a byte where they would bound
// it, even with the query rows padded to 16. In practice a call is a few
// microseconds of launch, merge and cluster work plus the longest
// (slot, kv head)'s walk, which is instruction-bound: converting K and V
// to the tensor cores' operands and the softmax, about 700 instructions a
// warp for 16 positions at the 7B's k8v4 heads.
//
// What held the first design (split partials and a second combine
// launch) at 5-36x its bound: a block had one warp a query row, so at
// R = 1 (the 7B's MHA) one warp staged 64 positions x 128 features in 1-
// and 2-byte loads, about 2 KB in flight an SM where 25-40 KB feed HBM;
// each 32-row tile ran load, sync, scores, softmax and p.V as one chain;
// K and V were staged as f32 and multiplied on the CUDA cores; and every
// split wrote R x D f32 partials (zeros past the length too) that a second
// kernel read back, with three scratch tensors allocated a call.
//
// This design, one launch a call, nothing allocated but the output:
//  - grid (nsplit, B * Kh): the S splits of one (slot, kv head) are one
//    thread-block cluster (at most 8, portable), and the blocks take the
//    slots longest first (ranked on the device from the lengths) so that
//    the longest walks start in the first wave. The host planner
//    (`attention_plan` in ops/kernels/decode_attention.py) takes the split
//    count from the shapes alone, never from the lengths: as many splits
//    as one wave of blocks holds while every position group keeps two
//    tiles (TinyLlama's 32 pairs take 4, Mixtral's 64 take 2, the 7B's 256
//    pass a wave alone and take 1). A block whose stretch lies past the
//    slot's length reads nothing and joins the cluster with empty partials
//    (max -1e30, sum 0).
//  - a block is 8 warps: mg = ceil(R / 16) warps a position group (one
//    16-row m tile each, R = rep * T query rows of the kv head) and 8 / mg
//    groups, each walking every group-th 16-position tile of the block's
//    stretch with its own online softmax. The groups merge in shared
//    memory in group order, then the cluster's blocks meet in distributed
//    shared memory and each combines its share of the outputs over the
//    splits in rank order (a fixed order: the same inputs give the same
//    bits).
//  - each group streams its tiles through a cp.async ring of 16-byte
//    copies (3 stages, or as many as it has tiles, so that the ring's
//    shared memory admits more blocks), in the stored form (bf16, int8 or
//    packed int4 bytes) with the f32 scales beside them. Each copy carries
//    its own address, so the paged layout keeps every page size: a tile
//    inside one page (any page a multiple of 16) finds its rows through
//    one table read, any other row through its own, and no tensor map is
//    encoded per call. Rows past the slot's length, and their scales, are
//    zero-filled by the copy (src-size 0), never read. Chunks land
//    XOR-swizzled, so that the fragment loads below meet no bank twice.
//  - both dots run on the tensor cores, mma.sync m16n8k16 -> f32, in
//    FlashAttention-2's register arrangement: query rows are the M side,
//    positions the n8 side of q.K^T with D as its depth (two accumulators
//    of alternate k-steps halve the chain), and the score fragments become
//    p's A fragment for p.V in registers. K comes by ldmatrix (bf16) or as
//    bytes converted exactly in registers: int8 and int4 K meet q in f16
//    (a byte is the mantissa of the f16 1024 + b, two instructions a pair
//    where bf16 takes five; f16 holds the bf16 q exactly in its normal
//    range). V comes by ldmatrix.trans (bf16) or as bytes gathered per
//    position pair (0x4300 | n is the bf16 128 + n for int4). The order of
//    D inside a k-step is free for q.K^T (q's fragments follow K's), and
//    the order of D across p.V's n8 tiles is free too (the output is
//    written back in order), so every thread reads its K and V bytes
//    contiguously. wgmma would need 64-row tiles of queries that decode
//    does not have; at <= 64 query rows the tensor cores are not the
//    limit, so mma.sync serves.
//  - the operands round as the TPU kernel's MXU path rounds them: q *
//    scale in bf16, K and V codes exact, f32 sums; the K scales fold into
//    the f32 scores (int4 K sums its two D halves in two accumulators,
//    one per sub-scale), the softmax sums use p before the V-scale fold.
//    But p (times the V scale where there is one) goes into p.V as two
//    bf16 terms, hi and lo (exact to about 2^-16; twice p.V's mma.sync):
//    rounded once, as the TPU rounds it, an int8 row stood 1.18e-2 of its
//    max from the int8 plain version (which rounds its own normalized
//    probabilities to bf16) on the card, and an int4 row at Mixtral's
//    heads 1.28e-2 from the f32 one (positions whose p.V cancel magnify
//    the rounding), past the 1e-2 gate.
//  - positions at or past a row's bound (lengths[b], or lengths[b] - (T -
//    1) + t for window token t) are excluded by a select, never by
//    multiplying by zero: pages are reused after release and padded
//    prompt writes leave rows past the length, so garbage or NaN there, in
//    values or in f32 scales, cannot leak.
//  - the mirror layout: a committed tile lands feature-major, D lines of
//    its positions (tiles are 16-64 positions, chunks 128: a tile never
//    straddles a chunk), and q.K^T reads it by ldmatrix.trans, the b16
//    pairs of two positions: a thread's register holds two features (the
//    matrix rows, whose lines the lanes address in the int8 order of
//    k_feature) at positions 2g and 2g + 1, and one byte permute a
//    position makes the f16 pair, as for row-major int8 K. So n8 tile nt's
//    column g is position 2g + nt of the 16 (tpos): the bound test, the
//    scale reads and p.V's V rows follow the same order. The tile's lines
//    are swizzled by their quarter of D (kt_swz), so that the eight lines
//    of a matrix meet no bank twice. sm_90 has no 8-bit ldmatrix, and a
//    transpose at the landing would cost a pass and a barrier a tile.
//  - the flush, and why it is race-free: a position group whose tail tile
//    lies in a whole chunk writes the tile's landed K bytes, transposed in
//    4 x 4 byte blocks in registers, to kt[b, c, h*D:(h+1)*D, tile's
//    slice]. Only committed chunks (c < full) are read from kt and only
//    tail chunks (c >= full) are written; the groups write disjoint slices
//    (one kv head, one tile each); the bytes come from k, which nothing in
//    the launch writes. A chunk that a rejected speculative window or a
//    prefix copy left stale heals this way before it becomes committed
//    (runtime/kvcache.py, the mirror's invariant).
//  - the step's new rows (kernels #2, #6 and #8 folded in): a decode or
//    verify call may carry the K/V rows of its step's T tokens a slot, bf16
//    as the model made them, with their positions (and, paged, their pool
//    rows). The launch writes them into the cache before it reads the
//    cache, so the step needs no writer launch of its own. Who writes
//    what: the cluster (b, kv head h) owns head h of slot b's new rows, and
//    inside it the split whose stretch [split * chunk, (split + 1) * chunk)
//    holds position p writes row p's head-h bytes and that head's scale
//    entries (at (slot * R + g) * S + p, or through the pool row); no other
//    block touches those bytes (another head's cluster writes and reads
//    other bytes of the row, another split other positions). A window of T
//    rows may straddle two tiles or two splits: each split writes its own.
//    A position below 0 or at or past S, and a paged row marked invalid or
//    outside the pool, writes nothing, as kv_append.cu's kernels drop it.
//    The bytes are kv_append.cu's (kv_store.cuh, bit for bit).
//    The tail tile must never be read stale: the rows lie inside the
//    length (attended lengths count the step's rows), so the ring's zero-
//    fill does not cover them. The owning block writes its rows to device
//    memory, one warp a (row, side), and meets the block's barrier before
//    it issues its first cp.async; bar.sync orders the writes before every
//    later read of the block's threads, and the copies are such reads
//    (cp.async of this kind runs in the generic proxy). Two later
//    schedules were built and timed against this one and lost in every
//    case (PERF.md section 6): writing after the ring's first copies are
//    issued, when none of them lands a new row (0.7-6.4% slower), and
//    having the position group that walks a row's tile write it just
//    before the group barrier that precedes the copy (up to 1.86x slower
//    at tokens 5: a window's rows serialize onto one group's warps). Dropping the row's
//    stored form into its landed, swizzled tile from registers instead
//    would have to hold those chunks' copies back and place a quantized
//    row's bytes into every store's swizzle. The kt mirror's cache keeps a
//    writer launch (#2) before its attention (#7): its flush reads the
//    tail from the landed tiles, and its route is the layout's.
//  - the int8-dot variant (template flag I8; entry point
//    decode_attention_i8.cu; "3i"): the TPU kernel's `int8_dots` branch
//    (`_kernel_mxu` :196-216, :219-237, :283-301), its default wherever K
//    is stored as int8 bytes (int8, int4, k8v4), contiguous layout only
//    (#5 has no such branch in JAX). Its function: q * scale in f32, qs =
//    max(|row|, 1e-30) * fl(1/127) (XLA's form of JAX's `/ 127.0`), codes
//    rint(q / qs) clipped to +-127; q.K^T as exact s32 sums on
//    mma.sync.m16n8k32 with B straight from the landed int8 tile (s8) or
//    the packed tile's nibbles read as v + 8 (u8, less 8 * the row's code
//    sum of that half): no K code is converted; the K scales and qs in
//    the TPU kernel's order, unfused. p (times its V scale, per half for
//    packed V) is requantized per row over each block of `blk` positions
//    of the TPU kernel's grid (`int8_dots_block`): rs = max(p, 1e-30) *
//    fl(1/127), codes rint(p / rs) in 0..127, and p.V runs on bf16
//    mma.sync of the integer codes (exact in bf16; a 16-position partial
//    is exact in f32), scaled by rs into the f32 accumulator. A block's
//    granule spans the splits of the cluster (TinyLlama's 1024 positions
//    are one block over four splits), so every split walks each block in
//    two passes: the first over K and the scales keeps each position's
//    final score (after qs, the K scales and the mask) in shared memory
//    (i8_smem: R rows of tile + 8 floats a tile; 8-40 KB a block at the
//    served heads) and finds each row's max score and max p * vs relative
//    to it, which meet over the groups in shared memory and over the
//    splits in distributed shared memory (a cluster barrier a block; the
//    maxima are kept by block parity, so one barrier suffices); the second
//    reads V and its scales alone and runs the online softmax on the kept
//    scores in the frame max(m, the block's max), the codes and p.V. A
//    group's items (its tiles' K, then their V, block after block) stream
//    through one ring of 2 * stages stages of K or V: a block's V copies
//    are issued before its barrier and land while it waits, the next
//    block's K while its second pass runs, so the ring ramps once a
//    split. Where a group cannot keep its whole share of a block (many
//    rows a kv head at long S; `int8_dots_keep`), its stages hold K and V
//    and the second pass reads K again for the tiles past `keep`.
//    q is quantized once a block, a warp a row, into shared memory.
//    Zeros (masked p, padding rows of an m tile, zero q) have code 0 and
//    divide 1 by 1 instead: a zero dividend can take IEEE division's slow
//    path, and the padding rows' zeros (15 of 16 rows at the 7B's heads)
//    did. Timed against two walks a block and other designs by
//    `chip_smoke.py --i8-ms` (PERF.md section 6; ms a call past the L2,
//    TinyLlama int8 / 7B k8v4 / Mixtral int8, tokens 1): two walks a
//    block 0.0240 / 0.0928 / 0.0430; this design 0.0187 / 0.0455 /
//    0.0275; K read again in the second pass, one ring (no kept scores)
//    0.0191 / 0.0469 / 0.0289; kept scores with q quantized in every
//    thread and the zeros divided 0.0226 / 0.0753 / 0.0391; q quantized
//    by all the block's threads at once 0.0195 / 0.0508 / 0.0292; twice
//    the plan's tile 0.0189 / 0.0470 / 0.0245 (faster at Mixtral's heads
//    only).
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"
#include "dequant_common.cuh"
#include "kv_store.cuh"
#include "wgmma.cuh"

namespace {

constexpr int STAGES = 3;      // cp.async ring depth of a position group
constexpr int MAX_WARPS = 8;   // mg * pw
constexpr int MAX_SPLITS = 8;  // a portable cluster
constexpr int MAX_ROWS = 64;   // query rows a kv head: 4 m tiles

constexpr int KT_CHUNK = 128;  // positions a chunk of the kt mirror

// The step's new rows, which the launch writes before it reads the cache:
// row t of slot b (T a slot) holds bf16 K at k + b * k_sb + t * k_ts and V
// at v + b * v_sb + t * v_ts (elements), goes to position pos[b * T + t]
// (below 0: nowhere) and, paged, to pool row prow[b * T + t] where
// valid[b * T + t] and the row is below `limit` (P * page). pos null: no
// new rows.
struct NewRows {
  const bf16* k;
  const bf16* v;
  long long k_sb, k_ts, v_sb, v_ts;
  const int* pos;
  const int* prow;
  const bool* valid;
  long long limit;
};

// Contiguous layout: virtual row s of slot b is (major b, minor s).
struct ContiguousRows {
  static constexpr bool kMirror = false;
  __device__ void operator()(int b, int s, long long& major, int& minor) const {
    major = b;
    minor = s;
  }
  // whether the n rows from a multiple of n are consecutive in one major
  __device__ bool whole(int n) const { return true; }
  // where new row i (position p of slot b) goes
  __device__ bool new_row(const NewRows& nr, int b, int i, int p,
                          long long& major, int& minor) const {
    major = b;
    minor = p;
    return true;
  }
};

// Paged layout: virtual row s of slot b is row s % page of page
// tab[b, s / page].
struct PagedRows {
  static constexpr bool kMirror = false;
  const int* __restrict__ tab;
  int tab_sb, page;
  __device__ void operator()(int b, int s, long long& major, int& minor) const {
    major = tab[(long long)b * tab_sb + s / page];
    minor = s % page;
  }
  __device__ bool whole(int n) const { return page % n == 0; }
  // new row i goes to its pool row (`row_ids`'), if valid and in the pool
  __device__ bool new_row(const NewRows& nr, int b, int i, int p,
                          long long& major, int& minor) const {
    const long long r = nr.prow[i];
    if (!nr.valid[i] || r < 0 || r >= nr.limit) return false;
    major = r / page;
    minor = (int)(r % page);
    return true;
  }
};

// Mirror layout: the contiguous rows, and the kt mirror (B, C, F, 128)
// int8 (slot stride C * F * 128, F = Kh * D), read for committed chunks
// and written by the flush.
struct MirrorRows : ContiguousRows {
  static constexpr bool kMirror = true;
  int8_t* kt;
  long long kt_sb;
  int F;
  // the first byte of feature line f of chunk c of slot b
  __device__ int8_t* line(int b, int c, int f) const {
    return kt + b * kt_sb + ((long long)c * F + f) * KT_CHUNK;
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

struct Args {
  const bf16* q;
  long long q_sb;
  const int* lens;
  int S, Kh, R, T;
  int nsplit, chunk;  // splits (the cluster) and positions a split
  int tile;           // positions a ring stage, % 16 == 0
  int pw, mg;         // position groups, warps a group
  int stages;         // ring stages of a group, 1..STAGES
  int svec;           // scales come 16 bytes a copy (else 4)
  float scale;
  bf16* out;
  cudaStream_t st;
  int blk;            // int8-dot path: positions a block of p's granule
  int keep;           // int8-dot path: tiles a group keeps the scores of
};

// The int8-dot path's tiles of one position group in one block of p's
// granule, at most: the split's tiles in the block over the groups.
__host__ __device__ inline int i8_share(const Args& a) {
  const int tiles = a.chunk / a.tile < (a.blk + a.tile - 1) / a.tile
                        ? a.chunk / a.tile
                        : (a.blk + a.tile - 1) / a.tile;
  return (tiles + a.pw - 1) / a.pw;
}

// The int8-dot path's shared memory (bytes): each group's ring of 2 *
// stages stages, a stage a data region (K at 0, and V at `voff`) then the
// scales (K's NK rows of `tile`, then V's), and after the rings the kept
// scores, `keep` tiles of R rows a group (a row padded to tile + 8 floats,
// so that the quads' 8-byte stores meet no bank twice). When the group
// keeps the scores of its whole share of a block a stage holds K or V,
// never both (`compact`); else V's stages carry K again for the tiles
// whose scores were not kept.
struct I8Smem {
  bool compact;
  int data, voff, stage, ring, kept;
};
__host__ __device__ inline I8Smem i8_smem(const Args& a, int khb, int vhb,
                                          int nscales) {
  I8Smem m;
  m.compact = a.keep >= i8_share(a);
  m.data = a.tile * (m.compact ? (khb > vhb ? khb : vhb) : khb + vhb);
  m.voff = m.compact ? 0 : a.tile * khb;
  m.stage = m.data + 4 * a.tile * nscales;
  m.ring = a.pw * 2 * a.stages * m.stage;
  m.kept = a.pw * a.keep * a.R * (a.tile + 8) * 4;
  return m;
}

template <int BITS>
__host__ __device__ constexpr int n_scales() {
  return BITS == 16 ? 0 : (BITS == 4 ? 2 : 1);
}

// Stored bytes of one kv head's row: 2D (bf16), D (int8), D/2 (int4).
template <int BITS, int D>
__host__ __device__ constexpr int head_bytes() {
  return D * BITS / 8;
}

// 16-byte chunk lam of a tile whose rows are CPR chunks, XOR-swizzled
// inside its 128-byte line: by the row for rows of >= 128 bytes, by twice
// the line for shorter rows, so that the fragment loads (eight rows of one
// chunk, or a thread's own bytes of rows 2c + e) meet no bank twice.
template <int CPR>
__device__ __forceinline__ int swz(int lam) {
  const int line = lam >> 3;
  if constexpr (CPR >= 8)
    return lam ^ ((line / (CPR / 8)) & 7);
  else
    return lam ^ ((2 * line) & 7);
}

// 16-byte chunk lam = f * cpl + q of a feature-major (kt) tile: line f of
// cpl chunks, XOR-swizzled by f's quarter of D, so that the eight lines an
// ldmatrix matrix reads (features of two quarters' k_feature pairs, one
// per quarter and pair: f % (D / 4) takes two neighbouring values) meet
// no bank twice
template <int D>
__device__ __forceinline__ int kt_swz(int lam, int f, int cpl) {
  const int qd = f / (D / 4);
  return lam ^ (cpl == 1 ? 2 * qd : cpl == 2 ? (qd & 1) | ((qd & 2) << 1)
                                              : qd);
}

// position of a thread's score element e (0, 1) of n8 tile nt in a 16-
// position sub-block, for thread c of its quad: row-major tiles in order;
// feature-major (kt) tiles give n8 tile nt's column g position 2g + nt
template <bool FM>
__device__ __forceinline__ int tpos(int nt, int e, int c) {
  return FM ? 4 * c + 2 * e + nt : 8 * nt + 2 * c + e;
}

// byte offset of byte `by` of tile row r
template <int CPR>
__device__ __forceinline__ int tile_off(int r, int by) {
  return (swz<CPR>(r * CPR + (by >> 4)) << 4) | (by & 15);
}

// N 32-bit words of tile row r from byte `by` (inside one chunk, or whole
// chunks)
template <int CPR, int N>
__device__ __forceinline__ void lds_words(const unsigned char* t, int r,
                                          int by, unsigned (&w)[N]) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 x =
          *reinterpret_cast<const uint4*>(t + tile_off<CPR>(r, by + 16 * i));
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(t + tile_off<CPR>(r, by));
    w[0] = x.x;
    w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const unsigned*>(t + tile_off<CPR>(r, by));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the n threads of a position group
__device__ __forceinline__ void bar_group(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ unsigned pack_f16(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// bytes (sel & 0xF, (sel >> 8) & 0xF) of u (biased: u ^ 0x80808080) as an
// exact f16 pair: each byte b becomes the mantissa of the f16 1024 + b,
// and one subtraction takes 1152 off (sel 0x4140: bytes 0, 1; 0x4342: 2,
// 3)
__device__ __forceinline__ unsigned f16x2_bytes(unsigned u, unsigned sel) {
  const unsigned v = __byte_perm(u, 0x64646464u, sel);
  unsigned d;
  asm("sub.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(v), "r"(0x64806480u));
  return d;
}

// the nibbles at bits sh and sh + 16 of u (biased: u ^ 0x88888888) as an
// exact f16 pair: 0x6400 | n is the f16 1024 + n, less 1032
__device__ __forceinline__ unsigned f16x2_nibbles(unsigned u, int sh) {
  const unsigned v = ((u >> sh) & 0x000F000Fu) | 0x64006400u;
  unsigned d;
  asm("sub.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(v), "r"(0x64086408u));
  return d;
}

// (x0, x1) as two bf16 pairs whose sum is exact to about 2^-16: hi, and
// lo = the rest
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// D(16 x 8) += A(16 x 32) B(32 x 8): s8 A, s8 or u8 B, exact s32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_s8u8(int (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte i of two words (biased: w ^ 0x80808080) as an exact bf16 pair,
// the first word's in the low half
__device__ __forceinline__ unsigned bf16x2_bytes(unsigned a, unsigned b,
                                                 int i) {
  const float f0 =
      __int_as_float(__byte_perm(a, 0x4B000000u, 0x7440u | i)) - 8388736.f;
  const float f1 =
      __int_as_float(__byte_perm(b, 0x4B000000u, 0x7440u | i)) - 8388736.f;
  return pack_bf16(f0, f1);
}

// The stored feature that feature f of a head computed at width D reads,
// or -1 for a zero. D = DR but for a narrow head (DR = 32, computed at D =
// 64): its stored bytes are followed in the tile by as many zero bytes
// (`copy_side`), so bf16 and int8 features keep their order below DR, and
// a packed int4 byte j, which holds features j and j + D/2 of the wide
// head, holds the stored features j and j + DR/2: the wide head's
// [0, DR/2) and [D/2, D/2 + DR/2) are the stored ones. Zeros change no
// absmax, no code and no sum, so the narrow head's function is unchanged.
template <int BITS, int D, int DR>
__device__ __forceinline__ int stored_feature(int f) {
  if constexpr (DR == D) {
    return f;
  } else if constexpr (BITS == 4) {
    return f < DR / 2 ? f
                      : (f >= D / 2 && f < D / 2 + DR / 2 ? f - D / 2 + DR / 2
                                                          : -1);
  } else {
    return f < DR ? f : -1;
  }
}

// The feature of q.K^T's k index 2c + (i & 1) + 8 (i >> 1) in k-step ks,
// per K store: ldmatrix's order for bf16; for int8 thread c's D/4
// contiguous bytes, four a k-step; for int4 (k-steps 0..D/32-1 the low
// nibbles, the rest the high ones) thread c's D/8 contiguous bytes, whose
// nibble pairs (bytes 0, 2) and (1, 3) a word make b0 and b1.
template <int KB, int D>
__device__ __forceinline__ int k_feature(int ks, int c, int i) {
  if constexpr (KB == 16) {
    return 16 * ks + 2 * c + (i & 1) + 8 * (i >> 1);
  } else if constexpr (KB == 8) {
    return (D / 4) * c + 4 * ks + i;
  } else {
    const int h = ks / (D / 32), kk = ks % (D / 32);
    return h * (D / 2) + (D / 8) * c + 4 * kk + 2 * (i & 1) + (i >> 1);
  }
}

// The feature of q.K^T's k index 4c + (i & 3) + 16 (i >> 2) in k-step ks
// of m16n8k32 (the int8-dot path): thread c's bytes of the stored row,
// eight a k-step (b0 the first word, b1 the second). int8: its D/4
// contiguous bytes; int4 (k-steps 0..D/64-1 the low nibbles, the rest the
// high ones): its D/8 contiguous bytes, a word's four nibbles of one half.
template <int KB, int D>
__device__ __forceinline__ int k_feature_i8(int ks, int c, int i) {
  if constexpr (KB == 8) {
    return (D / 4) * c + 8 * ks + i;
  } else {
    const int h = ks / (D / 64), kk = ks % (D / 64);
    return h * (D / 2) + (D / 8) * c + 8 * kk + i;
  }
}

// The feature of output column n of p.V's n8 tile nt, per V store:
// ldmatrix.trans's order for bf16; thread g's D/8 contiguous bytes for
// int8 (tile nt = byte nt); for int4, tiles 0..D/16-1 the low nibbles of
// thread g's D/16 bytes, the rest the high ones.
template <int VB, int D>
__device__ __forceinline__ int v_feature(int nt, int n) {
  if constexpr (VB == 16) {
    return 8 * nt + n;
  } else if constexpr (VB == 8) {
    return n * (D / 8) + nt;
  } else {
    const int h = nt / (D / 16), j = nt % (D / 16);
    return h * (D / 2) + n * (D / 16) + j;
  }
}

// The slot of rank r when the B slots are ordered by length, longest first
// (ties by index), so that the longest slots' blocks are scheduled first:
// each lane ranks one slot (B <= 32, else slots keep their order).
__device__ __forceinline__ int slot_by_length(const int* lens, int B, int r,
                                              int lane) {
  if (B > 32) return r;
  const int mine = lane < B ? lens[lane] : -1;
  int rank = 0;
  for (int y = 0; y < B; ++y) {
    const int other = __shfl_sync(0xffffffffu, mine, y);
    rank += other > mine || (other == mine && y < lane);
  }
  return __ffs(__ballot_sync(0xffffffffu, lane < B && rank == r)) - 1;
}

// The n live rows (of TL) of one side from virtual row t0 of slot b into a
// tile of CPR-chunk rows, this thread's share of the 16-byte copies: rows
// at the row stride from (major0, minor0) when `whole`, else each row
// through `rows`; the rest zero-filled. A stored head of RCPR < CPR chunks
// (a narrow head computed at twice its width, `stored_feature`) fills the
// first RCPR chunks of each tile row and zeros the rest.
template <int CPR, int RCPR, typename Rows>
__device__ __forceinline__ void copy_side(
    unsigned char* dst, const void* data, long long msb, int width, int esz,
    int hoff, const Rows& rows, bool whole, int b, int t0, int n, int TL,
    long long major0, int minor0, int tid, int nthr) {
  const unsigned char* d0 = (const unsigned char*)data;
  auto row_at = [&](long long major, int minor) {
    return d0 + (major * msb + (long long)minor * width) * esz + hoff;
  };
  const unsigned char* base = row_at(major0, minor0);
  for (int x = tid; x < TL * CPR; x += nthr) {
    const int r = x / CPR, q = x % CPR;
    const bool ok = r < n && q < RCPR;
    const unsigned char* src = base + (long long)r * width * esz;
    if (ok && !whole) {
      long long major;
      int minor;
      rows(b, t0 + r, major, minor);
      src = row_at(major, minor);
    }
    cp_async<16>(dst + 16 * swz<CPR>(x), ok ? src + 16 * q : d0,
                 ok ? 16 : 0);
  }
}

// The committed tile at t0 (TL positions of one chunk, all below the
// length) of kv head kh from kt into a feature-major tile: line f of its D
// features holds the TL positions in TL / 16 chunks (kt_swz); this
// thread's share of the 16-byte copies.
template <int D>
__device__ __forceinline__ void copy_kt(unsigned char* dst,
                                        const MirrorRows& rows, int b, int t0,
                                        int kh, int TL, int tid, int nthr) {
  const int cpl = TL / 16;
  const int8_t* src = rows.line(b, t0 / KT_CHUNK, kh * D) + t0 % KT_CHUNK;
  for (int x = tid; x < D * cpl; x += nthr) {
    const int f = x / cpl;
    cp_async<16>(dst + 16 * kt_swz<D>(x, f, cpl),
                 src + (long long)f * KT_CHUNK + 16 * (x - f * cpl), 16);
  }
}

// The flush of a landed row-major int8 K tile (TL rows of CPR chunks,
// positions t0..t0 + TL of a whole tail chunk) into kt: 4 x 4 byte blocks
// (four positions' words of four features) transposed in registers and
// written as four features' words of four positions; this thread's share.
template <int D, int CPR>
__device__ __forceinline__ void flush_kt(const unsigned char* tile,
                                         const MirrorRows& rows, int b,
                                         int t0, int kh, int TL, int tid,
                                         int nthr) {
  int8_t* dst = rows.line(b, t0 / KT_CHUNK, kh * D) + t0 % KT_CHUNK;
  const int pbs = TL / 4;
  for (int x = tid; x < pbs * (D / 4); x += nthr) {
    const int pb = x % pbs, fb = x / pbs;
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const unsigned*>(tile +
                                                tile_off<CPR>(4 * pb + i,
                                                              4 * fb));
    const unsigned t0w = __byte_perm(w[0], w[1], 0x5140);
    const unsigned t1w = __byte_perm(w[0], w[1], 0x7362);
    const unsigned t2w = __byte_perm(w[2], w[3], 0x5140);
    const unsigned t3w = __byte_perm(w[2], w[3], 0x7362);
    const unsigned o[4] = {__byte_perm(t0w, t2w, 0x5410),
                           __byte_perm(t0w, t2w, 0x7632),
                           __byte_perm(t1w, t3w, 0x5410),
                           __byte_perm(t1w, t3w, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<unsigned*>(dst + (long long)(4 * fb + j) * KT_CHUNK +
                                   4 * pb) = o[j];
  }
}

// One side of a new row's head kh, x its bf16 values, into row (major,
// minor) of the store and the head's scale entries, by one warp.
template <int BITS, int D>
__device__ __forceinline__ void store_new(const Side& s, const bf16* x,
                                          int kh, long long major, int minor,
                                          int lane) {
  constexpr int NS = n_scales<BITS>();
  unsigned char* out = (unsigned char*)s.data +
                       (major * s.msb + (long long)minor * s.width) *
                           (BITS == 16 ? 2 : 1) +
                       kh * head_bytes<BITS, D>();
  float* sc = nullptr;
  if constexpr (NS > 0)
    sc = (float*)s.scale + major * s.ssb + (long long)kh * NS * s.srs + minor;
  store_head<BITS>(x, out, sc, NS == 2 ? sc + s.srs : nullptr, D, lane);
}

// Whether block `split` owns a new row of slot b: a position in [0, S)
// inside its stretch
__device__ __forceinline__ bool owns_new(const NewRows& nr, int i, int S,
                                         int chunk, int split) {
  const int p = nr.pos[i];
  return p >= 0 && p < S && p / chunk == split;
}

// The new rows of slot b, head kh, that block `split` owns: one warp a
// (row, side).
template <int D, int KB, int VB, typename Rows>
__device__ __forceinline__ void write_new_rows(const NewRows& nr,
                                               const Side& k, const Side& v,
                                               const Rows& rows, int b,
                                               int kh, int T, int S,
                                               int chunk, int split) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int x = threadIdx.x >> 5; x < 2 * T; x += nw) {
    const int t = x >> 1, i = b * T + t;
    if (!owns_new(nr, i, S, chunk, split)) continue;
    long long major;
    int minor;
    if (!rows.new_row(nr, b, i, nr.pos[i], major, minor)) continue;
    if (x & 1)
      store_new<VB, D>(v, nr.v + b * nr.v_sb + t * nr.v_ts + kh * D, kh,
                       major, minor, lane);
    else
      store_new<KB, D>(k, nr.k + b * nr.k_sb + t * nr.k_ts + kh * D, kh,
                       major, minor, lane);
  }
}

// p.V's B operands over the 16 positions from rb of a landed V tile: one
// call pv(n8 output tile, V half, b0, b1) a tile. bf16 by ldmatrix.trans;
// int8 and int4 as exact bf16 pairs of the bytes of p's k indices 2c, 2c
// + 1 (b0) and 2c + 8, 2c + 9 (b1): rows rb + 2c + {0, 1, 8, 9}, or rb +
// 4c + {0, 2, 1, 3} in a feature-major tile's order (FM), at one feature.
template <int VB, int D, bool FM, typename PV>
__device__ __forceinline__ void v_operands(const unsigned char* vt, int rb,
                                           int lane, PV&& pv) {
  constexpr int VCPR = head_bytes<VB, D>() / 16;
  constexpr int NO = D / 8;
  const int g = lane >> 2, c = lane & 3;
  if constexpr (VB == 16) {
    const uint32_t base = smem_u32(vt);
#pragma unroll
    for (int nt = 0; nt < NO; nt += 2) {
      unsigned r[4];
      ldmatrix_x4_trans(
          base + tile_off<VCPR>(rb + 8 * ((lane >> 3) & 1) + (lane & 7),
                                16 * (nt + (lane >> 4))),
          r);
      pv(nt, 0, r[0], r[1]);
      pv(nt + 1, 0, r[2], r[3]);
    }
  } else {
    constexpr int VW = (VB == 8 ? D / 8 : D / 16) / 4;
    unsigned w[4][VW];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lds_words<VCPR>(vt, rb + tpos<FM>(e >> 1, e & 1, c), g * 4 * VW, w[e]);
#pragma unroll
      for (int x = 0; x < VW; ++x)
        w[e][x] ^= VB == 8 ? 0x80808080u : 0x88888888u;
    }
    if constexpr (VB == 8) {
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
        pv(nt, 0, bf16x2_bytes(w[0][nt / 4], w[1][nt / 4], nt % 4),
           bf16x2_bytes(w[2][nt / 4], w[3][nt / 4], nt % 4));
    } else {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const unsigned sel = (j % 4) | ((4 + j % 4) << 8);
        const unsigned u0 = __byte_perm(w[0][j / 4], w[1][j / 4], sel);
        const unsigned u1 = __byte_perm(w[2][j / 4], w[3][j / 4], sel);
        pv(j, 0, bf16x2_nibbles(u0, 0), bf16x2_nibbles(u1, 0));
        pv(D / 16 + j, 1, bf16x2_nibbles(u0, 4), bf16x2_nibbles(u1, 4));
      }
    }
  }
}

// Query rows: O = Kh * R rows a slot, R = rep * T per kv head, ordered
// (kv head, query head, window token t) as the TPU kernel folds a verify
// window into its output rows (`_fold_tokens` :488); T = 1 is decode. Row
// t of a window sees the positions below len - (T - 1) + t, where len =
// lens[b] counts the cached rows and the whole window (:262-266).
//
// The mirror layout (int8 K only) reads committed tiles feature-major
// (FM) and row-major tiles as the contiguous layout does; a tile is one or
// the other, so the choice is made per tile.
//
// grid (nsplit, B * Kh), cluster (nsplit, 1, 1), 32 * mg * pw threads.
// Dynamic shared memory: the groups' rings, pw * stages stages of tile *
// (K, V and scale bytes a row), reused at the end for the groups'
// partials (pw * R * (D + 2) + 2 * R floats); the int8-dot path's rings
// and kept scores are `i8_smem`'s, its exchange and q's codes follow.
// The kernels below launch it: `attention_kernel`, and the int8-dot path's
// `attention_kernel_i8`.
template <int D, int KB, int VB, typename Rows, bool I8, int DR>
__device__ __forceinline__ void attention_body(const Args a, const Side k,
                                               const Side v, const Rows rows,
                                               const NewRows nr) {
  static_assert(!I8 || (KB != 16 && !Rows::kMirror),
                "the int8-dot path takes contiguous int8-byte K");
  static_assert(DR == D || !Rows::kMirror, "narrow heads: no kt mirror");
  constexpr int KHB = head_bytes<KB, D>(), VHB = head_bytes<VB, D>();
  constexpr int KCPR = KHB / 16, VCPR = VHB / 16;
  // the stored head's chunks a row (DR < D: a narrow head, zero-padded)
  constexpr int KRC = head_bytes<KB, DR>() / 16;
  constexpr int VRC = head_bytes<VB, DR>() / 16;
  constexpr int NK = n_scales<KB>(), NV = n_scales<VB>();
  constexpr int KE = KB == 16 ? 2 : 1, VE = VB == 16 ? 2 : 1;
  constexpr int KS = D / 16;   // k-steps of q.K^T
  constexpr int NO = D / 8;    // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char sm[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int mg = warp % a.mg, pg = warp / a.mg;
  const int split = blockIdx.x;
  const int kh = blockIdx.y % a.Kh;
  const int b = slot_by_length(a.lens, gridDim.y / a.Kh, blockIdx.y / a.Kh,
                               lane);
  const int lb = a.lens[b];
  const int len = max(0, min(lb, a.S));
  // the mirror's committed positions: [0, full * KT_CHUNK)
  const int kt_end = Rows::kMirror ? max((lb - a.T) / KT_CHUNK, 0) * KT_CHUNK
                                   : 0;
  const int s0 = split * a.chunk, s1 = min(s0 + a.chunk, len);
  const int TL = a.tile;
  // the step's new rows this block owns, in the cache before any copy
  if constexpr (!Rows::kMirror) {
    if (nr.pos != nullptr) {
      bool owns = false;
      for (int t = 0; t < a.T; ++t)
        owns |= owns_new(nr, b * a.T + t, a.S, a.chunk, split);
      if (owns) {
        write_new_rows<DR, KB, VB>(nr, k, v, rows, b, kh, a.T, a.S, a.chunk,
                                   split);
        __syncthreads();
      }
    }
  }
  const int kbytes = TL * KHB, vbytes = TL * VHB;
  const int stage = kbytes + vbytes + 4 * TL * (NK + NV);
  unsigned char* ring = sm + pg * a.stages * stage;
  const int gthr = 32 * a.mg, gtid = tid - pg * gthr;
  const int ntiles = s1 > s0 ? (s1 - s0 + TL - 1) / TL : 0;
  const int mine = ntiles > pg ? (ntiles - pg + a.pw - 1) / a.pw : 0;

  // this thread's two query rows of the warp's m tile
  const int r0 = 16 * mg + g, r1 = r0 + 8;
  const int bound0 = lb - (a.T - 1) + r0 % a.T;
  const int bound1 = lb - (a.T - 1) + r1 % a.T;
  float m0 = DPT_NEG_INF, m1 = DPT_NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  // tile i of this group (positions t0..t0 + TL) into its ring stage:
  // K and V rows in 16-byte copies, then the scales; rows past the
  // block's stretch (which ends at the length or at a whole tile) are
  // zero-filled, their table entries and scales never read. A tile that
  // lies in one page (or slot) finds its rows through one table read.
  const bool whole = rows.whole(TL);
  // tile j of the block's stretch: its K rows into kd and its V rows into
  // vd (the int8-dot path's items: each unless null), and its scale rows
  // from hf0 on (K's NK, then V's NV, TL floats each) into sd
  auto load_at = [&](int j, unsigned char* kd, unsigned char* vd, float* sd,
                     int hf0) {
    const int t0 = s0 + j * TL;
    const int n = min(TL, s1 - t0);
    long long major0 = 0;
    int minor0 = 0;
    if (whole) rows(b, t0, major0, minor0);
    auto k_rows = [&] {
      copy_side<KCPR, KRC>(kd, k.data, k.msb, k.width, KE,
                           kh * head_bytes<KB, DR>(), rows, whole, b, t0, n,
                           TL, major0, minor0, gtid, gthr);
    };
    if (!I8 || kd != nullptr) {
      if constexpr (Rows::kMirror) {
        if (t0 < kt_end)
          copy_kt<D>(kd, rows, b, t0, kh, TL, gtid, gthr);
        else
          k_rows();
      } else {
        k_rows();
      }
    }
    if (!I8 || vd != nullptr)
      copy_side<VCPR, VRC>(vd, v.data, v.msb, v.width, VE,
                           kh * head_bytes<VB, DR>(), rows, whole, b, t0, n,
                           TL, major0, minor0, gtid, gthr);
    if constexpr (NK + NV > 0) {
      const int per = a.svec ? TL / 4 : TL;
      for (int x = gtid + (I8 ? hf0 * per : 0); x < (NK + NV) * per;
           x += gthr) {
        const int hf = x / per, j = (x - hf * per) * (a.svec ? 4 : 1);
        const int cnt = max(0, min(a.svec ? 4 : 1, n - j));
        const bool isk = hf < NK;
        const float* src = isk ? k.scale : v.scale;
        if (cnt) {
          long long major = major0;
          int minor = minor0 + j;
          if (!whole) rows(b, t0 + j, major, minor);
          src += major * (isk ? k.ssb : v.ssb) +
                 (isk ? kh * NK + hf : kh * NV + hf - NK) *
                     (isk ? k.srs : v.srs) +
                 minor;
        }
        if (a.svec)
          cp_async<16>(sd + hf * TL + j, src, 4 * cnt);
        else
          cp_async<4>(sd + hf * TL + j, src, 4 * cnt);
      }
    }
  };
  // tile i of this group into its ring stage
  auto load = [&](int i) {
    unsigned char* st = ring + (i % a.stages) * stage;
    load_at(pg + i * a.pw, st, st + kbytes,
            reinterpret_cast<float*>(st + kbytes + vbytes), 0);
  };

  if constexpr (I8) {
    // The int8-dot path (the TPU kernel's `int8_dots`, _kernel_mxu
    // :196-216, :219-237, :283-301): q quantized per row, exact s8 / u8
    // dots for q.K^T, p requantized per row and per JAX block of a.blk
    // positions. A block's granule may span the cluster's splits, so each
    // block takes two passes over this split's tiles in it: the first
    // reads K and the scales, keeps each position's final score and finds
    // each row's max score and max of p times the V scale (relative to
    // that max), met across the groups in shared memory and across the
    // splits in distributed shared memory; the second reads V and its
    // scales and runs the online softmax on the kept scores, the codes and
    // p.V. Both passes of every block stream through one ring a group.
    constexpr int KS8 = D / 32;           // m16n8k32 k-steps over D
    constexpr int NP = NV == 2 ? 2 : 1;   // p granules: one per V half
    const int R = a.R;
    const int bs = a.blk;
    const int nblk = len > 0 ? (len + bs - 1) / bs : 0;
    const I8Smem ism = i8_smem(a, KHB, VHB, NK + NV);
    const int RS = 2 * a.stages;          // the ring's stages
    const int KP = TL + 8;                // floats a kept score row
    // a padding row of the m tile (r >= R) sees no position: its scores
    // are masked and its p is 0
    const int ib0 = r0 < R ? bound0 : 0, ib1 = r1 < R ? bound1 : 0;
    unsigned char* iring = sm + pg * RS * ism.stage;
    float* kept = reinterpret_cast<float*>(sm + ism.ring) +
                  (long long)pg * a.keep * R * KP;
    // this group's tiles of block kb: the first, jf, and how many, n
    auto share = [&](int kb, int& jf, int& n) {
      const int lo = kb * bs - s0, hi = lo + bs;
      const int jlo = lo <= 0 ? 0 : min(ntiles, (lo + TL - 1) / TL);
      const int jhi = hi <= 0 ? 0 : min(ntiles, (hi + TL - 1) / TL);
      jf = jlo + ((pg - jlo) % a.pw + a.pw) % a.pw;
      n = jf < jhi ? (jhi - jf + a.pw - 1) / a.pw : 0;
    };
    // The ring's items in order: for each block, its pass-1 items (K and
    // every scale of each of the group's tiles in it), then its pass-2
    // items (V and its scales; K and its scales again for a tile at or
    // past `keep`, whose scores were not kept). The producer's cursor
    // (block pk, pass pv, item pi of pn from tile pjf) runs RS - 1 items
    // ahead of the consumer, across the passes and the blocks: a block's V
    // lands while its exchange waits, the next block's K while its pass 2
    // runs.
    int pk = 0, pv = 0, pi = 0, pjf = 0, pn = 0, issued = 0, taken = 0;
    auto seek = [&] {
      for (; pk < nblk; ++pk) {
        share(pk, pjf, pn);
        if (pn) break;
      }
    };
    auto produce = [&] {
      if (pk < nblk) {
        unsigned char* st = iring + (issued++ % RS) * ism.stage;
        const bool with_k = !pv || pi >= a.keep;
        load_at(pjf + pi * a.pw, with_k ? st : nullptr,
                pv ? st + ism.voff : nullptr,
                reinterpret_cast<float*>(st + ism.data), with_k ? 0 : NK);
        if (++pi == pn) {
          pi = 0;
          if (!pv) {
            pv = 1;
          } else {
            pv = 0;
            ++pk;
            seek();
          }
        }
      }
      cp_async_commit();
    };
    // the next item's stage, once it landed and the group consumed the one
    // before (whose stage takes the item RS - 1 ahead)
    auto next = [&]() -> const unsigned char* {
      if (RS >= 6)
        cp_async_wait<4>();
      else if (RS >= 4)
        cp_async_wait<2>();
      else
        cp_async_wait<0>();
      bar_group(1 + pg, gthr);
      produce();
      return iring + (taken++ % RS) * ism.stage;
    };
    seek();
    for (int i = 0; i < RS - 1; ++i) produce();
    // the exchange, past the rings, the kept scores and the partials: each
    // group's (max, max p.vs per half) a row, then the block's, by block
    // parity; then q's codes
    const int part_b = (a.pw * R * (D + 2) + 2 * R) * 4;
    const int used_b = ism.ring + ism.kept;
    float* xg = reinterpret_cast<float*>(
        sm + ((used_b > part_b ? used_b : part_b) + 15) / 16 * 16);
    float* xb = xg + a.pw * R * 3;
    // q quantized once a block, a warp a row (a rolled loop: the same
    // work unrolled in every thread, 16 rows an m tile whatever R, took a
    // third of the 7B's call, PERF.md section 6): x = q * scale in f32,
    // qs = max(max|x|, 1e-30) * fl(1/127) (XLA's `/ 127.0`), codes
    // rint(x / qs) clipped to +-127 into qcd (R rows of D), qs into qsr
    // and, for int4 K, 8 * the code sum of each D half into qhs
    signed char* qcd = reinterpret_cast<signed char*>(xg) +
                       ((a.pw * R + 2 * R) * 3 * 4 + 15) / 16 * 16;
    float* qsr = reinterpret_cast<float*>(qcd + R * D);
    float* qhs = qsr + R;
    {
      constexpr int PL = D / 32;   // features a lane
      const bf16* qb = a.q + (long long)b * a.q_sb + (long long)kh * R * DR;
      for (int r = warp; r < R; r += a.mg * a.pw) {
        float x[PL], am = 0.f;
#pragma unroll
        for (int i = 0; i < PL; ++i) {
          const int rf = stored_feature<KB, D, DR>(lane * PL + i);
          x[i] = rf < 0 ? 0.f : bf2f(qb[r * DR + rf]) * a.scale;
          am = fmaxf(am, fabsf(x[i]));
        }
        const float qsv = fmaxf(warp_max(am), 1e-30f) * (1.f / 127.f);
        int sum = 0;
#pragma unroll
        for (int i = 0; i < PL; ++i) {
          // a zero has code 0 and divides 1 by 1 instead: a zero dividend
          // can take IEEE division's slow path
          const bool z = x[i] == 0.f;
          const float qt = (z ? 1.f : x[i]) / (z ? 1.f : qsv);
          const int code =
              z ? 0 : (int)fminf(fmaxf(rintf(qt), -127.f), 127.f);
          qcd[r * D + lane * PL + i] = (signed char)code;
          sum += code;
        }
        if constexpr (KB == 4) {   // lanes 0-15 hold the first half
#pragma unroll
          for (int o = 1; o < 16; o <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
          if (lane % 16 == 0) qhs[2 * r + lane / 16] = 8.f * (float)sum;
        }
        if (lane == 0) qsr[r] = qsv;
      }
    }
    __syncthreads();
    // this thread's rows as A fragments (k_feature_i8's order: four
    // consecutive features a word); padding rows 0
    unsigned qa[KS8][4];
    float qs[2], qsum8[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0;
      qs[h] = r < R ? qsr[r] : 1.f;
#pragma unroll
      for (int ks = 0; ks < KS8; ++ks)
#pragma unroll
        for (int w = 0; w < 2; ++w)   // rows g, g + 8; k 4c.., 16 + 4c..
          qa[ks][2 * w + h] =
              r < R ? *reinterpret_cast<const unsigned*>(
                          qcd + r * D + k_feature_i8<KB, D>(ks, c, 4 * w))
                    : 0u;
      if constexpr (KB == 4) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          qsum8[hf][h] = r < R ? qhs[2 * r + hf] : 0.f;
      }
    }
    // scores of rows r0 (e 0, 1) and r1 (e 2, 3) at positions rb + 8 nt +
    // 2c + (e & 1) of a landed tile: exact integer dots, the scales in the
    // TPU kernel's order (no contraction), positions past a bound masked
    auto scores = [&](const unsigned char* kt, const float* ksc, int t0,
                      int rb, float(&s)[2][4]) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        int d0[4] = {0, 0, 0, 0}, d1[4] = {0, 0, 0, 0};
        if constexpr (KB == 8) {
          unsigned w[D / 16];
          lds_words<KCPR>(kt, rb + 8 * nt + g, c * (D / 4), w);
#pragma unroll
          for (int ks = 0; ks < KS8; ++ks)
            mma_s8(d0, qa[ks], w[2 * ks], w[2 * ks + 1]);
        } else {
          // nibbles read as v + 8 (0..15), the dot less 8 * the code sum
          unsigned w[D / 32];
          lds_words<KCPR>(kt, rb + 8 * nt + g, c * (D / 8), w);
#pragma unroll
          for (int kk = 0; kk < D / 64; ++kk) {
            const unsigned u0 = w[2 * kk], u1 = w[2 * kk + 1];
            mma_s8u8(d0, qa[kk], (u0 & 0x0F0F0F0Fu) ^ 0x08080808u,
                     (u1 & 0x0F0F0F0Fu) ^ 0x08080808u);
            mma_s8u8(d1, qa[D / 64 + kk],
                     ((u0 >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                     ((u1 >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, j = rb + 8 * nt + 2 * c + (e & 1);
          float x;
          if constexpr (KB == 8) {
            x = __fmul_rn(__fmul_rn((float)d0[e], qs[h]), ksc[j]);
          } else {
            const float x0 = (float)d0[e] - qsum8[0][h];
            const float x1 = (float)d1[e] - qsum8[1][h];
            x = __fmul_rn(
                __fadd_rn(__fmul_rn(x0, ksc[j]), __fmul_rn(x1, ksc[TL + j])),
                qs[h]);
          }
          s[nt][e] = t0 + j < (h ? ib1 : ib0) ? x : DPT_NEG_INF;
        }
      }
    };
    // a tile's scores kept (kp: its R rows of KP floats) and read back, by
    // the thread that computed them; rows past R read as masked
    auto keep_scores = [&](float* kp, int rb, const float(&s)[2][4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? r1 : r0;
        if (r < R) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            *reinterpret_cast<float2*>(kp + r * KP + rb + 8 * nt + 2 * c) =
                make_float2(s[nt][2 * h], s[nt][2 * h + 1]);
        }
      }
    };
    auto kept_scores = [&](const float* kp, int rb, float(&s)[2][4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? r1 : r0;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float2 x = make_float2(DPT_NEG_INF, DPT_NEG_INF);
          if (r < R)
            x = *reinterpret_cast<const float2*>(kp + r * KP + rb + 8 * nt +
                                                 2 * c);
          s[nt][2 * h] = x.x;
          s[nt][2 * h + 1] = x.y;
        }
      }
    };
    auto xload = [&](const float* p, int rank) {
      return a.nsplit > 1 ? ld_cluster(p, rank) : *p;
    };
    for (int kb = 0; kb < nblk; ++kb) {
      const int par = kb & 1;
      int jf, n;
      share(kb, jf, n);
      // pass 1: per row, the max score ml and the max of exp(s - ml) * vs
      float ml[2] = {DPT_NEG_INF, DPT_NEG_INF};
      float wl[NP][2];
#pragma unroll
      for (int hv = 0; hv < NP; ++hv) wl[hv][0] = wl[hv][1] = 0.f;
      for (int i = 0; i < n; ++i) {
        const unsigned char* kt = next();
        const int t0 = s0 + (jf + i * a.pw) * TL;
        const int nsub = min(TL, s1 - t0 + 15) >> 4;
        const float* ksc = reinterpret_cast<const float*>(kt + ism.data);
        const float* vsc = ksc + NK * TL;
        for (int sb = 0; sb < nsub; ++sb) {
          float sc[2][4];
          scores(kt, ksc, t0, 16 * sb, sc);
          if (i < a.keep) keep_scores(kept + i * R * KP, 16 * sb, sc);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float mx = fmaxf(fmaxf(sc[0][2 * h], sc[0][2 * h + 1]),
                                   fmaxf(sc[1][2 * h], sc[1][2 * h + 1]));
            if (mx > ml[h]) {
              const float f = __expf(ml[h] - mx);
#pragma unroll
              for (int hv = 0; hv < NP; ++hv) wl[hv][h] *= f;
              ml[h] = mx;
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int j = 16 * sb + 8 * nt + 2 * c + e;
                if (t0 + j < (h ? ib1 : ib0)) {
                  const float p = __expf(sc[nt][2 * h + e] - ml[h]);
#pragma unroll
                  for (int hv = 0; hv < NP; ++hv)
                    wl[hv][h] = fmaxf(wl[hv][h], p * vsc[hv * TL + j]);
                }
              }
          }
        }
      }
      // the quad's, then the block's groups (in order), then the splits'
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float M = ml[h];
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1)
          M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
        const int r = h ? r1 : r0;
#pragma unroll
        for (int hv = 0; hv < NP; ++hv) {
          float W = wl[hv][h] * __expf(ml[h] - M);
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1)
            W = fmaxf(W, __shfl_xor_sync(0xffffffffu, W, o));
          if (c == 0 && r < R) xg[(pg * R + r) * 3 + 1 + hv] = W;
        }
        if (c == 0 && r < R) xg[(pg * R + r) * 3] = M;
      }
      __syncthreads();
      if (tid < R) {
        float M = DPT_NEG_INF, W[2] = {0.f, 0.f};
        for (int p = 0; p < a.pw; ++p) M = fmaxf(M, xg[(p * R + tid) * 3]);
        for (int p = 0; p < a.pw; ++p) {
          const float* x = xg + (p * R + tid) * 3;
          const float f = __expf(x[0] - M);
#pragma unroll
          for (int hv = 0; hv < NP; ++hv) W[hv] = fmaxf(W[hv], x[1 + hv] * f);
        }
        float* y = xb + (par * R + tid) * 3;
        y[0] = M;
        y[1] = W[0];
        y[2] = W[1];
      }
      if (a.nsplit > 1)
        cluster_sync();
      else
        __syncthreads();
      // pass 2 in the frame m = max(m, the block's max), rs per row and
      // granule: the block's max of p * vs in that frame, / 127
      float rsv[NP][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? r1 : r0;
        float Ms[MAX_SPLITS], Ws[NP][MAX_SPLITS];
        float Mb = DPT_NEG_INF, Wb[NP];
#pragma unroll
        for (int hv = 0; hv < NP; ++hv) Wb[hv] = 0.f;
        if (r < R) {
#pragma unroll
          for (int sp = 0; sp < MAX_SPLITS; ++sp) {
            Ms[sp] = DPT_NEG_INF;
#pragma unroll
            for (int hv = 0; hv < NP; ++hv) Ws[hv][sp] = 0.f;
            if (sp < a.nsplit) {
              const float* y = xb + (par * R + r) * 3;
              Ms[sp] = xload(y, sp);
#pragma unroll
              for (int hv = 0; hv < NP; ++hv)
                Ws[hv][sp] = xload(y + 1 + hv, sp);
            }
          }
#pragma unroll
          for (int sp = 0; sp < MAX_SPLITS; ++sp) Mb = fmaxf(Mb, Ms[sp]);
#pragma unroll
          for (int sp = 0; sp < MAX_SPLITS; ++sp) {
            const float f = __expf(Ms[sp] - Mb);
#pragma unroll
            for (int hv = 0; hv < NP; ++hv)
              Wb[hv] = fmaxf(Wb[hv], Ws[hv][sp] * f);
          }
        }
        float& m = h ? m1 : m0;
        float& l = h ? l1 : l0;
        const float mn = fmaxf(m, Mb), al = __expf(m - mn);
        m = mn;
        l *= al;
#pragma unroll
        for (int nt = 0; nt < NO; ++nt) {
          acc[nt][2 * h] *= al;
          acc[nt][2 * h + 1] *= al;
        }
#pragma unroll
        for (int hv = 0; hv < NP; ++hv) {
          rsv[hv][h] =
              fmaxf(Wb[hv] * __expf(Mb - mn), 1e-30f) * (1.f / 127.f);
        }
      }
      // pass 2: V and its scales; the kept scores (or, past the `keep`,
      // K again)
      for (int i = 0; i < n; ++i) {
        const unsigned char* kt = next();
        const int t0 = s0 + (jf + i * a.pw) * TL;
        const int nsub = min(TL, s1 - t0 + 15) >> 4;
        const unsigned char* vt = kt + ism.voff;
        const float* ksc = reinterpret_cast<const float*>(kt + ism.data);
        const float* vsc = ksc + NK * TL;
        for (int sb = 0; sb < nsub; ++sb) {
          const int rb = 16 * sb;
          float sc[2][4];
          if (i < a.keep)
            kept_scores(kept + i * R * KP, rb, sc);
          else
            scores(kt, ksc, t0, rb, sc);
          // p, its sums, and its codes per granule as p.V's A fragments
          unsigned pa[NP][4];
          float cd[NP][2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1, j = rb + 8 * nt + 2 * c + (e & 1);
              const float p = t0 + j < (h ? ib1 : ib0)
                                  ? __expf(sc[nt][e] - (h ? m1 : m0))
                                  : 0.f;
              if (h)
                l1 += p;
              else
                l0 += p;
              // a zero p (masked, or a padding row's) has code 0 and
              // divides 1 by 1 instead, as q's zeros do (0 / 1 alone was
              // slower still)
              const bool z = !(p > 0.f);
#pragma unroll
              for (int hv = 0; hv < NP; ++hv) {
                const float qt = (z ? 1.f : p * vsc[hv * TL + j]) /
                                 (z ? 1.f : rsv[hv][h]);
                cd[hv][nt][e] = z ? 0.f : fminf(rintf(qt), 127.f);
              }
            }
#pragma unroll
          for (int hv = 0; hv < NP; ++hv) {
            pa[hv][0] = pack_bf16(cd[hv][0][0], cd[hv][0][1]);
            pa[hv][1] = pack_bf16(cd[hv][0][2], cd[hv][0][3]);
            pa[hv][2] = pack_bf16(cd[hv][1][0], cd[hv][1][1]);
            pa[hv][3] = pack_bf16(cd[hv][1][2], cd[hv][1][3]);
          }
          // the codes' exact dot over these 16 positions, then times rs
          auto pv = [&](float(&d)[4], int hv, unsigned b0, unsigned b1) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(t, pa[hv], b0, b1);
            d[0] = fmaf(t[0], rsv[hv][0], d[0]);
            d[1] = fmaf(t[1], rsv[hv][0], d[1]);
            d[2] = fmaf(t[2], rsv[hv][1], d[2]);
            d[3] = fmaf(t[3], rsv[hv][1], d[3]);
          };
          v_operands<VB, D, false>(
              vt, rb, lane, [&](int nt, int h, unsigned b0, unsigned b1) {
                pv(acc[nt], h, b0, b1);
              });
        }
      }
    }
  } else if (mine > 0) {
    for (int i = 0; i < a.stages - 1; ++i) {
      if (i < mine) load(i);
      cp_async_commit();
    }
    // q * scale in bf16, as A fragments in K's feature order
    unsigned qa[KS][4];
    {
      const bf16* qb = a.q + (long long)b * a.q_sb + (long long)kh * a.R * DR;
      auto qv = [&](int r, int ks, int i) {
        const int f = stored_feature<KB, D, DR>(k_feature<KB, D>(ks, c, i));
        return r < a.R && f >= 0 ? round_bf16(bf2f(qb[r * DR + f]) * a.scale)
                                 : 0.f;
      };
      // bf16 against bf16 K; f16 against int8 or int4 K (the bf16 value
      // again, exactly, in f16's normal range)
      auto pack = [](float lo, float hi) {
        if constexpr (KB == 16)
          return pack_bf16(lo, hi);
        else
          return pack_f16(lo, hi);
      };
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        qa[ks][0] = pack(qv(r0, ks, 0), qv(r0, ks, 1));
        qa[ks][1] = pack(qv(r1, ks, 0), qv(r1, ks, 1));
        qa[ks][2] = pack(qv(r0, ks, 2), qv(r0, ks, 3));
        qa[ks][3] = pack(qv(r1, ks, 2), qv(r1, ks, 3));
      }
    }
    for (int i = 0; i < mine; ++i) {
      // a ring of one stage loads its tile here, after the last one's use
      if (a.stages == 1) {
        if (i) bar_group(1 + pg, gthr);
        load(i);
        cp_async_commit();
      }
      if (a.stages >= 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      bar_group(1 + pg, gthr);  // tile i landed; tile i - 1 is consumed
      if (a.stages > 1 && i + a.stages - 1 < mine) load(i + a.stages - 1);
      cp_async_commit();
      const unsigned char* kt = ring + (i % a.stages) * stage;
      const unsigned char* vt = kt + kbytes;
      const float* ksc = reinterpret_cast<const float*>(vt + vbytes);
      const float* vsc = ksc + NK * TL;
      const int t0 = s0 + (pg + i * a.pw) * TL;
      const int nsub = min(TL, s1 - t0 + 15) >> 4;
      // a whole tail chunk's tile: into the mirror
      if constexpr (Rows::kMirror) {
        if (t0 >= kt_end && (t0 / KT_CHUNK + 1) * KT_CHUNK <= lb)
          flush_kt<D, KCPR>(kt, rows, b, t0, kh, TL, gtid, gthr);
      }
      // one 16-position sub-block; FM: the tile is feature-major
      auto sub_block = [&](auto fm_tag, int sb) {
        constexpr bool FM = decltype(fm_tag)::value;
        const int rb = 16 * sb;
        // scores of the 16 rows against positions rb..rb + 15 (two n8
        // tiles); int4 K: the high half in sh
        float sc[2][4], sh[2][4], sx[2][4];  // sx: odd k-steps, summed in
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = sh[nt][e] = sx[nt][e] = 0.f;
        if constexpr (FM) {
          // per k-step pair: matrices (ks, b0 features), (ks, b1), (ks + 1,
          // b0), (ks + 1, b1); lane row r is feature k_feature(ks, r / 2,
          // 2 * half + r % 2) of its matrix, 16 positions a line
          const uint32_t base = smem_u32(kt);
          const int mx = lane >> 3, r = lane & 7, cpl = TL / 16;
#pragma unroll
          for (int kp = 0; kp < KS / 2; ++kp) {
            const int f = (D / 4) * (r >> 1) + 4 * (2 * kp + (mx >> 1)) +
                          2 * (mx & 1) + (r & 1);
            unsigned w[4];
            ldmatrix_x4_trans(base + 16 * kt_swz<D>(f * cpl + sb, f, cpl), w);
#pragma unroll
            for (int x = 0; x < 4; ++x) w[x] ^= 0x80808080u;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              // bytes nt and 2 + nt: the two features at position 2g + nt
              const unsigned sel = nt ? 0x4341 : 0x4240;
              mma_f16(sc[nt], qa[2 * kp], f16x2_bytes(w[0], sel),
                      f16x2_bytes(w[1], sel));
              mma_f16(sx[nt], qa[2 * kp + 1], f16x2_bytes(w[2], sel),
                      f16x2_bytes(w[3], sel));
            }
          }
        } else {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          if constexpr (KB == 16) {
            const uint32_t base = smem_u32(kt);
#pragma unroll
            for (int kp = 0; kp < KS / 2; ++kp) {
              unsigned r[4];
              ldmatrix_x4(base + tile_off<KCPR>(rb + 8 * nt + (lane & 7),
                                                16 * (4 * kp + (lane >> 3))),
                          r);
              mma_bf16(sc[nt], qa[2 * kp], r[0], r[1]);
              mma_bf16(sx[nt], qa[2 * kp + 1], r[2], r[3]);
            }
          } else if constexpr (KB == 8) {
            unsigned w[D / 16];
            lds_words<KCPR>(kt, rb + 8 * nt + g, c * (D / 4), w);
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              const unsigned u = w[ks] ^ 0x80808080u;
              const unsigned b0 = f16x2_bytes(u, 0x4140);
              const unsigned b1 = f16x2_bytes(u, 0x4342);
              if (ks % 2)
                mma_f16(sx[nt], qa[ks], b0, b1);
              else
                mma_f16(sc[nt], qa[ks], b0, b1);
            }
          } else {
            unsigned w[D / 32];
            lds_words<KCPR>(kt, rb + 8 * nt + g, c * (D / 8), w);
#pragma unroll
            for (int kk = 0; kk < D / 32; ++kk) {
              const unsigned u = w[kk] ^ 0x88888888u;
              mma_f16(sc[nt], qa[kk], f16x2_nibbles(u, 0),
                      f16x2_nibbles(u, 8));
              mma_f16(sh[nt], qa[D / 32 + kk], f16x2_nibbles(u, 4),
                      f16x2_nibbles(u, 12));
            }
          }
        }
        }
        if constexpr (KB != 4) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[nt][e] += sx[nt][e];
        }
        // K scales folded in, positions past each row's bound selected away
        float mx0 = DPT_NEG_INF, mx1 = DPT_NEG_INF;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = rb + tpos<FM>(nt, e, c);
            const int pos = t0 + j;
            float x0 = sc[nt][e], x1 = sc[nt][2 + e];
            if constexpr (NK == 1) {
              x0 *= ksc[j];
              x1 *= ksc[j];
            } else if constexpr (NK == 2) {
              x0 = x0 * ksc[j] + sh[nt][e] * ksc[TL + j];
              x1 = x1 * ksc[j] + sh[nt][2 + e] * ksc[TL + j];
            }
            sc[nt][e] = pos < bound0 ? x0 : DPT_NEG_INF;
            sc[nt][2 + e] = pos < bound1 ? x1 : DPT_NEG_INF;
            mx0 = fmaxf(mx0, sc[nt][e]);
            mx1 = fmaxf(mx1, sc[nt][2 + e]);
          }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float p[2][4];
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pos = t0 + rb + tpos<FM>(nt, e, c);
            p[nt][e] = pos < bound0 ? __expf(sc[nt][e] - mn0) : 0.f;
            p[nt][2 + e] = pos < bound1 ? __expf(sc[nt][2 + e] - mn1) : 0.f;
            ps0 += p[nt][e];
            ps1 += p[nt][2 + e];
          }
        l0 = l0 * al0 + ps0;
        l1 = l1 * al1 + ps1;
        if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
          for (int nt = 0; nt < NO; ++nt) {
            acc[nt][0] *= al0;
            acc[nt][1] *= al0;
            acc[nt][2] *= al1;
            acc[nt][3] *= al1;
          }
        }
        // p (times the V scale of its position and half) as two bf16
        // terms, hi and lo: the A fragments of p.V, k index = position
        // rb + k
        constexpr int NP = NV == 2 ? 2 : 1;
        unsigned ph[NP][4], pl[NP][4];
        auto pv = [&](float(&d)[4], int h, unsigned b0, unsigned b1) {
          mma_bf16(d, ph[h], b0, b1);
          mma_bf16(d, pl[h], b0, b1);
        };
#pragma unroll
        for (int h = 0; h < NP; ++h) {
          float f[2][2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              f[nt][e] = NV ? vsc[h * TL + rb + tpos<FM>(nt, e, c)] : 1.f;
          const float x[4][2] = {{p[0][0] * f[0][0], p[0][1] * f[0][1]},
                                 {p[0][2] * f[0][0], p[0][3] * f[0][1]},
                                 {p[1][0] * f[1][0], p[1][1] * f[1][1]},
                                 {p[1][2] * f[1][0], p[1][3] * f[1][1]}};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split_bf16(x[j][0], x[j][1], ph[h][j], pl[h][j]);
        }
        // p.V over the 16 positions
        v_operands<VB, D, FM>(vt, rb, lane,
                              [&](int nt, int h, unsigned b0, unsigned b1) {
                                pv(acc[nt], h, b0, b1);
                              });
      };
      if constexpr (Rows::kMirror) {
        if (t0 < kt_end) {
          for (int sb = 0; sb < nsub; ++sb) sub_block(std::true_type{}, sb);
          continue;
        }
      }
      for (int sb = 0; sb < nsub; ++sb) sub_block(std::false_type{}, sb);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  __syncthreads();  // every ring is consumed: its memory takes the partials

  const int R = a.R;
  float* pacc = reinterpret_cast<float*>(sm);  // [pw][R][D]
  float* pm = pacc + a.pw * R * D;             // [pw][R]
  float* pl = pm + a.pw * R;
  float* bm = pl + a.pw * R;                   // [R], the block's
  float* bl = bm + R;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0;
    if (r >= R) continue;
    const long long base = (long long)(pg * R + r) * D;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      pacc[base + v_feature<VB, D>(nt, 2 * c)] = acc[nt][2 * h];
      pacc[base + v_feature<VB, D>(nt, 2 * c + 1)] = acc[nt][2 * h + 1];
    }
    if (c == 0) {
      pm[pg * R + r] = h ? m1 : m0;
      pl[pg * R + r] = h ? l1 : l0;
    }
  }
  __syncthreads();
  // the groups' partials merged, in group order
  // output feature i - r * D of row r, in the stored head's order (-1: a
  // narrow head's padding, not written)
  bf16* out = a.out + ((long long)b * a.Kh + kh) * R * DR;
  auto out_at = [&](int i, int r) {
    return stored_feature<VB, D, DR>(i - r * D);
  };
  for (int i = tid; i < R * D; i += blockDim.x) {
    const int r = i / D;
    float M = DPT_NEG_INF;
    for (int p = 0; p < a.pw; ++p) M = fmaxf(M, pm[p * R + r]);
    float L = 0.f, A = 0.f;
    for (int p = 0; p < a.pw; ++p) {
      const float wt = __expf(pm[p * R + r] - M);
      L += pl[p * R + r] * wt;
      A += pacc[p * R * D + i] * wt;
    }
    if (a.nsplit == 1) {
      const int f = out_at(i, r);
      if (f >= 0) out[r * DR + f] = f2bf(A / fmaxf(L, 1e-30f));
    } else {
      pacc[i] = A;
      if (i - r * D == 0) {
        bm[r] = M;
        bl[r] = L;
      }
    }
  }
  if (a.nsplit == 1) return;
  // the cluster's splits, in rank order: block `split` writes every
  // nsplit-th share of the outputs
  cluster_sync();
  for (int i = split * blockDim.x + tid; i < R * D;
       i += a.nsplit * blockDim.x) {
    const int r = i / D;
    // every split's (max, sum, p.V) loaded first, so that the remote loads
    // overlap
    float pm_[MAX_SPLITS], pl_[MAX_SPLITS], pa_[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      pm_[s] = DPT_NEG_INF;
      pl_[s] = pa_[s] = 0.f;
      if (s < a.nsplit) {
        pm_[s] = ld_cluster(bm + r, s);
        pl_[s] = ld_cluster(bl + r, s);
        pa_[s] = ld_cluster(pacc + i, s);
      }
    }
    float M = DPT_NEG_INF;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) M = fmaxf(M, pm_[s]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      const float wt = __expf(pm_[s] - M);
      L += pl_[s] * wt;
      A += pa_[s] * wt;
    }
    const int f = out_at(i, r);
    if (f >= 0) out[r * DR + f] = f2bf(A / fmaxf(L, 1e-30f));
  }
  cluster_sync();  // no block leaves while its partials are read
}

template <int D, int KB, int VB, typename Rows, int DR>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    attention_kernel(const Args a, const Side k, const Side v,
                     const Rows rows, const NewRows nr) {
  attention_body<D, KB, VB, Rows, false, DR>(a, k, v, rows, nr);
}

// At D = 64 the int8-dot path is held to two blocks an SM, as the plan
// counts (SM_WARPS): unbounded, ptxas gave its int4 instantiation 151
// registers a thread, and the bf16-dot kernels more than 128 when every
// instantiation was bounded by one block (both slower).
template <int D, int KB, int VB, typename Rows, int DR>
__global__ void __launch_bounds__(MAX_WARPS * 32, D == 64 ? 2 : 1)
    attention_kernel_i8(const Args a, const Side k, const Side v,
                        const Rows rows, const NewRows nr) {
  attention_body<D, KB, VB, Rows, true, DR>(a, k, v, rows, nr);
}

// D: the width the kernel computes at; DR: the stored head's (DR < D for
// a narrow head, `stored_feature`)
template <int D, int KB, int VB, bool I8, int DR, typename Rows>
int launch(const Args& a, const Side& k, const Side& v, Rows rows,
           const NewRows& nr, int B) {
  constexpr int NK = n_scales<KB>(), NV = n_scales<VB>();
  const size_t stage = (size_t)a.tile * (head_bytes<KB, D>() +
                                         head_bytes<VB, D>() + 4 * (NK + NV));
  size_t ring = (size_t)a.pw * a.stages * stage;
  const size_t part = ((size_t)a.pw * a.R * (D + 2) + 2 * a.R) * 4;
  // the int8-dot path: its rings and kept scores (i8_smem), then its
  // exchange ((max, two granule maxima) a row, for each group and for the
  // block's two parities) and q's codes (qs, two code sums and D codes a
  // row)
  if constexpr (I8) {
    const I8Smem m = i8_smem(a, head_bytes<KB, D>(), head_bytes<VB, D>(),
                             NK + NV);
    ring = (size_t)m.ring + m.kept;
  }
  size_t smem = ring > part ? ring : part;
  if constexpr (I8)
    smem = (smem + 15) / 16 * 16 +
           (((size_t)a.pw * a.R + 2 * a.R) * 3 * 4 + 15) / 16 * 16 +
           (size_t)a.R * (D + 3 * 4);
  void (*kern)(Args, Side, Side, Rows, NewRows);
  if constexpr (I8)
    kern = attention_kernel_i8<D, KB, VB, Rows, DR>;
  else
    kern = attention_kernel<D, KB, VB, Rows, DR>;
  static size_t sized = 48 * 1024;
  if (smem > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nsplit, B * a.Kh);
  cfg.blockDim = dim3(32 * a.mg * a.pw);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, a, k, v, rows, nr);
}

template <int D, bool I8, int DR, typename Rows>
int by_bits(const Args& a, const Side& k, const Side& v, Rows rows,
            const NewRows& nr, int B, int kb, int vb) {
  if constexpr (I8) {   // contiguous stores whose K is int8 bytes
    if (kb == 8 && vb == 8)
      return launch<D, 8, 8, true, DR>(a, k, v, rows, nr, B);
    if (kb == 4 && vb == 4)
      return launch<D, 4, 4, true, DR>(a, k, v, rows, nr, B);
    if (kb == 8 && vb == 4)
      return launch<D, 8, 4, true, DR>(a, k, v, rows, nr, B);
  } else if constexpr (Rows::kMirror) {   // int8 K: int8 or int4 V
    if (kb == 8 && vb == 8)
      return launch<D, 8, 8, false, DR>(a, k, v, rows, nr, B);
    if (kb == 8 && vb == 4)
      return launch<D, 8, 4, false, DR>(a, k, v, rows, nr, B);
  } else {
    if (kb == 16 && vb == 16)
      return launch<D, 16, 16, false, DR>(a, k, v, rows, nr, B);
    if (kb == 8 && vb == 8)
      return launch<D, 8, 8, false, DR>(a, k, v, rows, nr, B);
    if (kb == 4 && vb == 4)
      return launch<D, 4, 4, false, DR>(a, k, v, rows, nr, B);
    if (kb == 8 && vb == 4)
      return launch<D, 8, 4, false, DR>(a, k, v, rows, nr, B);
  }
  return (int)cudaErrorInvalidValue;
}

// The plan's rules (ops/kernels/decode_attention.py `attention_plan`) and
// the 16-byte alignment the copies need; the scales' copies are 16 bytes
// wide where their rows allow it.
// New rows need both sides; the mirror layout takes none. The int8-dot
// path (I8) takes a block of p's granule that covers S or is a whole
// number of tiles.
template <bool I8 = false, typename Rows>
int dispatch(Args a, const Side& k, const Side& v, Rows rows,
             const NewRows& nr, int B, int D, int kb, int vb,
             int scale_step) {
  const bool quant = kb != 16;
  const int esk = kb == 16 ? 2 : 1, esv = vb == 16 ? 2 : 1;
  if (a.R < 1 || a.R > MAX_ROWS || a.T < 1 || a.R % a.T || a.tile < 16 ||
      a.tile % 16 || a.chunk % a.tile || a.nsplit < 1 ||
      a.nsplit > MAX_SPLITS || (long long)a.nsplit * a.chunk < a.S ||
      (long long)(a.nsplit - 1) * a.chunk >= a.S ||
      a.mg != (a.R + 15) / 16 || a.pw < 1 || a.mg * a.pw > MAX_WARPS ||
      a.stages < 1 || a.stages > STAGES ||
      (uintptr_t)k.data % 16 || (uintptr_t)v.data % 16 ||
      (k.msb * esk) % 16 || (v.msb * esv) % 16 ||
      (nr.pos && (Rows::kMirror || !nr.k || !nr.v)))
    return (int)cudaErrorInvalidValue;
  if (I8 && (a.blk < 1 || (a.blk < a.S && a.blk % a.tile) || a.keep < 0 ||
             a.keep > i8_share(a)))
    return (int)cudaErrorInvalidValue;
  a.svec = !quant || ((uintptr_t)k.scale % 16 == 0 &&
                      (uintptr_t)v.scale % 16 == 0 && k.ssb % 4 == 0 &&
                      v.ssb % 4 == 0 && k.srs % 4 == 0 && v.srs % 4 == 0 &&
                      scale_step % 4 == 0);
  if (D == 64) return by_bits<64, I8, 64>(a, k, v, rows, nr, B, kb, vb);
  if (D == 128) return by_bits<128, I8, 128>(a, k, v, rows, nr, B, kb, vb);
  // a narrow head (moelm_ckpt's 32) computed at 64, contiguous caches only
  if constexpr (std::is_same<Rows, ContiguousRows>::value)
    if (D == 32) return by_bits<64, I8, 32>(a, k, v, rows, nr, B, kb, vb);
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

