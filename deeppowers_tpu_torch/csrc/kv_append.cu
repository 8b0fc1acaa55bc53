// In-place KV-cache row writes for the K and the V cache of one layer: a
// decode token per slot, or a prefill's rows: bf16 rows copied, or
// quantized into int8 / packed int4 stores with their scale columns.
//
// dpt_kv_append: cache[slots[i], positions[i], :] = row[i, :] over flat
// (B, S, F') caches (slots null: slot i, one row per slot). Replaces the
// Pallas TPU kernel deeppowers_tpu/ops/pallas/kv_append.py (`scatter_rows`
// :116 -> `_scatter_one` :69, body `_kernel` :43, pallas_call :104); a
// prefill's rows go through it too, where JAX quantizes them in XLA.
//
// dpt_kv_append_stacked: the same rows into [layer, slot, position] of the
// stacked (L, B, S, F') caches of scan-over-layers, the layer an int32 in
// device memory. Replaces `scatter_rows_stacked` :328 (body
// `_kernel_stacked` :252, pallas_call :315); one launch per layer writes K,
// V and their scales, as for a per-layer cache.
//
// dpt_kv_append_pool: pool[rows[b], :] = row[b, :] over the flat
// (P * page, F') view of the paged layout's pools, where valid[b]. Replaces
// `scatter_pool_rows` :225 (body `_kernel_pool` :146, pallas_call :207).
// An invalid row is not written at all: the TPU kernel writes the old
// content back into its 8-row tile, a tiling artefact.
//
// Stores, per side (K or V): 16 = bf16, the row copied; 8 = int8, one f32
// scale per head; 4 = packed int4, two sub-block scales per head (rows
// 2*head + half; byte j of a head holds feature j in its low nibble and
// feature j + D/2 in its high one). Scales are head-major (B, R, S) or
// (P, R, page) arrays (R = Kh, or 2*Kh for int4). The rows arrive as the
// model's bf16 (B, Kh*D) and are quantized inside the launch with
// quant/kvquant.py's arithmetic, bit for bit (kv_store.cuh). The TPU
// kernel scatters rows that XLA quantized in some ten separate ops per
// side; here the quantization is fused into the one launch that writes K,
// V and both sides' scales.
//
// What bounds it on an H100: bytes, 2 * B * F * 2 read and at most as many
// written (8 KB for TinyLlama's 8 slots, F = 256), far below a launch's
// fixed cost; the kernel only has to write in place and never touch the
// rest of the cache. A scale column is strided: one f32 every S (or page)
// floats, so each scale is its own 32-byte sector write. At B = 8 that is 8
// slots x (4 + 8) scales for k8v4, under 100 scattered 4-byte stores per
// launch, which the launch's fixed cost hides; a (B, S, R) layout would make
// them contiguous but would cost the decode kernels a strided read per row
// instead. A prefill group's rows (1024 at (2, 512)) write 12 such scales
// a row for k8v4, about 0.4 MB of sectors: well under a microsecond of HBM
// time.
//
// Design: one block per (row, side). A slot outside [0, B) or a position
// outside [0, S) (a row outside [0, P * page)) writes nothing, as the TPU
// kernel's select and JAX's scatter drop it. The TPU kernel's 8-row read-
// modify-write exists for the TPU's tiling; a GPU writes the row alone. A
// bf16 side is copied by all threads; for a quantized side each warp takes
// one kv head of the row (kv_store.cuh's `store_head`, which the attention
// launch also runs when it writes a decode or verify step's rows itself):
// it reduces the head's (or each half's) absmax with shuffles, lane 0
// writes the scale, and the lanes write the head's bytes.
//
// Since the attention launch writes decode and verify rows (the fold,
// decode_attention.cuh), these kernels write prefill rows, chunks and the
// kt-mirror cache's decode rows.
#include "common.cuh"
#include "kv_store.cuh"

namespace {

// Where row i goes: contiguous (B, S, F') caches, slot slot[i] (or i when
// slot is null), position pos[i]; the scale of group g at (slot * R + g) *
// S + pos.
struct ContigDst {
  const int* __restrict__ pos;
  const int* __restrict__ slot;
  int B, S;
  __device__ bool locate(int i, long long& row, long long& major,
                         int& minor) const {
    const int p = pos[i];
    const int b = slot ? slot[i] : i;
    if (b < 0 || b >= B || p < 0 || p >= S) return false;
    row = (long long)b * S + p;
    major = b;
    minor = p;
    return true;
  }
  __device__ int minor_len() const { return S; }
};

// Stacked all-layer caches (L, B, S, F'): layer *layer (an int32 on the
// device, read by every block as the TPU kernel prefetches it), slot
// slot[i] (or i), position pos[i]; the scale of group g at ((layer * B +
// slot) * R + g) * S + pos. A layer outside [0, L) drops every row.
struct StackDst {
  const int* __restrict__ layer;
  const int* __restrict__ pos;
  const int* __restrict__ slot;
  int L, B, S;
  __device__ bool locate(int i, long long& row, long long& major,
                         int& minor) const {
    const int l = *layer;
    const int p = pos[i];
    const int b = slot ? slot[i] : i;
    if (l < 0 || l >= L || b < 0 || b >= B || p < 0 || p >= S) return false;
    major = (long long)l * B + b;
    row = major * S + p;
    minor = p;
    return true;
  }
  __device__ int minor_len() const { return S; }
};

// Pools (P, page, F'): absolute row rows[b] where valid[b]; the scale of
// group g at (page_id * R + g) * page + row % page.
struct PoolDst {
  const int* __restrict__ rows;
  const bool* __restrict__ valid;
  int P, page;
  __device__ bool locate(int b, long long& row, long long& major,
                         int& minor) const {
    const long long r = rows[b];
    if (!valid[b] || r < 0 || r >= (long long)P * page) return false;
    row = r;
    major = r / page;
    minor = (int)(r % page);
    return true;
  }
  __device__ int minor_len() const { return page; }
};

// One side of an append: the slot's bf16 row into a bf16 (bits 16), int8
// (bits 8) or packed int4 (bits 4) store and, when quantized, its scale
// column.
struct Side {
  void* store;
  float* scale;
  const bf16* rows;
  long long rows_sb;
  int bits;
};

// grid (rows, 2): blockIdx.y 0 writes K, 1 writes V; 128 threads.
template <typename Dst>
__global__ void __launch_bounds__(128) kv_append_kernel(Side k, Side v,
                                                        Dst dst, int Kh,
                                                        int D) {
  const int b = blockIdx.x;
  long long row, major;
  int minor;
  if (!dst.locate(b, row, major, minor)) return;
  const Side sd = blockIdx.y ? v : k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  const bf16* src = sd.rows + (long long)b * sd.rows_sb;
  const int L = dst.minor_len();
  if (sd.bits == 16) {
    bf16* out = (bf16*)sd.store + row * (long long)(Kh * D);
    for (int i = threadIdx.x; i < Kh * D; i += blockDim.x) out[i] = src[i];
  } else if (sd.bits == 8) {
    int8_t* out = (int8_t*)sd.store + row * (long long)(Kh * D);
    for (int h = warp; h < Kh; h += nwarp)
      store_head<8>(src + h * D, out + h * D,
                    sd.scale + (major * Kh + h) * L + minor, nullptr, D, lane);
  } else {
    const int hd = D / 2;
    int8_t* out = (int8_t*)sd.store + row * (long long)(Kh * hd);
    for (int h = warp; h < Kh; h += nwarp) {
      float* sc = sd.scale + (major * 2 * Kh + 2 * h) * L + minor;
      store_head<4>(src + h * D, out + h * hd, sc, sc + L, D, lane);
    }
  }
}

bool valid_bits(int bits) { return bits == 16 || bits == 8 || bits == 4; }

template <typename Dst>
int launch(void* kc, void* vc, void* ks, void* vs, const void* kr,
           long long kr_sb, const void* vr, long long vr_sb, Dst dst, int B,
           int Kh, int D, int k_bits, int v_bits, void* stream) {
  if (!valid_bits(k_bits) || !valid_bits(v_bits) ||
      ((k_bits == 4 || v_bits == 4) && D % 2))
    return (int)cudaErrorInvalidValue;
  const Side k{kc, (float*)ks, (const bf16*)kr, kr_sb, k_bits};
  const Side v{vc, (float*)vs, (const bf16*)vr, vr_sb, v_bits};
  kv_append_kernel<Dst><<<dim3(B, 2), 128, 0, (cudaStream_t)stream>>>(
      k, v, dst, Kh, D);
  return (int)cudaGetLastError();
}

}  // namespace

// kc, vc: (B, S, F') contiguous stores per k_bits / v_bits (16 bf16,
// F' = Kh*D; 8 int8, F' = Kh*D; 4 packed int4, F' = Kh*D/2), updated in
// place. ks, vs: (B, R, S) f32 head-major scales (R = Kh for int8, 2*Kh for
// int4), null for bf16. kr, vr: (N, Kh*D) bf16 rows with row strides
// kr_sb, vr_sb (elements). pos: (N,) int32 write positions on the device;
// slots: (N,) int32 slots, or null for N = B rows, one per slot.
extern "C" int dpt_kv_append(void* kc, void* vc, void* ks, void* vs,
                             const void* kr, long long kr_sb, const void* vr,
                             long long vr_sb, const void* pos,
                             const void* slots, int N, int B, int S, int Kh,
                             int D, int k_bits, int v_bits, void* stream) {
  return launch(kc, vc, ks, vs, kr, kr_sb, vr, vr_sb,
                ContigDst{(const int*)pos, (const int*)slots, B, S}, N, Kh,
                D, k_bits, v_bits, stream);
}

// As dpt_kv_append into layer *layer of stacked (L, B, S, F') stores and
// (L, B, R, S) scales: `layer` is a (1,) int32 on the device.
extern "C" int dpt_kv_append_stacked(void* kc, void* vc, void* ks, void* vs,
                                     const void* kr, long long kr_sb,
                                     const void* vr, long long vr_sb,
                                     const void* layer, const void* pos,
                                     const void* slots, int N, int L, int B,
                                     int S, int Kh, int D, int k_bits,
                                     int v_bits, void* stream) {
  return launch(kc, vc, ks, vs, kr, kr_sb, vr, vr_sb,
                StackDst{(const int*)layer, (const int*)pos,
                         (const int*)slots, L, B, S},
                N, Kh, D, k_bits, v_bits, stream);
}

// As dpt_kv_append into (P, page, F') pools and (P, R, page) scale pools at
// absolute rows rows[b] (int32) of the (P * page, F') views where valid[b]
// (bool, one byte each).
extern "C" int dpt_kv_append_pool(void* kp, void* vp, void* ks, void* vs,
                                  const void* kr, long long kr_sb,
                                  const void* vr, long long vr_sb,
                                  const void* rows, const void* valid, int B,
                                  int P, int page, int Kh, int D, int k_bits,
                                  int v_bits, void* stream) {
  return launch(kp, vp, ks, vs, kr, kr_sb, vr, vr_sb,
                PoolDst{(const int*)rows, (const bool*)valid, P, page}, B, Kh,
                D, k_bits, v_bits, stream);
}
