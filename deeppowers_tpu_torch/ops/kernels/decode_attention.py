"""GQA decode attention over bf16 or quantized KV: wrappers, plain
versions and launch counts for the contiguous, the paged and the kt-mirror
layout, for one token a slot (decode) or a speculative verify window of T
tokens a slot. CUDA sources: csrc/decode_attention.cuh (one kernel
template, three row layouts, four store variants, and the int8-dot
variant) with the entry points of csrc/decode_attention.cu (contiguous,
paged), csrc/decode_attention_i8.cu (the int8-dot variant, "3i") and
csrc/decode_attention_kt.cu (the mirror, #7).

The int8-dot variant: the TPU kernel's `int8_dots` branch of
`_kernel_mxu` (:196-216, :219-237, :283-301), which its TPU route takes
by default wherever K is stored as int8 bytes (int8, int4, k8v4), decode
and verify, per-layer and stacked: q requantized to int8 per row, exact
integer dots for q.K^T, p (times its V scale) requantized to int8 per
row and per S block of the TPU kernel's grid (`int8_dots_block`), whose
p.V sums are exact. On the card each split walks a block in two passes,
K then V, through one ring, and keeps the first pass's scores for the
second (`int8_dots_keep` tiles a position group; `int8_dots_smem`).
`decode_attention` takes it on the card as the JAX
package's call sites do (`int8_dots_default`: the switch DPT_ATTN_INT8,
"0" off, and the S >= 128 rule of `attention_decode_auto` for the int8
store and of the stacked route); `int8_dots=` overrides, as on
`decode_attention_mxu`. Its plain version is
`decode_attention_int8_dots_plain`, the function held against Pallas in
interpret mode. A CPU tensor keeps the JAX package's CPU function
(`decode_attention_plain(xla=True)`: int4 and k8v4 values dequantized
into q's dtype, q * scale rounded to it; a verify window's rows in
XLA's order, ops/xla_cpu.py, bit for bit with JAX's; it never takes the
Pallas kernel) unless
`cpu_attention_function("kernel")` gives it the card's. Its launches
count under the store's keys and under "i8:" + the key ("i8:int8",
"i8:k8v4:t5+rows"). The bf16-dot kernel described below stays the path
of bf16 stores, of #5 and #11, and of every store with DPT_ATTN_INT8=0.

`decode_attention_kt` / `verify_attention_kt` replace the Pallas TPU
kernel `decode_attention_kt` :1081 (pallas_call :1132, body `_kt_kernel`
:845) and `verify_attention_kt` :1148: attention over an int8-K cache that
carries the chunk-transposed mirror kt (runtime/kvcache.py), reading
committed chunks from kt and the rest from the row-major k, and flushing
every chunk its tail completes into kt in place. On the card they launch
#3's kernel over its mirror layout (one launch, `attention_plan`'s plan,
p in two bf16 terms as below), which reads a committed tile's K
feature-major and flushes the whole tail chunks it walks. Their plain
version walks the TPU kernel's units in its order, with its roundings
(bf16 q after the scale, bf16 probabilities times V scales), so that
greedy streams follow the JAX engine's; the kernel is held to it at 1e-2
of a row's max. `decode_attention_kernel` is the older
per-head kernel (:1160, pallas_call :1219, body `_kernel` :42), which
nothing in the JAX package calls: its entry point launches the contiguous
kernel on the flat view of its (B, S, Kh, D) caches, which computes its
function, and counts its own launches. Its TPU kernel computes in f32
throughout; the port's rounds as below (q * scale in bf16 first), which is
why its rows stand further from their f32 plain version than they did when
it computed in f32.

`decode_attention` replaces the Pallas TPU kernel
deeppowers_tpu/ops/pallas/decode_attention.py (`decode_attention_mxu`
:341, pallas_call :470, body `_kernel_mxu` :123) over flat (B, S, F')
caches; `decode_attention_paged` replaces `decode_attention_paged_mxu`
:706 (pallas_call :780, body `_kernel_mxu_paged_db` :526) over (P, page,
F') pools read through a (B, WP) page table. The stacked cache's layer i
reaches `decode_attention` as (B, S, F') views of its (L, B, S, F')
tensors, which the kernel reads in place (its slot stride is taken from
the view), where the TPU kernel takes a `layer` operand.

Verify windows (`tokens` = T > 1): `verify_attention` and
`verify_attention_paged` replace `verify_attention_mxu` :501 and
`verify_attention_paged_mxu` :1235. As there, the T window tokens fold into
extra query rows ordered (head, t) (`_fold_tokens` :488), the kernel gets
lengths + T, and row t sees the positions below lengths + 1 + t (:262-266,
:657-661), so the cache streams once for the whole window. Launch counts
are kept per store and per T: `variant_launches["bf16"]` for decode,
`["bf16:t5"]` for a window of 5.

The step's new rows (`new`, a `NewRows`): `decode_attention` and
`decode_attention_paged` (and so `verify_attention` /
`verify_attention_paged`) may carry the K/V rows of the step's T tokens a
slot, bf16 as the model made them, with their positions (B, T) and, paged,
their pool rows. The launch writes them into the cache (quantized for a
quantized store, with their scales) before it reads the cache: the row
writers #2 (`scatter_rows`), #8 (`scatter_rows_stacked`, whose layer views
reach `decode_attention`) and #6 (`scatter_pool_rows`) of
ops/kernels/kv_append.py fold into #3 / #5, one launch a layer and step
fewer. The plain version is the writer's plain version, then the
attention's, in that order; on the card the same bytes and scales land
(csrc/kv_store.cuh is kv_append.cu's code), and the outputs are held to
the attention's limits. Such a launch also counts under
`variant_launches["<variant>+rows"]` ("int8+rows", "int8:t5+rows").

Store variants, named as quant/kvquant.py's `store_variant` names them:
"bf16" (no scales); with head-major f32 scales k_scale / v_scale ((B, R, S), or
(P, R, page) paged) and `kv_bits` / `v_bits` as JAX takes them: "int8"
(int8 K and V, R = Kh), "int4" (packed int4 K and V, two sub-block scales
per head, R = 2*Kh), "k8v4" (int8 K, packed int4 V).

out[b, h] = softmax(q[b, h] . K[b, :len, h // rep] * scale) @ V[b, :len,
h // rep], with len = lengths[b] (lengths[b] - (T - 1) + t for window token
t) and K/V the slot's (virtual) dequantized rows. Bound on an H100: the
live K/V bytes and their scales over 3.35 TB/s, for a window as for one
token. One launch a call: the sequence splits across the blocks of a
thread-block cluster per (slot, kv head) (flash-decoding; `attention_plan`
picks the splits and tiles from the shapes), each block's position groups
stream their tiles through a cp.async ring in the stored form, run both
dots on the tensor cores (mma.sync, bf16 operands, f32 sums) and keep an
online softmax each; the groups merge in shared memory and the splits in
distributed shared memory, in a fixed order. The operands round as the
TPU kernel's MXU path rounds them: bf16(q * scale), the K scales folded
into the f32 scores, the V codes exact in bf16. p * v_scale goes into p.V
as two bf16 terms, hi = bf16(p * v_scale) and lo = bf16 of the rest (exact
to about 2^-16), where the TPU rounds it once: rounded once, an int8 row
stood past the 1e-2 gate from its plain version on the card. Positions at
or past a row's bound are excluded by a select, and blocks past the slot's
length read nothing. No scratch tensor is allocated.

The plain versions follow the JAX package's CPU path for each variant, so
that greedy streams match the JAX engine's: bf16 and int8 as
`attention_decode` and `attention_decode_quantized` (bf16 q * scale and
bf16 probabilities times the V scales, f32 sums), int4 and k8v4 by
dequantizing and then `attention_decode`
(deeppowers_tpu/models/transformer.py:1309-1330). JAX dequantizes into
the activation dtype; the plain version dequantizes into f32, which is
the same in the f32 parity tests. In bf16 that one rounding of K moves an
output row by up to 1.2% of its max (random K and q, lengths 100-256),
more than the kernel's whole limit against the plain version (1e-2).
"""

from __future__ import annotations

import collections
import functools
import os
from typing import Optional

import torch

from ..xla_cpu import dot4, xla_softmax
from ...quant.kvquant import (STORE_BITS, dequant_side, gather_scale,
                              scale_heads, store_variant, unpack4)
from . import _build
from .kv_append import scatter_pool_rows_plain, scatter_rows_plain

NEG_INF = -1e30
#: query rows a kv head the CUDA kernel takes: four 16-row m tiles
MAX_ROWS = 64
#: splits of one (slot, kv head) at most: a portable thread-block cluster
MAX_SPLITS = 8
#: warps a block (csrc MAX_WARPS)
MAX_WARPS = 8
#: stages of a position group's cp.async ring at most (csrc STAGES)
STAGES = 3
#: positions a ring stage (a tile) at least: one p.V k-step
TILE = 16
#: streaming multiprocessors of the H100 SXM, which the split count fills
SMS = 132
#: dynamic shared memory a block may use on an H100 (bytes)
SMEM_BLOCK = 232_448
#: warps an SM holds of the kernel at head_dim 64 / 128: ptxas gives it
#: about 128 / 165-210 registers a thread
SM_WARPS = {64: 16, 128: 8}


def compute_dim(d: int) -> int:
    """The head width the kernel computes at: D, or 64 for a narrow head
    of 32 (moelm_ckpt's), whose stored bytes the kernel reads followed by
    as many zeros (csrc `stored_feature`; the contiguous kernel and its
    int8-dot variant only). Its plan and shared memory are the wide
    head's."""
    return 64 if d == 32 else d

#: The launch of #3 / #5: `nsplit` splits of `chunk` positions for each
#: (slot, kv head), a cluster; ring stages of `tile` positions, `stages`
#: of them a position group; a block of `pw` position groups of `mg` warps
#: (one 16-row m tile each).
Plan = collections.namedtuple("Plan", "nsplit chunk tile pw mg stages")

#: The step's new rows, written by the attention launch before it reads
#: them: k, v (B, T, Kh*D) bf16 unquantized rows (contiguous features);
#: pos (B, T) int32 positions, -1 for none (an inactive slot); rows, valid
#: the paged layout's (B*T,) int32 pool rows and bool validity
#: (runtime/kvcache_paged.py `row_ids`), None on the contiguous layouts.
NewRows = collections.namedtuple("NewRows", "k v pos rows valid",
                                  defaults=(None, None))


def attention_plan(b: int, kh: int, s: int, rows: int, d: int,
                   page: Optional[int] = None) -> Plan:
    """The kernel's launch from the shapes alone (never the lengths, so no
    host sync): B slots, Kh kv heads, S positions (WP * page when paged),
    `rows` query rows a kv head, head_dim D, and the page size.

    - mg = ceil(rows / 16) warps share a position group's ring, and a block
      holds MAX_WARPS // mg groups;
    - a tile is 16 positions for one warp a group, 32 for two, else 64 (32
      at D = 128): the group's barrier a tile is shared by more rows. A
      tile never crosses a page whose size is a multiple of 16 (it shrinks
      to the page); through any other page each row finds its own;
    - splits: as many as one wave of such blocks holds (SM_WARPS a
      streaming multiprocessor) while each group keeps two tiles or more,
      at most MAX_SPLITS (a cluster); one when the (slot, kv head) pairs
      alone pass a wave;
    - chunk: positions a split, a whole number of tiles; stages: STAGES,
      or as many tiles as a group walks when fewer."""
    mg = -(-rows // 16)
    pw = MAX_WARPS // mg
    tile = TILE * (1 if mg == 1 else 2 if mg == 2 or d == 128 else 4)
    while page and page % TILE == 0 and page % tile:
        tile //= 2
    wave = SMS * max(1, SM_WARPS[d] // (mg * pw))
    nsplit = max(1, min(MAX_SPLITS, wave // (b * kh), s // (2 * pw * tile)))
    chunk = -(-(-(-s // nsplit)) // tile) * tile
    stages = min(STAGES, -(-(chunk // tile) // pw))
    return Plan(-(-s // chunk), chunk, tile, pw, mg, stages)


def fold_tokens(q: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) -> (B, H*T, D), rows ordered (head, t) (JAX
    `_fold_tokens` :488)."""
    b, t, h, d = q.shape
    return q.transpose(1, 2).reshape(b, h * t, d)


def unfold_tokens(out: torch.Tensor, t: int) -> torch.Tensor:
    """(B, H*T, D) -> (B, T, H, D) (JAX `_unfold_tokens` :495)."""
    b, ht, d = out.shape
    return out.reshape(b, ht // t, t, d).transpose(1, 2)


def _masks(q, s, lengths, tokens):
    """(slot mask (B, S): positions below lengths, which V rows and scales
    may be read at; row mask (B, O, S): the positions each query row sees,
    below lengths - (T - 1) + t for its window token t)."""
    pos = torch.arange(s, device=q.device)
    lens = lengths.to(q.device).long()
    t = torch.arange(q.shape[1], device=q.device) % tokens
    bound = lens[:, None] - (tokens - 1) + t[None, :]
    return pos[None, :] < lens[:, None], pos[None, None, :] < bound[:, :, None]


def _dense_plain(q, k, v, lengths, scale, tokens=1, round_q=False):
    """attention_decode over (B, S, Kh, D) float K/V for query rows q
    (B, O, D), O = H*T. Unread V rows are zeroed by a select first, so NaN
    there cannot reach the output through a zero probability. `round_q`:
    q * scale in q's dtype, as JAX multiplies by a weakly typed scalar
    (its off-TPU `attention_decode` / `attention_verify`); else in f32."""
    b, o, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    rows = o // kh
    valid, seen = _masks(q, s, lengths, tokens)
    v = torch.where(valid[:, :, None, None], v.float(),
                    torch.zeros((), device=v.device))
    if round_q:
        sc = torch.tensor(scale, dtype=q.dtype).float()
        qg = (q.reshape(b, kh, rows, d).float() * sc).to(q.dtype).float()
    else:
        qg = q.reshape(b, kh, rows, d).float() * scale
    xla_rows = round_q and tokens > 1 and q.device.type == "cpu"
    if xla_rows:
        # XLA's verify order (its einsums' operands swapped, four-sum
        # dots) and its softmax: JAX's bf16 rows bit for bit
        kf = k.float().permute(0, 2, 1, 3)
        scores = dot4(kf, qg.transpose(-1, -2)).transpose(-1, -2)
    else:
        scores = torch.einsum("bkrd,bskd->bkrs", qg, k.float())
    scores = torch.where(seen.reshape(b, kh, rows, s), scores,
                         torch.full((), NEG_INF, device=q.device))
    if xla_rows:
        probs = xla_softmax(scores)
        out = dot4(v.permute(0, 2, 3, 1), probs.transpose(-1, -2)
                   ).transpose(-1, -2)
    else:
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkrs,bskd->bkrd", probs, v)
    return out.reshape(b, o, d).to(q.dtype)


def attention_decode_quantized(q, k_q, v_q, k_scale, v_scale, lengths, *,
                               scale: Optional[float] = None,
                               tokens: int = 1):
    """JAX's `attention_decode_quantized` (ops/attention.py:192-228), the
    int8 variant's plain version: q (B, H, D) (or (B, H*T, D) folded query
    rows of a verify window, JAX `attention_verify_quantized` :161-189),
    k_q, v_q (B, S, Kh, D) int8, scales (B, Kh, S) f32. bf16(q * scale)
    against the int8 values, the K scales folded into the f32 scores, and
    bf16(probs * v_scale) against the V values, f32 sums. Rows past each
    length are selected away (values and scales), so a NaN scale there
    cannot reach the output."""
    b, o, d = q.shape
    s, kh = k_q.shape[1], k_q.shape[2]
    rows = o // kh
    scale = scale if scale is not None else d ** -0.5
    valid, seen = _masks(q, s, lengths, tokens)
    zero = torch.zeros((), device=q.device)
    ks = torch.where(valid[:, None, :], k_scale.float(), zero)
    vs = torch.where(valid[:, None, :], v_scale.float(), zero)
    v = torch.where(valid[:, :, None, None], v_q.float(), zero)
    # q * scale in q's dtype, as JAX multiplies by a weakly typed scalar
    sc = torch.tensor(scale, dtype=q.dtype).float()
    qg = (q.reshape(b, kh, rows, d).float() * sc).to(torch.bfloat16).float()
    scores = torch.einsum("bkrd,bskd->bkrs", qg, k_q.float())
    scores = scores * ks[:, :, None, :]
    scores = torch.where(seen.reshape(b, kh, rows, s), scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    pw = (probs * vs[:, :, None, :]).to(torch.bfloat16).float()
    out = torch.einsum("bkrs,bskd->bkrd", pw, v)
    return out.reshape(b, o, d).to(q.dtype)


def _flat_rows(new: NewRows):
    """The new rows as (B*T, F) K and V rows, row b*T + t slot b's t."""
    b, t = new.pos.shape
    return new.k.reshape(b * t, -1), new.v.reshape(b * t, -1)


def _write_plain(k_cache, v_cache, new: NewRows, **store):
    """The step's rows into a contiguous cache by `scatter_rows_plain`, in
    place (row b*T + t is slot b's token t)."""
    b, t = new.pos.shape
    scatter_rows_plain(
        k_cache, v_cache, *_flat_rows(new), new.pos.reshape(-1),
        slots=None if t == 1 else torch.arange(
            b, device=new.pos.device).repeat_interleave(t), **store)


def decode_attention_plain(q, k_cache, v_cache, lengths, *, k_scale=None,
                           v_scale=None, kv_bits: int = 8, v_bits: int = 0,
                           scale: Optional[float] = None, tokens: int = 1,
                           new: Optional[NewRows] = None,
                           xla: bool = False) -> torch.Tensor:
    """q: (B, H*T, D) query rows (T = tokens, folded as `fold_tokens`
    folds them); caches: (B, S, F') flat stores; scales (B, R, S) when
    quantized; lengths: (B,), including the T window rows. The JAX
    package's CPU numerics per variant (module docstring). `new`: first
    `scatter_rows_plain` writes the step's rows (in place). `xla`: the
    JAX package's off-TPU function in q's dtype, which `decode_attention`
    takes for a CPU tensor under `cpu_attention_function("xla")`: int4 and
    k8v4 values dequantized into q's dtype (`kvcache.read(cache, dtype)`)
    and q * scale rounded to it; without it (the default) both stay f32,
    the function the kernels are held to."""
    if new is not None:
        _write_plain(k_cache, v_cache, new, k_scale=k_scale, v_scale=v_scale,
                     kv_bits=kv_bits, v_bits=v_bits)
    b, o, d = q.shape
    s = k_cache.shape[1]
    scale = scale if scale is not None else d ** -0.5
    name = store_variant(k_scale, kv_bits, v_bits)
    kb, vb = STORE_BITS[name]
    if name == "bf16":
        kh = k_cache.shape[2] // d
        return _dense_plain(q, k_cache.reshape(b, s, kh, d),
                            v_cache.reshape(b, s, kh, d), lengths, scale,
                            tokens, round_q=xla)
    kh = scale_heads(k_scale, kb)
    k4 = k_cache.reshape(b, s, kh, -1)
    v4 = v_cache.reshape(b, s, kh, -1)
    if name == "int8":
        return attention_decode_quantized(q, k4, v4, k_scale, v_scale,
                                          lengths, scale=scale, tokens=tokens)
    dt = q.dtype if xla else torch.float32
    return _dense_plain(q, dequant_side(k4, k_scale, kb, dt),
                        dequant_side(v4, v_scale, vb, dt), lengths, scale,
                        tokens, round_q=xla)


#: what `decode_attention` computes for a CPU tensor: "xla" or "kernel"
_cpu_function = "xla"


def cpu_attention_function(name: str) -> str:
    """Choose what `decode_attention` and `decode_attention_paged` compute
    for a CPU tensor, and return the former choice. "xla" (the default):
    the JAX package's CPU function, which never takes the Pallas kernel:
    `decode_attention_plain(xla=True)`, int4 and k8v4 values dequantized
    into q's dtype as JAX's `kvcache.read(cache, dtype)` does, q * scale
    rounded to it. "kernel": the card's function, f32 throughout and the
    int8-dot plain version
    wherever the card takes the int8-dot variant (`int8_dots_default`),
    for a CPU reference that is held against the card's results (the path
    phases of chip_smoke.py, beside ops/matmul.py's
    `cpu_weight_only_function`). CUDA tensors take the kernels either
    way."""
    global _cpu_function
    if name not in ("xla", "kernel"):
        raise ValueError(f"cpu_attention_function: {name!r} is neither "
                         f"'xla' nor 'kernel'")
    old, _cpu_function = _cpu_function, name
    return old


def int8_dots_switch() -> bool:
    """The JAX package's switch DPT_ATTN_INT8, read at each call ("0"
    turns the int8-dot path off; anything else, or unset, on). A captured
    decode step keys its graph by it (runtime/graphs.py), as JAX's jit
    cache keys its kernel."""
    return os.environ.get("DPT_ATTN_INT8", "1") != "0"


def int8_dots_default(name: str, s: int, stacked: bool = False) -> bool:
    """Whether #3 takes its int8-dot path for a store `name` of S
    positions, as the TPU route of the JAX package decides: the switch
    DPT_ATTN_INT8 ("0" turns it off; anything else, or unset, on,
    decode_attention.py:393-399) and K stored as int8 bytes (int8, int4,
    k8v4), at the call sites that reach the kernel (models/transformer.py
    :1179-1183, :1236-1250, :1309-1323): a stacked cache (`layer=`) of S
    >= 128, the int8 store (`attention_decode_auto`, ops/attention.py
    :283-287, and `_verify_attn`) at S >= 128, int4 and k8v4 at any S."""
    if name == "bf16" or not int8_dots_switch():
        return False
    return s >= 128 if stacked or name == "int8" else True


def _resolve_dots(int8_dots: Optional[bool], name: str, s: int) -> bool:
    """None: `int8_dots_default` of a per-layer cache; True only where K
    is stored as int8 bytes (JAX :399)."""
    if int8_dots is None:
        return int8_dots_default(name, s)
    return bool(int8_dots) and name != "bf16"


def int8_dots_block(s: int, f: int, block_s: Optional[int] = None) -> int:
    """Positions of one S block of the TPU kernel's grid over S positions
    of F bytes a K row (JAX `_auto_block_s` :325-335): the largest multiple
    of 128 whose K block fits 2 MiB, at most 1024, or the whole S when it
    fits. The int8-dot path requantizes p per block, so the block is part
    of its function: 1024 at TinyLlama's and Mixtral's heads, 512 at the
    7B's k8v4 (F = 4096)."""
    if block_s is None:
        block_s = min(max((2 << 20) // f // 128 * 128, 128), 1024)
    return s if s <= block_s else block_s


def _i8_share(plan: Plan, blk: int) -> int:
    """A position group's tiles in one block of p's granule, at most
    (csrc `i8_share`)."""
    tiles = min(plan.chunk // plan.tile, -(-blk // plan.tile))
    return -(-tiles // plan.pw)


def int8_dots_smem(plan: Plan, rows: int, d: int, kb: int, vb: int,
                   blk: int, keep: int) -> int:
    """The int8-dot launch's dynamic shared memory in bytes (csrc
    `i8_smem` and `launch`): each group's ring of 2 * stages stages (K or
    V of a tile and its scales; K and V where the group does not keep the
    scores of its whole share of a block), the kept scores (`keep` tiles
    of `rows` rows a group, a row padded to tile + 8 floats), or the
    partials the groups merge at the end where larger, then the exchange
    and q's codes (D codes, qs and two code sums a row)."""
    khb, vhb = d * kb // 8, d * vb // 8
    scales = (2 if kb == 4 else 1) + (2 if vb == 4 else 1)
    compact = keep >= _i8_share(plan, blk)
    data = plan.tile * (max(khb, vhb) if compact else khb + vhb)
    ring = plan.pw * 2 * plan.stages * (data + 4 * plan.tile * scales)
    kept = plan.pw * keep * rows * (plan.tile + 8) * 4
    part = (plan.pw * rows * (d + 2) + 2 * rows) * 4
    exchange = (plan.pw * rows + 2 * rows) * 3 * 4
    return -(-max(ring + kept, part) // 16) * 16 + \
        -(-exchange // 16) * 16 + rows * (d + 3 * 4)


@functools.lru_cache(maxsize=None)
def int8_dots_keep(plan: Plan, rows: int, d: int, kb: int, vb: int,
                   blk: int) -> int:
    """The tiles of one block of p's granule whose scores a position group
    keeps from the first pass for the second, which then reads V alone:
    its whole share where that fits a block's shared memory (SMEM_BLOCK),
    else as many as fit beside rings that hold K and V (the second pass
    reads K again for the rest)."""
    share = _i8_share(plan, blk)
    keep = share
    while keep > 0 and int8_dots_smem(plan, rows, d, kb, vb, blk,
                                      keep) > SMEM_BLOCK:
        keep -= 1
    return keep


def decode_attention_int8_dots_plain(q, k_cache, v_cache, lengths, *,
                                     k_scale, v_scale, kv_bits: int = 8,
                                     v_bits: int = 0,
                                     scale: Optional[float] = None,
                                     tokens: int = 1,
                                     new: Optional[NewRows] = None,
                                     block_s: Optional[int] = None
                                     ) -> torch.Tensor:
    """The int8-dot path of the TPU kernel (`_kernel_mxu` with int8_dots,
    decode_attention.py:196-216, :219-237, :283-301) in plain PyTorch,
    over the stores of `decode_attention_plain` whose K is int8 bytes
    (int8, int4, k8v4; per-layer or a stacked layer's views), for decode
    or a folded verify window. `new`: first `scatter_rows_plain` writes
    the step's rows (in place). Per kv head and query row:
      - qs = max(max|q * scale|, 1e-30) * fl(1 / 127) (q * scale in f32;
        XLA computes JAX's `/ 127.0` so), codes wi8 = clip(round(q *
        scale / qs), -127, 127), half to even;
      - scores: the exact integer dot of wi8 and the K codes, then
        (dot * qs) * k_scale for int8 K; for packed int4 K each D half's
        dot against its nibbles (v + 8, less 8 * the half's code sum),
        (dot0 * ks0 + dot1 * ks1) * qs;
      - then per S block of `int8_dots_block` positions, in order, the
        online softmax in f32, and p times the V scale (per half for
        packed V) requantized per row and block: rs = max(max p, 1e-30) *
        fl(1 / 127), pi8 = clip(round(p / rs), 0, 127); acc = acc * alpha
        + (pi8 . V codes) * rs.
    Positions at or past a row's bound are selected away, their scales
    never multiplied into a sum (the TPU kernel multiplies a zero
    probability into a stale V scale, so a NaN there gives NaN)."""
    if new is not None:
        _write_plain(k_cache, v_cache, new, k_scale=k_scale, v_scale=v_scale,
                     kv_bits=kv_bits, v_bits=v_bits)
    b, o, d = q.shape
    s, fk = k_cache.shape[1], k_cache.shape[2]
    name = store_variant(k_scale, kv_bits, v_bits)
    if name == "bf16":
        raise ValueError("the int8-dot path takes a K stored as int8 bytes")
    kb, vb = STORE_BITS[name]
    kh = scale_heads(k_scale, kb)
    rep = o // kh
    bs = int8_dots_block(s, fk, block_s)
    dev = q.device
    zero = torch.zeros((), device=dev)
    sc = torch.tensor(scale if scale is not None else d ** -0.5,
                      dtype=torch.float32)
    qf = q.float().reshape(b, kh, rep, d) * sc
    # XLA turns JAX's division by the constant 127 into a product with
    # fl(1 / 127) (the jitted kernel's qs and rs, bit for bit)
    inv127 = torch.ones((), dtype=torch.float32) / 127.0
    qs = qf.abs().amax(-1, keepdim=True).clamp_min(1e-30) * inv127
    k4 = k_cache.reshape(b, s, kh, -1)
    v4 = v_cache.reshape(b, s, kh, -1)
    if kb == 4:
        halves = (qf[..., :d // 2], qf[..., d // 2:])
        k_codes = unpack4(k4)
        ks = k_scale.float().reshape(b, kh, 2, s)
    else:
        halves, k_codes = (qf,), (k4,)
        ks = k_scale.float()[:, :, None]
    # exact integer dots (every partial sum below 2^24), then the scales
    parts = [torch.einsum("bkrd,bskd->bkrs",
                          torch.clamp(torch.round(h / qs), -127, 127),
                          c.float()) for h, c in zip(halves, k_codes)]
    if kb == 4:
        scores = (parts[0] * ks[:, :, None, 0]
                  + parts[1] * ks[:, :, None, 1]) * qs
    else:
        scores = (parts[0] * qs) * ks
    valid, seen = _masks(q, s, lengths, tokens)
    seen = seen.reshape(b, kh, rep, s)
    scores = torch.where(seen, scores, torch.full((), NEG_INF, device=dev))
    if vb == 4:
        lo, hi = unpack4(v4)
        v_parts = (lo.float(), hi.float())
        vs = v_scale.float().reshape(b, kh, 2, s)
        v_scales = (vs[:, :, None, 0], vs[:, :, None, 1])
    else:
        v_parts = (v4.float(),)
        v_scales = (v_scale.float()[:, :, None],)
    v_parts = [torch.where(valid[:, :, None, None], v, zero) for v in v_parts]
    m = torch.full((b, kh, rep, 1), NEG_INF, device=dev)
    l = torch.zeros((b, kh, rep, 1), device=dev)
    acc = [torch.zeros((b, kh, rep, v.shape[-1]), device=dev)
           for v in v_parts]
    lens = lengths.to(dev).long()
    for lo_s in range(0, s, bs):
        hi_s = min(lo_s + bs, s)
        live = (lo_s < lens)[:, None, None, None]
        blk = scores[..., lo_s:hi_s]
        sn = seen[..., lo_s:hi_s]
        m_new = torch.maximum(m, blk.amax(-1, keepdim=True))
        p = torch.where(sn, torch.exp(blk - m_new), zero)
        alpha = torch.exp(m - m_new)
        l = torch.where(live, l * alpha + p.sum(-1, keepdim=True), l)
        for i, (v, vsc) in enumerate(zip(v_parts, v_scales)):
            pv = torch.where(sn, p * vsc[..., lo_s:hi_s], zero)
            rs = pv.amax(-1, keepdim=True).clamp_min(1e-30) * inv127
            pi8 = torch.clamp(torch.round(pv / rs), 0, 127)
            di = torch.einsum("bkrs,bskd->bkrd", pi8, v[:, lo_s:hi_s])
            acc[i] = torch.where(live, acc[i] * alpha + di * rs, acc[i])
        m = torch.where(live, m_new, m)
    l_inv = 1.0 / l.clamp_min(1e-30)
    out = torch.cat([a * l_inv for a in acc], -1)
    return out.reshape(b, o, d).to(q.dtype)


def _count(fn, name: str, tokens: int, new: bool = False,
           dots: bool = False) -> None:
    """One launch, counted under its store and window: "int8" for decode,
    "int8:t5" for a verify window of 5; one that wrote the step's rows
    also under "int8+rows", "int8:t5+rows"; one of the int8-dot variant
    also under each of those keys with "i8:" before it ("i8:int8",
    "i8:int8:t5+rows")."""
    key = name if tokens == 1 else f"{name}:t{tokens}"
    keys = [key, key + "+rows"] if new else [key]
    fn.launches += 1
    for k in keys + (["i8:" + k for k in keys] if dots else []):
        fn.variant_launches[k] += 1


def _new_args(new: Optional[NewRows], b: int, tokens: int, f: int):
    """The launch's new-row operands (nk, nk_sb, nk_ts, nv, nv_sb, nv_ts,
    npos), after checking what the kernel takes; None pointers without
    rows."""
    if new is None:
        return [None, 0, 0, None, 0, 0, None]
    for t in (new.k, new.v, new.pos):
        _build.require_cuda(t, "new rows")
    for r in (new.k, new.v):
        if r.dtype != torch.bfloat16 or r.shape != (b, tokens, f) or \
                r.stride(2) != 1:
            raise ValueError(f"new rows must be bf16 (B, T, F) = "
                             f"{(b, tokens, f)} with contiguous features, "
                             f"got {tuple(r.shape)} {r.dtype}")
    if new.pos.dtype != torch.int32 or new.pos.shape != (b, tokens) or \
            not new.pos.is_contiguous():
        raise ValueError(f"new row positions must be contiguous int32 "
                         f"{(b, tokens)}, got {tuple(new.pos.shape)} "
                         f"{new.pos.dtype}")
    return [new.k.data_ptr(), new.k.stride(0), new.k.stride(1),
            new.v.data_ptr(), new.v.stride(0), new.v.stride(1),
            new.pos.data_ptr()]


def _check_common(q, o, d, kh, tokens, name, caches, scales, wrapper,
                  dims=(64, 128)):
    if d not in dims:
        raise NotImplementedError(f"head_dim {d} not supported by "
                                  f"{wrapper}")
    rows = o // max(kh, 1)
    if kh < 1 or tokens < 1 or rows * kh != o or rows % tokens or \
            rows > MAX_ROWS:
        raise NotImplementedError(
            f"{o} query rows of {tokens} tokens over {kh} kv heads (at most "
            f"{MAX_ROWS} rows a kv head)")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(f"CUDA {wrapper} takes bf16 q")
    want = torch.bfloat16 if name == "bf16" else torch.int8
    if any(c.dtype != want for c in caches):
        raise NotImplementedError(f"CUDA {wrapper} takes {want} stores for "
                                  f"the {name} variant")
    if name != "bf16" and any(s is None or s.dtype != torch.float32
                              for s in scales):
        raise NotImplementedError(f"CUDA {wrapper} takes f32 scales")
    return rows


def _aligned(t: torch.Tensor, lead_stride: int, what: str) -> None:
    """The kernel copies 16-byte chunks: the base and the stride between
    slots (or pages) must be multiples of 16 bytes."""
    if t.data_ptr() % 16 or (lead_stride * t.element_size()) % 16:
        raise ValueError(f"{what} must be 16-byte aligned (base and slot "
                         f"stride), got stride {lead_stride}")


def _kv_heads(name, k_cache_width, k_scale, d):
    if name == "bf16":
        return k_cache_width // d
    return scale_heads(k_scale, STORE_BITS[name][0])


def _widths(kh, d, kb, vb):
    return (kh * d // 2 if kb == 4 else kh * d,
            kh * d // 2 if vb == 4 else kh * d)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     kv_bits: int = 8, v_bits: int = 0,
                     scale: Optional[float] = None, tokens: int = 1,
                     new: Optional[NewRows] = None,
                     int8_dots: Optional[bool] = None) -> torch.Tensor:
    """q: (B, H*T, D) query rows, T = tokens (folded as `fold_tokens`
    folds a window); k_cache, v_cache: (B, S, F') stores (bf16 F' = Kh*D;
    int8 Kh*D; packed int4 Kh*D/2); k_scale, v_scale: (B, R, S) f32 when
    quantized; lengths: (B,) valid positions per slot (including the
    current token, or all T window tokens); `new`: the step's rows, written
    by the same launch before it reads them (module docstring);
    `int8_dots`: the int8-dot path, as JAX's `decode_attention_mxu` takes
    it (None: `int8_dots_default` of a per-layer cache). Returns (B, H*T,
    D). A CPU tensor takes the plain version of `cpu_attention_function`'s
    choice; a CUDA tensor launches the kernel or raises."""
    name = store_variant(k_scale, kv_bits, v_bits)
    dots = _resolve_dots(int8_dots, name, k_cache.shape[1])
    if not q.is_cuda:
        kw = dict(k_scale=k_scale, v_scale=v_scale, kv_bits=kv_bits,
                  v_bits=v_bits, scale=scale, tokens=tokens, new=new)
        if _cpu_function == "kernel":
            plain = (decode_attention_int8_dots_plain if dots
                     else decode_attention_plain)
            return plain(q, k_cache, v_cache, lengths, **kw)
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      xla=True, **kw)
    out = _launch(q, k_cache, v_cache, lengths, k_scale=k_scale,
                  v_scale=v_scale, kv_bits=kv_bits, v_bits=v_bits,
                  scale=scale, tokens=tokens, new=new, int8_dots=dots)
    _count(decode_attention, name, tokens, new is not None, dots)
    return out


def _launch(q, k_cache, v_cache, lengths, *, k_scale, v_scale, kv_bits,
            v_bits, scale, tokens, new=None, int8_dots=False):
    """Check the operands of the contiguous kernel and launch it, or its
    int8-dot variant (not counted: its callers count their own
    launches)."""
    name = store_variant(k_scale, kv_bits, v_bits)
    b, o, d = q.shape
    s = k_cache.shape[1]
    kb, vb = STORE_BITS[name]
    tensors = [k_cache, v_cache, lengths] + (
        [k_scale, v_scale] if name != "bf16" else [])
    for t in tensors:
        _build.require_cuda(t, "decode_attention operand")
    kh = _kv_heads(name, k_cache.shape[2], k_scale, d)
    rows = _check_common(q, o, d, kh, tokens, name, (k_cache, v_cache),
                         (k_scale, v_scale), "decode_attention",
                         dims=(32, 64, 128))
    kw, vw = _widths(kh, d, kb, vb)
    for c, w in ((k_cache, kw), (v_cache, vw)):
        if c.dim() != 3 or c.shape[:2] != (b, s) or c.shape[2] != w or \
                c.stride(2) != 1 or c.stride(1) != w:
            raise ValueError(f"caches must be (B, S, {w}) views with "
                             f"contiguous rows, got {tuple(c.shape)}")
    if kb == vb and k_cache.stride(0) != v_cache.stride(0):
        raise ValueError("K and V caches of one store must share strides")
    for c in (k_cache, v_cache):
        _aligned(c, c.stride(0), "decode_attention caches")
    sc_args = [None, 0, 0, None, 0, 0]
    if name != "bf16":
        for sc, bits in ((k_scale, kb), (v_scale, vb)):
            srows = kh * (2 if bits == 4 else 1)
            if sc.dim() != 3 or sc.shape[:2] != (b, srows) or \
                    sc.shape[2] < s or sc.stride(2) != 1:
                raise ValueError(f"scales must be (B, {srows}, >= S) with "
                                 f"contiguous positions, got "
                                 f"{tuple(sc.shape)}")
        sc_args = [k_scale.data_ptr(), k_scale.stride(0), k_scale.stride(1),
                   v_scale.data_ptr(), v_scale.stride(0), v_scale.stride(1)]
    if q.stride(2) != 1 or q.stride(1) != d:
        q = q.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    scale = scale if scale is not None else d ** -0.5
    plan = attention_plan(b, kh, s, rows, compute_dim(d))
    out = torch.empty((b, o, d), dtype=torch.bfloat16, device=q.device)
    lib = _build.library()
    args = [q.data_ptr(), q.stride(0), k_cache.data_ptr(), k_cache.stride(0),
            v_cache.data_ptr(), v_cache.stride(0), *sc_args, lens.data_ptr(),
            b, s, kh, rows, tokens, d, kb, vb, *plan, float(scale),
            out.data_ptr(), *_new_args(new, b, tokens, kh * d)]
    if int8_dots:
        blk = int8_dots_block(s, kw)
        keep = int8_dots_keep(plan, rows, compute_dim(d), kb, vb, blk)
        rc = lib.dpt_decode_attention_i8(*args, blk, keep, _build.stream())
    else:
        rc = lib.dpt_decode_attention(*args, _build.stream())
    _build.check(rc, "decode_attention")
    return out


decode_attention.launches = 0
decode_attention.variant_launches = collections.Counter()


def decode_attention_paged_plain(q, k_pool, v_pool, table, lengths, *,
                                 k_scale=None, v_scale=None, kv_bits: int = 8,
                                 v_bits: int = 0,
                                 scale: Optional[float] = None,
                                 tokens: int = 1,
                                 new: Optional[NewRows] = None,
                                 xla: bool = False) -> torch.Tensor:
    """q: (B, H*T, D); pools: (P, page, F'); scale pools (P, R, page) when
    quantized; table: (B, WP); lengths: (B,). `new`: first
    `scatter_pool_rows_plain` writes the step's rows (in place). Gathers
    each slot's pages (and their scales) into its virtual (B, WP*page, F')
    view and applies decode_attention_plain, whose selects keep stale rows
    and stale scales (a released page's previous occupant, NaN included)
    out of the output."""
    if new is not None:
        scatter_pool_rows_plain(k_pool, v_pool, *_flat_rows(new), new.rows,
                                new.valid, k_scale=k_scale, v_scale=v_scale,
                                kv_bits=kv_bits, v_bits=v_bits)
    b, wp = table.shape
    ids = table.reshape(-1).long()

    def gather(pool):
        return pool[ids].reshape(b, wp * pool.shape[1], pool.shape[2])

    scales = {}
    if k_scale is not None:
        scales = dict(k_scale=gather_scale(k_scale, table),
                      v_scale=gather_scale(v_scale, table))
    return decode_attention_plain(q, gather(k_pool), gather(v_pool), lengths,
                                  kv_bits=kv_bits, v_bits=v_bits, scale=scale,
                                  tokens=tokens, xla=xla, **scales)


def decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           kv_bits: int = 8, v_bits: int = 0,
                           scale: Optional[float] = None, tokens: int = 1,
                           new: Optional[NewRows] = None) -> torch.Tensor:
    """q: (B, H*T, D) query rows, T = tokens; k_pool, v_pool: (P, page,
    F') stores; k_scale, v_scale: (P, R, page) f32 when quantized; table:
    (B, WP) int32 page ids; lengths: (B,) valid positions per slot
    (including the current token, or all T window tokens), at most WP *
    page; `new`: the step's rows with their pool rows, written by the same
    launch before it reads them. Returns (B, H*T, D). A CPU tensor takes
    the plain version of `cpu_attention_function`'s choice; a CUDA tensor
    launches the kernel or raises."""
    name = store_variant(k_scale, kv_bits, v_bits)
    if not q.is_cuda:
        return decode_attention_paged_plain(
            q, k_pool, v_pool, table, lengths, k_scale=k_scale,
            v_scale=v_scale, kv_bits=kv_bits, v_bits=v_bits, scale=scale,
            tokens=tokens, new=new, xla=_cpu_function == "xla")
    b, o, d = q.shape
    p, ps = k_pool.shape[0], k_pool.shape[1]
    wp = table.shape[1]
    kb, vb = STORE_BITS[name]
    tensors = [k_pool, v_pool, table, lengths] + (
        [k_scale, v_scale] if name != "bf16" else [])
    for t in tensors:
        _build.require_cuda(t, "decode_attention_paged operand")
    kh = _kv_heads(name, k_pool.shape[2], k_scale, d)
    rows = _check_common(q, o, d, kh, tokens, name, (k_pool, v_pool),
                         (k_scale, v_scale), "decode_attention_paged")
    kw, vw = _widths(kh, d, kb, vb)
    for c, w in ((k_pool, kw), (v_pool, vw)):
        if c.shape != (p, ps, w) or not c.is_contiguous():
            raise ValueError(f"pools must be contiguous ({p}, {ps}, {w}), "
                             f"got {tuple(c.shape)}")
        _aligned(c, c.stride(0), "decode_attention_paged pools")
    ks_ptr = vs_ptr = None
    if name != "bf16":
        for sc, bits in ((k_scale, kb), (v_scale, vb)):
            srows = kh * (2 if bits == 4 else 1)
            if sc.shape != (p, srows, ps) or not sc.is_contiguous():
                raise ValueError(f"scale pools must be contiguous ({p}, "
                                 f"{srows}, {ps}), got {tuple(sc.shape)}")
        ks_ptr, vs_ptr = k_scale.data_ptr(), v_scale.data_ptr()
    if table.dim() != 2 or table.shape[0] != b or table.stride(1) != 1:
        raise ValueError(f"table must be (B, WP) with contiguous rows, got "
                         f"{tuple(table.shape)}")
    if q.stride(2) != 1 or q.stride(1) != d:
        q = q.contiguous()
    tab = table if table.dtype == torch.int32 else table.to(torch.int32)
    lens = lengths.to(torch.int32).contiguous()
    scale = scale if scale is not None else d ** -0.5
    nargs = _new_args(new, b, tokens, kh * d)
    rows_args = [None, None]
    if new is not None:
        for t in (new.rows, new.valid):
            _build.require_cuda(t, "new rows")
        if new.rows.dtype != torch.int32 or new.valid.dtype != torch.bool \
                or new.rows.shape != (b * tokens,) \
                or new.valid.shape != (b * tokens,) \
                or not new.rows.is_contiguous() \
                or not new.valid.is_contiguous():
            raise ValueError(f"new pool rows must be contiguous int32 and "
                             f"bool ({b * tokens},), got "
                             f"{tuple(new.rows.shape)} {new.rows.dtype}, "
                             f"{tuple(new.valid.shape)} {new.valid.dtype}")
        rows_args = [new.rows.data_ptr(), new.valid.data_ptr()]
    plan = attention_plan(b, kh, wp * ps, rows, d, page=ps)
    out = torch.empty((b, o, d), dtype=torch.bfloat16, device=q.device)
    rc = _build.library().dpt_decode_attention_paged(
        q.data_ptr(), q.stride(0), k_pool.data_ptr(), v_pool.data_ptr(),
        ks_ptr, vs_ptr, tab.data_ptr(), tab.stride(0), ps, lens.data_ptr(), b,
        wp, kh, rows, tokens, d, kb, vb, *plan, float(scale), out.data_ptr(),
        p, *nargs, *rows_args, _build.stream())
    _build.check(rc, "decode_attention_paged")
    _count(decode_attention_paged, name, tokens, new is not None)
    return out


decode_attention_paged.launches = 0
decode_attention_paged.variant_launches = collections.Counter()


def verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     **kw) -> torch.Tensor:
    """Speculative-verify attention (JAX `verify_attention_mxu` :501): q
    (B, T, H, D) window queries over the stores of `decode_attention`
    (which already hold the window's K/V); lengths (B,) tokens cached
    BEFORE the window. The window folds into T query rows a head, one
    launch for all of them. Returns (B, T, H, D)."""
    t = q.shape[1]
    out = decode_attention(fold_tokens(q), k_cache, v_cache, lengths + t,
                           tokens=t, **kw)
    return unfold_tokens(out, t)


def verify_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor,
                           lengths: torch.Tensor, **kw) -> torch.Tensor:
    """`verify_attention` over the paged pools (JAX
    `verify_attention_paged_mxu` :1235). Returns (B, T, H, D)."""
    t = q.shape[1]
    out = decode_attention_paged(fold_tokens(q), k_pool, v_pool, table,
                                 lengths + t, tokens=t, **kw)
    return unfold_tokens(out, t)


# ---------------------------------------------------------------------------
# The chunk-transposed K mirror (kernel #7) and the per-head kernel (#11)
# ---------------------------------------------------------------------------

#: positions a kt chunk holds
KT_CHUNK = 128


def kt_group(f: int, c_chunks: int) -> int:
    """Chunks a committed unit of the TPU kernel's loop reads at once (JAX
    `kt_group` :834); the plain version walks the same units, so its
    online softmax rounds where the TPU kernel's does."""
    grp = max(1, min(8, 2048 // max(f, 1)))
    while grp > 1 and c_chunks % grp:
        grp -= 1
    return grp


def _kt_units(ln: int, full: int, grp: int):
    """(first chunk, chunks, tail?) of one slot's units, in the TPU
    kernel's order (`unit_of` :887-895): committed groups, then the
    128-row tail units."""
    units = [(c0, grp, False) for c0 in range(0, full, grp)]
    n_tail = ln - full * KT_CHUNK
    units += [(full + j, 1, True)
              for j in range(-(-n_tail // KT_CHUNK))]
    return units


def decode_attention_kt_plain(q, kt, k, v, lengths, k_scale, v_scale, *,
                              scale: Optional[float] = None,
                              tokens: int = 1, v_bits: int = 8):
    """The kt kernel's function in plain PyTorch (JAX `_kt_kernel` :845),
    unit by unit as the TPU kernel walks them: q rounded to bf16 after the
    scale, scores (q . k_int) * k_scale in f32, an online softmax in f32,
    bf16(p * v_scale) against the V values; committed chunks read from kt,
    the rest from the row-major k; each tail chunk that lies whole below
    the length is written into kt (in place). Positions past a row's bound
    are selected away, their V scales never multiplied by 0. Returns
    (out (B, O, D), kt)."""
    b, o, d = q.shape
    c_n, f = kt.shape[1], kt.shape[2]
    kh = f // d
    rep = o // kh
    scale = scale if scale is not None else d ** -0.5
    grp = kt_group(f, c_n)
    ch = KT_CHUNK
    qb = (q.float() * scale).to(torch.bfloat16).float().reshape(b, kh, rep, d)
    t_row = torch.arange(rep, device=q.device) % tokens
    out = torch.zeros((b, o, d), dtype=q.dtype, device=q.device)
    zero = torch.zeros((), device=q.device)
    for i, ln in enumerate(lengths.tolist()):
        if ln <= 0:
            continue
        full = max((ln - tokens) // ch, 0)
        m = torch.full((kh, rep), NEG_INF, device=q.device)
        l = torch.zeros((kh, rep), device=q.device)
        acc = torch.zeros((kh, rep, d), device=q.device)
        for c0, g, tail in _kt_units(ln, full, grp):
            pos = torch.arange(c0 * ch, (c0 + g) * ch, device=q.device)
            if tail:
                rows = k[i, c0 * ch:(c0 + 1) * ch]                  # (128, F)
                kk = rows.reshape(ch, kh, d).permute(1, 2, 0)
                bound = ln - (tokens - 1) + t_row
                valid = pos[None, :] < bound[:, None]
                if (c0 + 1) * ch <= ln:                             # flush
                    kt[i, c0] = rows.t()
            else:
                kk = kt[i, c0:c0 + g].reshape(g, kh, d, ch).permute(
                    1, 2, 0, 3).reshape(kh, d, g * ch)
                valid = (pos < full * ch)[None, :].expand(rep, -1)
            s = torch.einsum("krd,kdn->krn", qb[i], kk.float())
            s = s * k_scale[i][:, None, pos]
            s = torch.where(valid[None], s, torch.full((), NEG_INF,
                                                       device=q.device))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(valid[None], torch.exp(s - m_new[..., None]),
                            zero)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            m = m_new
            vrows = v[i, pos].reshape(pos.numel(), kh, -1).transpose(0, 1)
            if v_bits == 4:
                lo, hi = unpack4(vrows)
                vsc = v_scale[i].reshape(kh, 2, -1)[:, :, pos]
                pv = torch.cat([
                    _bf16_probs(p, vsc[:, 0], valid) @ lo.float(),
                    _bf16_probs(p, vsc[:, 1], valid) @ hi.float()], -1)
            else:
                pv = _bf16_probs(p, v_scale[i][:, pos], valid) @ \
                    vrows.float()
            acc = acc * alpha[..., None] + pv
        out[i] = (acc * (1.0 / l.clamp_min(1e-30))[..., None]).reshape(
            o, d).to(q.dtype)
    return out, kt


def _bf16_probs(p, vs, valid):
    """bf16(p * v_scale) over (Kh, rows, n) probabilities and (Kh, n) V
    scales, 0 where a position is not visible."""
    w = torch.where(valid[None], p * vs[:, None, :],
                    torch.zeros((), device=p.device))
    return w.to(torch.bfloat16).float()


def _kt_check(q, kt, k, v, lengths, k_scale, v_scale, tokens, v_bits):
    """Check what the kt kernel takes; returns (B, C, Kh, rows)."""
    b, o, d = q.shape
    c_n, f = kt.shape[1], kt.shape[2]
    kh = f // d
    rows = o // max(kh, 1)
    s = c_n * KT_CHUNK
    fv = f // 2 if v_bits == 4 else f
    for t in (kt, k, v, lengths, k_scale, v_scale):
        _build.require_cuda(t, "decode_attention_kt operand")
    if d not in (64, 128) or q.dtype != torch.bfloat16 or kh * d != f or \
            rows * kh != o or rows % tokens or rows > MAX_ROWS or \
            v_bits not in (8, 4):
        raise NotImplementedError(
            f"CUDA decode_attention_kt takes bf16 q of head_dim 64 or 128, "
            f"at most {MAX_ROWS} rows a kv head and v_bits 8 or 4; got q "
            f"{tuple(q.shape)} {q.dtype} over F = {f}, v_bits {v_bits}")
    want = {kt: (b, c_n, f, KT_CHUNK), k: (b, s, f), v: (b, s, fv)}
    for t, shape in want.items():
        if t.dtype != torch.int8 or tuple(t.shape) != shape or \
                not t.is_contiguous() or t.data_ptr() % 16:
            raise NotImplementedError(
                f"kt, k and v must be contiguous 16-byte aligned int8 "
                f"{list(want.values())}, got {tuple(t.shape)} {t.dtype}")
    for sc, r in ((k_scale, kh), (v_scale, 2 * kh if v_bits == 4 else kh)):
        if sc.dtype != torch.float32 or tuple(sc.shape) != (b, r, s) or \
                not sc.is_contiguous():
            raise NotImplementedError(
                f"scales must be contiguous f32 ({b}, {r}, {s}), got "
                f"{tuple(sc.shape)} {sc.dtype}")
    return b, c_n, kh, rows


def decode_attention_kt(q: torch.Tensor, kt: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, lengths: torch.Tensor,
                        k_scale: torch.Tensor, v_scale: torch.Tensor, *,
                        scale: Optional[float] = None, tokens: int = 1,
                        v_bits: int = 8):
    """Decode (or, with tokens = T, folded verify) attention over an int8-K
    cache that carries the chunk-transposed mirror (JAX
    `decode_attention_kt` :1081): q (B, H*T, D); kt (B, C, Kh*D, 128) int8,
    updated in place; k (B, C*128, Kh*D) int8, the row-major source; v
    (B, C*128, FV) int8 or packed int4 (v_bits 4); k_scale (B, Kh, S),
    v_scale (B, Kh | 2*Kh, S) f32; lengths (B,) including the T window rows.
    Returns (out (B, H*T, D), kt). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if not q.is_cuda:
        return decode_attention_kt_plain(q, kt, k, v, lengths, k_scale,
                                         v_scale, scale=scale, tokens=tokens,
                                         v_bits=v_bits)
    b, c_n, kh, rows = _kt_check(q, kt, k, v, lengths, k_scale, v_scale,
                                 tokens, v_bits)
    o, d = q.shape[1], q.shape[2]
    if q.stride(2) != 1 or q.stride(1) != d:
        q = q.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    scale = scale if scale is not None else d ** -0.5
    plan = attention_plan(b, kh, c_n * KT_CHUNK, rows, d)
    out = torch.empty((b, o, d), dtype=torch.bfloat16, device=q.device)
    rc = _build.library().dpt_decode_attention_kt(
        q.data_ptr(), q.stride(0), kt.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), lens.data_ptr(), b, c_n, kh,
        rows, tokens, d, v_bits, *plan, float(scale), out.data_ptr(),
        _build.stream())
    _build.check(rc, "decode_attention_kt")
    _count(decode_attention_kt, "k8v4" if v_bits == 4 else "int8", tokens)
    return out, kt


decode_attention_kt.launches = 0
decode_attention_kt.variant_launches = collections.Counter()


def verify_attention_kt(q: torch.Tensor, kt: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, lengths: torch.Tensor,
                        k_scale: torch.Tensor, v_scale: torch.Tensor, *,
                        scale: Optional[float] = None, v_bits: int = 8):
    """Speculative-verify attention over the kt layout (JAX
    `verify_attention_kt` :1148): q (B, T, H, D), lengths (B,) tokens
    cached before the window. Returns (out (B, T, H, D), kt)."""
    t = q.shape[1]
    out, kt = decode_attention_kt(fold_tokens(q), kt, k, v, lengths + t,
                                  k_scale, v_scale, scale=scale, tokens=t,
                                  v_bits=v_bits)
    return unfold_tokens(out, t), kt


def decode_attention_kernel_plain(q, k_cache, v_cache, lengths, k_scale=None,
                                  v_scale=None, *,
                                  block_s: Optional[int] = None,
                                  scale: Optional[float] = None):
    """JAX `_kernel` (:42-95) in plain PyTorch: f32 throughout, K and V
    dequantized by their (B, Kh, S) scales, positions past `lengths`
    masked. The TPU kernel's blocks of `block_s` rows change only its
    online softmax's rounding, not the function. V rows past the length
    are selected away (the TPU kernel multiplies p = 0 into the last
    block's stale rows, so a NaN there gives NaN)."""
    del block_s
    b, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kf, vf = k_cache.float(), v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale.float().transpose(1, 2)[..., None]
        vf = vf * v_scale.float().transpose(1, 2)[..., None]
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])
    vf = torch.where(valid[:, :, None, None], vf,
                     torch.zeros((), device=q.device))
    qg = q.float().reshape(b, kh, h // kh, d) * scale
    scores = torch.einsum("bkrd,bskd->bkrs", qg, kf)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=q.device))
    out = torch.einsum("bkrs,bskd->bkrd", torch.softmax(scores, -1), vf)
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, lengths: torch.Tensor,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None, *,
                            block_s: Optional[int] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Per-head decode attention (JAX `decode_attention_kernel` :1160): q
    (B, H, D); k_cache, v_cache (B, S, Kh, D) bf16, or int8 with (B, Kh, S)
    f32 scales; lengths (B,). Returns (B, H, D). On the card it launches
    kernel #3's CUDA kernel on the flat (B, S, Kh*D) view of the same
    memory, which computes this function with bf16 operands and f32 sums;
    its launches count here. `block_s` tiles the TPU's VMEM and is not
    used. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if not q.is_cuda:
        return decode_attention_kernel_plain(q, k_cache, v_cache, lengths,
                                             k_scale, v_scale,
                                             block_s=block_s, scale=scale)
    b, s, kh, d = k_cache.shape
    for c in (k_cache, v_cache):
        if c.shape != (b, s, kh, d) or not c.is_contiguous():
            raise NotImplementedError(
                f"caches must be contiguous (B, S, Kh, D) = {(b, s, kh, d)}, "
                f"got {tuple(c.shape)}")
    if k_scale is not None and k_cache.dtype != torch.int8:
        raise NotImplementedError("scaled caches must be int8")
    out = _launch(q, k_cache.view(b, s, kh * d), v_cache.view(b, s, kh * d),
                  lengths, k_scale=k_scale, v_scale=v_scale, kv_bits=8,
                  v_bits=0, scale=scale, tokens=1)
    _count(decode_attention_kernel, store_variant(k_scale), 1)
    return out


decode_attention_kernel.launches = 0
decode_attention_kernel.variant_launches = collections.Counter()
