"""In-place KV-cache row writes: wrappers, plain versions and launch
counts of three kernels, K and V of one layer (and their scale columns) in
one launch: a decode token per slot, or a prefill's rows. CUDA source:
csrc/kv_append.cu.

`scatter_rows` replaces the Pallas TPU kernel
deeppowers_tpu/ops/pallas/kv_append.py (`scatter_rows` :116 ->
`_scatter_one` :69, pallas_call :104, body `_kernel` :43) for flat
(B, S, F') caches: rows[i] go to cache[slots[i], positions[i]] (slot i
without `slots`); a slot outside [0, B) or a position outside [0, S) is
dropped, with no write and no fault.

`scatter_rows_stacked` replaces `scatter_rows_stacked` :328 (pallas_call
:315, body `_kernel_stacked` :252) for the stacked (L, B, S, F') caches of
scan-over-layers (runtime/kvcache_stacked.py): the same rows into
[layer, slot, position], the layer an int32 read on the device, with
(L, B, R, S) scales; its launches count under their own name.

`scatter_pool_rows` replaces `scatter_pool_rows` :225 (pallas_call :207,
body `_kernel_pool` :146) for the paged layout's (P, page, F') pools and
their (P, R, page) scale pools: rows[b] go to absolute row row_idx[b] of
the flat (P*page, F') view where valid[b]; an invalid row is not written
at all. (The TPU kernel writes the old content back into its 8-row tile,
a tiling artefact.)

Stores, named as quant/kvquant.py's `store_variant` names them: "bf16"
(rows copied), and the quantized caches of runtime/kvcache.py, whose rows
arrive unquantized as (B, Kh*D) and are quantized inside the launch
(quant/kvquant.py's arithmetic, bit for bit): "int8" (int8 K and V, one
f32 scale per head), "int4" (packed int4 K and V, two sub-block scales
per head), "k8v4" (int8 K, packed int4 V). Scales are head-major:
(B, R, S) or (P, R, page) with R = Kh for an int8 side and 2*Kh for an
int4 side. The TPU kernel only scatters rows that XLA quantized; fusing
the quantization into the scatter replaces some ten eager ops per side per
layer.

Both write IN PLACE (the JAX versions return aliased buffers). Bound on
an H100: the bytes written and read, far below the fixed cost of a
launch; the point of the kernels is to touch nothing else.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from ...quant.kvquant import (STORE_BITS, quant_for, scale_heads,
                              store_variant)
from . import _build


def _count(fn, name: str) -> None:
    fn.launches += 1
    fn.variant_launches[name] += 1


def scatter_rows_plain(k_cache, v_cache, k_rows, v_rows, positions, *,
                       slots=None, k_scale=None, v_scale=None,
                       kv_bits: int = 8, v_bits: int = 0) -> None:
    """The kernel's effect in plain PyTorch (in place)."""
    b, s = k_cache.shape[0], k_cache.shape[1]
    pos = positions.long()
    slot = (torch.arange(b, device=k_cache.device) if slots is None
            else slots.long())
    keep = (pos >= 0) & (pos < s) & (slot >= 0) & (slot < b)
    slots = slot[keep]
    if k_scale is None:
        k_cache[slots, pos[keep]] = k_rows[keep].to(k_cache.dtype)
        v_cache[slots, pos[keep]] = v_rows[keep].to(v_cache.dtype)
        return
    for cache, sc, rows, bits in ((k_cache, k_scale, k_rows, kv_bits),
                                  (v_cache, v_scale, v_rows,
                                   v_bits or kv_bits)):
        q, qs = quant_for(rows[keep], sc, bits)
        cache[slots, pos[keep]] = q
        sc[slots, :, pos[keep]] = qs


def _launch_args(name, caches, scales, rows, lead: tuple, minor: int):
    """Check what the kernels take and return (k_bits, v_bits, Kh, D):
    bf16 rows (B, Kh*D) with contiguous features; contiguous stores (*lead,
    minor, F') of the variant's dtype and width and, when quantized,
    contiguous f32 (*lead, R, minor) scales."""
    kb, vb = STORE_BITS[name]
    b, f = rows[0].shape
    for r in rows:
        if r.shape != (b, f) or r.dtype != torch.bfloat16 or \
                r.stride(-1) != 1:
            raise ValueError(f"rows must be bf16 (B, F) = {(b, f)} with "
                             f"contiguous features, got {tuple(r.shape)} "
                             f"{r.dtype}")
    if name == "bf16":
        kh, d = 1, f
        want = torch.bfloat16
    else:
        kh = scale_heads(scales[0], kb)
        d = f // max(kh, 1)
        want = torch.int8
        if scale_heads(scales[1], vb) != kh or kh * d != f or d % 2:
            raise NotImplementedError(
                f"CUDA {name} stores need K and V scales over the same kv "
                f"heads and an even head width, got scales "
                f"{[tuple(s.shape) for s in scales]} for rows of {f}")
        for sc, bits in zip(scales, (kb, vb)):
            if (sc.dtype != torch.float32 or not sc.is_contiguous()
                    or sc.shape != (*lead, kh * (2 if bits == 4 else 1),
                                    minor)):
                raise NotImplementedError(
                    f"scales must be contiguous f32 (*{lead}, R, {minor}), "
                    f"got {tuple(sc.shape)} {sc.dtype}")
    for cache, bits in zip(caches, (kb, vb)):
        width = f // 2 if bits == 4 else f
        if (cache.dtype != want or not cache.is_contiguous()
                or cache.shape != (*lead, minor, width)):
            raise NotImplementedError(
                f"CUDA {name} stores must be contiguous {want} (*{lead}, "
                f"{minor}, {width}), got {tuple(cache.shape)} {cache.dtype}")
    return kb, vb, kh, d


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _rows_at(positions, slots, n: int, b: int):
    """int32 (N,) positions and slots (or None: N = B, row i into slot i)
    for a launch; no copy when they already are."""
    pos = positions.to(torch.int32).contiguous()
    if pos.shape != (n,) or (slots is None and n != b):
        raise ValueError(f"positions must be (N,) for N rows, and N = B "
                         f"without slots; got {tuple(pos.shape)} for {n} "
                         f"rows, B = {b}")
    sl = None
    if slots is not None:
        sl = slots.to(torch.int32).contiguous()
        if sl.shape != (n,):
            raise ValueError(f"slots must be (N,), got {tuple(sl.shape)}")
    return pos, sl


def scatter_rows(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_rows: torch.Tensor, v_rows: torch.Tensor,
                 positions: torch.Tensor, *,
                 slots: Optional[torch.Tensor] = None,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None, kv_bits: int = 8,
                 v_bits: int = 0) -> None:
    """k_cache, v_cache: (B, S, F') stores, updated in place: bf16 (F' = F)
    or, with k_scale/v_scale (B, R, S) f32, int8 (F' = F) or packed int4
    (F' = F/2) per kv_bits / v_bits. k_rows, v_rows: (N, F) unquantized.
    positions: (N,) int; slots: (N,) int, or None when N = B (row i into
    slot i). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    name = store_variant(k_scale, kv_bits, v_bits)
    if not k_cache.is_cuda:
        scatter_rows_plain(k_cache, v_cache, k_rows, v_rows, positions,
                           slots=slots, k_scale=k_scale, v_scale=v_scale,
                           kv_bits=kv_bits, v_bits=v_bits)
        return
    b, s = k_cache.shape[0], k_cache.shape[1]
    for t in (v_cache, k_rows, v_rows, positions, slots, k_scale, v_scale):
        if t is not None:
            _build.require_cuda(t, "scatter_rows operand")
    kb, vb, kh, d = _launch_args(name, (k_cache, v_cache), (k_scale, v_scale),
                                 (k_rows, v_rows), (b,), s)
    n = k_rows.shape[0]
    pos, sl = _rows_at(positions, slots, n, b)
    rc = _build.library().dpt_kv_append(
        k_cache.data_ptr(), v_cache.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        k_rows.data_ptr(), k_rows.stride(0), v_rows.data_ptr(),
        v_rows.stride(0), pos.data_ptr(), _ptr(sl), n, b, s, kh, d, kb, vb,
        _build.stream())
    _build.check(rc, "scatter_rows")
    _count(scatter_rows, name)


scatter_rows.launches = 0
scatter_rows.variant_launches = collections.Counter()


def scatter_rows_stacked_plain(k_cache, v_cache, k_rows, v_rows, layer,
                               positions, *, slots=None, k_scale=None,
                               v_scale=None, kv_bits: int = 8,
                               v_bits: int = 0) -> None:
    """The kernel's effect in plain PyTorch (in place): scatter_rows_plain
    on the layer's views. A layer outside [0, L) writes nothing."""
    lay = int(layer.reshape(-1)[0]) if torch.is_tensor(layer) else int(layer)
    if not 0 <= lay < k_cache.shape[0]:
        return
    scales = {}
    if k_scale is not None:
        scales = dict(k_scale=k_scale[lay], v_scale=v_scale[lay])
    scatter_rows_plain(k_cache[lay], v_cache[lay], k_rows, v_rows, positions,
                       slots=slots, kv_bits=kv_bits, v_bits=v_bits, **scales)


def scatter_rows_stacked(k_cache: torch.Tensor, v_cache: torch.Tensor,
                         k_rows: torch.Tensor, v_rows: torch.Tensor,
                         layer: torch.Tensor, positions: torch.Tensor, *,
                         slots: Optional[torch.Tensor] = None,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None,
                         kv_bits: int = 8, v_bits: int = 0) -> None:
    """`scatter_rows` into layer `layer` of the stacked scan-over-layers
    caches (JAX `scatter_rows_stacked` :328): k_cache, v_cache (L, B, S,
    F') stores, updated in place, with (L, B, R, S) f32 scales when
    quantized; layer: a (1,) int32 tensor on the caches' device, which the
    kernel reads there (no host value per layer); the rows, positions and
    slots as `scatter_rows` takes them. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    name = store_variant(k_scale, kv_bits, v_bits)
    if not k_cache.is_cuda:
        scatter_rows_stacked_plain(k_cache, v_cache, k_rows, v_rows, layer,
                                   positions, slots=slots, k_scale=k_scale,
                                   v_scale=v_scale, kv_bits=kv_bits,
                                   v_bits=v_bits)
        return
    n_layers, b, s = k_cache.shape[:3]
    for t in (v_cache, k_rows, v_rows, layer, positions, slots, k_scale,
              v_scale):
        if t is not None:
            _build.require_cuda(t, "scatter_rows_stacked operand")
    if layer.dtype != torch.int32 or layer.numel() != 1:
        raise ValueError(f"layer must be one int32 on the device, got "
                         f"{tuple(layer.shape)} {layer.dtype}")
    kb, vb, kh, d = _launch_args(name, (k_cache, v_cache), (k_scale, v_scale),
                                 (k_rows, v_rows), (n_layers, b), s)
    n = k_rows.shape[0]
    pos, sl = _rows_at(positions, slots, n, b)
    rc = _build.library().dpt_kv_append_stacked(
        k_cache.data_ptr(), v_cache.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        k_rows.data_ptr(), k_rows.stride(0), v_rows.data_ptr(),
        v_rows.stride(0), layer.data_ptr(), pos.data_ptr(), _ptr(sl), n,
        n_layers, b, s, kh, d, kb, vb, _build.stream())
    _build.check(rc, "scatter_rows_stacked")
    _count(scatter_rows_stacked, name)


scatter_rows_stacked.launches = 0
scatter_rows_stacked.variant_launches = collections.Counter()


def scatter_pool_rows_plain(k_pool, v_pool, k_rows, v_rows, row_idx, valid,
                            *, k_scale=None, v_scale=None, kv_bits: int = 8,
                            v_bits: int = 0) -> None:
    """The kernel's effect in plain PyTorch (in place)."""
    rows = row_idx.long()[valid]
    if k_scale is None:
        f = k_pool.shape[2]
        k_pool.view(-1, f)[rows] = k_rows[valid].to(k_pool.dtype)
        v_pool.view(-1, f)[rows] = v_rows[valid].to(v_pool.dtype)
        return
    ps = k_pool.shape[1]
    for pool, sc, r, bits in ((k_pool, k_scale, k_rows, kv_bits),
                              (v_pool, v_scale, v_rows, v_bits or kv_bits)):
        q, qs = quant_for(r[valid], sc, bits)
        pool.view(-1, pool.shape[2])[rows] = q
        sc[rows // ps, :, rows % ps] = qs


def scatter_pool_rows(k_pool: torch.Tensor, v_pool: torch.Tensor,
                      k_rows: torch.Tensor, v_rows: torch.Tensor,
                      row_idx: torch.Tensor, valid: torch.Tensor, *,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      kv_bits: int = 8, v_bits: int = 0) -> None:
    """k_pool, v_pool: (P, page, F') stores, updated in place, with
    (P, R, page) f32 scale pools when quantized (as `scatter_rows`).
    k_rows, v_rows: (B, F) unquantized. row_idx: (B,) absolute rows of the
    (P*page, F') view; valid: (B,) bool. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    name = store_variant(k_scale, kv_bits, v_bits)
    if not k_pool.is_cuda:
        scatter_pool_rows_plain(k_pool, v_pool, k_rows, v_rows, row_idx,
                                valid, k_scale=k_scale, v_scale=v_scale,
                                kv_bits=kv_bits, v_bits=v_bits)
        return
    p, ps = k_pool.shape[0], k_pool.shape[1]
    b = row_idx.shape[0]
    for t in (v_pool, k_rows, v_rows, row_idx, valid, k_scale, v_scale):
        if t is not None:
            _build.require_cuda(t, "scatter_pool_rows operand")
    kb, vb, kh, d = _launch_args(name, (k_pool, v_pool), (k_scale, v_scale),
                                 (k_rows, v_rows), (p,), ps)
    if valid.shape != (b,) or row_idx.dim() != 1 or k_rows.shape[0] != b:
        raise ValueError("row_idx, valid and the rows must have B entries")
    rows = row_idx.to(torch.int32).contiguous()      # no copy when int32
    ok = valid.to(torch.bool).contiguous()           # no copy when bool
    rc = _build.library().dpt_kv_append_pool(
        k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        k_rows.data_ptr(), k_rows.stride(0), v_rows.data_ptr(),
        v_rows.stride(0), rows.data_ptr(), ok.data_ptr(), b, p, ps, kh, d,
        kb, vb, _build.stream())
    _build.check(rc, "scatter_pool_rows")
    _count(scatter_pool_rows, name)


scatter_pool_rows.launches = 0
scatter_pool_rows.variant_launches = collections.Counter()
