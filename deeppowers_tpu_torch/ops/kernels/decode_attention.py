"""GQA decode attention over bf16 KV: wrappers, plain versions and launch
counts for the contiguous and the paged layout. CUDA source:
csrc/decode_attention.cu (one kernel template, two row addressings).

`decode_attention` replaces the Pallas TPU kernel
deeppowers_tpu/ops/pallas/decode_attention.py (`decode_attention_mxu`
:341, pallas_call :470, body `_kernel_mxu` :123) over flat (B, S, F)
caches; `decode_attention_paged` replaces `decode_attention_paged_mxu`
:706 (pallas_call :780, body `_kernel_mxu_paged_db` :526) over (P, page,
F) pools read through a (B, WP) page table. Both: bf16, one token per
slot, no stacked `layer` operand.

out[b, h] = softmax(q[b, h] . K[b, :len, h // rep] * scale) @ V[b, :len,
h // rep], with len = lengths[b] and K/V the slot's (virtual) rows. Bound
on an H100: the live K/V bytes over 3.35 TB/s. The kernel splits the
sequence across blocks (flash-decoding, 64 positions a block) and
combines the partials in a second small kernel; positions at or past the
length are excluded by a select, and blocks past it read nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
#: cache positions per block of the S split
SPLIT_CHUNK = 64


def decode_attention_plain(q, k_cache, v_cache, lengths, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, D); caches: (B, S, Kh*D) flat; lengths: (B,). Same math as
    deeppowers_tpu/ops/attention.py::attention_decode (f32 scores, -1e30
    mask, softmax). Unread V rows are zeroed by a select first, so NaN
    there cannot reach the output through a zero probability."""
    b, h, d = q.shape
    s = k_cache.shape[1]
    kh = k_cache.shape[2] // d
    rep = h // kh
    scale = scale if scale is not None else d ** -0.5
    k = k_cache.reshape(b, s, kh, d).float()
    v = v_cache.reshape(b, s, kh, d).float()
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None].long()
    v = torch.where(valid[:, :, None, None], v, torch.zeros((), device=v.device))
    qg = q.reshape(b, kh, rep, d).float() * scale
    scores = torch.einsum("bkrd,bskd->bkrs", qg, k)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", probs, v)
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, D); k_cache, v_cache: (B, S, Kh*D); lengths: (B,) valid
    positions per slot (including the current token). Returns (B, H, D).
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      scale=scale)
    b, h, d = q.shape
    s, f = k_cache.shape[1], k_cache.shape[2]
    for t, name in ((k_cache, "k_cache"), (v_cache, "v_cache"),
                    (lengths, "lengths")):
        _build.require_cuda(t, name)
    if d not in (64, 128) or f % d:
        raise NotImplementedError(f"head_dim {d} (F={f}) not supported")
    kh = f // d
    rep = h // kh
    if rep * kh != h or rep > 16:
        raise NotImplementedError(f"{h} heads over {kh} kv heads")
    if (q.dtype != torch.bfloat16 or k_cache.dtype != torch.bfloat16
            or v_cache.dtype != torch.bfloat16):
        raise NotImplementedError("CUDA decode_attention takes bf16 q and caches")
    if (v_cache.shape != k_cache.shape or k_cache.stride() != v_cache.stride()
            or k_cache.stride(2) != 1 or k_cache.stride(1) != f):
        raise ValueError("caches must be (B, S, F) views of one shape with "
                         "contiguous rows")
    if q.stride(2) != 1 or q.stride(1) != d:
        q = q.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    scale = scale if scale is not None else d ** -0.5
    nsplit = -(-s // SPLIT_CHUNK)
    pm = torch.empty((b * h * nsplit,), dtype=torch.float32, device=q.device)
    pl = torch.empty_like(pm)
    pacc = torch.empty((b * h * nsplit * d,), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((b, h, d), dtype=torch.bfloat16, device=q.device)
    rc = _build.library().dpt_decode_attention(
        q.data_ptr(), q.stride(0), k_cache.data_ptr(), v_cache.data_ptr(),
        k_cache.stride(0), lens.data_ptr(), b, s, kh, rep, d, SPLIT_CHUNK, float(scale),
        pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(), out.data_ptr(),
        _build.stream())
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_paged_plain(q, k_pool, v_pool, table, lengths, *,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """q: (B, H, D); pools: (P, page, Kh*D); table: (B, WP); lengths: (B,).
    Gathers each slot's pages into its virtual (B, WP*page, F) view and
    applies decode_attention_plain, whose selects keep stale rows (a
    released page's previous occupant, NaN included) out of the output."""
    b, wp = table.shape
    ps, f = k_pool.shape[1], k_pool.shape[2]
    ids = table.reshape(-1).long()
    k = k_pool[ids].reshape(b, wp * ps, f)
    v = v_pool[ids].reshape(b, wp * ps, f)
    return decode_attention_plain(q, k, v, lengths, scale=scale)


def decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, D); k_pool, v_pool: (P, page, Kh*D); table: (B, WP) int32
    page ids; lengths: (B,) valid positions per slot (including the current
    token), at most WP * page. Returns (B, H, D). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if not q.is_cuda:
        return decode_attention_paged_plain(q, k_pool, v_pool, table, lengths,
                                            scale=scale)
    b, h, d = q.shape
    _, ps, f = k_pool.shape
    wp = table.shape[1]
    for t, name in ((k_pool, "k_pool"), (v_pool, "v_pool"), (table, "table"),
                    (lengths, "lengths")):
        _build.require_cuda(t, name)
    if d not in (64, 128) or f % d:
        raise NotImplementedError(f"head_dim {d} (F={f}) not supported")
    kh = f // d
    rep = h // kh
    if rep * kh != h or rep > 16:
        raise NotImplementedError(f"{h} heads over {kh} kv heads")
    if (q.dtype != torch.bfloat16 or k_pool.dtype != torch.bfloat16
            or v_pool.dtype != torch.bfloat16):
        raise NotImplementedError(
            "CUDA decode_attention_paged takes bf16 q and pools")
    if (v_pool.shape != k_pool.shape or not k_pool.is_contiguous()
            or not v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous (P, page, F) of one shape")
    if table.dim() != 2 or table.shape[0] != b or table.stride(1) != 1:
        raise ValueError(f"table must be (B, WP) with contiguous rows, got "
                         f"{tuple(table.shape)}")
    if q.stride(2) != 1 or q.stride(1) != d:
        q = q.contiguous()
    tab = table if table.dtype == torch.int32 else table.to(torch.int32)
    lens = lengths.to(torch.int32).contiguous()
    scale = scale if scale is not None else d ** -0.5
    nsplit = -(-(wp * ps) // SPLIT_CHUNK)
    pm = torch.empty((b * h * nsplit,), dtype=torch.float32, device=q.device)
    pl = torch.empty_like(pm)
    pacc = torch.empty((b * h * nsplit * d,), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((b, h, d), dtype=torch.bfloat16, device=q.device)
    rc = _build.library().dpt_decode_attention_paged(
        q.data_ptr(), q.stride(0), k_pool.data_ptr(), v_pool.data_ptr(),
        tab.data_ptr(), tab.stride(0), ps, lens.data_ptr(), b, wp, kh, rep, d,
        SPLIT_CHUNK, float(scale), pm.data_ptr(), pl.data_ptr(),
        pacc.data_ptr(), out.data_ptr(), _build.stream())
    _build.check(rc, "decode_attention_paged")
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0
