"""GQA decode attention over a flat bf16 cache: wrapper, plain version and
launch count.

Replaces the Pallas TPU kernel deeppowers_tpu/ops/pallas/decode_attention.py
(`decode_attention_mxu` :341, pallas_call :470, body `_kernel_mxu` :123)
for bf16 caches, one token per slot, no stacked `layer` operand. CUDA
source: csrc/decode_attention.cu.

out[b, h] = softmax(q[b, h] . K[b, :len, h // rep] * scale) @ V[b, :len,
h // rep], with len = lengths[b]. Bound on an H100: the live K/V bytes
over 3.35 TB/s. The kernel splits S across blocks (flash-decoding) and
combines the partials in a second small kernel; positions at or past the
length are excluded by a select.
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
