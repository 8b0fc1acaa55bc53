"""Causal flash attention for prefill and prefill chunks: wrappers, plain
versions and launch counts.

Replaces the Pallas TPU kernel deeppowers_tpu/ops/pallas/flash_attention.py
(`flash_attention_prefill` :79, pallas_call :140, body `_kernel` :33).
CUDA source: csrc/flash_attention.cu (one wgmma kernel, D = 64 or 128; a
head of 32 runs at 64 over zero-filled boxes).

Query row i of slot b sits at position start + i and attends keys j <=
start + i with j < lengths[b]; K/V may have fewer heads than Q (GQA reads
kv head h // rep, never a repeated copy). Rows past lengths[b] stay
finite. `flash_attention_prefill` is start = 0 over a padded prompt;
`flash_attention_chunk` is one prefill chunk's queries over its slot's
cache view (what ops/attention.py `attention_chunk` computes; the JAX
package leaves that to XLA). Bound on an H100: operations, ~2*H*L^2*D
operations per prompt of length L.

Launch counts: `flash_attention_prefill.launches`,
`flash_attention_chunk.launches`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
#: head dims the kernel takes (32 computed at 64)
HEAD_DIMS = (32, 64, 128)


def flash_attention_plain(q, k, v, lengths, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, Kh, D); lengths: (B,). The reference:
    K/V repeated to every query head, one masked softmax per head in f32.
    Written apart from the dense path of ops/attention.py so that the
    kernel is held against code it shares nothing with."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qh = q.float().transpose(1, 2)                            # (B, H, S, D)
    kh, vh = (t.float().repeat_interleave(rep, 2).transpose(1, 2)
              for t in (k, v))
    scores = qh @ kh.transpose(-1, -2) * scale                # (B, H, S, S)
    pos = torch.arange(s, device=q.device)
    keep = ((pos[None, :] <= pos[:, None])[None]
            & (pos[None, None, :] < lengths.long()[:, None, None]))
    scores = scores.masked_fill(~keep[:, None], NEG_INF)
    out = torch.softmax(scores, dim=-1) @ vh
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_chunk_plain(q, k_cache, v_cache, start: int, *,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """The chunk's queries q (B, C, H, D) at positions start..start+C over a
    cache view (B, S, Kh, D) that holds this chunk's keys, with the causal
    frontier at start + i; grouped queries against the unrepeated K/V, f32
    scores. Returns (B, C, H, D)."""
    b, c, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    rep = h // kh
    scale = scale if scale is not None else d ** -0.5
    qg = (q.reshape(b, c, kh, rep, d) * scale).float()
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k_cache.float())
    q_idx = start + torch.arange(c, device=q.device)
    k_idx = torch.arange(s, device=q.device)
    mask = k_idx[None, :] <= q_idx[:, None]                   # (C, S)
    scores = torch.where(mask[None, None, None], scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v_cache.float())
    return out.reshape(b, c, h, d).to(q.dtype)


def tma_view(shape, strides, data_ptr: int) -> bool:
    """Whether the kernel's tensor maps can read a (B, S, Hx, D) bf16 view
    as it lies: heads and dims contiguous, slot and position strides
    multiples of 16 bytes, the base 16-byte aligned. Other views are
    copied first."""
    d, hx = shape[3], shape[2]
    return (strides[3] == 1 and (hx == 1 or strides[2] == d)
            and strides[1] % 8 == 0 and strides[0] % 8 == 0
            and data_ptr % 16 == 0)


def _readable(t: torch.Tensor) -> torch.Tensor:
    return t if tma_view(t.shape, t.stride(), t.data_ptr()) else \
        t.clone(memory_format=torch.contiguous_format)


def _launch(q, k, v, lengths, start, scale, name):
    """Checks, then the kernel over q (B, Sq, H, D) and k, v (B, Skv, Kh,
    D) with query row i at position start + i."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    for t, what in ((k, "k"), (v, "v")):
        _build.require_cuda(t, what)
    if d not in HEAD_DIMS or h % kh or k.shape != v.shape \
            or k.shape[0] != b or k.shape[3] != d:
        raise NotImplementedError(
            f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise NotImplementedError(f"CUDA {name} takes bf16")
    q, k, v = (_readable(t) for t in (q, k, v))
    lens = None
    if lengths is not None:
        _build.require_cuda(lengths, "lengths")
        lens = lengths.to(torch.int32).contiguous()
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, sq, h, d), dtype=torch.bfloat16, device=q.device)
    rc = _build.library().dpt_flash_attention(
        q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), k.stride(0),
        k.stride(1), v.data_ptr(), v.stride(0), v.stride(1),
        None if lens is None else lens.data_ptr(), b, sq, k.shape[1], h, kh,
        d, start, float(scale), out.data_ptr(), _build.stream())
    _build.check(rc, name)
    return out


def flash_attention_prefill(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor, *,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Causal GQA attention over a padded prompt. q: (B, S, H, D); k, v:
    (B, S, Kh, D), unrepeated; lengths: (B,). Returns (B, S, H, D). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, lengths, scale=scale)
    if k.shape[1] != q.shape[1]:
        raise NotImplementedError(
            f"flash_attention_prefill: q {tuple(q.shape)}, k {tuple(k.shape)}")
    out = _launch(q, k, v, lengths, 0, scale, "flash_attention_prefill")
    flash_attention_prefill.launches += 1
    return out


flash_attention_prefill.launches = 0


def flash_attention_chunk(q: torch.Tensor, k_view: torch.Tensor,
                          v_view: torch.Tensor, start: int, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """One prefill chunk's attention: q (B, C, H, D) at positions
    start..start+C over its slots' cache views (B, S, Kh, D) that hold the
    chunk's keys; query i sees keys j <= start + i, j < S. The view may
    end before start + C (the engine pads a prompt's last chunk to the
    chunk size, past the cache's end): a query past it sees every key.
    Returns (B, C, H, D). A CPU tensor takes the plain version; a CUDA
    tensor launches #4's kernel with the start offset (the views cut at
    start + C, the last key any query sees) or raises."""
    if not q.is_cuda:
        return flash_attention_chunk_plain(q, k_view, v_view, start,
                                           scale=scale)
    if start < 0:
        raise ValueError(f"flash_attention_chunk: start {start} < 0")
    end = start + q.shape[1]
    out = _launch(q, k_view[:, :end], v_view[:, :end], None, start, scale,
                  "flash_attention_chunk")
    flash_attention_chunk.launches += 1
    return out


flash_attention_chunk.launches = 0
