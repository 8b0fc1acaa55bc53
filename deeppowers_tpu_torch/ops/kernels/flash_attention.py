"""Causal flash attention for prefill: wrapper, plain version and launch
count.

Replaces the Pallas TPU kernel deeppowers_tpu/ops/pallas/flash_attention.py
(`flash_attention_prefill` :79, pallas_call :140, body `_kernel` :33).
CUDA source: csrc/flash_attention.cu.

Query row i of slot b attends keys j <= i with j < lengths[b]; K/V may
have fewer heads than Q (GQA reads kv head h // rep, never a repeated
copy). Bound on an H100: operations, ~2*H*L^2*D operations per prompt
of length L. Rows past lengths[b] stay finite.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

NEG_INF = -1e30


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


def _rows(t: torch.Tensor, d: int) -> bool:
    """(B, S, Hx, D) with heads and dims contiguous."""
    return t.stride(3) == 1 and t.stride(2) == d


def flash_attention_prefill(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor, *,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Causal GQA attention over a padded prompt. q: (B, S, H, D); k, v:
    (B, S, Kh, D), unrepeated; lengths: (B,). Returns (B, S, H, D). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, lengths, scale=scale)
    b, s, h, d = q.shape
    kh = k.shape[2]
    for t, name in ((k, "k"), (v, "v"), (lengths, "lengths")):
        _build.require_cuda(t, name)
    if d not in (64, 128) or h % kh or k.shape != v.shape \
            or k.shape[:2] != (b, s) or k.shape[3] != d:
        raise NotImplementedError(
            f"flash_attention_prefill: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise NotImplementedError("CUDA flash_attention_prefill takes bf16")
    q, k, v = (t if _rows(t, d) else t.contiguous() for t in (q, k, v))
    lens = lengths.to(torch.int32).contiguous()
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q.device)
    rc = _build.library().dpt_flash_attention(
        q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), k.stride(0),
        k.stride(1), v.data_ptr(), v.stride(0), v.stride(1), lens.data_ptr(),
        b, s, h, kh, d, float(scale), out.data_ptr(), _build.stream())
    _build.check(rc, "flash_attention_prefill")
    flash_attention_prefill.launches += 1
    return out


flash_attention_prefill.launches = 0
