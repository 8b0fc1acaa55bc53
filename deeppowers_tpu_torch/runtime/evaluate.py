"""Model-quality evaluation: perplexity and the Δppl gate, ported from
deeppowers_tpu/runtime/evaluate.py.

`perplexity` scores teacher-forced next tokens over `forward_prefill`;
`cached_perplexity` feeds every position through `forward_decode` over a
KV cache (bf16 or quantized), so every attention read hits the cache the
way serving does. Both batch and pad as JAX does: `batch_size` rows a
forward, zero ids past a sequence, rows past the last sequence empty, and
perplexity = exp(total NLL / predicted tokens).

Where the tensors are decides what runs: the parameters' device. On the
CPU the port's plain and XLA-function paths run; on the card the
hand-written kernels, which take bf16 activations (`dtype=torch.bfloat16`;
quantized weights with f32 activations raise there).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..models.transformer import (TransformerConfig, forward_decode,
                                  forward_prefill)
from ..quant.qtypes import QuantizedTensor
from . import kvcache


def params_device(params: Any) -> torch.device:
    """The device of a parameter tree (its first tensor's)."""
    if isinstance(params, dict):
        for v in params.values():
            dev = params_device(v)
            if dev is not None:
                return dev
    elif isinstance(params, (list, tuple)):
        for v in params:
            dev = params_device(v)
            if dev is not None:
                return dev
    elif isinstance(params, (torch.Tensor, QuantizedTensor)):
        return params.device
    return None


def _batches(sequences, batch_size, max_len):
    """JAX's batching: sequences cut to max_len (those of fewer than 2
    tokens dropped), padded to the longest; yields (ids (batch_size,
    pad_to) int64, lengths (batch_size,) int32) on the host."""
    seqs = [list(s)[:max_len] for s in sequences if len(s) >= 2]
    if not seqs:
        raise ValueError("need sequences of length >= 2")
    pad_to = max(len(s) for s in seqs)
    for i in range(0, len(seqs), batch_size):
        ids = np.zeros((batch_size, pad_to), dtype=np.int64)
        lens = np.zeros((batch_size,), dtype=np.int32)
        for j, s in enumerate(seqs[i:i + batch_size]):
            ids[j, :len(s)] = s
            lens[j] = len(s)
        yield torch.from_numpy(ids), torch.from_numpy(lens)


def _token_logp(logits, targets):
    """log p(target) under logits (..., V), in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, targets[..., None])[..., 0]


def nll_sum(params: Any, cfg: TransformerConfig, input_ids: torch.Tensor,
            lengths: torch.Tensor, dtype=torch.float32):
    """Sum of next-token NLLs over valid positions (JAX `_nll_sum`
    :23-39): input_ids (B, S) padded, lengths (B,); position t predicts
    token t + 1, positions t >= length - 1 are masked. Returns (nll f32
    scalar tensor, token count tensor)."""
    logits, _ = forward_prefill(params, cfg, input_ids, lengths, dtype=dtype)
    tok = _token_logp(logits[:, :-1], input_ids[:, 1:])
    pos = torch.arange(input_ids.shape[1] - 1, device=input_ids.device)
    valid = pos[None, :] < (lengths[:, None].long() - 1)
    nll = -torch.where(valid, tok, torch.zeros((), device=tok.device))
    return nll.sum(), valid.sum()


def perplexity(params: Any, cfg: TransformerConfig,
               sequences: Sequence[Sequence[int]], *,
               batch_size: int = 8, max_len: Optional[int] = None,
               dtype=torch.float32) -> float:
    """Corpus perplexity = exp(total NLL / total predicted tokens) (JAX
    :42-65)."""
    dev = params_device(params)
    total_nll, total_tokens = 0.0, 0
    for ids, lens in _batches(sequences, batch_size,
                              max_len or cfg.max_seq_len):
        with torch.no_grad():
            nll, cnt = nll_sum(params, cfg, ids.to(dev), lens.to(dev),
                               dtype)
        total_nll += float(nll)
        total_tokens += int(cnt)
    return float(np.exp(total_nll / max(total_tokens, 1)))


def nll_sum_cached(params: Any, cfg: TransformerConfig,
                   input_ids: torch.Tensor, lengths: torch.Tensor, *,
                   kv_cache_dtype: str = "bf16", dtype=torch.float32,
                   cache_len: int = 0):
    """Teacher-forced NLL through the decode path (JAX `_nll_sum_cached`
    :68-103): the token at position t is fed to `forward_decode` with t
    tokens cached, and its logits predict t + 1. The cache is the
    contiguous per-layer one, `cache_len` (or S) rows, in
    `kv_cache_dtype`. JAX's `lax.scan` over positions is a loop here;
    the sums stay on the device until the end. Returns (nll, count)."""
    b, s = input_ids.shape
    dev = input_ids.device
    caches = kvcache.init_cache(
        cfg.num_layers, b, cache_len or s, cfg.kv_heads, cfg.dim_head,
        dtype=dtype, kv_cache_dtype=kv_cache_dtype, device=dev)
    nll = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    zero = torch.zeros((), device=dev)
    for t in range(s - 1):
        logits, caches = forward_decode(
            params, cfg, input_ids[:, t], caches,
            torch.full((b,), t, dtype=torch.int32, device=dev), dtype=dtype)
        tlp = _token_logp(logits, input_ids[:, t + 1])
        valid = (t + 1) < lengths
        nll = nll + torch.where(valid, -tlp, zero).sum()
        cnt = cnt + valid.sum()
    return nll, cnt


def cached_perplexity(params: Any, cfg: TransformerConfig,
                      sequences: Sequence[Sequence[int]], *,
                      kv_cache_dtype: str = "bf16", batch_size: int = 8,
                      max_len: Optional[int] = None,
                      dtype=torch.float32) -> float:
    """Corpus perplexity computed step by step through the KV cache (JAX
    :106-135): equal to `perplexity` where the store holds the compute
    dtype exactly; with a quantized store it measures what the quantized
    cache costs on every attention read."""
    dev = params_device(params)
    total_nll, total_tokens = 0.0, 0
    for ids, lens in _batches(sequences, batch_size,
                              max_len or cfg.max_seq_len):
        with torch.no_grad():
            nll, cnt = nll_sum_cached(
                params, cfg, ids.to(dev), lens.to(dev),
                kv_cache_dtype=kv_cache_dtype, dtype=dtype,
                cache_len=ids.shape[1])
        total_nll += float(nll)
        total_tokens += int(cnt)
    return float(np.exp(total_nll / max(total_tokens, 1)))


def delta_ppl(params_ref: Any, params_quant: Any, cfg: TransformerConfig,
              sequences: Sequence[Sequence[int]], **kw) -> dict:
    """The acceptance gate: Δppl = ppl(quantized) - ppl(reference) (JAX
    :138-145)."""
    ppl_ref = perplexity(params_ref, cfg, sequences, **kw)
    ppl_q = perplexity(params_quant, cfg, sequences, **kw)
    return {"ppl_ref": ppl_ref, "ppl_quant": ppl_q,
            "delta_ppl": ppl_q - ppl_ref}
