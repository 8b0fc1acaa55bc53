"""Token sampling, ported from deeppowers_tpu/ops/sampling.py.

The same chain per slot: penalties -> logit bias -> (greedy argmax |
temperature -> top-k / top-p -> categorical draw), as plain torch ops on
the logits' device. Random draws come from an explicit torch.Generator;
JAX's threefry streams cannot be reproduced, so sampled paths are compared
by distribution, greedy ones token for token. The categorical draw is
JAX's Gumbel-max over log(p + 1e-30) (`draw`): it never reads the device
back, so a sampled decode step can be captured in a CUDA graph
(runtime/graphs.py), where torch.multinomial's checks would wait.

Shapes: logits (B, V); per-slot params (B,).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
LOGIT_BIAS_SLOTS = 64
#: floor added to probabilities before a draw, as JAX's log(p + 1e-30):
#: an all-zero row (a greedy slot's speculative residual) then draws
#: uniformly instead of failing; such a draw is never used
_TINY = 1e-30


@dataclass
class SamplingParams:
    """Per-slot sampling parameters, all (B,) (bias_*: (B, LOGIT_BIAS_SLOTS))."""

    temperature: torch.Tensor          # f32; 0 => greedy
    top_k: torch.Tensor                # int32; 0 => disabled
    top_p: torch.Tensor                # f32; 1.0 => disabled
    repetition_penalty: torch.Tensor   # f32; 1.0 => disabled
    presence_penalty: torch.Tensor     # f32
    frequency_penalty: torch.Tensor    # f32
    min_tokens: torch.Tensor           # int32
    bias_ids: torch.Tensor             # int32; -1 = empty
    bias_vals: torch.Tensor            # f32

    @classmethod
    def from_config(cls, cfg, batch_size: int, device=None) -> "SamplingParams":
        def full(v, dt=torch.float32):
            return torch.full((batch_size,), v, dtype=dt, device=device)

        temp = cfg.temperature if cfg.do_sample else 0.0
        ids = torch.full((batch_size, LOGIT_BIAS_SLOTS), -1, dtype=torch.int32)
        vals = torch.zeros((batch_size, LOGIT_BIAS_SLOTS), dtype=torch.float32)
        bias = getattr(cfg, "logit_bias", None)
        if bias:
            for j, (tid, v) in enumerate(list(bias.items())[:LOGIT_BIAS_SLOTS]):
                ids[:, j] = int(tid)
                vals[:, j] = float(v)
        return cls(
            temperature=full(float(temp)), top_k=full(cfg.top_k, torch.int32),
            top_p=full(cfg.top_p), repetition_penalty=full(cfg.repetition_penalty),
            presence_penalty=full(cfg.presence_penalty),
            frequency_penalty=full(cfg.frequency_penalty),
            min_tokens=full(cfg.min_tokens, torch.int32),
            bias_ids=ids.to(device), bias_vals=vals.to(device))

    def set_row(self, slot: int, other: "SamplingParams") -> None:
        """Install row 0 of `other` at `slot`, in place."""
        for f in fields(self):
            getattr(self, f.name)[slot] = getattr(other, f.name)[0]


def apply_logit_bias(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Additive per-slot logit bias; ids outside the vocabulary are ignored."""
    v = logits.shape[-1]
    valid = (params.bias_ids >= 0) & (params.bias_ids < v)
    safe = params.bias_ids.clamp(0, v - 1).long()
    vals = torch.where(valid, params.bias_vals, torch.zeros_like(params.bias_vals))
    return logits.scatter_add(1, safe, vals)


def apply_penalties(logits: torch.Tensor, token_counts: torch.Tensor,
                    params: SamplingParams) -> torch.Tensor:
    """Repetition (HF divide/multiply) + presence/frequency penalties."""
    seen = token_counts > 0
    rp = params.repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rp, logits * rp)
    logits = torch.where(seen, penalized, logits)
    logits = logits - params.presence_penalty[:, None] * seen.float()
    return logits - params.frequency_penalty[:, None] * token_counts.float()


def top_k_top_p_mask(logits: torch.Tensor, top_k: torch.Tensor,
                     top_p: torch.Tensor) -> torch.Tensor:
    """Mask logits outside per-slot top-k / nucleus top-p to -1e30, both as
    value thresholds against one descending sort (ties at a threshold are
    all kept)."""
    b, v = logits.shape
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, v)).clamp(1, v)
    kth = torch.gather(sorted_desc, 1, (k - 1).long()[:, None])
    keep_k = logits >= kth
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum_before = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
    in_nucleus = cum_before < top_p[:, None]
    thresh_p = torch.where(in_nucleus, sorted_desc,
                           torch.full_like(sorted_desc, float("inf"))
                           ).amin(dim=-1, keepdim=True)
    keep_p = logits >= thresh_p
    return torch.where(keep_k & keep_p, logits,
                       torch.full_like(logits, NEG_INF))


def guide_mask(logits: torch.Tensor, rows: torch.Tensor, guided: torch.Tensor,
               allow: torch.Tensor):
    """The structured-output mask of a step (JAX engine.py:337-346,
    speculative.py:142-147): a guided slot's logits outside the allowed
    tokens of its DFA row (`rows` (B,) into `allow` (R, V) bool) become
    -1e30. Returns (masked logits, the allowed set (B, V) bool, no_move
    (B,) bool: a guided slot with no legal token, an accept-only state
    without an EOS id, which must stop rather than emit)."""
    ok = allow[rows] | ~guided[:, None]
    no_move = guided & ~ok.any(-1)
    return (torch.where(ok, logits, torch.full((), NEG_INF,
                                               dtype=logits.dtype,
                                               device=logits.device)),
            ok, no_move)


def draw(probs: torch.Tensor, generator: Optional[torch.Generator]
         ) -> torch.Tensor:
    """One token a row from (B, V) probabilities: JAX's categorical over
    log(p + 1e-30), by the same Gumbel-max draw (argmax of log p plus
    Gumbel noise)."""
    u = torch.rand(probs.shape, generator=generator, device=probs.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=_TINY)))
    return torch.argmax(torch.log(probs + _TINY) + gumbel, dim=-1)


def sample(logits: torch.Tensor, params: SamplingParams,
           generator: Optional[torch.Generator] = None, *,
           token_counts: Optional[torch.Tensor] = None,
           any_sampled: Optional[bool] = None) -> torch.Tensor:
    """Full sampling chain -> next token ids (B,) int32. Greedy slots
    (temperature 0) take the argmax; an all-greedy batch skips the sort.
    `any_sampled` lets a caller that knows the temperatures on the host
    spare the device-to-host read."""
    logits = logits.float()
    if token_counts is not None:
        logits = apply_penalties(logits, token_counts, params)
    logits = apply_logit_bias(logits, params)
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if any_sampled is None:
        any_sampled = bool((params.temperature > 0).any())
    if not any_sampled:
        return greedy_tok
    temp = params.temperature.clamp(min=1e-6)[:, None]
    filtered = top_k_top_p_mask(logits / temp, params.top_k, params.top_p)
    probs = torch.softmax(filtered, dim=-1)
    tok = draw(probs, generator).to(torch.int32)
    return torch.where(params.temperature > 0, tok, greedy_tok)


def processed_probs(logits: torch.Tensor, params: SamplingParams, *,
                    token_counts: Optional[torch.Tensor] = None,
                    generated_counts: Optional[torch.Tensor] = None,
                    eos_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The distribution `sample` draws from, as (B, V) f32 probabilities
    (JAX `processed_probs`, ops/sampling.py:174-204): penalties -> logit
    bias -> min-tokens EOS suppression (slots with generated_counts <
    min_tokens and an EOS id) -> temperature -> top-k / top-p -> softmax.
    A greedy slot (temperature 0) gets an exact one-hot at the argmax.
    Speculative verification accepts drafts against it."""
    logits = logits.float()
    if token_counts is not None:
        logits = apply_penalties(logits, token_counts, params)
    logits = apply_logit_bias(logits, params)
    b, v = logits.shape
    if eos_ids is not None and generated_counts is not None:
        suppress = (generated_counts < params.min_tokens) & (eos_ids >= 0)
        col = eos_ids.clamp(0, v - 1).long()
        rows = torch.arange(b, device=logits.device)
        logits = logits.clone()
        logits[rows, col] += torch.where(
            suppress, torch.full_like(logits[:, 0], NEG_INF),
            torch.zeros_like(logits[:, 0]))
    greedy = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1),
                                         v).float()
    temp = params.temperature.clamp(min=1e-6)[:, None]
    filtered = top_k_top_p_mask(logits / temp, params.top_k, params.top_p)
    sampled = torch.softmax(filtered, dim=-1)
    return torch.where((params.temperature > 0)[:, None], sampled, greedy)


def logprobs_of(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Log-probability of the chosen tokens (B,)."""
    logits = logits.float()
    chosen = torch.gather(logits, 1, tokens.long()[:, None])[:, 0]
    return chosen - torch.logsumexp(logits, dim=-1)


def top_logprobs(logits: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest log-probabilities of each row of `logits` (..., V) and
    their ids, as JAX's engine computes them (engine.py:407-411, 479-482):
    `jax.lax.top_k(logits - logsumexp(logits), k)`, in f32. Values (..., k)
    f32 in descending order, ids (..., k) int32; among equal values the
    lower id comes first, as `jax.lax.top_k` orders them.

    torch.topk leaves the order of ties unspecified (and it differs
    between devices), so the k ids are taken by k passes of argmax, which
    returns the first of equal maxima on every device, each pass striking
    out the id it took: no sort of the vocabulary, nothing read back, only
    ops the decode graphs already capture."""
    x = logits.float()
    logp = x - torch.logsumexp(x, dim=-1, keepdim=True)
    rest = logp.clone()
    ids = []
    for _ in range(k):
        i = rest.argmax(-1, keepdim=True)
        ids.append(i)
        rest.scatter_(-1, i, float("-inf"))
    tid = torch.cat(ids, -1)
    return torch.gather(logp, -1, tid), tid.to(torch.int32)
