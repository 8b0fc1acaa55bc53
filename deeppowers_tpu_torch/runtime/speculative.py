"""Speculative decoding: prompt-lookup (n-gram) drafting or a draft model,
and exact verification of the window in one target forward.

Ported from deeppowers_tpu/runtime/speculative.py (`init_history` :47,
`draft_ngram` :52, `_accept_window` :82, `spec_decode_core` :184,
`SpecStats` :297, `spec_decode_draft_core` :314). One step:

1. Draft K tokens a slot: the continuation of the latest earlier match of
   the slot's trailing n-gram in its own token history (prompt +
   generated), or K sequential decode steps of a draft model sharing the
   vocabulary, each token drawn from the draft's sampling distribution q
   (after a window that accepted every draft, one more draft step first
   writes the last draft's row, which JAX's draft cache lacks).
2. Verify the K + 1 window positions in one target forward
   (models/transformer.py::forward_verify: the verify variants of #3/#5
   write the window's K/V and attend in one launch, through
   runtime/kvcache.py::append_attend; the kt-mirror cache keeps #2, then
   #7).
3. Accept each draft d with probability min(1, p(d) / q(d)) under the
   slot's full sampling chain p (ops/sampling.py::processed_probs; q is a
   point mass for prompt lookup); on the first rejection resample from the
   normalized residual max(0, p - q); with every draft accepted, draw a
   bonus token from p. The output distribution is the target chain's, and
   a greedy slot's tokens are the argmax chain's (Leviathan et al. 2023).

Random numbers come from the engine's torch.Generator (the JAX package
folds its step key per window position; the two streams cannot agree, so
sampled runs are compared by distribution, greedy ones token for token).
With structured-output guide tables (runtime/engine.py `_register_guide`)
each window position's target logits are masked to the slot's DFA row
and the row advances per accepted token; a guided slot with no legal
token stops there; a draft model masks its proposals to the grammar along
the all-accepted path. With `top_k_out` a step also returns the top-k
log-probabilities of every window position's raw target logits
(ops/sampling.py `top_logprobs`). JAX's multi-step cores
(`spec_decode_multi_core`, `spec_decode_draft_multi_core` :451-532, a
`lax.scan` of N steps) are the engine's dispatch loop over one step
(runtime/engine.py `_dispatch`), which the card replays as a CUDA graph
(runtime/graphs.py): every step updates the state, the history and the
caches in place, and the draft tail passes from step to step on the
device.

Cache discipline as in JAX: position lengths + t holds window input t's
K/V; emission is a prefix of the window, so rows of rejected drafts lie
past the slot's new length, masked on every read and overwritten later;
writes past the cache are dropped.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.transformer import (forward_decode, forward_verify,
                                  forward_verify_scan)
from ..ops.sampling import (draw, guide_mask, logprobs_of, processed_probs,
                             top_logprobs)
from .kvcache_stacked import StackedKVCache


def init_history(batch_slots: int, max_seq: int, device=None
                 ) -> torch.Tensor:
    """(B, S + 1) int32 token history (prompt + generated, per slot); the
    last column is a sink for the writes of a window's unemitted tokens.
    Drafting reads the first S columns."""
    return torch.zeros((batch_slots, max_seq + 1), dtype=torch.int32,
                       device=device)


def draft_ngram(history: torch.Tensor, hist_len: torch.Tensor, ngram: int,
                k_draft: int) -> torch.Tensor:
    """Prompt-lookup drafting (JAX :52-79): (B, K) tokens a slot, the
    continuation of the most recent earlier occurrence of the trailing
    `ngram` tokens of history[:hist_len]; a slot without a match repeats
    its last token."""
    b, s = history.shape
    dev = history.device
    hist_len = hist_len.long()
    gram_pos = hist_len[:, None] - ngram + torch.arange(ngram, device=dev)
    gram = torch.gather(history, 1, gram_pos.clamp(0, s - 1))
    num_p = s - ngram + 1
    # wins[b, p, j] = history[b, p + j]: every candidate n-gram window
    wins = history.unfold(1, ngram, 1)                       # (B, num_p, n)
    match = (wins == gram[:, None, :]).all(-1)
    p_idx = torch.arange(num_p, device=dev)[None, :]
    # the match must end strictly before the trailing gram itself
    legal = (p_idx + ngram) <= (hist_len[:, None] - 1)
    match = match & legal & (hist_len[:, None] >= ngram + 1)
    best = torch.where(match, p_idx, torch.full_like(p_idx, -1)).amax(1)
    found = best >= 0
    src = best[:, None] + ngram + torch.arange(k_draft, device=dev)
    cand = torch.gather(history, 1, src.clamp(0, s - 1))
    last = torch.gather(history, 1, (hist_len - 1).clamp(0, s - 1)[:, None])
    return torch.where(found[:, None], cand, last)


def _accept_window(logits, drafts, state, generator, counts,
                   max_cache_len: int, q_probs=None, guide_tables=None):
    """Accept or reject the K drafts in order and draw the bonus token
    (JAX :82-181). logits: (B, T, V) target logits, T = K + 1; drafts
    (B, K); q_probs (B, K, V) draft-model distributions, or None for
    prompt-lookup drafts (q a point mass at the draft). `counts` is the
    (B, V) token counts when a slot uses penalties, else None.
    `guide_tables` (allow (R, V), next (R, V)): a guided slot's logits at
    each position are masked to its DFA row before the sampling chain, and
    the row advances per emitted token; a guided slot with no legal token
    terminates there (the decode step's no_move).

    Returns (emitted (B, T) int32, -1 past each slot's accepted prefix;
    lps (B, T) f32; counts; generated (B,); terminated (B,) bool; the DFA
    rows (B,) int64 after the window, or None without tables)."""
    b, t, _ = logits.shape
    k_draft = t - 1
    sp = state.sampling
    rows = torch.arange(b, device=logits.device)
    emitting = state.active.clone()      # window-local: rejection ends it
    terminated = torch.zeros_like(emitting)
    gen = state.generated
    new_counts = None if counts is None else counts.clone()
    emitted_cols, lp_cols = [], []
    g_row = None
    if guide_tables is not None:
        g_allow, g_next = guide_tables
        guided = state.guide_state >= 0
        g_row = state.guide_state.clamp(0, g_allow.shape[0] - 1).long()
    for j in range(t):
        logits_j = logits[:, j]
        no_move = torch.zeros_like(emitting)
        if guide_tables is not None:
            logits_j, _, no_move = guide_mask(logits_j.float(), g_row,
                                              guided, g_allow)
        p = processed_probs(logits_j, sp, token_counts=new_counts,
                            generated_counts=gen, eos_ids=state.eos_id)
        if j < k_draft:
            d = drafts[:, j].long()
            pd = p[rows, d]
            u = torch.rand((b,), generator=generator, device=p.device)
            if q_probs is None:
                # a point-mass draft: accept with p(d), residual p minus d
                acc = u < pd
                p_res = p.scatter(1, d[:, None], 0.0)
            else:
                q = q_probs[:, j]
                acc = u * q[rows, d].clamp(min=1e-20) < pd
                p_res = (p - q).clamp(min=0.0)
            p_res = p_res / p_res.sum(-1, keepdim=True).clamp(min=1e-20)
            tok = torch.where(acc, d, draw(p_res, generator))
        else:
            # the bonus position: every draft accepted, draw from p
            acc = torch.zeros_like(emitting)
            tok = draw(p, generator)
        tok = tok.to(torch.int32)
        emit = emitting & ~terminated & ~no_move
        terminated = terminated | (emitting & no_move)
        emitted_cols.append(torch.where(emit, tok, torch.full_like(tok, -1)))
        lp_cols.append(logprobs_of(logits_j, tok))
        if new_counts is not None:
            new_counts[rows, tok.long()] += emit.to(torch.int32)
        gen = gen + emit.to(torch.int32)
        if guide_tables is not None:
            g_row = torch.where(emit & guided, g_next[g_row, tok.long()].long(),
                                g_row)
        hit_eos = (tok == state.eos_id) & (state.eos_id >= 0)
        hit_max = gen >= state.max_tokens
        # stop before the engine's cache-full frontier (max_seq - 1)
        hit_cap = (state.lengths + (j + 1)) >= (max_cache_len - 1)
        terminated = terminated | (emit & (hit_eos | hit_max | hit_cap))
        emitting = emitting & acc
    return (torch.stack(emitted_cols, 1), torch.stack(lp_cols, 1),
            new_counts, gen, terminated, g_row)


def _finish(state, emitted, lps, counts, gen, terminated, g_row):
    """The state after a window (JAX :258-283), written into its tensors
    in place: lengths advance by the tokens emitted, the last one becomes
    the next input, a guided slot's DFA row is the window's last."""
    t = emitted.shape[1]
    valid = emitted >= 0
    n_new = valid.sum(1).to(torch.int32)
    last_idx = (n_new.long() - 1).clamp(0, t - 1)[:, None]
    last_tok = torch.gather(emitted, 1, last_idx)[:, 0]
    last_lp = torch.gather(lps, 1, last_idx)[:, 0]
    got_any = state.active & (n_new > 0)
    state.tokens.copy_(torch.where(got_any, last_tok, state.tokens))
    state.lengths.add_(n_new)
    state.active.copy_(state.active & ~terminated)
    state.generated.copy_(gen)
    if counts is not None:
        state.token_counts.copy_(counts)
    state.last_logprob.copy_(torch.where(got_any, last_lp,
                                         state.last_logprob))
    if g_row is not None:
        state.guide_state.copy_(torch.where(state.guide_state >= 0,
                                            g_row.to(torch.int32),
                                            state.guide_state))
    return valid


def _verify(params, cfg, inputs, caches, state, dtype):
    """The target's verify forward over its cache: the stacked one of
    scan-over-layers (JAX speculative.py:205-215, 354-360) or per-layer
    caches of either layout. A draft model's cache is always per-layer
    (JAX engine.py:796)."""
    fwd = (forward_verify_scan if isinstance(caches, StackedKVCache)
           else forward_verify)
    return fwd(params, cfg, inputs, caches, state.lengths, dtype=dtype,
               active=state.active)


def spec_decode_core(params, cfg, caches, state, history: torch.Tensor, *,
                     k_draft: int, ngram: int, max_cache_len: int,
                     generator: Optional[torch.Generator] = None,
                     penalties: bool = False, dtype=torch.bfloat16,
                     guide_tables=None, top_k_out: int = 0):
    """One prompt-lookup speculative step for every slot (JAX :184-294).
    Updates `state` and `history` (its sink column included) in place and
    returns (caches, emitted (B, T) int32 with -1 padding, lps (B, T)),
    with `top_k_out` also (values, ids) each (B, T, k) of the raw verify
    logits. An inactive slot writes and reads no cache rows
    (`forward_verify`'s `active`). `guide_tables`: `_accept_window`."""
    s_hist = history.shape[1] - 1
    t = k_draft + 1
    hist_len = state.lengths + 1     # cached tokens + the pending last token
    drafts = draft_ngram(history[:, :s_hist], hist_len, ngram, k_draft)
    inputs = torch.cat([state.tokens[:, None], drafts], 1)
    logits, caches = _verify(params, cfg, inputs, caches, state, dtype)
    out = _accept_window(logits, drafts, state, generator,
                         state.token_counts if penalties else None,
                         max_cache_len, guide_tables=guide_tables)
    emitted, lps = out[0], out[1]
    valid = _finish(state, *out)
    # emitted token j lands at history position hist_len + j; the rest go
    # to the sink column
    pos = hist_len.long()[:, None] + torch.arange(t, device=history.device)
    pos = torch.where(valid, pos, torch.full_like(pos, s_hist))
    history.scatter_(1, pos, emitted.clamp(min=0))
    if top_k_out:
        return caches, emitted, lps, top_logprobs(logits, top_k_out)
    return caches, emitted, lps


def spec_decode_draft_core(params, draft_params, cfg, draft_cfg, caches,
                           draft_caches, state, *, k_draft: int,
                           max_cache_len: int,
                           generator: Optional[torch.Generator] = None,
                           penalties: bool = False, dtype=torch.bfloat16,
                           tail=None, guide_tables=None, top_k_out: int = 0):
    """One draft-model speculative step for every slot (JAX :314-448): K
    sequential draft decode steps (the draft's own cache, the shared
    lengths), each token drawn from the draft's penalty-free chain q, then
    one target verify forward accepting against q. Updates `state` in
    place; returns (caches, draft_caches, emitted (B, T), lps (B, T),
    tail), with `top_k_out` also the verify logits' top-k (values, ids)
    each (B, T, k). With `guide_tables` each draft step masks its
    proposal to a guided slot's DFA row and walks the row along the
    drafts (all accepted), and the verify masks as `_accept_window` does.

    The K draft steps feed back all drafts but the last, so after a window
    that accepts every draft the draft cache lacks the last one's row (JAX
    leaves it stale). `tail` is (tokens (B,), mask (B,) bool): the last
    drafts of the previous step and the slots whose window accepted them
    all; given, one draft decode step first writes those rows, at the
    position before each slot's length, and the mask chooses the slots
    (none, for a mask of False). The returned tail is this step's: the
    engine keeps it in the same two tensors, hands it to the next step of
    a dispatch on the device, and across dispatches passes it on when the
    last step's windows held a whole one."""
    sp = state.sampling
    if tail is not None:
        _, draft_caches = forward_decode(
            draft_params, draft_cfg, tail[0], draft_caches,
            state.lengths - 1, dtype=dtype, active=tail[1] & state.active)
    tok, lengths = state.tokens, state.lengths
    if guide_tables is not None:
        g_allow, g_next = guide_tables
        guided = state.guide_state >= 0
        d_row = state.guide_state.clamp(0, g_allow.shape[0] - 1).long()
    drafts, qs = [], []
    for _ in range(k_draft):
        logits, draft_caches = forward_decode(
            draft_params, draft_cfg, tok, draft_caches, lengths, dtype=dtype,
            active=state.active)
        if guide_tables is not None:
            logits, ok, _ = guide_mask(logits.float(), d_row, guided, g_allow)
        q = processed_probs(logits, sp)
        tok = draw(q, generator).to(torch.int32)
        if guide_tables is not None:
            d_ok = ok.gather(1, tok.long()[:, None])[:, 0]
            d_row = torch.where(guided & d_ok, g_next[d_row, tok.long()].long(),
                                d_row)
        drafts.append(tok)
        qs.append(q)
        lengths = lengths + 1
    drafts = torch.stack(drafts, 1)                           # (B, K)
    inputs = torch.cat([state.tokens[:, None], drafts], 1)
    logits, caches = _verify(params, cfg, inputs, caches, state, dtype)
    out = _accept_window(logits, drafts, state, generator,
                         state.token_counts if penalties else None,
                         max_cache_len, q_probs=torch.stack(qs, 1),
                         guide_tables=guide_tables)
    whole = _finish(state, *out).all(1)
    if top_k_out:
        return (caches, draft_caches, out[0], out[1], (drafts[:, -1], whole),
                top_logprobs(logits, top_k_out))
    return caches, draft_caches, out[0], out[1], (drafts[:, -1], whole)


class SpecStats(NamedTuple):
    """Host-side speculative efficiency counters."""

    steps: int = 0
    emitted: int = 0

    @property
    def mean_accepted(self) -> float:
        return self.emitted / max(self.steps, 1)
