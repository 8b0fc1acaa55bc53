#!/usr/bin/env python3
"""Smoke run of deeppowers_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --step-ms CHECKOUT
    python3 chip_smoke.py --ttft CHECKOUT
    python3 chip_smoke.py --kt-ms CHECKOUT
    python3 chip_smoke.py --slot-orders CHECKOUT
    python3 chip_smoke.py --fold-ms CHECKOUT
    python3 chip_smoke.py --i8-ms CHECKOUT
    python3 chip_smoke.py --seg-ms CHECKOUT
    python3 chip_smoke.py --dispatch-ms CHECKOUT

The second form only times the TinyLlama int8 decode step's 89 matmuls
and its w_gu at a 1024-token prefill through #1, the Llama-2-7B W4A8 g128
decode step's 129 matmuls and one Mixtral-8x7B layer's cat experts (the
row quantizer included, through `dequant_matmul` alone), a decode step's
attention calls through #3 and #5 (STEP_ATTENTION: 22 TinyLlama bf16
calls, 32 Llama-2-7B k8v4 ones, 22 paged TinyLlama ones, and single calls
at the 7B's bf16 and Mixtral's int8 heads, over cache copies past the L2),
with the package of
another checkout of the repo (its root first on sys.path; it builds that
checkout's kernels), three times each, and prints them as JSON: run it
for two checkouts in turn (parent, change, change, parent) to pair them
on one card. `--ttft CHECKOUT` does the same for the TTFT where #4 and
#9 run (see `ttft_ms`), `--kt-ms CHECKOUT` for #7 at the 7B's and
TinyLlama's heads beside #3 on the same caches (see `kt_ms`),
`--slot-orders CHECKOUT` for the attention calls over ATTN_LENS in ten
orders of the slots (see `slot_order_ms`), `--fold-ms CHECKOUT` for the
attention that writes a step's rows beside the writer + attention pair
(see `fold_ms`; a checkout without the fold times the pair only),
`--i8-ms CHECKOUT` for #3's int8-dot variant at I8_HEADS beside the
bf16-dot kernel on the same caches (see `i8_ms`), `--seg-ms CHECKOUT` for
9q, the a8 pre-pass of #9 and #10, at Mixtral-8x7B's 1024 routed rows
(#9's input from #10's gate | up by 9q's GLU mode where the checkout has
it, else by the eager GLU ops then 9q) and a 512-token Mixtral prefill's
device busy and its 9q and eager GLU share (see `seg_ms`),
`--dispatch-ms CHECKOUT` for the served `step()` at the default runtime
(see `dispatch_ms`).
`--kt-ms` and `--fold-ms` run with DPT_ATTN_INT8=0, so #3 is its bf16-dot
kernel in every checkout; `--step-ms` and `--slot-orders` time each
checkout's default (#3's int8-dot variant for int8 and k8v4 KV since it
exists); `--i8-ms` names each kernel by `int8_dots=`.

Phases, each printing a line with its wall time:
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    the nvcc calls (one per source, in parallel, and a link)
              that build every CUDA kernel of the port
  3. kernels  each kernel at the main path's shapes against its plain
              PyTorch version on the card, timed beside its bound and one
              PyTorch library call
  4. path     TinyLlama-1.1B at full width, random weights made on the card
              from a seed, int8 per-channel: a teacher-forced prefill and
              decode steps through the kernels, held against the plain
              versions on the same weights (on the CPU)
  5. paged path  the same through the paged KV cache (pages scattered in a
              pool whose unwritten rows hold NaN), against the plain path
              on the CPU
  6. serve    the scheduler and the HTTP server in-process on 127.0.0.1,
              8 concurrent /api/v1/generate requests, greedy, contiguous
              KV; prompts over 512 tokens prefill in chunks; every
              contiguous-path kernel's launch count must grow
  7. paged serve  12 requests over a paged pool too small for them (lazy
              reservation, prefix cache, chunked prefill): preemption,
              prefix hits and multi-chunk prompts must all occur, the paged
              kernels must launch and the contiguous ones must not
  8. serve[int8]  phase 6 over an int8 KV cache: the int8 variants of #2
              and #3 must launch, the bf16 ones must not
  9. paged_serve[k8v4]  phase 7 over a k8v4 KV pool (int8 K, packed int4
              V, the deployed recipe): the k8v4 variants of #5 and #6 must
              launch, the bf16 ones and the contiguous kernels must not
 10. serve[llama2-7b]  Llama-2-7B at full width and depth (BASELINE
              config 3): W4A8 g128 weights drawn in quantized form from the
              seed, k8v4 KV, serve's traffic once; the W4A8 g128 variant of
              #1 and the activation quantizer must launch, no other weight
              variant; then a profiled decode step, which must run the row
              quantizer once a W4A8 matmul (129 times; its launches and
              device ms a step are printed), and the TTFT of a 512-token
              prompt alone on the warm engine
 11. serve[mixtral-8x7b]  Mixtral-8x7B whole (BASELINE config 5: 32
              layers, 8 experts top-2, W4A8 g128 drawn quantized, int8 KV),
              serve's traffic once: prefills of 256 tokens and more take
              the grouped kernels #10 and #9, the rest and every decode
              step the cat path through #1; only W4A8 g128 variants may
              launch, every expert must take routed pairs, and each a8
              launch of #10 / #9 follows one of 9q in plain / GLU mode;
              then a profiled decode step (the row quantizer 129 times, as
              in phase 10), a 512-token TTFT, and a profiled 512-token
              prefill (device busy, launches, 9q's share; no kernel may
              run between #10 and #9, where the GLU ran as eager ops)
 12. spec_serve  phase 6 with prompt-lookup speculation (K = 4 drafts,
              n-gram 3): serve's 8 greedy requests and one at temperature
              0.8; the bf16 verify variant of #3 (tokens = 5) and #2 must
              launch, the one-token #3 must not; the share of tokens equal
              to phase 6's stream, the acceptance stats, a profiled step
 13. spec_paged_serve[k8v4]  phase 9 with K = 4: preemption, prefix hits
              and multi-chunk prompts must still occur, the k8v4 verify
              variant of #5 and #6 must launch, no contiguous kernel
 14. spec_serve[llama2-7b+draft]  phase 10's Llama-2-7B weights verifying
              drafts of the main path's TinyLlama-1.1B int8 (shared
              vocabulary), serve's traffic once: acceptance, tok/s and step
              p50 beside phase 10's, the draft's share of a step; then
              TinyLlama drafting for itself must accept at least 3 of 5
              tokens a window
 15. scan_serve  phase 6's traffic at the default scan_layers "auto", which
              stacks TinyLlama's 22 layers (runtime/kvcache_stacked.py),
              with the prefix cache: the 8 requests, then the same 8 again
              (prefix copies of the stacked rows); #8 must launch, #2 must
              not; then one request with prompt lookup (K = 4) on a scan
              engine; tok/s, TTFT and step p50 beside phase 6's
 16. serve[llama2-7b,kt]  phase 10's weights and traffic with the kt
              mirror (DPT_KV_KT=1, bench.py:61-68's `kt_auto`): #7 must
              launch and #3 must not; tok/s, step p50 and KV bytes beside
              phase 10's
(12 and 15 run after 6, 13 after 9, 14 and 16 after 10; every other
contiguous phase pins scan_layers=False, so that the unrolled cache they
measured stays their path.) After the quantized path phases,
scan_path[bf16] and scan_path[k8v4] teacher-force the main path's weights,
stacked, through the scan forwards against the same on the CPU and,
printed, against the unrolled path on the card, and check under
torch.profiler that a scan decode step copies no layer of the cache;
after path[llama2-7b], kt_path[llama2-7b] runs its model with the kt
mirror: a 252-token prompt, 5 decode steps (one completes chunk 1, which
#7 flushes), a verify window of 5 reading the mirror, against the CPU and
the run without the mirror. The kernels phase also holds #8 (stacked
appends, four stores, 8 and 40 rows), #7 (int8 and k8v4, tokens 1 and 5,
Llama-2-7B's and TinyLlama's heads, its kt bytes too, stale chunks that
must heal and NaN scales past the lengths; timed over cache copies past
the L2, #3 on the same caches beside it) and #11 (bf16, int8) against
their plain versions. #3, #5 and #7 are one kernel template, one launch
a call (a cluster of splits a (slot, kv head) combined in distributed
shared memory, no combine_kernel: no serve phase's profiled decode step
may show one). The kernels phase also holds #3 at tokens
= 1 at Llama-2-7B's heads in k8v4 and bf16 (beside sdpa) and at
Mixtral-8x7B's in int8, timed over cache copies past the 50 MB L2, and
#3 and #5 at tokens = 5 in every store (and #3 k8v4 at Llama-2-7B's
heads), the window appends of #2 and #6 (8 slots x 5 rows), and #1 at a
verify step's M = 40 (TinyLlama w8, Llama-2-7B w4a8g); after the path
phases, spec_path[store,layout] verifies a forced window of 5 tokens in
one forward_verify through each store on each layout, against the plain
path on the CPU and five sequential decode steps on the card.
Between 5 and 6, the path phase runs again through each quantized store
(int8, int4, k8v4) on each layout; the card gates with the least room
(#3's worst row ratio per store, the teacher-forced rel L2 of int4 and
k8v4) are held again over three more seeds (margins[seed=...] lines), to
show how close each sits to its limit; and the path runs once at the shape
of the repo's trained checkpoint lm124_ckpt (path[lm124]: random weights,
its untied 260-wide lm_head takes #1's instantiation for N % 8 != 0)
through InferenceEngine.generate and teacher-forced; then path[llama2-7b],
Llama-2-7B at full width cut to 4 layers, W4A8 g128 + k8v4, teacher-forced
against the plain path on the CPU; then path[mixtral-8x7b], Mixtral-8x7B
at full width cut to 2 layers, W4A8 g128 + int8 KV, a 320-token prompt
(#10, #9) and three decode steps (#1), teacher-forced against the plain
path on the CPU with every route recorded on both (at most 1% may flip a
near-tie). The kernels phase holds the quantized
variants of #2, #3, #5 and #6, #1 at widths no multiple of 8, and #1's
int4, grouped and a8 weight variants at Llama-2-7B's matrices (M = 8
and 512), the activation quantizer (a cluster of blocks a row) at the
7B's and Mixtral-8x7B's rows (K up to 114688, M = 8 and 40; a decode
step's 129 quantizations of each model a row), and the grouped kernels #10 and
#9 of MoE at Mixtral-8x7B's experts (1024 routed rows) in four weight
variants too (#10 also, untimed, at mixtral-mini's, tiny-moe's and a ragged
cat whose column blocks end inside the next expert), 9q, their a8 pre-pass,
per a8 variant on #9's and #10's inputs and in its GLU mode from #10's
gate | up output (bit for bit with its plain version; the GLU row timed
beside the eager GLU ops + 9q it replaces), and #1's GEMV on one
Mixtral-8x7B layer's cat experts at M = 8 (dequant_matmul[w4a8g, Mixtral
layer, M=8]). #1's tensor-core route (every M above GEMV_MAX_M) is held
at a TinyLlama 512-token prefill on the main path's own int8 weight
(dequant_matmul[w8, M=512]), its weight-only prologue
(stage_activations) at those rows, and the two routes are timed side by
side at M = 8..64 (route sweep lines); every #1 gate is per row (2e-2 of
the row's max|ref|). The serve, spec and scan phases also require both of
#1's routes to launch (dequant_matmul[gemv] for decode steps,
dequant_matmul[mma] for prefills and verify steps), and serve[llama2-7b]
times its 512-token TTFT on the default scan engine too. Each serve phase,
and each path
run on the card that gives a row its launches, sets every launch count
(per variant too) to 0 just before it and reads the counts just after. Each serve phase also
prints every request's TTFT, the host split of a profiled decode step
(PyTorch ops, kernel launches, blocking calls, allocator calls); phase
6 also prints each prompt's prefill alone on the warm engine
with its host split, and serve the same traffic twice more: warm, and
with the scheduler's thread under torch.profiler (the served run's host
split). Then one JSON line with every kernel's numbers and, last,
the result line {"ok": true, "device": {...}}.

The row writers #2, #6 and #8 are folded into the attention launch of a
decode or verify step (kvcache.append_attend: #3 writes the step's rows
before it reads them, #5 on the paged layout). The kernels phase holds the
fold (rows "decode_attention+scatter_rows[...]" (#3+2),
"decode_attention+scatter_rows_stacked[...]" (#3+8) and
"decode_attention_paged+scatter_pool_rows[...]" (#5+6): every store,
tokens 1 and 5, TinyLlama's and Llama-2-7B's heads) against its plain
route, bytes and scales exact and each output row within 1e-2, with NaN
in the rows' slots first, and times it beside the writer + attention pair
it replaces, over cache copies past the L2. Every path, scan, spec and
serve phase whose layout folds gates that its decode and verify forwards
launched no row writer (the count "step_writers": #2, #6 and #8 launches
made inside forward_decode / forward_verify) and that the attention's
"+rows" variant launched; prefills and chunks still write through #2, #6
and #8, and the kt-mirror phases keep #2 before #7. Each serve phase prints
its profiled decode step's launches, device-busy ms, row-writer launches
and folded attention calls a step.

#3 takes its int8-dot variant (3i, the TPU kernel's default `int8_dots`:
q and p requantized to int8, exact integer q.K^T) wherever the JAX
package's TPU route would: a K stored as int8 bytes (int8, int4, k8v4),
unless DPT_ATTN_INT8=0. So every quantized contiguous or stacked decode
and verify of the path, scan, spec and serve phases runs it, and their
CPU references compute its function (`cpu_attention_function("kernel")`).
The kernel rows of the earlier slices run with DPT_ATTN_INT8=0 and keep
holding #3's bf16-dot kernel against `decode_attention_plain`; those
rows count only that kernel's launches (the wrapper counts the variant's
under the store's key too, and under "i8:" + the key). The kernels phase
then holds the variant (rows "decode_attention_int8_dots[...]": int8,
int4 and k8v4 at TinyLlama's heads, k8v4 at the 7B's, int8 at
Mixtral's, tokens 1 and 5, contiguous and stacked, writing the step's
rows) against `decode_attention_int8_dots_plain`, bytes and scales
exact, each row within 1e-2, and times it beside the bf16-dot kernel on
the same caches. serve[int8], serve[llama2-7b] (its stacked engine's
decode steps too) and serve[mixtral-8x7b] must launch the variant, and
each profiles a decode step again with DPT_ATTN_INT8=0, which must launch
none (both steps' device-busy ms and #3's ms are printed); the margins
hold both of #3's functions.

Every decode dispatch of the engine is a replayed CUDA graph
(runtime/graphs.py), so every serve phase's decode steps run inside
graphs; the wrappers' launch counts count each replay. The dispatch
phases (`dispatch_phase` on TinyLlama after the serve phases,
`dispatch_model` inside serve[llama2-7b] on its scan engine and inside
serve[mixtral-8x7b]) hold a replay of each decode step variant against
one eager call of the same function (`InferenceEngine._run_step`, the
graph's plain version) on copies of the state, the history, the draft
tail and the caches, bit for bit and with every cache at its address;
require equal greedy streams across dispatch depths and pipelining, lazy
paging that preempts at N = 1 and 4, and a seeded sampled engine that
repeats its stream while its replays draw anew; and print profiled steps
at N = 1 (graph) and at the auto depth.

After the Mixtral path phases, `trained` loads the repo's trained MoE
checkpoint moelm_ckpt (6 layers, hidden 256, 8 experts top-2, heads of 32
dims, which #3, 3i and #4 compute at 64 over zero-padded heads) with the
port's loader straight onto the card, and scores its own text at bf16:
prefill perplexity over 8 x 512 tokens for the float weights (float
experts through the stacked grouped branch), int8 per-channel and W4A8
g128 (#10 / #9 behind 9q), and decode-path perplexity over 8 x 128 tokens
for W4A8 g128 + k8v4 KV (the GEMV's cat experts, 3i) and float weights +
int8 KV (3i); each row's launches counted from 0 and its perplexity held
within 1e-2 of the same function on the CPU (the kernels' plain
versions). It prints the experts' share of routed pairs on the text and
serves 8 requests of the text with and without prompt lookup (K = 4,
n-gram 3): equal greedy tokens, the acceptance mean and histogram. The
checkpoint travels with the chip run; the phase fails without it.

Any failed check raises: the error goes to stderr and the exit code is 1.
Without a CUDA device, or without the deeppowers_tpu_torch package beside
it, the script exits non-zero and prints no result. A watchdog ends the
process with exit code 1 if the run passes 15 minutes (whole runs take
7.5-8 minutes on most hosts, past 10 on slow ones; the card's command
limit is 20). It starts no child
process but nvcc and nvidia-smi, and writes only under build/.
"""

from __future__ import annotations

import collections
import json
import os
import random
import subprocess
import sys
import threading
import time
import traceback

WATCHDOG_S = 900
SEED = 0
H100_BYTES_PER_S = 3.35e12        # HBM3, NVIDIA data sheet (SXM)
H100_BF16_FLOPS = 989e12          # dense bf16 tensor-core peak
H100_INT8_OPS = 1979e12           # dense int8 tensor-core peak

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_line(name: str, t0: float, **info) -> None:
    detail = " ".join(f"{k}={v}" for k, v in info.items())
    log(f"phase {name}: {time.perf_counter() - t0:.2f}s {detail}".rstrip())


def watchdog() -> None:
    time.sleep(WATCHDOG_S)
    sys.stderr.write(f"chip_smoke: watchdog: run passed {WATCHDOG_S}s\n")
    sys.stderr.flush()
    os._exit(1)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def cuda_ms(torch, fns, iters: int, graph: bool = True) -> float:
    """Mean ms per call over `iters` calls cycling through `fns` (several
    input copies keep a weight stream out of the 50 MB L2, as on the
    path), by CUDA events after a warm-up. With `graph` the calls are
    captured in one CUDA graph and the replay is timed: device time, free
    of the host's per-call launch cost. Without it (for code that syncs
    with the host) the eager calls are timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fns[i % len(fns)]()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for i in range(iters):
            fns[i % len(fns)]()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, int8: bool = False):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / (H100_INT8_OPS if int8 else H100_BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_errors(out, ref):
    """Max abs error, and the worst ratio of a row's max abs error to its
    own max|ref|, over the last axis. A per-row limit keeps rows that
    attend many keys (small outputs) as tight as the short ones."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    ratio = diff / ref.float().abs().amax(-1).clamp_min(1e-30)
    return diff.max().item(), ratio.max().item()


def check_dm(what, got, ref, limit=2e-2):
    """#1's gate: finite, and every row's max abs error at most `limit` of
    that row's max|ref|. Returns (max abs error, worst row ratio)."""
    err, ratio = row_errors(got, ref)
    if not (bool(got.isfinite().all()) and ratio <= limit):
        fail(f"{what}: worst row error {ratio:.3e} of its max|ref| > "
             f"{limit} (max abs error {err:.3e})")
    return err, ratio


# #1's routes, each counted under its own key: prefills and verify steps
# take the tensor-core kernel, decode steps the GEMV; their sources
ROUTES_ON = ["dequant_matmul[gemv]", "dequant_matmul[mma]"]
GEMV_SRC = "deeppowers_tpu_torch/csrc/gemv.cu"
MMA_SRC = "deeppowers_tpu_torch/csrc/mma_kernel.cuh"


def tree_to(tree, device):
    from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    if isinstance(tree, QuantizedTensor):
        return tree.to(device)
    return tree.to(device)


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def randn_on(torch, seed):
    """rn(*shape, scale, dtype): normal values on the card from a
    generator seeded with `seed`."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(dtype)
    return rn


def int8_step(torch, cfg, rn, b=8):
    """The int8 per-channel decode step's five matmuls at M = b slots, one
    at a time: (name, K, N, launches per step, weight copies (enough to
    stream 200 MB, past the 50 MB L2, as on the path), x, fusion kwargs,
    out dtype)."""
    from deeppowers_tpu_torch.quant.quantize import quantize
    h, ffn, L = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    for name, k, n, mode, per_step in (
            ("wqkv+rms", h, cfg.q_size + 2 * cfg.kv_size, "rms", L),
            ("wo+res", cfg.q_size, h, "res", L),
            ("w_gu+rms", h, 2 * ffn, "rms", L),
            ("w_out+glu+res", ffn, h, "glu", L),
            ("lm_head f32", h, cfg.vocab_size, "f32", 1)):
        qws = [quantize(rn(k, n, scale=0.02, dtype=torch.float32))
               for _ in range(max(1, -(-200_000_000 // (k * n))))]
        x = rn(b, 2 * k if mode == "glu" else k)
        kw = {}
        if mode == "rms":
            kw["rms_weight"] = rn(k, scale=0.1) + 1.0
        if mode in ("res", "glu"):
            kw["residual"] = rn(b, n)
        if mode == "glu":
            kw["glu"] = True
        yield (name, k, n, per_step, qws, x, kw,
               torch.float32 if mode == "f32" else torch.bfloat16)


STEP_REPS = 3


def step_ms(torch, cfg) -> dict:
    """ms of the TinyLlama int8 decode step's 89 matmuls through #1, and of
    its w_gu at a 1024-token prefill (the tensor-core route), by CUDA-graph
    replays as the kernels phase times them, STEP_REPS times each. Only
    the wrapper's call is used, so any checkout's package can be timed
    (`--step-ms ROOT`)."""
    from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
    from deeppowers_tpu_torch.quant.quantize import quantize
    rn = randn_on(torch, SEED + 1)
    calls = [([lambda q=q, x=x, kw=kw, od=od: dm.dequant_matmul(
        x, q, out_dtype=od, **kw) for q in qws], per)
        for _, _, _, per, qws, x, kw, od in int8_step(torch, cfg, rn)]
    q_big = quantize(rn(cfg.hidden_size, 2 * cfg.ffn_size, scale=0.02,
                        dtype=torch.float32))
    xp = rn(1024, cfg.hidden_size)
    out = {"step_matmuls_ms": [sum(per * cuda_ms(torch, fns, 50)
                                   for fns, per in calls)
                               for _ in range(STEP_REPS)],
           "w_gu_prefill_ms": [cuda_ms(torch, [lambda: dm.dequant_matmul(
               xp, q_big)], 20) for _ in range(STEP_REPS)]}
    del calls, q_big, xp
    torch.cuda.empty_cache()
    out.update(a8_step_ms(torch))
    out.update(step_attention_ms(torch, cfg))
    return out


def a8_step_ms(torch) -> dict:
    """ms of the Llama-2-7B W4A8 g128 decode step's 129 matmuls (8 slots,
    LLAMA2_MATS, weight copies past the L2) and of one Mixtral-8x7B
    layer's cat experts (MIXTRAL_GEMV_MATS), the row quantizer included,
    through `dequant_matmul` alone, by CUDA-graph replay, STEP_REPS times
    each (`--step-ms`)."""
    from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
    g = torch.Generator(device="cuda").manual_seed(SEED + 27)

    def calls(mats, copies_of):
        for k, n, mode, per in mats:
            qws = [random_qw(torch, g, k, n, 4, 128, 8)
                   for _ in range(copies_of(k, n))]
            x = torch.randn(8, 2 * k if mode == "glu" else k, generator=g,
                            device="cuda").to(torch.bfloat16)
            kw = {}
            if mode == "rms":
                kw["rms_weight"] = (torch.randn(k, generator=g, device="cuda")
                                    * 0.1 + 1).to(torch.bfloat16)
            if mode in ("res", "glu"):
                kw["residual"] = torch.randn(8, n, generator=g,
                                             device="cuda").to(torch.bfloat16)
            if mode == "glu":
                kw["glu"] = True
            od = torch.float32 if mode == "f32" else torch.bfloat16
            yield [lambda q=q, x=x, kw=kw, od=od: dm.dequant_matmul(
                x, q, out_dtype=od, **kw) for q in qws], per

    l7 = list(calls([(k, n, mode, 1 if mode == "f32" else LLAMA2_LAYERS)
                     for _, k, n, mode in LLAMA2_MATS],
                    lambda k, n: max(1, -(-200_000_000 // (k // 2 * n)))))
    out = {"llama2_w4a8g_step_ms": [sum(per * cuda_ms(torch, fns, 50)
                                        for fns, per in l7)
                                    for _ in range(STEP_REPS)]}
    del l7
    torch.cuda.empty_cache()
    mx = list(calls([(k, n, "f32", 1) for _, k, n in MIXTRAL_GEMV_MATS],
                    lambda k, n: 1))
    out["mixtral_cat_layer_ms"] = [sum(cuda_ms(torch, fns, 20)
                                       for fns, _ in mx)
                                   for _ in range(STEP_REPS)]
    del mx
    torch.cuda.empty_cache()
    return out


# (name, store, query heads, kv heads, head dim, layout, calls a decode
# step): the attention calls of a decode step that `--step-ms` times, then
# single calls at the 7B's and Mixtral's heads (calls 1)
STEP_ATTENTION = (
    ("tinyllama #3 bf16 x22", "bf16", 32, 4, 64, "contiguous", 22),
    ("llama2-7b #3 k8v4 x32", "k8v4", 32, 32, 128, "contiguous", 32),
    ("tinyllama #5 bf16 pages of 128 x22", "bf16", 32, 4, 64, "paged", 22),
    ("llama2-7b #3 bf16", "bf16", 32, 32, 128, "contiguous", 1),
    ("mixtral-8x7b #3 int8", "int8", 32, 8, 128, "contiguous", 1))
ATTN_PAGE = 128
#: live K/V bytes a timing cycles through at least: past the 50 MB L2, as a
#: decode step finds the cache after a layer's weights streamed by
ATTN_COLD_BYTES = 75_000_000


def attention_live_bytes(store, kh, d, lens, page=None):
    """Bytes #3 / #5 must read at `lens`: each live row's K and V of every
    kv head and their f32 scales, and with pages the page ids of the live
    pages (q and the output apart)."""
    per = {"bf16": 4 * d, "int8": 2 * d + 8, "int4": d + 16,
           "k8v4": d + d // 2 + 12}[store] * kh
    live = sum(lens)
    table = 4 * sum(-(-n // page) for n in lens) if page else 0
    return live * per + table


def attention_inputs(torch, store, hq, kh, d, layout, copies, seed):
    """Random decode-attention operands on the card, 8 slots over a 1024-row
    cache (or 8 pages of ATTN_PAGE a slot in a pool of 65 pages), `copies`
    caches deep: (q, lens, [(args, kwargs) per copy]). Quantized codes are
    random bytes, scales uniform in [0.001, 0.021)."""
    from deeppowers_tpu_torch.quant.kvquant import STORE_BITS
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, s = 8, 1024
    kb, vb = STORE_BITS[store]
    q = torch.randn(b, hq, d, generator=g, device="cuda").to(torch.bfloat16)
    lens = torch.tensor(ATTN_LENS, device="cuda", dtype=torch.int32)
    wp = s // ATTN_PAGE
    table = (torch.randperm(b * wp, generator=torch.Generator().manual_seed(
        seed)) + 1).reshape(b, wp).to(device="cuda", dtype=torch.int32)

    def side(bits):
        width = kh * d // 2 if bits == 4 else kh * d
        shape = ((b * wp + 1, ATTN_PAGE, width) if layout == "paged"
                 else (b, s, width))
        if bits == 16:
            return torch.randn(shape, generator=g, device="cuda").to(
                torch.bfloat16), None
        rows = kh * (2 if bits == 4 else 1)
        sshape = ((b * wp + 1, rows, ATTN_PAGE) if layout == "paged"
                  else (b, rows, s))
        return (torch.randint(-128, 128, shape, generator=g, device="cuda",
                              dtype=torch.int8),
                0.001 + 0.02 * torch.rand(sshape, generator=g, device="cuda"))
    sets = []
    for _ in range(copies):
        (kc, ks), (vc, vs) = side(kb), side(vb)
        kw = {} if store == "bf16" else dict(k_scale=ks, v_scale=vs,
                                            kv_bits=kb, v_bits=vb)
        args = ((q, kc, vc, table, lens) if layout == "paged"
                else (q, kc, vc, lens))
        sets.append((args, kw))
    return q, lens, sets


def step_attention_ms(torch, cfg) -> dict:
    """ms of the decode step's attention calls through the wrappers of #3
    and #5 (STEP_ATTENTION: a step's calls times one call's mean), each
    call cycling through enough cache copies that their live rows pass
    ATTN_COLD_BYTES, by CUDA-graph replay, STEP_REPS times each. Only the
    wrappers' calls are used, so any checkout's package can be timed."""
    from deeppowers_tpu_torch.ops.kernels import decode_attention as da
    out = {}
    for i, (name, store, hq, kh, d, layout, per) in enumerate(
            STEP_ATTENTION):
        live = attention_live_bytes(store, kh, d, ATTN_LENS,
                                    ATTN_PAGE if layout == "paged" else None)
        copies = max(1, -(-ATTN_COLD_BYTES // live))
        _, _, sets = attention_inputs(torch, store, hq, kh, d, layout,
                                      copies, SEED + 40 + i)
        fn = (da.decode_attention_paged if layout == "paged"
              else da.decode_attention)
        fns = [lambda a=a, kw=kw: fn(*a, **kw) for a, kw in sets]
        out[f"attention_ms[{name}]"] = [per * cuda_ms(torch, fns, 20 * copies)
                                        for _ in range(STEP_REPS)]
        del sets, fns
        torch.cuda.empty_cache()
    return out


#: random slot orders of ATTN_LENS that `--slot-orders` times, and their seed
SLOT_ORDERS, SLOT_ORDER_SEED = 8, 7


def slot_order_ms(torch) -> dict:
    """ms of STEP_ATTENTION's calls, timed as `step_attention_ms` times them
    but once each, with ATTN_LENS given to the 8 slots ascending,
    descending and in SLOT_ORDERS random orders (random.Random(
    SLOT_ORDER_SEED)): how far a call's time depends on which slots hold
    the long walks. Only the wrappers are used, so any checkout's package
    can be timed (`--slot-orders ROOT`)."""
    global ATTN_LENS, STEP_REPS
    base, reps = ATTN_LENS, STEP_REPS
    rng = random.Random(SLOT_ORDER_SEED)
    orders = [("ascending", base), ("descending", base[::-1])]
    for i in range(SLOT_ORDERS):
        order = list(base)
        rng.shuffle(order)
        orders.append((f"random{i}", tuple(order)))
    out = {}
    try:
        STEP_REPS = 1
        for name, lens in orders:
            ATTN_LENS = lens
            out[name] = {"lens": lens, **step_attention_ms(torch, None)}
    finally:
        ATTN_LENS, STEP_REPS = base, reps
    return out


def ttft_ms(torch) -> dict:
    """TTFT (ms: a prompt alone on a warm engine, add_request and its
    chunks to the first token, synchronized) where #4 and #9 run, TTFT_REPS
    times each: TinyLlama int8 (serve's weights) on a 512-token prompt
    (#4 in bucket 512) and a 900-token one (two chunks through
    flash_attention_chunk); Llama-2-7B W4A8 g128 + k8v4 (serve[llama2-7b]'s
    weights) on a 512-token prompt, unrolled and on the default scan
    engine; Mixtral-8x7B W4A8 g128 + int8 KV (serve[mixtral-8x7b]'s
    weights) on a 512-token prompt (#10 and #9). Then serve's TTFT p50:
    serve's 8 requests through the scheduler and the HTTP server on the
    warm TinyLlama engine, STEP_REPS times. Only the engine and the
    serving API are used, so any checkout's package can be timed
    (`--ttft ROOT`)."""
    from deeppowers_tpu_torch.config import (GenerationConfig, QuantConfig,
                                             RuntimeConfig)
    from deeppowers_tpu_torch.models import transformer as T
    from deeppowers_tpu_torch.models.presets import (LLAMA2_7B, MIXTRAL_8X7B,
                                                     TINYLLAMA_1_1B)
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    first = GenerationConfig(max_tokens=1, temperature=0.0)

    def engine(params, cfg, kv, scan=False):
        e = InferenceEngine(
            params, cfg, device="cuda", eos_token_id=tok.eos_token_id,
            kv_cache_dtype=kv,
            runtime=RuntimeConfig(max_batch_size=8, max_seq_len=1024,
                                  prefill_buckets=(64, 128, 256, 512, 1024),
                                  **({} if scan else {"scan_layers": False})))
        e.generate(tok.encode("warm up"), GenerationConfig(
            max_tokens=2, temperature=0.0))
        return e

    def times(e, n):
        out = []
        for i in range(TTFT_REPS + 1):       # the first one warms the shape
            ids = [4 + (j * 7 + i) % 250 for j in range(n)]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            slot = e.add_request(ids, first)
            while slot in e.prefilling_slots:
                e.continue_prefill(slot)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t1) * 1e3)
            e.pop_finished()
        return out[1:]

    res = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = T.init_params(TINYLLAMA_1_1B, gen, dtype=torch.bfloat16,
                           device="cuda")
    params = T.fuse_params(T.quantize_params(params, QuantConfig()),
                           TINYLLAMA_1_1B)
    e = engine(params, TINYLLAMA_1_1B, "bf16")
    res["tinyllama_512_ms"] = times(e, 512)
    res["tinyllama_900_ms"] = times(e, 900)
    prompts = [prompt_text(n, i) for i, n in enumerate(PROMPT_BYTES)]
    p50 = []
    for _ in range(STEP_REPS):
        results, _, wall, sched = run_requests(torch, e, prompts, MAX_TOKENS,
                                               {}, tok)
        p50.append(summary(results, wall, sched, {})["ttft_ms_p50"])
    res["tinyllama_serve_ttft_p50_ms"] = p50
    del e, params
    params = llama2_params(torch, T, LLAMA2_7B, torch.Generator(
        device="cuda").manual_seed(SEED + 12), "cuda")
    for scan in (False, True):
        e = engine(params, LLAMA2_7B, LLAMA2_KV, scan)
        res["llama2_512_scan_ms" if scan else "llama2_512_ms"] = times(e, 512)
        del e
    del params
    torch.cuda.empty_cache()
    params = mixtral_params(torch, T, MIXTRAL_8X7B, torch.Generator(
        device="cuda").manual_seed(SEED + 16), "cuda")
    e = engine(params, MIXTRAL_8X7B, MIXTRAL_KV)
    res["mixtral_512_ms"] = times(e, 512)
    del e, params
    torch.cuda.empty_cache()
    return res


def check_kernels(torch, cfg):
    from deeppowers_tpu_torch.ops.kernels import (decode_attention as da,
                                                  dequant_matmul as dm,
                                                  flash_attention as fa,
                                                  kv_append as ka)

    dev = torch.device("cuda")
    rn = randn_on(torch, SEED + 1)
    rows = []
    b = 8

    # -- 1. dequant_matmul: the five decode matmuls of one step, M = 8 -----
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0.0, "flops": 0.0}
    err_max = 0.0
    for name, k, n, per_step, qws, x, kw, out_dtype in int8_step(
            torch, cfg, rn, b):
        w_bytes = k * n
        got = dm.dequant_matmul(x, qws[0], out_dtype=out_dtype, **kw)
        ref = dm.dequant_matmul_plain(x, qws[0].data, qws[0].scales,
                                      out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
        err, ratio = check_dm(f"dequant_matmul {name}", got, ref)
        log(f"  dequant_matmul {name} M={b} K={k} N={n}: max_abs_err={err:.3e}"
            f" worst row ratio {ratio:.3e}")
        err_max = max(err_max, err)
        wbf = [(q.data.to(torch.bfloat16) * q.scales.to(torch.bfloat16))
               for q in qws]
        t_k = cuda_ms(torch, [lambda q=q: dm.dequant_matmul(
            x, q, out_dtype=out_dtype, **kw) for q in qws], 50)
        t_p = cuda_ms(torch, [lambda q=q: dm.dequant_matmul_plain(
            x, q.data, q.scales, out_dtype=out_dtype, **kw) for q in qws], 10,
            graph=False)
        t_e = cuda_ms(torch, [lambda q=q: dm.dequant_matmul(
            x, q, out_dtype=out_dtype, **kw) for q in qws], 50, graph=False)
        t_l = cuda_ms(torch, [lambda w=w: torch.matmul(x[:, :k], w)
                              for w in wbf], 50)
        nbytes = (w_bytes + 4 * n + x.numel() * 2
                  + b * n * (4 if out_dtype == torch.float32 else 2)
                  + (b * n * 2 if "residual" in kw else 0)
                  + (k * 2 if "rms_weight" in kw else 0))
        flops = 2 * b * k * n
        bd, _ = bound_ms(nbytes, flops)
        log(f"  dequant_matmul {name}: kernel {t_k:.4f} ms (eager, with the "
            f"host's launch cost: {t_e:.4f} ms), plain {t_p:.4f} ms, "
            f"torch.matmul bf16 {t_l:.4f} ms, bound {bd:.4f} ms, "
            f"x{per_step} per step")
        tot["ms"] += per_step * t_k
        tot["plain"] += per_step * t_p
        tot["lib"] += per_step * t_l
        tot["bytes"] += per_step * nbytes
        tot["flops"] += per_step * flops
        del qws, wbf
    bd, by = bound_ms(tot["bytes"], tot["flops"])
    rows.append({"name": "dequant_matmul", "route": "cuda",
                 "source": "deeppowers_tpu_torch/csrc/gemv.cu",
                 "replaces": "deeppowers_tpu/ops/pallas/dequant_matmul.py:528",
                 "max_abs_err": err_max, "ms": tot["ms"],
                 "plain_ms": tot["plain"], "bound_ms": bd, "bound_by": by,
                 "library_ms": tot["lib"]})

    rows += check_w8_prefill(torch, cfg, rn)
    rows += check_odd_n(torch)

    # -- 2. kv_append: one decode token per slot into a 1024-row cache -----
    s_cache, f = 1024, cfg.kv_size
    kc, vc = rn(b, s_cache, f), rn(b, s_cache, f)
    kc2, vc2 = kc.clone(), vc.clone()
    kr, vr = rn(b, f), rn(b, f)
    pos = torch.tensor([16, 64, 100, 200, 300, 450, 600, 1024], device=dev,
                       dtype=torch.int32)                # last one dropped
    ka.scatter_rows(kc, vc, kr, vr, pos)
    ka.scatter_rows_plain(kc2, vc2, kr, vr, pos)
    torch.cuda.synchronize()
    if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
        fail("scatter_rows differs from its plain version")
    t_k = cuda_ms(torch, [lambda: ka.scatter_rows(kc, vc, kr, vr, pos)], 200)
    t_p = cuda_ms(torch, [lambda: ka.scatter_rows_plain(kc2, vc2, kr, vr,
                                                        pos)], 50, graph=False)
    nb = 2 * 2 * 7 * f * 2                      # 7 rows written, K and V
    bd, by = bound_ms(nb + b * 4, 0)
    keep = pos < s_cache
    flat_rows = (torch.arange(b, device=dev) * s_cache + pos.long())[keep]
    kf, vf = kc2.view(-1, f), vc2.view(-1, f)
    kr_k, vr_k = kr[keep], vr[keep]
    t_l = cuda_ms(torch, [lambda: (kf.index_copy_(0, flat_rows, kr_k),
                                   vf.index_copy_(0, flat_rows, vr_k))], 200)
    log(f"  scatter_rows B={b} S={s_cache} F={f}: exact, kernel {t_k:.4f} ms,"
        f" plain {t_p:.4f} ms, index_copy_ {t_l:.4f} ms, bound {bd:.6f} ms")
    rows.append({"name": "scatter_rows", "route": "cuda",
                 "source": "deeppowers_tpu_torch/csrc/kv_append.cu",
                 "replaces": "deeppowers_tpu/ops/pallas/kv_append.py:104",
                 "max_abs_err": 0.0, "ms": t_k, "plain_ms": t_p,
                 "bound_ms": bd, "bound_by": by, "library_ms": t_l})
    bf16_ms = {"scatter_rows": t_k}

    # -- 3. decode_attention over the serve phase's lengths ----------------
    hq, d, kh = cfg.num_heads, cfg.dim_head, cfg.kv_heads
    rep = hq // kh
    lens = torch.tensor([48, 96, 132, 232, 332, 482, 632, 932], device=dev,
                        dtype=torch.int32)
    q = rn(b, hq, d)
    out = da.decode_attention(q, kc, vc, lens)
    ref = da.decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    err, worst = row_errors(out, ref)
    if not (torch.isfinite(out).all() and worst <= 1e-2):
        fail(f"decode_attention: a (slot, head) row's error is {worst:.3g} "
             f"of its max|ref| (limit 1e-2)")
    t_k = cuda_ms(torch, [lambda: da.decode_attention(q, kc, vc, lens)], 200)
    t_p = cuda_ms(torch, [lambda: da.decode_attention_plain(q, kc, vc,
                                                            lens)], 20,
                  graph=False)
    k4 = kc.view(b, s_cache, kh, d).transpose(1, 2).repeat_interleave(rep, 1)
    v4 = vc.view(b, s_cache, kh, d).transpose(1, 2).repeat_interleave(rep, 1)
    mask = (torch.arange(s_cache, device=dev)[None, :] < lens[:, None].long()
            )[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_l = cuda_ms(torch, [lambda: sdpa(q[:, :, None], k4, v4,
                                       attn_mask=mask)], 200)
    live = int(lens.sum())
    bd, by = bound_ms(2 * live * f * 2 + 2 * q.numel() * 2,
                      4 * live * hq * d)
    log(f"  decode_attention B={b} H={hq} Kh={kh} D={d} S={s_cache} "
        f"live={live}: max_abs_err={err:.3e} worst_row_ratio={worst:.3e}, "
        f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, sdpa {t_l:.4f} ms, "
        f"bound {bd:.6f} ms")
    rows.append({"name": "decode_attention", "route": "cuda",
                 "source": "deeppowers_tpu_torch/csrc/decode_attention.cu",
                 "replaces": "deeppowers_tpu/ops/pallas/decode_attention.py:470",
                 "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                 "bound_ms": bd, "bound_by": by, "library_ms": t_l})
    contiguous_attn_ms = bf16_ms["decode_attention"] = t_k

    # -- 4. flash_attention_prefill: at the serve phase's shape, the 300-
    # and 450-token prompts batched in bucket 512 (longer prompts prefill
    # in chunks, through flash_attention_chunk); and at bucket 1024 with
    # 600 and 900 tokens, the shape it was first held at. The line reports
    # bucket 512; untimed, the same prompts at Mixtral's heads. Then at
    # the 7B's heads (32 x 128, MHA), a 512-token prompt, in a row of its
    # own; and a chunk.
    def flash_case(s, plen, hq=hq, kh=kh, d=d, timed=True):
        rep = hq // kh
        b = len(plen)
        qp, kp, vp = rn(b, s, hq, d), rn(b, s, kh, d), rn(b, s, kh, d)
        ln = torch.tensor(plen, device=dev, dtype=torch.int32)
        out = fa.flash_attention_prefill(qp, kp, vp, ln)
        ref = fa.flash_attention_plain(qp, kp, vp, ln)
        torch.cuda.synchronize()
        errs = [row_errors(out[i, :n], ref[i, :n]) for i, n in enumerate(plen)]
        err, worst = max(e for e, _ in errs), max(w for _, w in errs)
        if not (torch.isfinite(out).all() and worst <= 1e-2):
            fail(f"flash_attention_prefill S={s} H={hq} Kh={kh} D={d}: a "
                 f"valid (token, head) row's error is {worst:.3g} of its "
                 f"max|ref| (limit 1e-2), or not finite")
        if not timed:
            log(f"  flash_attention_prefill B={b} S={s} H={hq} Kh={kh} D={d} "
                f"lengths={plen}: max_abs_err={err:.3e} worst_row_ratio="
                f"{worst:.3e}")
            return err
        t_k = cuda_ms(torch, [lambda: fa.flash_attention_prefill(qp, kp, vp,
                                                                 ln)], 20)
        t_p = cuda_ms(torch, [lambda: fa.flash_attention_plain(qp, kp, vp,
                                                               ln)], 5,
                      graph=False)
        pos = torch.arange(s, device=dev)
        fmask = ((pos[None, :] <= pos[:, None])[None]
                 & (pos[None, None, :] < ln[:, None, None].long()))[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (qp, kp, vp))
        kt, vt = kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1)
        t_l = cuda_ms(torch, [lambda: sdpa(qt, kt, vt, attn_mask=fmask)], 20)
        # only rows below each length are needed (the rest only come out
        # finite): q, out, k and v over those rows, keys j <= i < n per row
        rows_n, keys = sum(plen), sum(n * (n + 1) // 2 for n in plen)
        bd, by = bound_ms(rows_n * (2 * hq + 2 * kh) * d * 2,
                          4 * keys * hq * d)
        log(f"  flash_attention_prefill B={b} S={s} H={hq} Kh={kh} D={d} "
            f"lengths={plen}: max_abs_err={err:.3e} worst_row_ratio="
            f"{worst:.3e}, kernel {t_k:.4f} ms (the CUDA-core kernel "
            f"before: {FLASH_OLD_MS.get((s, hq, kh, d), 'not measured')}), "
            f"plain {t_p:.4f} ms, sdpa {t_l:.4f} ms, bound {bd:.6f} ms")
        return err, t_k, t_p, t_l, bd, by

    err, t_k, t_p, t_l, bd, by = flash_case(512, [300, 450])
    f1024 = flash_case(1024, [600, 900])
    # untimed: Mixtral's heads (32 / 8 x 128, GQA), serve[mixtral-8x7b]'s
    err = max(err, f1024[0], flash_case(512, [300, 450], hq=32, kh=8, d=128,
                                        timed=False))
    rows.append({"name": "flash_attention_prefill", "route": "cuda",
                 "source": "deeppowers_tpu_torch/csrc/flash_attention.cu",
                 "replaces": "deeppowers_tpu/ops/pallas/flash_attention.py:140",
                 "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                 "bound_ms": bd, "bound_by": by, "library_ms": t_l,
                 "ms_1024": f1024[1], "library_ms_1024": f1024[3]})
    err, t_k, t_p, t_l, bd, by = flash_case(512, [512], hq=32, kh=32, d=128)
    rows.append({"name": "flash_attention_prefill[llama2-7b]", "route": "cuda",
                 "source": "deeppowers_tpu_torch/csrc/flash_attention.cu",
                 "replaces": "deeppowers_tpu/ops/pallas/flash_attention.py:140",
                 "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                 "bound_ms": bd, "bound_by": by, "library_ms": t_l,
                 "launch_from": ("serve[llama2-7b]",
                                 "flash_attention_prefill")})
    rows.append(check_flash_chunk(torch, rn, hq, kh, d))
    del kc, vc, kc2, vc2, k4, v4
    torch.cuda.empty_cache()

    # -- 6. scatter_pool_rows: one decode token per slot into the pools ----
    page, n_pages = 128, 65                     # full reservation's pool
    kpool, vpool = rn(n_pages, page, f), rn(n_pages, page, f)
    kpool2, vpool2 = kpool.clone(), vpool.clone()
    prow = torch.tensor([130, 7 * page + 5, 300, 64 * page + 127, 1000, 42,
                         2 * page, 5 * page + 77], device=dev,
                        dtype=torch.int32)
    pvalid = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], device=dev,
                          dtype=torch.bool)       # row 300 is a live row
    ka.scatter_pool_rows(kpool, vpool, kr, vr, prow, pvalid)
    ka.scatter_pool_rows_plain(kpool2, vpool2, kr, vr, prow, pvalid)
    torch.cuda.synchronize()
    if not (torch.equal(kpool, kpool2) and torch.equal(vpool, vpool2)):
        fail("scatter_pool_rows differs from its plain version")
    untouched = kpool.view(-1, f)[[300, 2 * page]]
    if not torch.equal(untouched, kpool2.view(-1, f)[[300, 2 * page]]) or \
            torch.equal(kpool.view(-1, f)[300], kr[2]):
        fail("scatter_pool_rows wrote an invalid row")
    t_k = cuda_ms(torch, [lambda: ka.scatter_pool_rows(
        kpool, vpool, kr, vr, prow, pvalid)], 200)
    t_p = cuda_ms(torch, [lambda: ka.scatter_pool_rows_plain(
        kpool2, vpool2, kr, vr, prow, pvalid)], 50, graph=False)
    vrows = prow.long()[pvalid]
    kpf, vpf = kpool2.view(-1, f), vpool2.view(-1, f)
    kr_v, vr_v = kr[pvalid], vr[pvalid]
    t_l = cuda_ms(torch, [lambda: (kpf.index_copy_(0, vrows, kr_v),
                                   vpf.index_copy_(0, vrows, vr_v))], 200)
    n_valid = int(pvalid.sum())
    bd, by = bound_ms(2 * 2 * n_valid * f * 2 + b * 5, 0)
    log(f"  scatter_pool_rows B={b} pool=({n_pages}, {page}, {f}) "
        f"valid={n_valid}: exact, kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"index_copy_ {t_l:.4f} ms, bound {bd:.6f} ms")
    rows.append({"name": "scatter_pool_rows", "route": "cuda",
                 "source": "deeppowers_tpu_torch/csrc/kv_append.cu",
                 "replaces": "deeppowers_tpu/ops/pallas/kv_append.py:207",
                 "max_abs_err": 0.0, "ms": t_k, "plain_ms": t_p,
                 "bound_ms": bd, "bound_by": by, "library_ms": t_l})
    bf16_ms["scatter_pool_rows"] = t_k

    # -- 5. decode_attention_paged: the lengths of phase 3, through a table
    # of pages scattered over the pool; rows past each length are stale:
    # random, and every third one NaN
    wp = 1024 // page
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(
        SEED + 3))[:b * wp] + 1
    table = perm.reshape(b, wp).to(device=dev, dtype=torch.int32)
    pos_all = torch.arange(wp * page, device=dev)
    stale = pos_all[None, :] >= lens[:, None].long()              # (B, S)
    nan_rows = stale & (pos_all[None, :] % 3 == 0)
    vrow = (table.long()[:, pos_all // page] * page + pos_all % page)
    for pool in (kpool, vpool):
        pool.view(-1, f)[vrow[nan_rows]] = float("nan")
    out = da.decode_attention_paged(q, kpool, vpool, table, lens)
    ref = da.decode_attention_paged_plain(q, kpool, vpool, table, lens)
    torch.cuda.synchronize()
    err, worst = row_errors(out, ref)
    if not (torch.isfinite(out).all() and worst <= 1e-2):
        fail(f"decode_attention_paged: a (slot, head) row's error is "
             f"{worst:.3g} of its max|ref| (limit 1e-2), or not finite")
    t_k = cuda_ms(torch, [lambda: da.decode_attention_paged(
        q, kpool, vpool, table, lens)], 200)
    t_p = cuda_ms(torch, [lambda: da.decode_attention_paged_plain(
        q, kpool, vpool, table, lens)], 20, graph=False)
    live_pages = int(((lens.long() + page - 1) // page).sum())
    bd, by = bound_ms(2 * live * f * 2 + 2 * q.numel() * 2
                      + live_pages * 4 + b * 4, 4 * live * hq * d)
    log(f"  decode_attention_paged B={b} page={page} WP={wp} live={live}: "
        f"max_abs_err={err:.3e} worst_row_ratio={worst:.3e}, kernel "
        f"{t_k:.4f} ms (contiguous kernel #3 at the same lengths "
        f"{contiguous_attn_ms:.4f} ms), plain {t_p:.4f} ms, no single "
        f"library call reads through a table, bound {bd:.6f} ms")
    rows.append({"name": "decode_attention_paged", "route": "cuda",
                 "source": "deeppowers_tpu_torch/csrc/decode_attention.cu",
                 "replaces": "deeppowers_tpu/ops/pallas/decode_attention.py:780",
                 "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                 "bound_ms": bd, "bound_by": by, "library_ms": None,
                 "contiguous_ms": contiguous_attn_ms})
    bf16_ms["decode_attention_paged"] = t_k
    del kpool, vpool, kpool2, vpool2
    rows += check_quantized_kernels(torch, cfg, rn, bf16_ms)
    rows += check_verify_kernels(torch, cfg, bf16_ms)
    rows += check_big_heads_attention(torch)

    return rows


# #3 at tokens 1 over ATTN_LENS at the big models' heads: (name, store,
# query heads, kv heads, head dim, phase and counter of its launches)
BIG_HEADS_ATTENTION = (
    ("llama2-7b", "k8v4", 32, 32, 128,
     ("serve[llama2-7b]", "decode_attention[k8v4]")),
    ("llama2-7b", "bf16", 32, 32, 128,
     ("serve[llama2-7b]", "decode_attention[bf16]")),
    ("mixtral-8x7b", "int8", 32, 8, 128,
     ("serve[mixtral-8x7b]", "decode_attention[int8]")))


def check_big_heads_attention(torch):
    """#3 at tokens 1 over ATTN_LENS (8 slots of a 1024-row cache) at
    Llama-2-7B's heads (32 x 128, MHA) in k8v4 and bf16 and at
    Mixtral-8x7B's (32 / 8 x 128) in int8: each (slot, head) row within
    1e-2 of its plain version's max|ref|, finite, with NaN in the bf16
    rows and scales past each length; timed over enough cache copies that
    their live rows pass ATTN_COLD_BYTES (4 of the 7B's k8v4 cache, 2 of
    its bf16 one), as a decode step finds them after a layer's weights;
    the bf16 row beside F.scaled_dot_product_attention with a length
    mask over the same copies."""
    from deeppowers_tpu_torch.ops.kernels import decode_attention as da
    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for i, (model, store, hq, kh, d, frm) in enumerate(BIG_HEADS_ATTENTION):
        live = attention_live_bytes(store, kh, d, ATTN_LENS)
        copies = max(1, -(-ATTN_COLD_BYTES // live))
        q, lens, sets = attention_inputs(torch, store, hq, kh, d,
                                         "contiguous", copies, SEED + 30 + i)
        (kc, vc), kw = sets[0][0][1:3], sets[0][1]
        stale = torch.arange(kc.shape[1], device="cuda")[None, :] >= \
            lens[:, None].long()
        if store == "bf16":
            kc[stale] = float("nan")
            vc[stale] = float("nan")
        else:
            for sc in (kw["k_scale"], kw["v_scale"]):
                sc.masked_fill_(stale[:, None, :], float("nan"))
        out = da.decode_attention(q, kc, vc, lens, **kw)
        ref = da.decode_attention_plain(q, kc, vc, lens, **kw)
        torch.cuda.synchronize()
        err, worst = row_errors(out, ref)
        if not (torch.isfinite(out).all() and worst <= 1e-2):
            fail(f"decode_attention[{store}] at {model}'s heads: a (slot, "
                 f"head) row's error is {worst:.3g} of its max|ref| (limit "
                 f"1e-2), or not finite")
        fns = [lambda a=a, kw=kw: da.decode_attention(*a, **kw)
               for a, kw in sets]
        t_k = cuda_ms(torch, fns, 20 * copies)
        t_p = cuda_ms(torch, [lambda: da.decode_attention_plain(
            q, kc, vc, lens, **kw)], 5, graph=False)
        bd, by = bound_ms(live + 2 * q.numel() * 2,
                          4 * int(lens.sum()) * hq * d)
        t_l = None
        if store == "bf16":
            mask = (torch.arange(kc.shape[1], device="cuda")[None, :]
                    < lens[:, None].long())[:, None, None, :]
            views = [(a[1].view(8, -1, kh, d).transpose(1, 2),
                      a[2].view(8, -1, kh, d).transpose(1, 2))
                     for a, _ in sets]
            t_l = cuda_ms(torch, [lambda k4=k4, v4=v4: sdpa(
                q[:, :, None], k4, v4, attn_mask=mask)
                for k4, v4 in views], 20 * copies)
        log(f"  decode_attention[{store}] {model} {hq}/{kh} heads x {d} "
            f"live={int(lens.sum())}: max_abs_err={err:.3e} "
            f"worst_row_ratio={worst:.3e}, kernel {t_k:.4f} ms over "
            f"{copies} cache copies, plain {t_p:.4f} ms"
            + (f", sdpa {t_l:.4f} ms" if t_l else "")
            + f", bound {bd:.6f} ms ({by})")
        rows.append({"name": f"decode_attention[{store}, {model}]",
                     "route": "cuda",
                     "source": "deeppowers_tpu_torch/csrc/decode_attention.cu",
                     "replaces": "deeppowers_tpu/ops/pallas/decode_attention.py:470",
                     "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                     "bound_ms": bd, "bound_by": by, "library_ms": t_l,
                     "worst_row_ratio": worst, "cache_copies": copies,
                     "launch_from": frm,
                     **({} if store != "bf16" else {
                         "note": "no phase serves the 7B over a bf16 "
                                 "cache"})})
        del q, lens, sets, kc, vc, kw, out, ref
        torch.cuda.empty_cache()
    return rows


# #4's times before its wgmma redesign (the CUDA-core kernel, PERF.md §6;
# NVIDIA H100 80GB HBM3, 700.00 W), by (S, H, Kh, D); other shapes were not
# timed
FLASH_OLD_MS = {(512, 32, 4, 64): 0.361754}
CHUNK_START, CHUNK_C = 512, 388


def check_flash_chunk(torch, rn, hq, kh, d):
    """#4 with a start offset (flash_attention_chunk): a 900-token prompt's
    second chunk, C = 388 queries at start 512 over its slot's view of 900
    rows, TinyLlama's heads; against its plain version (the f32 einsum
    code attention_chunk ran on the card before), every row within 1e-2
    of its max|ref|; timed beside sdpa with the same mask on repeated
    K/V. Launches from serve, whose 600- and 900-byte prompts chunk. Also
    held, untimed: a last chunk padded to 512 rows past a 1024-row
    cache's end (start 896), whose queries past the view see all of it,
    and the timed chunk at the 7B's and Mixtral's heads (D = 128)."""
    from deeppowers_tpu_torch.ops.kernels import flash_attention as fa
    dev = torch.device("cuda")
    st, c = CHUNK_START, CHUNK_C
    qc, kc, vc = rn(1, c, hq, d), rn(1, st + c, kh, d), rn(1, st + c, kh, d)
    out = fa.flash_attention_chunk(qc, kc, vc, st)
    ref = fa.flash_attention_chunk_plain(qc, kc, vc, st)
    torch.cuda.synchronize()
    err, worst = row_errors(out, ref)
    finite = bool(torch.isfinite(out).all())
    # untimed: the padded last chunk; the same chunk at the 7B's (32 x 128,
    # MHA) and Mixtral's (32 / 8 x 128) heads, which serve[llama2-7b] and
    # serve[mixtral-8x7b] chunk with
    for s_e, c_e, st_e, hq_e, kh_e, d_e in ((1024, 512, 896, hq, kh, d),
                                            (st + c, c, st, 32, 32, 128),
                                            (st + c, c, st, 32, 8, 128)):
        qe, ke, ve = rn(1, c_e, hq_e, d_e), rn(1, s_e, kh_e, d_e), \
            rn(1, s_e, kh_e, d_e)
        out_e = fa.flash_attention_chunk(qe, ke, ve, st_e)
        ref_e = fa.flash_attention_chunk_plain(qe, ke, ve, st_e)
        torch.cuda.synchronize()
        err_e, worst_e = row_errors(out_e, ref_e)
        err, worst = max(err, err_e), max(worst, worst_e)
        finite = finite and bool(torch.isfinite(out_e).all())
        log(f"  flash_attention_chunk C={c_e} start={st_e} view={s_e} "
            f"H={hq_e} Kh={kh_e} D={d_e}: max_abs_err={err_e:.3e} "
            f"worst_row_ratio={worst_e:.3e}")
    if not (finite and worst <= 1e-2):
        fail(f"flash_attention_chunk: a (token, head) row's error is "
             f"{worst:.3g} of its max|ref| (limit 1e-2), or not finite")
    t_k = cuda_ms(torch, [lambda: fa.flash_attention_chunk(qc, kc, vc, st)],
                  20)
    t_p = cuda_ms(torch, [lambda: fa.flash_attention_chunk_plain(
        qc, kc, vc, st)], 5, graph=False)
    rep = hq // kh
    mask = (torch.arange(st + c, device=dev)[None, :]
            <= st + torch.arange(c, device=dev)[:, None])
    qt = qc.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(rep, 1) for t in (kc, vc))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_l = cuda_ms(torch, [lambda: sdpa(qt, kt, vt, attn_mask=mask)], 20)
    keys = sum(st + i + 1 for i in range(c))
    bd, by = bound_ms((c * 2 * hq + (st + c) * 2 * kh) * d * 2,
                      4 * keys * hq * d)
    log(f"  flash_attention_chunk C={c} start={st} H={hq} Kh={kh} D={d}: "
        f"max_abs_err={err:.3e} worst_row_ratio={worst:.3e}, kernel "
        f"{t_k:.4f} ms, plain (attention_chunk's f32 einsum) {t_p:.4f} ms, "
        f"sdpa {t_l:.4f} ms, bound {bd:.6f} ms")
    return {"name": "flash_attention_chunk", "route": "cuda",
            "source": "deeppowers_tpu_torch/csrc/flash_attention.cu",
            "replaces": "deeppowers_tpu/ops/pallas/flash_attention.py:140",
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": bd,
            "bound_by": by, "library_ms": t_l,
            "launch_from": ("serve", "flash_attention_chunk")}


PREFILL_M = 512


def check_w8_prefill(torch, cfg, rn):
    """#1 on the main path's own weight (int8 per-channel, "w8") at a
    512-token prefill: TinyLlama's 22 layers x (wqkv+rms, wo+res,
    w_gu+rms, w_out+glu+res) through the tensor-core route, each against
    its plain version (2e-2 of each row's max|ref|), timed beside its
    bound, its plain version and torch.matmul on bf16 weights. Then the
    route's weight-only prologue (#1p, `stage_activations`) at the same
    rows: the RMSNorm rows of wqkv / w_gu and the GLU rows of w_out against
    its plain version (RMSNorm rows bit for bit; a GLU row may move one
    bf16 step where silu's last f32 bit differs, on at most 1e-3 of the
    values; the row factor within 1e-5)."""
    from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
    m = PREFILL_M
    tot = dict(ms=0.0, plain=0.0, lib=0.0, bytes=0.0, ops=0.0)
    err_max = 0.0
    for name, k, n, per, qws, x, kw, od in int8_step(torch, cfg, rn, m):
        if od == torch.float32:
            continue                 # a prefill takes logits at one row
        q0 = qws[0]
        got = dm.dequant_matmul(x, q0, out_dtype=od, **kw)
        ref = dm.dequant_matmul_plain(x, q0.data, q0.scales, out_dtype=od,
                                      **kw)
        torch.cuda.synchronize()
        err, ratio = check_dm(f"dequant_matmul[w8] {name} M={m}", got, ref)
        err_max = max(err_max, err)
        t_k = cuda_ms(torch, [lambda q=q: dm.dequant_matmul(
            x, q, out_dtype=od, **kw) for q in qws], 10)
        t_p = cuda_ms(torch, [lambda: dm.dequant_matmul_plain(
            x, q0.data, q0.scales, out_dtype=od, **kw)], 3, graph=False)
        wbf = [q.data.to(torch.bfloat16) for q in qws[:2]]
        t_l = cuda_ms(torch, [lambda w=w: torch.matmul(x[:, :k], w)
                              for w in wbf], 10)
        nbytes = (k * n + 4 * n + x.numel() * 2 + m * n * 2
                  + (m * n * 2 if "residual" in kw else 0)
                  + (k * 2 if "rms_weight" in kw else 0))
        log(f"  dequant_matmul[w8] {name} M={m} K={k} N={n}: max_abs_err="
            f"{err:.3e} worst row ratio {ratio:.3e}, kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms, torch.matmul bf16 {t_l:.4f} ms, x{per}")
        tot["ms"] += per * t_k
        tot["plain"] += per * t_p
        tot["lib"] += per * t_l
        tot["bytes"] += per * nbytes
        tot["ops"] += per * 2 * m * k * n
        del qws, wbf
    bd, by = bound_ms(tot["bytes"], tot["ops"])
    log(f"  dequant_matmul[w8, M={m}] TinyLlama prefill: kernel "
        f"{tot['ms']:.4f} ms, plain {tot['plain']:.4f} ms, torch.matmul "
        f"bf16 {tot['lib']:.4f} ms, bound {bd:.4f} ms ({by})")
    rows = [{"name": f"dequant_matmul[w8, M={m}]", "route": "cuda",
             "source": "deeppowers_tpu_torch/csrc/dequant_matmul.cu",
             "replaces": "deeppowers_tpu/ops/pallas/dequant_matmul.py:528",
             "max_abs_err": err_max, "ms": tot["ms"],
             "plain_ms": tot["plain"], "bound_ms": bd, "bound_by": by,
             "library_ms": tot["lib"], "variant": "w8",
             "shape": "TinyLlama 512-token prefill: 22 layers x (wqkv, wo, "
                      "w_gu, w_out)",
             "launch_from": ("serve", "dequant_matmul[mma]")}]

    t = dict(ms=0.0, plain=0.0, bytes=0.0)
    err_max = 0.0
    L = cfg.num_layers
    for k, glu, per in ((cfg.hidden_size, False, 2 * L),
                        (cfg.ffn_size, True, L)):
        x = rn(m, 2 * k if glu else k)
        kw = {"glu": True} if glu else {"rms_weight": rn(k, scale=0.1) + 1.0,
                                         "rms_eps": cfg.norm_eps}
        a, rf = dm.stage_activations(x, k, **kw)
        a2, rf2 = dm.stage_activations_plain(x, k, **kw)
        torch.cuda.synchronize()
        diff = (a.float() - a2.float()).abs()
        err_max = max(err_max, diff.max().item())
        moved = (diff > 0).float().mean().item()
        step = (diff <= a2.float().abs() * 2.0 ** -7 + 1e-30).all().item()
        if glu and not (step and moved <= 1e-3) or not glu and moved:
            fail(f"stage_activations {'glu' if glu else 'rms'}: {moved:.2e} "
                 f"of the values differ from the plain version (one step: "
                 f"{step})")
        if rf is not None and not (
                (rf - rf2).abs() <= 1e-5 * rf.abs()).all():
            fail("stage_activations: row factor off the plain version's")
        t["ms"] += per * cuda_ms(torch, [lambda: dm.stage_activations(
            x, k, **kw)], 20)
        t["plain"] += per * cuda_ms(torch, [
            lambda: dm.stage_activations_plain(x, k, **kw)], 5, graph=False)
        t["bytes"] += per * (x.numel() * 2 + m * k * 2
                             + (0 if glu else k * 2 + m * 4))
    bd, by = bound_ms(t["bytes"], 0.0)
    log(f"  stage_activations (#1p) TinyLlama prefill rows, M={m}: kernel "
        f"{t['ms']:.4f} ms, plain {t['plain']:.4f} ms, bound {bd:.4f} ms "
        f"({by}), max_abs_err {err_max:.3e}")
    rows.append({"name": "stage_activations", "route": "cuda",
                 "source": "deeppowers_tpu_torch/csrc/dequant_matmul.cu",
                 "replaces": "deeppowers_tpu/ops/pallas/dequant_matmul.py:"
                             "179 (the RMSNorm and GLU folds of _make_kernel)",
                 "max_abs_err": err_max, "ms": t["ms"],
                 "plain_ms": t["plain"], "bound_ms": bd, "bound_by": by,
                 "library_ms": None,
                 "shape": "TinyLlama 512-token prefill: 22 layers x (wqkv, "
                          "w_gu RMSNorm rows, w_out GLU rows)",
                 "note": "no one PyTorch call computes bf16(x * g) with the "
                         "row's rsqrt(mean(x^2) + eps), or act(gate) * up",
                 "launch_from": ("scan_serve", "stage_activations")})
    return rows


# GEMV against the tensor-core route: one layer's matmuls at these M
SWEEP_M = (8, 16, 17, 24, 32, 40, 64)


def route_sweep(torch, cfg) -> dict:
    """#1's two routes at small M: one layer's four matmuls of TinyLlama
    int8 (w8) and of Llama-2-7B W4A8 g128, ms a layer by CUDA-graph replay
    with weight copies past the 50 MB L2; the GEMV takes M <= GEMV_MAX_M
    only. {variant: {M: {route: ms}}}: where the tensor-core route is no
    slower, GEMV_MAX_M could end."""
    from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
    g = torch.Generator(device="cuda").manual_seed(SEED + 24)
    h, ffn = cfg.hidden_size, cfg.ffn_size
    tiny = [(h, cfg.q_size + 2 * cfg.kv_size, "rms"), (cfg.q_size, h, "res"),
            (h, 2 * ffn, "rms"), (ffn, h, "glu")]
    l7 = [(k, n, mode) for _, k, n, mode in LLAMA2_MATS if mode != "f32"]
    out = {}
    for var, mats, bits, group, a8 in (("w8", tiny, 8, 0, 0),
                                       ("w4a8g", l7, 4, 128, 8)):
        layer = sum((k // 2 if bits == 4 else k) * n for k, n, _ in mats)
        copies = max(1, -(-150_000_000 // layer))
        qws = [[random_qw(torch, g, k, n, bits, group, a8)
                for k, n, _ in mats] for _ in range(copies)]
        res = {}
        for m in SWEEP_M:
            xs, kws = [], []
            for k, n, mode in mats:
                xs.append((torch.randn(m, 2 * k if mode == "glu" else k,
                                       generator=g, device="cuda")
                           ).to(torch.bfloat16))
                kw = {}
                if mode == "rms":
                    kw["rms_weight"] = torch.ones(k, device="cuda",
                                                  dtype=torch.bfloat16)
                if mode in ("res", "glu"):
                    kw["residual"] = torch.zeros(m, n, device="cuda",
                                                 dtype=torch.bfloat16)
                if mode == "glu":
                    kw["glu"] = True
                kws.append(kw)
            for path in (("gemv", "mma") if m <= dm.GEMV_MAX_M
                         else ("mma",)):
                fns = [lambda c=c, i=i, path=path: dm.dequant_matmul_via(
                    path, xs[i], qws[c][i], **kws[i])
                    for c in range(copies) for i in range(len(mats))]
                res.setdefault(m, {})[path] = round(
                    cuda_ms(torch, fns, 2 * len(fns)) * len(mats), 6)
        out[var] = res
        log(f"  route sweep [{var}] ms a layer (GEMV_MAX_M = "
            f"{dm.GEMV_MAX_M}): " + json.dumps(res))
        del qws
        torch.cuda.empty_cache()
    return out


# #1 at widths no multiple of 8: the untied lm_head of the repo's trained
# checkpoints (lm124_ckpt, moelm_ckpt: K = 768, N = 260) and a wide odd N
ODD_N = ((768, 260), (2048, 4099))


def check_odd_n(torch):
    """#1's tail columns: the decode GEMV (M = 8) and the tensor-core prefill
    path (M = 512) against the plain version, 2e-2 of max|ref|. Its inputs
    come from a generator of their own, so the other checks' inputs do not
    depend on it."""
    from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
    from deeppowers_tpu_torch.quant.quantize import quantize
    rn = randn_on(torch, SEED + 6)
    rows = []
    for k, n in ODD_N:
        qw = quantize(rn(k, n, scale=0.02, dtype=torch.float32))
        err_max, times = 0.0, {}
        for m in (8, 512):
            x = rn(m, k)
            got = dm.dequant_matmul(x, qw, out_dtype=torch.float32)
            ref = dm.dequant_matmul_plain(x, qw.data, qw.scales,
                                          out_dtype=torch.float32)
            torch.cuda.synchronize()
            err, ratio = check_dm(f"dequant_matmul K={k} N={n} M={m}", got,
                                  ref)
            err_max = max(err_max, err)
            times[m] = (
                cuda_ms(torch, [lambda: dm.dequant_matmul(
                    x, qw, out_dtype=torch.float32)], 50),
                cuda_ms(torch, [lambda: dm.dequant_matmul_plain(
                    x, qw.data, qw.scales, out_dtype=torch.float32)], 10,
                    graph=False),
                cuda_ms(torch, [lambda w=qw.data.to(torch.bfloat16)
                                * qw.scales.to(torch.bfloat16): torch.matmul(
                                    x, w)], 50))
            log(f"  dequant_matmul odd N: K={k} N={n} M={m}: max_abs_err="
                f"{err:.3e} worst row ratio {ratio:.3e}, kernel "
                f"{times[m][0]:.4f} "
                f"ms, plain {times[m][1]:.4f} ms, torch.matmul bf16 "
                f"{times[m][2]:.4f} ms")
        t_k, t_p, t_l = times[8]
        bd, by = bound_ms(k * n + 4 * n + 8 * k * 2 + 8 * n * 4, 2 * 8 * k * n)
        rows.append({"name": f"dequant_matmul[N={n}]", "route": "cuda",
                     "source": "deeppowers_tpu_torch/csrc/gemv.cu",
                     "replaces": "deeppowers_tpu/ops/pallas/dequant_matmul.py:528",
                     "max_abs_err": err_max, "ms": t_k, "plain_ms": t_p,
                     "bound_ms": bd, "bound_by": by, "library_ms": t_l,
                     "variant": dm.width_variant(n),
                     "shape": f"M=8 K={k} N={n} (also held at M=512: "
                              f"{times[512][0]:.4f} ms)"})
    return rows


# #1's weight variants at Llama-2-7B's shapes (hidden 4096, ffn 11008,
# vocab 32000): (name, K, N, fusion); w_out's packed half (5504 rows) is no
# multiple of 2048, the TPU kernel's ragged case
LLAMA2_MATS = (("wqkv+rms", 4096, 12288, "rms"), ("wo+res", 4096, 4096, "res"),
               ("w_gu+rms", 4096, 22016, "rms"),
               ("w_out+glu+res", 11008, 4096, "glu"),
               ("lm_head f32", 4096, 32000, "f32"))
# (variant, bits, group, act_bits): the path's W4A8 g128 first
WQ_VARIANTS = (("w4a8g", 4, 128, 8), ("w4g", 4, 128, 0), ("w4", 4, 0, 0),
               ("w8g", 8, 128, 0), ("w8a8", 8, 0, 8))
LLAMA2_LAYERS = 32


def random_qw(torch, g, k, n, bits, group, act_bits):
    """A QuantizedTensor of random ints and random positive scales (so that
    a wrong scale row shows), made on the card."""
    from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor
    data = torch.randint(-127, 128, (k // 2 if bits == 4 else k, n),
                         generator=g, device="cuda", dtype=torch.int8)
    base = 0.02 / (127 if bits == 8 else 7)
    scales = base * (0.5 + torch.rand(k // group if group else 1, n,
                                      generator=g, device="cuda"))
    return QuantizedTensor(data, scales, None, bits, group, act_bits)


def check_wquant_kernels(torch):
    """#1's int4, grouped and a8 variants at Llama-2-7B's matrices, M = 8
    (a decode step of 8 slots) and M = 512 (a 512-token prefill), each
    against its plain version (2e-2 of max|ref|), timed beside its bound,
    the plain version, torch.matmul on bf16 weights and, for a8 at M =
    512, torch._int_mm on the int8 operands (timed only, never called by
    the port). Then the activation quantizer (`check_quantizer`). Rows:
    a decode step's 129 matmuls per variant, a prefill's 128 at M = 512,
    and the quantizer's two. Inputs from a generator of their own."""
    from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
    from deeppowers_tpu_torch.quant.qtypes import unpack_int4
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)

    rows = []
    for var, bits, group, a8 in WQ_VARIANTS:
        for m in (8, 512):
            tot = dict(ms=0.0, plain=0.0, lib=0.0, int_mm=0.0, bytes=0.0,
                       ops=0.0)
            err_max = 0.0
            for name, k, n, mode in LLAMA2_MATS:
                per = 1 if mode == "f32" else LLAMA2_LAYERS
                if m == 512 and mode == "f32":
                    per = 0          # a prefill takes logits at one row
                w_bytes = (k // 2 if bits == 4 else k) * n
                copies = max(1, -(-200_000_000 // w_bytes)) if m == 8 else 1
                qws = [random_qw(torch, g, k, n, bits, group, a8)
                       for _ in range(copies)]
                kx = 2 * k if mode == "glu" else k
                x = rn(m, kx)
                kw = {}
                if mode == "rms":
                    kw["rms_weight"] = rn(k, scale=0.1) + 1.0
                if mode in ("res", "glu"):
                    kw["residual"] = rn(m, n)
                if mode == "glu":
                    kw["glu"] = True
                out_dtype = torch.float32 if mode == "f32" else torch.bfloat16
                q0 = qws[0]

                def plain(q=q0):
                    return dm.dequant_matmul_plain(
                        x, q.data, q.scales, bits=bits, act_bits=a8,
                        out_dtype=out_dtype, **kw)

                got = dm.dequant_matmul(x, q0, out_dtype=out_dtype, **kw)
                ref = plain()
                torch.cuda.synchronize()
                err, ratio = check_dm(f"dequant_matmul[{var}] {name} M={m}",
                                      got, ref)
                err_max = max(err_max, err)
                iters = 50 if m == 8 else 10
                t_k = cuda_ms(torch, [lambda q=q: dm.dequant_matmul(
                    x, q, out_dtype=out_dtype, **kw) for q in qws], iters)
                t_p = cuda_ms(torch, [lambda q=q: plain(q) for q in qws],
                              3, graph=False)
                q_int = unpack_int4(q0.data) if bits == 4 else q0.data
                wbf = [(unpack_int4(q.data) if bits == 4 else q.data).to(
                    torch.bfloat16) for q in qws[:2]]
                xa = x[:, :k]
                t_l = cuda_ms(torch, [lambda w=w: torch.matmul(xa, w)
                                      for w in wbf], iters)
                t_i = 0.0
                if a8 and m == 512:
                    xq = torch.randint(-127, 128, (m, k), generator=g,
                                       device="cuda", dtype=torch.int8)
                    t_i = cuda_ms(torch, [lambda: torch._int_mm(xq, q_int)],
                                  iters)
                nbytes = (w_bytes + q0.scales.numel() * 4 + x.numel() * 2
                          + m * n * (4 if mode == "f32" else 2)
                          + (m * n * 2 if mode in ("res", "glu") else 0))
                ops = 2 * m * k * n
                bd, by = bound_ms(nbytes, ops, int8=bool(a8))
                log(f"  dequant_matmul[{var}] {name} M={m} K={k} N={n}: "
                    f"max_abs_err={err:.3e} worst row ratio {ratio:.3e}, "
                    f"kernel "
                    f"{t_k:.4f} ms, plain {t_p:.4f} ms, torch.matmul bf16 "
                    f"{t_l:.4f} ms" + (f", torch._int_mm {t_i:.4f} ms"
                                       if t_i else "")
                    + f", bound {bd:.4f} ms ({by}), x{per}")
                tot["ms"] += per * t_k
                tot["plain"] += per * t_p
                tot["lib"] += per * t_l
                tot["int_mm"] += per * t_i
                tot["bytes"] += per * nbytes
                tot["ops"] += per * ops
                del qws, wbf, q_int
            bd, by = bound_ms(tot["bytes"], tot["ops"], int8=bool(a8))
            row = {"name": f"dequant_matmul[{var}, M={m}]", "route": "cuda",
                   "source": (GEMV_SRC if m == 8 else MMA_SRC),
                   "replaces": "deeppowers_tpu/ops/pallas/dequant_matmul.py:528",
                   "max_abs_err": err_max, "ms": tot["ms"],
                   "plain_ms": tot["plain"], "bound_ms": bd, "bound_by": by,
                   "library_ms": tot["lib"], "variant": var,
                   "shape": ("Llama-2-7B decode step, 8 slots: 32 layers x "
                             "(wqkv, wo, w_gu, w_out) + lm_head" if m == 8
                             else "Llama-2-7B 512-token prefill: 32 layers x "
                             "(wqkv, wo, w_gu, w_out)")}
            if tot["int_mm"]:
                row["int_mm_ms"] = tot["int_mm"]
            rows.append(row)
            torch.cuda.empty_cache()
    rows += check_quantizer(torch, rn)
    return rows


# the row quantizer's cases (mode, K, M): the 7B's rows at a decode step
# (wqkv and w_gu behind RMSNorm, w_out behind the GLU, plain wo and
# lm_head rows, which Mixtral's attention and w_gu cat share), Mixtral's
# cat w_out rows (K = 8 x 14336: a cluster of 16 blocks a row), and those
# at a verify step's 40 rows (7 blocks a row)
MIXTRAL_CAT_K = 8 * 14336
QUANT_CASES = (("rms", 4096, 8), ("glu", 11008, 8), ("plain", 4096, 8),
               ("plain", MIXTRAL_CAT_K, 8), ("plain", MIXTRAL_CAT_K, 40))
# a decode step's row quantizations, by case: the 7B's 32 layers x (wqkv,
# w_gu, w_out, wo) + lm_head; Mixtral's 32 x (wqkv, wo, w_gu cat, w_out
# cat) + lm_head
QUANT_STEPS = {
    "Llama-2-7B": {("rms", 4096, 8): 2 * LLAMA2_LAYERS,
                   ("glu", 11008, 8): LLAMA2_LAYERS,
                   ("plain", 4096, 8): LLAMA2_LAYERS + 1},
    "Mixtral-8x7B": {("rms", 4096, 8): 32, ("plain", 4096, 8): 2 * 32 + 1,
                     ("plain", MIXTRAL_CAT_K, 8): 32}}


# blocks a row the plan sweep times at each case (those that hold the row)
QUANT_SWEEP_BLOCKS = (1, 2, 3, 4, 8, 16)


def quant_plan_sweep(torch, dm, x, k, kw) -> dict:
    """The row quantizer on the same rows at other cluster sizes: {blocks:
    ms} by CUDA-graph replay, what `quant_plan`'s rule is set from."""
    out = {}
    for blocks in QUANT_SWEEP_BLOCKS:
        piece = -(-k // blocks)
        plan = dm.QuantPlan(blocks, -(-piece // dm.QUANT_ITEM) * dm.QUANT_ITEM)
        if (-(-k // plan.slice) != blocks or plan.slice > dm.QUANT_THREADS
                * dm.QUANT_ITEM * dm.QUANT_ITEMS):
            continue
        out[blocks] = round(cuda_ms(torch, [lambda: dm.quantize_activations(
            x, k, _plan=plan, **kw)], 100), 6)
    return out


def check_quantizer(torch, rn):
    """The row quantizer (a thread-block cluster of `quant_plan` blocks a
    row) at the path's shapes (QUANT_CASES). Plain rows must equal the
    plain version's bytes and scales exactly; with a norm or a GLU in
    front, a last-bit difference in the transform may move a byte by one
    step (limit: one step, and at most 1e-3 of the bytes). Rows: the 7B's
    and Mixtral's decode step's 129 row quantizations each (QUANT_STEPS),
    timed per case by CUDA-graph replay, bound by x read and q written
    once."""
    from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
    times, err_max = {}, 0.0
    for mode, k, m in QUANT_CASES:
        x = rn(m, 2 * k if mode == "glu" else k)
        kw = {"glu": True} if mode == "glu" else {}
        if mode == "rms":
            kw["rms_weight"] = rn(k, scale=0.1) + 1.0
        q, xs = dm.quantize_activations(x, k, **kw)
        qr, xr = dm.quantize_activations(x.cpu(), k, **{
            a: (v.cpu() if torch.is_tensor(v) else v) for a, v in kw.items()})
        diff = (q.cpu().int() - qr.int()).abs()
        err = (q.cpu().float() * xs.cpu() - qr.float() * xr).abs().max().item()
        if mode == "plain" and not (diff.max() == 0 and torch.equal(
                xs.cpu(), xr)):
            fail(f"quantize_activations[plain, K={k}, M={m}] differs from "
                 f"its plain version")
        if diff.max() > 1 or (diff > 0).float().mean() > 1e-3:
            fail(f"quantize_activations[{mode}, K={k}, M={m}]: bytes off by "
                 f"{diff.max().item()} ({(diff > 0).sum().item()} of them)")
        err_max = max(err_max, err)
        t_k = cuda_ms(torch, [lambda: dm.quantize_activations(x, k, **kw)],
                      100)
        t_p = cuda_ms(torch, [lambda: dm.quantize_rows(
            dm._unfused_input(x, k, kw.get("rms_weight"), 1e-6,
                              kw.get("glu", False), "silu"))], 10,
            graph=False)
        nbytes = (x.numel() * 2 + m * k + m * 4
                  + (2 * k if mode == "rms" else 0))
        times[(mode, k, m)] = (t_k, t_p, nbytes)
        plan = dm.quant_plan(m, k, mode == "glu")
        log(f"  quantize_activations[{mode}] M={m} K={k} ({plan.blocks} "
            f"block(s) a row): bytes off {(diff > 0).sum().item()}, max "
            f"dequant err {err:.3e}, kernel {t_k:.4f} ms, plain {t_p:.4f} "
            f"ms, bound {bound_ms(nbytes, 0)[0]:.6f} ms; plan sweep "
            + json.dumps(quant_plan_sweep(torch, dm, x, k, kw)))
    rows = []
    for model, per in QUANT_STEPS.items():
        ms = sum(n * times[c][0] for c, n in per.items())
        plain = sum(n * times[c][1] for c, n in per.items())
        bd, by = bound_ms(sum(n * times[c][2] for c, n in per.items()), 0)
        big = model.startswith("Mixtral")
        rows.append({
            "name": "quantize_activations" + ("[Mixtral step]" if big
                                              else ""),
            "route": "cuda",
            "source": "deeppowers_tpu_torch/csrc/dequant_matmul.cu",
            "replaces": "deeppowers_tpu/ops/pallas/dequant_matmul.py:198 "
                        "(qdot's activation quantization, in #1's body)",
            "max_abs_err": err_max, "ms": ms, "plain_ms": plain,
            "bound_ms": bd, "bound_by": by, "library_ms": None,
            "shape": (f"{model} decode step, 8 slots: 32 layers x (wqkv "
                      "rms, wo, w_gu " + ("cat, w_out cat rows of 114688"
                                          if big else "rms, w_out glu")
                      + ") + lm_head"),
            "note": "no one PyTorch call quantizes rows by their absmax",
            "launch_from": ("serve[mixtral-8x7b]" if big
                            else "serve[llama2-7b]", "quantize_activations")})
    return rows


# Mixtral-8x7B's experts (BASELINE config 5): w_gu (hidden 4096 -> 2 x ffn
# 14336 per expert, cat over 8 experts) through #10 and w_out (14336 ->
# 4096, stacked) through #9, at a routed 512-token prompt: 1024 (token,
# expert) pairs, skewed as a router skews them, one expert empty
MIXTRAL_H, MIXTRAL_FFN, MIXTRAL_E = 4096, 14336, 8
ROUTED_COUNTS = (300, 220, 160, 130, 100, 70, 44, 0)
GROUPED_VARIANTS = (("w4a8g", 4, 128, 8), ("w4g", 4, 128, 0),
                    ("w8g", 8, 128, 0), ("w8a8g", 8, 128, 8))
# #9's and #10's times before they moved onto #1's tensor-core kernel
# (the mma.sync kernel each had, PERF.md §6; NVIDIA H100 80GB HBM3,
# 700.00 W), by kernel and variant
GROUPED_OLD_MS = {
    "grouped_dequant_matmul": {"w4a8g": 3.120774, "w4g": 1.910336,
                               "w8g": 1.969952, "w8a8g": 2.953203},
    "grouped_dequant_matmul_ncat": {"w4a8g": 5.227206, "w4g": 3.369261,
                                    "w8g": 3.453946, "w8a8g": 4.963488}}
# #10's other cats, held untimed: (name, K, n_e, E, group): mixtral-mini's
# w_gu, tiny-moe's, and a ragged one whose 128-column blocks end inside
# the next expert's columns
NCAT_EDGES = (("mixtral-mini", 2048, 11264, 8, 128),
              ("tiny-moe", 64, 256, 4, 32), ("ragged", 64, 96, 4, 32))


def check_grouped_kernels(torch):
    """#10 (grouped_dequant_matmul_ncat, w_gu) and #9 (grouped_dequant_matmul,
    w_out) at Mixtral-8x7B's matrices over ROUTED_COUNTS, laid out in tiles
    of 64 rows as the MoE layer lays them out (every expert's segment
    padded to a tile, dead tail tiles), per weight variant (the path's
    W4A8 g128 first): each against its plain version, every routed row
    within 2e-2 of its own max|ref| (pad rows are never read), timed
    beside its bound, the plain version and one torch.bmm of (E, max
    rows, K) bf16 rows by the dequantized (E, K, N) bf16 weights (timed
    only, never called by the port). Inputs from a generator of their
    own."""
    from deeppowers_tpu_torch.ops.kernels import grouped_matmul as gm
    from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor, unpack_int4
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    e, h, ffn = MIXTRAL_E, MIXTRAL_H, MIXTRAL_FFN
    pairs = int(sum(ROUTED_COUNTS))
    te, dest, m_pad = routed_layout(torch)
    live_tiles = int((te >= 0).sum())
    live_e = sum(1 for c in ROUTED_COUNTS if c)
    xs = {}
    for k in (h, ffn):
        x = torch.zeros(m_pad, k, device=dev, dtype=torch.bfloat16)
        x[dest] = torch.randn(pairs, k, generator=g, device=dev).to(
            torch.bfloat16)
        xs[k] = x
    rows = []
    for var, bits, group, a8 in GROUPED_VARIANTS:
        for kernel, k, n in (("grouped_dequant_matmul_ncat", h, 2 * ffn),
                             ("grouped_dequant_matmul", ffn, h)):
            x = xs[k]
            kst = k // 2 if bits == 4 else k
            base = 0.02 / (127 if bits == 8 else 7)
            if kernel == "grouped_dequant_matmul":
                shape, sshape = (e, kst, n), (e, k // group, n)
            else:
                shape, sshape = (kst, e * n), (k // group, e * n)
            qw = QuantizedTensor(
                torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int8),
                base * (0.5 + torch.rand(sshape, generator=g, device=dev)),
                None, bits, group, a8)
            if kernel == "grouped_dequant_matmul":
                out_dtype = torch.float32
                run = lambda: gm.grouped_dequant_matmul(x, qw, te)  # noqa
                plain = lambda: gm.grouped_dequant_matmul_plain(  # noqa
                    x, qw, te)
                codes = unpack_int4(qw.data, dim=1) if bits == 4 else qw.data
                wbf = (codes.to(torch.bfloat16)
                       * qw.scales.repeat_interleave(group, 1).to(
                           torch.bfloat16))                   # (E, K, N)
            else:
                out_dtype = torch.bfloat16
                run = lambda: gm.grouped_dequant_matmul_ncat(  # noqa
                    x, qw, te, n)
                plain = lambda: gm.grouped_dequant_matmul_ncat_plain(  # noqa
                    x, qw, te, n)
                codes = unpack_int4(qw.data) if bits == 4 else qw.data
                wbf = (codes.to(torch.bfloat16) * qw.scales.repeat_interleave(
                    group, 0).to(torch.bfloat16)).view(k, e, n).transpose(
                        0, 1).contiguous()
            del codes
            got, ref = run(), plain()
            torch.cuda.synchronize()
            err, worst = row_errors(got[dest], ref[dest])
            if not (torch.isfinite(got[dest]).all() and worst <= 2e-2):
                fail(f"{kernel}[{var}]: a routed row's error is {worst:.3g} "
                     f"of its max|ref| (limit 2e-2)")
            t_k = cuda_ms(torch, [run], 5)
            t_p = cuda_ms(torch, [plain], 1, graph=False)
            xb = torch.zeros(e, max(ROUTED_COUNTS), k, device=dev,
                             dtype=torch.bfloat16)
            t_l = cuda_ms(torch, [lambda: torch.bmm(xb, wbf)], 5)
            del wbf, xb
            w_bytes = qw.data.numel() * live_e // e
            s_bytes = qw.scales.numel() * 4 * live_e // e
            # the routed rows only, as the operations count them: the
            # tiles' pad rows are the design's cost, not the function's
            nbytes = (w_bytes + s_bytes + pairs * k * 2
                      + pairs * n * (4 if out_dtype == torch.float32 else 2))
            bd, by = bound_ms(nbytes, 2 * pairs * k * n, int8=bool(a8))
            stacked = kernel == "grouped_dequant_matmul"
            old = (f" (the mma.sync kernel before: "
                   f"{GROUPED_OLD_MS[kernel][var]} ms)")
            log(f"  {kernel}[{var}] {pairs} routed rows (M_pad={m_pad}, "
                f"{live_tiles} live tiles) K={k} N={n}: max_abs_err="
                f"{err:.3e} worst_row_ratio={worst:.3e}, kernel {t_k:.4f} ms"
                f"{old}, plain {t_p:.4f} ms, torch.bmm bf16 {t_l:.4f} ms, "
                f"bound {bd:.4f} ms ({by})")
            if stacked and a8:
                rows += check_segments(torch, gm, te, dest, m_pad, var)
            rows.append({
                "name": f"{kernel}[{var}]", "route": "cuda",
                "source": "deeppowers_tpu_torch/csrc/dequant_matmul.cu",
                "replaces": ("deeppowers_tpu/ops/pallas/dequant_matmul.py:911"
                             if kernel.endswith("ncat") else
                             "deeppowers_tpu/ops/pallas/dequant_matmul.py:755"),
                "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                "bound_ms": bd, "bound_by": by, "library_ms": t_l,
                "variant": var,
                "shape": (f"Mixtral-8x7B {'w_gu' if n > h else 'w_out'}, "
                          f"one layer of a 512-token prefill: {pairs} routed "
                          f"rows over {live_e} of {e} experts")})
            del qw, got, ref
            torch.cuda.empty_cache()
    check_ncat_edges(torch, gm)
    return rows


def check_ncat_edges(torch, gm):
    """#10 at the other cats (NCAT_EDGES) in the four weight variants,
    routed rows of every expert but one, dead tail tiles: every routed row
    within 2e-2 of its own max|ref| of the plain version; untimed."""
    from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 25)
    for name, k, ne, e, group in NCAT_EDGES:
        counts = torch.tensor([70, 0, 130] + [9] * (e - 3), device=dev)
        sorted_e = torch.repeat_interleave(torch.arange(e, device=dev), counts)
        dest, te, m_pad = gm.expert_tiles(sorted_e, counts)
        x = torch.zeros(m_pad, k, device=dev, dtype=torch.bfloat16)
        x[dest] = torch.randn(dest.numel(), k, generator=g, device=dev).to(
            torch.bfloat16)
        errs = {}
        for var, bits, _, a8 in GROUPED_VARIANTS:
            qw = QuantizedTensor(
                torch.randint(-127, 128, (k // 2 if bits == 4 else k, e * ne),
                              generator=g, device=dev, dtype=torch.int8),
                0.01 * (0.5 + torch.rand(k // group, e * ne, generator=g,
                                         device=dev)), None, bits, group, a8)
            got = gm.grouped_dequant_matmul_ncat(x, qw, te, ne)
            ref = gm.grouped_dequant_matmul_ncat_plain(x, qw, te, ne)
            torch.cuda.synchronize()
            err, worst = row_errors(got[dest], ref[dest])
            if not (torch.isfinite(got[dest]).all() and worst <= 2e-2):
                fail(f"grouped_dequant_matmul_ncat[{var}] at {name}: a routed "
                     f"row's error is {worst:.3g} of its max|ref| (limit "
                     f"2e-2)")
            errs[var] = f"{worst:.2e}"
        log(f"  grouped_dequant_matmul_ncat at {name} (K={k}, n_e={ne}, "
            f"E={e}, g{group}): worst row ratio by variant {json.dumps(errs)}")


# a Mixtral-8x7B decode step's MoE through #1's GEMV (the cat path, as
# the engine takes it below 256 tokens): w_gu over all 8 experts' gate|up
# (K = 4096, N = 8 x 2 x 14336) and w_out over their stacked halves (K = 8
# x 14336, N = 4096), W4A8 g128, 8 slots
MIXTRAL_GEMV_MATS = (("w_gu cat", MIXTRAL_H, MIXTRAL_E * 2 * MIXTRAL_FFN),
                     ("w_out cat", MIXTRAL_E * MIXTRAL_FFN, MIXTRAL_H))


def check_mixtral_gemv(torch):
    """#1's GEMV on one Mixtral-8x7B layer's cat experts at M = 8, W4A8
    g128 (the row quantizer's launch included, as the path runs it: the
    cat w_out's rows of 114688 a cluster of 16 blocks each): each matmul
    against its plain version (2e-2 of each row's max|ref|), timed beside
    its bound (the codes and scales read once: about 0.2235 ms), the plain
    version and torch.matmul on the layer's bf16 weights (2.8 GB, made
    here; timed only, never called by the port). Launches from
    serve[mixtral-8x7b]'s GEMV route. Inputs from a generator of their
    own."""
    from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
    g = torch.Generator(device="cuda").manual_seed(SEED + 26)
    tot = dict(ms=0.0, plain=0.0, lib=0.0, bytes=0.0, ops=0.0)
    err_max = 0.0
    for name, k, n in MIXTRAL_GEMV_MATS:
        qw = random_qw(torch, g, k, n, 4, 128, 8)
        x = torch.randn(8, k, generator=g, device="cuda").to(torch.bfloat16)
        got = dm.dequant_matmul(x, qw, out_dtype=torch.float32)
        ref = dm.dequant_matmul_plain(x, qw.data, qw.scales, bits=4,
                                      act_bits=8, out_dtype=torch.float32)
        torch.cuda.synchronize()
        err, ratio = check_dm(f"dequant_matmul[w4a8g] Mixtral {name} M=8",
                              got, ref)
        err_max = max(err_max, err)
        del ref
        t_k = cuda_ms(torch, [lambda: dm.dequant_matmul(
            x, qw, out_dtype=torch.float32)], 20)
        t_p = cuda_ms(torch, [lambda: dm.dequant_matmul_plain(
            x, qw.data, qw.scales, bits=4, act_bits=8,
            out_dtype=torch.float32)], 1, graph=False)
        wbf = torch.randn(k, n, generator=g, device="cuda").to(torch.bfloat16)
        t_l = cuda_ms(torch, [lambda: torch.matmul(x, wbf)], 20)
        del wbf
        nbytes = (qw.data.numel() + qw.scales.numel() * 4 + x.numel() * 2
                  + 8 * n * 4)
        bd, by = bound_ms(nbytes, 2 * 8 * k * n, int8=True)
        log(f"  dequant_matmul[w4a8g] Mixtral {name} M=8 K={k} N={n}: "
            f"max_abs_err={err:.3e} worst row ratio {ratio:.3e}, kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, torch.matmul bf16 "
            f"{t_l:.4f} ms, bound {bd:.4f} ms ({by})")
        tot["ms"] += t_k
        tot["plain"] += t_p
        tot["lib"] += t_l
        tot["bytes"] += nbytes
        tot["ops"] += 2 * 8 * k * n
        del qw, got
        torch.cuda.empty_cache()
    bd, by = bound_ms(tot["bytes"], tot["ops"], int8=True)
    return [{"name": "dequant_matmul[w4a8g, Mixtral layer, M=8]",
             "route": "cuda",
             "source": GEMV_SRC,
             "replaces": "deeppowers_tpu/ops/pallas/dequant_matmul.py:528",
             "max_abs_err": err_max, "ms": tot["ms"],
             "plain_ms": tot["plain"], "bound_ms": bd, "bound_by": by,
             "library_ms": tot["lib"],
             "shape": "Mixtral-8x7B decode step, 8 slots, one layer's cat "
                      "experts: w_gu 4096 x 229376 and w_out 114688 x 4096",
             "launch_from": ("serve[mixtral-8x7b]", "dequant_matmul[gemv]")}]


# 9q at Mixtral's experts, segments of SEG_GROUP (the a8 variants' group):
# #9's input rows (w_out, K = 14336) and #10's (w_gu, K = 4096) in plain
# mode, and #9's input computed from #10's gate | up output in GLU mode
SEG_GROUP = 128
SEG_CASES = (("w_out", MIXTRAL_FFN, False), ("w_gu", MIXTRAL_H, False),
             ("glu", MIXTRAL_FFN, True))
SEG_SRC = "deeppowers_tpu_torch/csrc/dequant_matmul.cu"
SEG_NOTE = ("9q is one launch for both a8 variants (segments of 128 "
            "values); the served Mixtral is w4a8g")


def routed_layout(torch):
    """(te, dest, m_pad) of ROUTED_COUNTS over Mixtral's experts in tiles of
    64 rows, as the MoE layer lays them out."""
    from deeppowers_tpu_torch.ops.kernels import grouped_matmul as gm
    counts = torch.tensor(ROUTED_COUNTS, device="cuda")
    sorted_e = torch.repeat_interleave(
        torch.arange(MIXTRAL_E, device="cuda"), counts)
    dest, te, m_pad = gm.expert_tiles(sorted_e, counts)
    return te, dest, m_pad


def segment_inputs(torch, dest, m_pad, k, glu, seed):
    """9q inputs, (M_pad, K) bf16 rows or (M_pad, 2K) gate | up, over
    copies that keep a timed call's rows and codes out of the 50 MB L2
    (ATTN_COLD_BYTES a turn, at least two): the routed rows random, the
    tiles' pad rows zero, as #10 leaves them for zero rows. From a
    generator of their own."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    width = 2 * k if glu else k
    copies = max(2, -(-ATTN_COLD_BYTES // (m_pad * (2 * width + k))))
    out = []
    for _ in range(copies):
        x = torch.zeros(m_pad, width, device="cuda", dtype=torch.bfloat16)
        x[dest] = torch.randn(dest.numel(), width, generator=g,
                              device="cuda").to(torch.bfloat16)
        out.append(x)
    return out


def eager_glu(torch, gu):
    """#9's input from #10's gate | up output as the MoE layer computes it
    in eager ops where #9's pre-pass does not: bf16(silu(f32 gate) * f32
    up), five kernels (two copies to f32, the SiLU, the product, the
    cast)."""
    i = gu.shape[1] // 2
    return (torch.nn.functional.silu(gu[:, :i].float())
            * gu[:, i:].float()).to(torch.bfloat16)


def segment_calls(torch, gm, te, x, glu, fused):
    """One 9q call on x: plain rows; or #9's input from gate | up, by the
    GLU mode (`fused`, where the package has it) or by the eager GLU ops
    then 9q in plain mode."""
    if glu and fused:
        return lambda: gm.quantize_segments(x, SEG_GROUP, te, glu=True)
    if glu:
        return lambda: gm.quantize_segments(eager_glu(torch, x), SEG_GROUP,
                                            te)
    return lambda: gm.quantize_segments(x, SEG_GROUP, te)


def check_segments(torch, gm, te, dest, m_pad, var):
    """9q, the a8 pre-pass of #9 and #10, for one a8 variant at SEG_CASES:
    every live tile's codes and segment scales equal its plain version's,
    bit for bit; timed over copies past the L2 beside its bound (the
    routed rows read once, GLU's gate and up, and their codes and f32
    scales written once) and the plain version; the GLU row also beside
    the route it replaces (`pair_ms`: the eager GLU ops, then 9q in plain
    mode). Launches from serve[mixtral-8x7b], by mode."""
    live = torch.repeat_interleave(te >= 0, 64)
    pairs = dest.numel()
    rows = []
    for i, (what, k, glu) in enumerate(SEG_CASES):
        xs = segment_inputs(torch, dest, m_pad, k, glu, SEED + 90 + i)
        q, qs = gm.quantize_segments(xs[0], SEG_GROUP, te, glu=glu)
        qp, qsp = gm.quantize_segments_plain(xs[0], SEG_GROUP, glu)
        torch.cuda.synchronize()
        name = f"quantize_segments[{var}, {what} K={k}]"
        if not (torch.equal(q[live], qp[live])
                and torch.equal(qs[:, live], qsp[:, live])):
            fail(f"{name} differs from its plain version")
        del q, qs, qp, qsp
        fns = [segment_calls(torch, gm, te, x, glu, True) for x in xs]
        t_k = cuda_ms(torch, fns, 10 * len(xs))
        t_p = cuda_ms(torch, [lambda: gm.quantize_segments_plain(
            xs[0], SEG_GROUP, glu)], 3, graph=False)
        nbytes = pairs * k * ((4 if glu else 2) + 1) + \
            pairs * (k // SEG_GROUP) * 4
        bd, by = bound_ms(nbytes, 0)
        row = {"name": name, "route": "cuda", "source": SEG_SRC,
               "replaces": "deeppowers_tpu/ops/pallas/dequant_matmul.py:"
                           + ("911" if what == "w_gu" else "755"),
               "max_abs_err": 0.0, "ms": t_k, "plain_ms": t_p,
               "bound_ms": bd, "bound_by": by, "library_ms": None,
               "launch_from": ("serve[mixtral-8x7b]", "quantize_segments"
                               f"[{'glu' if glu else 'plain'}]")}
        pair = ""
        if glu:
            row["pair_ms"] = cuda_ms(torch, [segment_calls(
                torch, gm, te, x, True, False) for x in xs], 10 * len(xs))
            pair = f", the eager GLU ops + 9q {row['pair_ms']:.4f} ms"
        if var != GROUPED_VARIANTS[0][0]:
            row["note"] = SEG_NOTE
        log(f"  {name} {pairs} routed rows (M_pad={m_pad}) segments of "
            f"{SEG_GROUP}{', from gate | up' if glu else ''}: exact, kernel "
            f"{t_k:.4f} ms{pair}, plain {t_p:.4f} ms, bound {bd:.6f} ms "
            f"({by}), {len(xs)} input copies")
        rows.append(row)
        del xs, fns
        torch.cuda.empty_cache()
    return rows


def seg_kernel_ms(torch) -> dict:
    """ms a call of 9q at SEG_CASES (w4a8g's inputs; #9's input from gate |
    up by the GLU mode where the package has it, else by the eager GLU ops
    then 9q, and by that pair in both), over copies past the L2, in turns,
    STEP_REPS times. Only the wrapper is used, so any checkout's package
    can be timed."""
    import inspect

    from deeppowers_tpu_torch.ops.kernels import grouped_matmul as gm
    fused = "glu" in inspect.signature(gm.quantize_segments).parameters
    te, dest, m_pad = routed_layout(torch)
    calls, inputs = {}, []
    for i, (what, k, glu) in enumerate(SEG_CASES):
        xs = segment_inputs(torch, dest, m_pad, k, glu, SEED + 90 + i)
        inputs.append(xs)
        calls[f"{what}_ms"] = [segment_calls(torch, gm, te, x, glu, fused)
                               for x in xs]
        if glu:
            calls["glu_pair_ms"] = [segment_calls(torch, gm, te, x, True,
                                                  False) for x in xs]
    out = {"glu_mode": fused}
    for _ in range(STEP_REPS):
        for name, fns in calls.items():
            out.setdefault(name, []).append(cuda_ms(torch, fns,
                                                    10 * len(fns)))
    del calls, inputs
    torch.cuda.empty_cache()
    return out


def seg_ms(torch) -> dict:
    """`seg_kernel_ms`, then a TTFT_PROMPT-token Mixtral-8x7B prefill alone
    on serve[mixtral-8x7b]'s engine and weights (`moe_prefill_profile`,
    STEP_REPS times). Only the wrappers and the engine are used, so any
    checkout's package can be timed (`--seg-ms ROOT`)."""
    from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
    from deeppowers_tpu_torch.models import transformer as T
    from deeppowers_tpu_torch.models.presets import MIXTRAL_8X7B as cfg
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer
    out = seg_kernel_ms(torch)
    params = mixtral_params(torch, T, cfg, torch.Generator(
        device="cuda").manual_seed(SEED + 16), "cuda")
    tok = ByteTokenizer()
    engine = InferenceEngine(
        params, cfg, device="cuda", eos_token_id=tok.eos_token_id,
        kv_cache_dtype=MIXTRAL_KV,
        runtime=RuntimeConfig(max_batch_size=8, max_seq_len=1024,
                              prefill_buckets=(64, 128, 256, 512, 1024),
                              scan_layers=False))
    engine.generate(tok.encode("warm up"), GenerationConfig(
        max_tokens=2, temperature=0.0))
    out["prefill"] = [moe_prefill_profile(torch, engine)
                      for _ in range(STEP_REPS)]
    del engine, params
    torch.cuda.empty_cache()
    return out


ATTN_LENS = (48, 96, 132, 232, 332, 482, 632, 932)


def check_quantized_kernels(torch, cfg, rn, bf16_ms):
    """#2, #6, #3 and #5 in their quantized variants at the main path's
    shapes: 8 slots, F = 256 (Kh = 4, D = 64), a 1024-row cache or a
    65-page pool of 128 rows. The appends must equal their plain versions
    exactly (bytes and scale bits), leaving dropped and invalid rows
    untouched; attention must keep each (slot, head) row within 1e-2 of
    its max|ref|, finite, with garbage in stale rows and NaN in stale
    scale entries. No single PyTorch call reads or writes a quantized
    cache, so library_ms is null; each row carries the bf16 kernel's time
    at the same shapes as its yardstick."""
    from deeppowers_tpu_torch.ops.kernels import (decode_attention as da,
                                                  kv_append as ka)
    from deeppowers_tpu_torch.quant.kvquant import STORE_BITS, quant_side

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    b, s_cache, page, n_pages = 8, 1024, 128, 65
    hq, d, kh = cfg.num_heads, cfg.dim_head, cfg.kv_heads
    f = kh * d
    wp = s_cache // page
    pos = torch.tensor([16, 64, 100, 200, 300, 450, 600, 1024], device=dev,
                       dtype=torch.int32)                # last one dropped
    prow = torch.tensor([130, 7 * page + 5, 300, 64 * page + 127, 1000, 42,
                         2 * page, 5 * page + 77], device=dev,
                        dtype=torch.int32)
    pvalid = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], device=dev,
                          dtype=torch.bool)
    lens = torch.tensor(ATTN_LENS, device=dev, dtype=torch.int32)
    live = int(lens.sum())
    live_pages = int(((lens.long() + page - 1) // page).sum())
    table = (torch.randperm(n_pages - 1, generator=torch.Generator()
                            .manual_seed(SEED + 5))[:b * wp] + 1).reshape(
        b, wp).to(device=dev, dtype=torch.int32)
    q = rn(b, hq, d)
    kr, vr = rn(b, f), rn(b, f)
    rows = []

    def row(name, src, ms, plain, bd, by, err, extra):
        out = {"name": name, "route": "cuda",
               "source": f"deeppowers_tpu_torch/csrc/{src}",
               "replaces": {"scatter_rows": "deeppowers_tpu/ops/pallas/kv_append.py:104",
                            "scatter_pool_rows": "deeppowers_tpu/ops/pallas/kv_append.py:207",
                            "decode_attention": "deeppowers_tpu/ops/pallas/decode_attention.py:470",
                            "decode_attention_paged": "deeppowers_tpu/ops/pallas/decode_attention.py:780",
                            }[name.split("[")[0]],
               "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": bd, "bound_by": by, "library_ms": None}
        out.update(extra)
        return out

    def random_store(shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    for dtype in ("int8", "int4", "k8v4"):
        kb, vb = STORE_BITS[dtype]
        kw = dict(kv_bits=kb, v_bits=vb)
        fk, fv = (f // 2 if kb == 4 else f), (f // 2 if vb == 4 else f)
        rk, rv = kh * (2 if kb == 4 else 1), kh * (2 if vb == 4 else 1)

        # -- #2: quantize-and-append into (B, S, F') stores, (B, R, S) scales
        arrs = [random_store((b, s_cache, fk)), random_store((b, s_cache, fv)),
                torch.rand((b, rk, s_cache), generator=g, device=dev),
                torch.rand((b, rv, s_cache), generator=g, device=dev)]
        before = [a.clone() for a in arrs]
        refs = [a.clone() for a in arrs]
        ka.scatter_rows(arrs[0], arrs[1], kr, vr, pos, k_scale=arrs[2],
                        v_scale=arrs[3], **kw)
        ka.scatter_rows_plain(refs[0], refs[1], kr, vr, pos, k_scale=refs[2],
                              v_scale=refs[3], **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, r) for a, r in zip(arrs, refs)):
            fail(f"scatter_rows[{dtype}] differs from its plain version")
        if not (torch.equal(arrs[0][7], before[0][7])
                and torch.equal(arrs[3][7], before[3][7])):
            fail(f"scatter_rows[{dtype}] wrote a dropped position")
        changed = (arrs[0] != before[0]).any(-1).sum().item()
        if changed > 7:
            fail(f"scatter_rows[{dtype}] wrote {changed} rows for 7")
        t_k = cuda_ms(torch, [lambda: ka.scatter_rows(
            arrs[0], arrs[1], kr, vr, pos, k_scale=arrs[2], v_scale=arrs[3],
            **kw)], 200)
        t_p = cuda_ms(torch, [lambda: ka.scatter_rows_plain(
            refs[0], refs[1], kr, vr, pos, k_scale=refs[2], v_scale=refs[3],
            **kw)], 50, graph=False)
        nb = 7 * (2 * f * 2 + fk + fv + 4 * (rk + rv)) + b * 4
        bd, by = bound_ms(nb, 0)
        log(f"  scatter_rows[{dtype}] B={b} S={s_cache} F={f}: exact, kernel "
            f"{t_k:.4f} ms (bf16 #2 {bf16_ms['scatter_rows']:.4f} ms), plain "
            f"{t_p:.4f} ms, bound {bd:.6f} ms")
        rows.append(row(f"scatter_rows[{dtype}]", "kv_append.cu", t_k, t_p,
                        bd, by, 0.0, {"bf16_ms": bf16_ms["scatter_rows"]}))

        # -- #6: the same into (P, page, F') pools, (P, R, page) scale pools
        pools = [random_store((n_pages, page, fk)),
                 random_store((n_pages, page, fv)),
                 torch.rand((n_pages, rk, page), generator=g, device=dev),
                 torch.rand((n_pages, rv, page), generator=g, device=dev)]
        before = [a.clone() for a in pools]
        prefs = [a.clone() for a in pools]
        ka.scatter_pool_rows(pools[0], pools[1], kr, vr, prow, pvalid,
                             k_scale=pools[2], v_scale=pools[3], **kw)
        ka.scatter_pool_rows_plain(prefs[0], prefs[1], kr, vr, prow, pvalid,
                                   k_scale=prefs[2], v_scale=prefs[3], **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, r) for a, r in zip(pools, prefs)):
            fail(f"scatter_pool_rows[{dtype}] differs from its plain version")
        if not (torch.equal(pools[0].view(-1, fk)[300],
                            before[0].view(-1, fk)[300])
                and torch.equal(pools[2][2, :, 300 % page],
                                before[2][2, :, 300 % page])):
            fail(f"scatter_pool_rows[{dtype}] wrote an invalid row")
        t_k = cuda_ms(torch, [lambda: ka.scatter_pool_rows(
            pools[0], pools[1], kr, vr, prow, pvalid, k_scale=pools[2],
            v_scale=pools[3], **kw)], 200)
        t_p = cuda_ms(torch, [lambda: ka.scatter_pool_rows_plain(
            prefs[0], prefs[1], kr, vr, prow, pvalid, k_scale=prefs[2],
            v_scale=prefs[3], **kw)], 50, graph=False)
        n_valid = int(pvalid.sum())
        nb = n_valid * (2 * f * 2 + fk + fv + 4 * (rk + rv)) + b * 5
        bd, by = bound_ms(nb, 0)
        log(f"  scatter_pool_rows[{dtype}] B={b} pool=({n_pages}, {page}) "
            f"valid={n_valid}: exact, kernel {t_k:.4f} ms (bf16 #6 "
            f"{bf16_ms['scatter_pool_rows']:.4f} ms), plain {t_p:.4f} ms, "
            f"bound {bd:.6f} ms")
        rows.append(row(f"scatter_pool_rows[{dtype}]", "kv_append.cu", t_k,
                        t_p, bd, by, 0.0,
                        {"bf16_ms": bf16_ms["scatter_pool_rows"]}))
        del arrs, refs, pools, prefs, before

        # -- #2 and #6 at a prefill's shapes: a (2, 512) prompt group's rows
        # into slots 3 and 9 (past the cache: dropped), and a 512-row chunk
        # into slot 0's first four pages. A generator of its own keeps the
        # other checks' inputs as they were.
        gp = torch.Generator(device=dev).manual_seed(SEED + 9)
        pk, pv = (torch.randn(2 * 512, f, generator=gp, device=dev).to(
            torch.bfloat16) for _ in range(2))
        psl = torch.tensor([3, 9], device=dev,
                           dtype=torch.int32).repeat_interleave(512)
        ppos = torch.arange(512, device=dev, dtype=torch.int32).repeat(2)
        prow_p = (table[0, :4, None] * page + torch.arange(
            page, device=dev)).reshape(-1).to(torch.int32)
        pval = torch.ones_like(prow_p, dtype=torch.bool)
        cases = (
            ("scatter_rows", lambda a: ka.scatter_rows(
                a[0], a[1], pk, pv, ppos, slots=psl, k_scale=a[2],
                v_scale=a[3], **kw), lambda a: ka.scatter_rows_plain(
                a[0], a[1], pk, pv, ppos, slots=psl, k_scale=a[2],
                v_scale=a[3], **kw), (b, s_cache), 1024),
            ("scatter_pool_rows", lambda a: ka.scatter_pool_rows(
                a[0], a[1], pk[:512], pv[:512], prow_p, pval, k_scale=a[2],
                v_scale=a[3], **kw), lambda a: ka.scatter_pool_rows_plain(
                a[0], a[1], pk[:512], pv[:512], prow_p, pval, k_scale=a[2],
                v_scale=a[3], **kw), (n_pages, page), 512))
        for kname, kern, plain, (lead, minor), n_rows in cases:
            arrs = [torch.randint(-128, 128, (lead, minor, w), generator=gp,
                                  device=dev, dtype=torch.int8)
                    for w in (fk, fv)] + [
                torch.rand((lead, r, minor), generator=gp, device=dev)
                for r in (rk, rv)]
            refs = [a.clone() for a in arrs]
            kern(arrs)
            plain(refs)
            torch.cuda.synchronize()
            if not all(torch.equal(a, r) for a, r in zip(arrs, refs)):
                fail(f"{kname}[{dtype}] at prefill shapes differs from its "
                     f"plain version")
            t_k = cuda_ms(torch, [lambda: kern(arrs)], 50)
            t_p = cuda_ms(torch, [lambda: plain(refs)], 10, graph=False)
            log(f"  {kname}[{dtype}] {n_rows} prefill rows: exact, kernel "
                f"{t_k:.4f} ms, plain {t_p:.4f} ms")
            del arrs, refs

        # -- #3: a cache quantized from random K/V; stale scales NaN
        kc, ks = quant_side(rn(b, s_cache, kh, d, dtype=torch.float32), kb,
                            2 if kb == 4 else 1)
        vc, vs = quant_side(rn(b, s_cache, kh, d, dtype=torch.float32), vb,
                            2 if vb == 4 else 1)
        ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
        posn = torch.arange(s_cache, device=dev)
        stale = posn[None, :] >= lens[:, None].long()
        nan_at = stale & (posn[None, :] % 3 == 0)
        for sc in (ks, vs):
            sc.masked_fill_(nan_at[:, None, :], float("nan"))
        out = da.decode_attention(q, kc, vc, lens, k_scale=ks, v_scale=vs, **kw)
        ref = da.decode_attention_plain(q, kc, vc, lens, k_scale=ks,
                                        v_scale=vs, **kw)
        torch.cuda.synchronize()
        err, worst = row_errors(out, ref)
        if not (torch.isfinite(out).all() and worst <= 1e-2):
            fail(f"decode_attention[{dtype}]: a (slot, head) row's error is "
                 f"{worst:.3g} of its max|ref| (limit 1e-2), or not finite")
        t_k = cuda_ms(torch, [lambda: da.decode_attention(
            q, kc, vc, lens, k_scale=ks, v_scale=vs, **kw)], 200)
        t_p = cuda_ms(torch, [lambda: da.decode_attention_plain(
            q, kc, vc, lens, k_scale=ks, v_scale=vs, **kw)], 20, graph=False)
        nb = live * (fk + fv + 4 * (rk + rv)) + 2 * q.numel() * 2
        bd, by = bound_ms(nb, 4 * live * hq * d)
        log(f"  decode_attention[{dtype}] B={b} S={s_cache} live={live}: "
            f"max_abs_err={err:.3e} worst_row_ratio={worst:.3e}, kernel "
            f"{t_k:.4f} ms (bf16 #3 {bf16_ms['decode_attention']:.4f} ms), "
            f"plain {t_p:.4f} ms, bound {bd:.6f} ms")
        rows.append(row(f"decode_attention[{dtype}]", "decode_attention.cu",
                        t_k, t_p, bd, by, err,
                        {"worst_row_ratio": worst,
                         "bf16_ms": bf16_ms["decode_attention"]}))

        # -- #5: the same rows scattered over the pool's pages; stale rows
        # random bytes, stale scale entries NaN
        def to_pool(store, width):
            pool = random_store((n_pages, page, width))
            pool[table.long()] = store.reshape(b, wp, page, width)
            return pool

        def to_scale_pool(sc):
            r = sc.shape[1]
            pool = torch.full((n_pages, r, page), float("nan"), device=dev)
            pool[table.long()] = sc.reshape(b, r, wp, page).transpose(1, 2)
            return pool

        kstale = stale[:, :, None]
        kp = to_pool(torch.where(kstale, random_store(kc.shape), kc), fk)
        vp = to_pool(torch.where(kstale, random_store(vc.shape), vc), fv)
        ksp = to_scale_pool(ks.masked_fill(stale[:, None, :], float("nan")))
        vsp = to_scale_pool(vs.masked_fill(stale[:, None, :], float("nan")))
        out = da.decode_attention_paged(q, kp, vp, table, lens, k_scale=ksp,
                                        v_scale=vsp, **kw)
        ref = da.decode_attention_paged_plain(q, kp, vp, table, lens,
                                              k_scale=ksp, v_scale=vsp, **kw)
        torch.cuda.synchronize()
        err, worst = row_errors(out, ref)
        if not (torch.isfinite(out).all() and worst <= 1e-2):
            fail(f"decode_attention_paged[{dtype}]: a (slot, head) row's "
                 f"error is {worst:.3g} of its max|ref| (limit 1e-2), or not "
                 f"finite")
        t_k = cuda_ms(torch, [lambda: da.decode_attention_paged(
            q, kp, vp, table, lens, k_scale=ksp, v_scale=vsp, **kw)], 200)
        t_p = cuda_ms(torch, [lambda: da.decode_attention_paged_plain(
            q, kp, vp, table, lens, k_scale=ksp, v_scale=vsp, **kw)], 20,
            graph=False)
        bd, by = bound_ms(nb + live_pages * 4 + b * 4, 4 * live * hq * d)
        log(f"  decode_attention_paged[{dtype}] B={b} page={page} "
            f"live={live}: max_abs_err={err:.3e} worst_row_ratio="
            f"{worst:.3e}, kernel {t_k:.4f} ms (bf16 #5 "
            f"{bf16_ms['decode_attention_paged']:.4f} ms), plain {t_p:.4f} "
            f"ms, bound {bd:.6f} ms")
        rows.append(row(f"decode_attention_paged[{dtype}]",
                        "decode_attention.cu", t_k, t_p, bd, by, err,
                        {"worst_row_ratio": worst,
                         "bf16_ms": bf16_ms["decode_attention_paged"]}))
        del kc, vc, ks, vs, kp, vp, ksp, vsp
    torch.cuda.empty_cache()
    return rows


# speculative verify windows: K = 4 drafts + the last token
SPEC_K = 4
SPEC_T = SPEC_K + 1
STORES = ("bf16", "int8", "int4", "k8v4")


def verify_bound(torch, lens, t, hq, d, kv_bytes, q_bytes):
    """bound_ms of a verify window: the live K/V bytes (`kv_bytes`, read
    once for all T rows, as for one token), q and the output, and 4 * D
    operations per (query row, visible position): window token t of a
    slot sees lens - (T - 1) + t positions."""
    seen = sum(t * n - t * (t - 1) // 2 for n in lens.tolist())
    return bound_ms(kv_bytes + 2 * q_bytes, 4 * seen * hq * d)


def check_verify_kernels(torch, cfg, bf16_ms):
    """#3 and #5 at tokens = 5 (a verify window of K = 4) in all four
    stores at the decode rows' shapes (8 slots, the kernel's lengths
    ATTN_LENS, 2,886 live rows: TinyLlama's 4 kv heads x 8 query heads x 5
    tokens = 40 rows a kv head), #3 k8v4 at Llama-2-7B's heads (32 x 128,
    rep 1: 5 rows a kv head), and the window appends of #2 and #6 (8 slots
    x 5 rows) in all four stores. Each against its plain version with the
    tokens = 1 limits (attention: each row within 1e-2 of its max|ref|,
    finite over stale rows with NaN in stale scales; appends exact), timed
    beside its bound and its plain version; the bf16 contiguous row also
    beside one F.scaled_dot_product_attention call with an explicit
    (B, H, T, S) boolean mask. Rows carry `launch_from`: the phase and
    counter whose count becomes their launches."""
    from deeppowers_tpu_torch.ops.kernels import (decode_attention as da,
                                                  kv_append as ka)
    from deeppowers_tpu_torch.quant.kvquant import STORE_BITS, quant_side

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    b, s_cache, page, n_pages, t = 8, 1024, 128, 65, SPEC_T
    wp = s_cache // page
    lens = torch.tensor(ATTN_LENS, device=dev, dtype=torch.int32)
    cached = lens - t
    live = int(lens.sum())
    live_pages = int(((lens.long() + page - 1) // page).sum())
    table = (torch.randperm(n_pages - 1, generator=torch.Generator()
                            .manual_seed(SEED + 21))[:b * wp] + 1).reshape(
        b, wp).to(device=dev, dtype=torch.int32)
    pos = torch.arange(s_cache, device=dev)
    stale = pos[None, :] >= lens[:, None].long()
    rows = []

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def row(name, src, pallas_line, ms, plain, bd, by, err, lib, frm, **kw):
        out = {"name": name, "route": "cuda",
               "source": f"deeppowers_tpu_torch/csrc/{src}",
               "replaces": f"deeppowers_tpu/ops/pallas/{pallas_line}",
               "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": bd, "bound_by": by, "library_ms": lib,
               "tokens": t, "launch_from": frm}
        out.update(kw)
        return out

    def store(dtype, kh, d):
        """A cache of `dtype` over random K/V (B, S, Kh, D), stale scales
        NaN: (k, v, kwargs)."""
        kb, vb = STORE_BITS[dtype]
        if dtype == "bf16":
            return (rn(b, s_cache, kh * d).to(torch.bfloat16),
                    rn(b, s_cache, kh * d).to(torch.bfloat16), {})
        kc, ks = quant_side(rn(b, s_cache, kh, d), kb, 2 if kb == 4 else 1)
        vc, vs = quant_side(rn(b, s_cache, kh, d), vb, 2 if vb == 4 else 1)
        ks, vs = (a.transpose(1, 2).contiguous() for a in (ks, vs))
        nan_at = stale & (pos[None, :] % 3 == 0)
        for a in (ks, vs):
            a.masked_fill_(nan_at[:, None, :], float("nan"))
        return (kc.reshape(b, s_cache, -1), vc.reshape(b, s_cache, -1),
                dict(k_scale=ks, v_scale=vs, kv_bits=kb, v_bits=vb))

    def kv_bytes(dtype, kh, d):
        kb, vb = STORE_BITS[dtype]
        f = kh * d
        per = {16: 2 * f, 8: f, 4: f // 2}
        sc = 0 if dtype == "bf16" else 4 * kh * ((2 if kb == 4 else 1)
                                                 + (2 if vb == 4 else 1))
        return live * (per[kb] + per[vb] + sc)

    def attention(dtype, hq, kh, d, layout, frm, shape):
        q = rn(b, t, hq, d).to(torch.bfloat16)
        kc, vc, kw = store(dtype, kh, d)
        if layout == "paged":
            def to_pool(x):
                p = torch.zeros((n_pages, page, x.shape[-1]), dtype=x.dtype,
                                device=dev)
                p[table.long()] = x.reshape(b, wp, page, -1)
                return p

            def to_spool(x):
                p = torch.full((n_pages, x.shape[1], page), float("nan"),
                               device=dev)
                p[table.long()] = x.reshape(b, x.shape[1], wp,
                                            page).transpose(1, 2)
                return p
            kern_args = (q, to_pool(kc), to_pool(vc), table, cached)
            kern_kw = dict(kw)
            if "k_scale" in kw:
                kern_kw.update(k_scale=to_spool(kw["k_scale"]),
                               v_scale=to_spool(kw["v_scale"]))
            fn, plain = da.verify_attention_paged, \
                da.decode_attention_paged_plain
        else:
            fn, plain = da.verify_attention, da.decode_attention_plain
            kern_args, kern_kw = (q, kc, vc, cached), kw
        # the plain version takes the folded rows and the kernel's lengths
        pargs = (da.fold_tokens(q), *kern_args[1:-1], kern_args[-1] + t)
        out = fn(*kern_args, **kern_kw)
        ref = da.unfold_tokens(plain(*pargs, tokens=t, **kern_kw), t)
        torch.cuda.synchronize()
        err, worst = row_errors(out, ref)
        if not (torch.isfinite(out).all() and worst <= 1e-2):
            fail(f"verify {layout} [{dtype}] {shape}: a (slot, token, head) "
                 f"row's error is {worst:.3g} of its max|ref| (limit 1e-2), "
                 f"or not finite")
        t_k = cuda_ms(torch, [lambda: fn(*kern_args, **kern_kw)], 200)
        t_p = cuda_ms(torch, [lambda: plain(*pargs, tokens=t, **kern_kw)],
                      10, graph=False)
        extra = live_pages * 4 + b * 4 if layout == "paged" else b * 4
        bd, by = verify_bound(torch, lens, t, hq, d,
                              kv_bytes(dtype, kh, d) + extra,
                              q.numel() * 2)
        t_l = None
        if dtype == "bf16" and layout == "contiguous":
            rep = hq // kh
            k4 = kc.view(b, s_cache, kh, d).transpose(1, 2).repeat_interleave(
                rep, 1)
            v4 = vc.view(b, s_cache, kh, d).transpose(1, 2).repeat_interleave(
                rep, 1)
            bound_t = (cached[:, None] + 1 + torch.arange(t, device=dev))
            mask = (pos[None, None, :] < bound_t[:, :, None].long())[
                :, None].expand(b, hq, t, s_cache)
            qt = q.transpose(1, 2)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            t_l = cuda_ms(torch, [lambda: sdpa(qt, k4, v4, attn_mask=mask)],
                          200)
        base = bf16_ms["decode_attention_paged" if layout == "paged"
                       else "decode_attention"]
        name = ("decode_attention_paged" if layout == "paged"
                else "decode_attention")
        log(f"  {name}[{dtype}:t{t}] {shape} live={live}: max_abs_err="
            f"{err:.3e} worst_row_ratio={worst:.3e}, kernel {t_k:.4f} ms "
            f"(bf16 tokens=1 {base:.4f} ms), plain {t_p:.4f} ms"
            + (f", sdpa with a (B, H, T, S) mask {t_l:.4f} ms" if t_l else "")
            + f", bound {bd:.6f} ms ({by})")
        return row(f"{name}[{dtype}:t{t}]", "decode_attention.cu",
                   "decode_attention.py:501" if layout != "paged"
                   else "decode_attention.py:1235", t_k, t_p, bd, by, err,
                   t_l, frm, worst_row_ratio=worst, shape=shape)

    hq, kh, d = cfg.num_heads, cfg.kv_heads, cfg.dim_head
    tiny = f"TinyLlama {hq}/{kh} heads x {d}, 8 slots"
    serves = {("bf16", "contiguous"): "spec_serve",
              ("k8v4", "paged"): "spec_paged_serve[k8v4]"}
    for layout in ("contiguous", "paged"):
        for dtype in STORES:
            name = ("decode_attention_paged" if layout == "paged"
                    else "decode_attention")
            phase = serves.get((dtype, layout),
                               f"spec_path[{dtype},{layout}]")
            rows.append(attention(dtype, hq, kh, d, layout,
                                  (phase, f"{name}[{dtype}:t{t}]"), tiny))
            torch.cuda.empty_cache()
    rows.append(attention("k8v4", 32, 32, 128, "contiguous",
                          ("spec_serve[llama2-7b+draft]",
                           f"decode_attention[k8v4:t{t}]"),
                          "Llama-2-7B 32/32 heads x 128, 8 slots"))
    torch.cuda.empty_cache()

    # -- #2 and #6: a window's 8 x 5 rows, per-row slots (#2) or pool rows
    f = kh * d
    kr, vr = (rn(b * t, f).to(torch.bfloat16) for _ in range(2))
    wpos = (torch.tensor([16, 64, 100, 200, 300, 450, 600, 1021], device=dev)
            [:, None] + torch.arange(t, device=dev)).reshape(-1).to(
        torch.int32)                         # the last slot's 3 rows dropped
    wslots = torch.arange(b, device=dev, dtype=torch.int32
                          ).repeat_interleave(t)
    vpage = (wpos.long() // page).clamp(max=wp - 1)
    wvalid = wpos < s_cache
    prow = torch.where(wvalid, table[wslots.long(), vpage].long() * page
                       + wpos.long() % page, 0).to(torch.int32)
    n_ok = int(wvalid.sum())
    for dtype in STORES:
        kb, vb = STORE_BITS[dtype]
        qkw = {} if dtype == "bf16" else dict(kv_bits=kb, v_bits=vb)
        fk = f if kb == 16 else (f // 2 if kb == 4 else f)
        fv = f if vb == 16 else (f // 2 if vb == 4 else f)
        rk, rv = kh * (2 if kb == 4 else 1), kh * (2 if vb == 4 else 1)
        for kname, lead, minor in (("scatter_rows", b, s_cache),
                                   ("scatter_pool_rows", n_pages, page)):
            sdt = torch.bfloat16 if dtype == "bf16" else torch.int8
            arrs = [torch.zeros((lead, minor, w), dtype=sdt, device=dev)
                    for w in (fk, fv)]
            if dtype != "bf16":
                arrs += [torch.rand((lead, r, minor), generator=g, device=dev)
                         for r in (rk, rv)]
            refs = [a.clone() for a in arrs]
            sc = (lambda a: dict(k_scale=a[2], v_scale=a[3])
                  if dtype != "bf16" else {})
            if kname == "scatter_rows":
                def kern(a):
                    ka.scatter_rows(a[0], a[1], kr, vr, wpos, slots=wslots,
                                    **sc(a), **qkw)

                def plain(a):
                    ka.scatter_rows_plain(a[0], a[1], kr, vr, wpos,
                                          slots=wslots, **sc(a), **qkw)
            else:
                def kern(a):
                    ka.scatter_pool_rows(a[0], a[1], kr, vr, prow, wvalid,
                                         **sc(a), **qkw)

                def plain(a):
                    ka.scatter_pool_rows_plain(a[0], a[1], kr, vr, prow,
                                               wvalid, **sc(a), **qkw)
            kern(arrs)
            plain(refs)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(arrs, refs)):
                fail(f"{kname}[{dtype}] with {b * t} window rows differs "
                     f"from its plain version")
            t_k = cuda_ms(torch, [lambda: kern(arrs)], 200)
            t_p = cuda_ms(torch, [lambda: plain(refs)], 20, graph=False)
            t_l = None
            if dtype == "bf16":
                # the same rows by index_copy_ into the flat views, K and V
                flat = (prow.long() if kname == "scatter_pool_rows" else
                        wslots.long() * s_cache + wpos.long())[wvalid]
                kf, vf = refs[0].view(-1, f), refs[1].view(-1, f)
                kv, vv = kr[wvalid], vr[wvalid]
                t_l = cuda_ms(torch, [lambda: (kf.index_copy_(0, flat, kv),
                                               vf.index_copy_(0, flat, vv))],
                              200)
            sc_b = 0 if dtype == "bf16" else 4 * (rk + rv)
            bd, by = bound_ms(n_ok * (2 * f * 2 + fk * (2 if kb == 16 else 1)
                                      + fv * (2 if vb == 16 else 1) + sc_b)
                              + b * t * 8, 0)
            layout = "paged" if kname == "scatter_pool_rows" else "contiguous"
            frm = {("bf16", "contiguous"): "spec_serve",
                   ("k8v4", "paged"): "spec_paged_serve[k8v4]"}.get(
                (dtype, layout), f"spec_path[{dtype},{layout}]")
            log(f"  {kname}[{dtype}] {b} slots x {t} window rows ({n_ok} "
                f"written): exact, kernel {t_k:.4f} ms, plain {t_p:.4f} ms"
                + (f", index_copy_ {t_l:.4f} ms" if t_l else "")
                + f", bound {bd:.6f} ms")
            rows.append(row(
                f"{kname}[{dtype}, {b * t} rows]", "kv_append.cu",
                "kv_append.py:104" if kname == "scatter_rows"
                else "kv_append.py:207", t_k, t_p, bd, by, 0.0, t_l,
                (frm, f"{kname}[{dtype}]")))
            del arrs, refs
    torch.cuda.empty_cache()
    return rows


def check_verify_matmuls(torch, cfg):
    """#1 at a verify step's M = B * T = 40 rows (8 slots x 5 tokens),
    above GEMV_MAX_M, so every matmul takes the tensor-core route: the
    TinyLlama verify step's 89 int8 per-channel matmuls (beside the same
    at M = 8, the decode GEMV) and Llama-2-7B's 129 W4A8 g128 ones (the
    M = 8 row is dequant_matmul[w4a8g, M=8]). Each against its plain
    version (2e-2 of each row's max|ref|), timed beside its bound, its
    plain version, torch.matmul on bf16 weights and, for W4A8,
    torch._int_mm on int8 operands."""
    from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
    m = 8 * SPEC_T
    rn = randn_on(torch, SEED + 22)
    rows = []
    for var, mats in (("w8", None), ("w4a8g", LLAMA2_MATS)):
        for mm in ((8, m) if var == "w8" else (m,)):
            tot = dict(ms=0.0, plain=0.0, lib=0.0, int_mm=0.0, bytes=0.0,
                       ops=0.0)
            err_max = 0.0
            if var == "w8":
                calls = [(per, qws, x, kw, od, k, n)
                         for _, k, n, per, qws, x, kw, od in int8_step(
                             torch, cfg, rn, mm)]
            else:
                g = torch.Generator(device="cuda").manual_seed(SEED + 23)
                calls = []
                for _, k, n, mode in mats:
                    per = 1 if mode == "f32" else LLAMA2_LAYERS
                    copies = max(1, -(-200_000_000 // (k // 2 * n)))
                    qws = [random_qw(torch, g, k, n, 4, 128, 8)
                           for _ in range(copies)]
                    x = rn(mm, 2 * k if mode == "glu" else k)
                    kw = {}
                    if mode == "rms":
                        kw["rms_weight"] = rn(k, scale=0.1) + 1.0
                    if mode in ("res", "glu"):
                        kw["residual"] = rn(mm, n)
                    if mode == "glu":
                        kw["glu"] = True
                    od = torch.float32 if mode == "f32" else torch.bfloat16
                    calls.append((per, qws, x, kw, od, k, n))
            for per, qws, x, kw, od, k, n in calls:
                q0 = qws[0]
                got = dm.dequant_matmul(x, q0, out_dtype=od, **kw)
                ref = dm.dequant_matmul_plain(x, q0.data, q0.scales,
                                              bits=q0.bits,
                                              act_bits=q0.act_bits,
                                              out_dtype=od, **kw)
                torch.cuda.synchronize()
                err, _ = check_dm(f"dequant_matmul[{var}] M={mm} K={k} N={n}",
                                  got, ref)
                err_max = max(err_max, err)
                t_k = cuda_ms(torch, [lambda q=q: dm.dequant_matmul(
                    x, q, out_dtype=od, **kw) for q in qws], 20)
                t_p = cuda_ms(torch, [lambda: dm.dequant_matmul_plain(
                    x, q0.data, q0.scales, bits=q0.bits, act_bits=q0.act_bits,
                    out_dtype=od, **kw)], 3, graph=False)
                from deeppowers_tpu_torch.quant.qtypes import unpack_int4
                wbf = [(unpack_int4(q.data) if q.bits == 4 else q.data).to(
                    torch.bfloat16) for q in qws[:2]]
                t_l = cuda_ms(torch, [lambda w=w: torch.matmul(x[:, :k], w)
                                      for w in wbf], 20)
                if q0.act_bits == 8:
                    xq = torch.randint(-127, 128, (mm, k), device="cuda",
                                       dtype=torch.int8)
                    q_int = unpack_int4(q0.data) if q0.bits == 4 else q0.data
                    tot["int_mm"] += per * cuda_ms(torch, [
                        lambda: torch._int_mm(xq, q_int)], 20)
                    del q_int
                w_bytes = (k // 2 if q0.bits == 4 else k) * n
                tot["ms"] += per * t_k
                tot["plain"] += per * t_p
                tot["lib"] += per * t_l
                tot["bytes"] += per * (w_bytes + q0.scales.numel() * 4
                                       + x.numel() * 2 + mm * n * (
                                           4 if od == torch.float32 else 2)
                                       + (mm * n * 2 if "residual" in kw
                                          else 0))
                tot["ops"] += per * 2 * mm * k * n
                del wbf
            bd, by = bound_ms(tot["bytes"], tot["ops"], int8=var == "w4a8g")
            shape = ("TinyLlama verify step, 8 slots x 5 tokens: 22 layers x "
                     "4 + lm_head" if var == "w8" else
                     "Llama-2-7B verify step, 8 slots x 5 tokens: 32 layers "
                     "x 4 + lm_head")
            if mm == 8:
                shape = "TinyLlama decode step, 8 slots (GEMV path)"
            log(f"  dequant_matmul[{var}, M={mm}] {shape}: kernel "
                f"{tot['ms']:.4f} ms, plain {tot['plain']:.4f} ms, "
                f"torch.matmul bf16 {tot['lib']:.4f} ms"
                + (f", torch._int_mm {tot['int_mm']:.4f} ms"
                   if tot["int_mm"] else "")
                + f", bound {bd:.4f} ms ({by}), max_abs_err {err_max:.3e}")
            rows.append({
                "name": f"dequant_matmul[{var}, M={mm}]", "route": "cuda",
                "source": (GEMV_SRC if mm == 8 else MMA_SRC),
                "replaces": "deeppowers_tpu/ops/pallas/dequant_matmul.py:528",
                "max_abs_err": err_max, "ms": tot["ms"],
                "plain_ms": tot["plain"], "bound_ms": bd, "bound_by": by,
                "library_ms": tot["lib"], "shape": shape,
                "launch_from": ("serve" if mm == 8 else "spec_serve"
                                if var == "w8" else
                                "spec_serve[llama2-7b+draft]",
                                f"dequant_matmul[{var}]")})
            if tot["int_mm"]:
                rows[-1]["int_mm_ms"] = tot["int_mm"]
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3, continued: #8 (stacked caches), #7 (the kt mirror), #11
# ---------------------------------------------------------------------------

# serve's lengths with two slots that complete a chunk in the launch (128
# and 640 rows: a decode step or a window ending on a 128-row boundary)
KT_LENS = (48, 96, 128, 232, 332, 482, 640, 932)
KT_PATH_KV = "k8v4"


def kt_cases(cfg):
    """#7's kernel rows: ((name, query heads, kv heads, head dim), V bits,
    tokens) at Llama-2-7B's heads and `cfg`'s (TinyLlama's)."""
    heads = (("llama2-7b", 32, 32, 128),
             ("tinyllama", cfg.num_heads, cfg.kv_heads, cfg.dim_head))
    return [(h, v_bits, t) for h in heads for v_bits in (8, 4)
            for t in (1, SPEC_T)]


def kt_live_bytes(kh, d, v_bits, t):
    """Bytes #7 must move at KT_LENS: each live row's K (from kt or k) and
    V and their f32 scales, and the chunks it flushes written once (q and
    the output apart)."""
    f = kh * d
    fv = f // 2 if v_bits == 4 else f
    flush = sum(128 * f for n in KT_LENS if n >= 128 and n % 128 < t)
    return sum(KT_LENS) * (f + fv + 4 * kh * (2 + (v_bits == 4))) + flush


def kt_copies(kh, d, v_bits, t):
    """Cache copies a #7 timing cycles through: past ATTN_COLD_BYTES."""
    return max(1, -(-ATTN_COLD_BYTES // kt_live_bytes(kh, d, v_bits, t)))


def kt_inputs(torch, hq, kh, d, v_bits, t, copies, seed):
    """#7's operands on the card: 8 slots of a 1024-row cache at KT_LENS,
    q (8, hq * t, d) folded query rows, lengths, and `copies` caches (kt,
    k, v, k_scale, v_scale): random int8 K and V codes (V packed int4 at
    v_bits 4), scales in [0.01, 0.03) with NaN in every third position past
    each length, the mirror holding each slot's committed chunks and
    random stale bytes in every other chunk (a rejected window's or a
    prefix copy's leftovers, which the whole tail chunks must heal)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, s = 8, 1024
    f = kh * d
    dev = "cuda"
    lens = torch.tensor(KT_LENS, device=dev, dtype=torch.int32)
    pos = torch.arange(s, device=dev)
    nan_at = ((pos[None, :] >= lens[:, None].long())
              & (pos % 3 == 0)[None, :])[:, None, :]
    q = torch.randn(b, t * hq, d, generator=g, device=dev).to(torch.bfloat16)
    sets = []
    for _ in range(copies):
        k = torch.randint(-127, 128, (b, s, f), generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (b, s, f // 2 if v_bits == 4 else f),
                          generator=g, device=dev, dtype=torch.int8)
        ks = torch.rand(b, kh, s, generator=g, device=dev) * 0.02 + 0.01
        vs = torch.rand(b, kh * (2 if v_bits == 4 else 1), s, generator=g,
                        device=dev) * 0.02 + 0.01
        for sc in (ks, vs):
            sc.masked_fill_(nan_at, float("nan"))
        kt = torch.randint(-127, 128, (b, s // 128, f, 128), generator=g,
                           device=dev, dtype=torch.int8)
        for i, n in enumerate(KT_LENS):
            full = max((n - t) // 128, 0)
            kt[i, :full] = k[i, :full * 128].reshape(full, 128,
                                                     f).transpose(1, 2)
        sets.append((kt, k, v, ks, vs))
    return q, lens, sets


def kt_pair_ms(torch, da, q, lens, sets, t, v_bits, reps=1):
    """ms a call of #7 and of #3 over the same caches (#3 reads the
    row-major K and ignores the mirror), by CUDA-graph replay cycling
    through the copies, in turns #7, #3, `reps` times: two lists."""
    fk = [lambda c=c: da.decode_attention_kt(
        q, c[0], c[1], c[2], lens, c[3], c[4], tokens=t, v_bits=v_bits)
        for c in sets]
    f3 = [lambda c=c: da.decode_attention(
        q, c[1], c[2], lens, k_scale=c[3], v_scale=c[4], kv_bits=8,
        v_bits=v_bits if v_bits == 4 else 0, tokens=t) for c in sets]
    kt_ms, d3_ms = [], []
    for _ in range(reps):
        kt_ms.append(cuda_ms(torch, fk, 20 * len(sets)))
        d3_ms.append(cuda_ms(torch, f3, 20 * len(sets)))
    return kt_ms, d3_ms


def kt_ms(torch) -> dict:
    """ms a call of #7 in every case of `kt_cases` (TinyLlama's heads from
    the preset), each beside #3 on the same caches, over cache copies past
    the L2, STEP_REPS times: only the wrappers are used, so any checkout's
    package can be timed (`--kt-ms ROOT`)."""
    from deeppowers_tpu_torch.models.presets import TINYLLAMA_1_1B
    from deeppowers_tpu_torch.ops.kernels import decode_attention as da
    out = {}
    for (heads, hq, kh, d), v_bits, t in kt_cases(TINYLLAMA_1_1B):
        q, lens, sets = kt_inputs(torch, hq, kh, d, v_bits, t,
                                  kt_copies(kh, d, v_bits, t), SEED + 50)
        k_ms, d3 = kt_pair_ms(torch, da, q, lens, sets, t, v_bits,
                              STEP_REPS)
        name = f"{heads},{'k8v4' if v_bits == 4 else 'int8'},t{t}"
        out[f"kt_ms[{name}]"] = k_ms
        out[f"decode_attention_ms[{name}]"] = d3
        del q, lens, sets
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the row writers folded into the attention launch (#3+2, #3+8, #5+6)
# ---------------------------------------------------------------------------

#: (heads, query heads, kv heads, head dim) the fold is held and timed at
FOLD_HEADS = (("tinyllama", 32, 4, 64), ("llama2-7b", 32, 32, 128))
#: (layout, attention, the writer it folds in, its tag, the writer's
#: pallas_call, the attention's)
FOLD_LAYOUTS = (
    ("contiguous", "decode_attention", "scatter_rows", "#3+2",
     "deeppowers_tpu/ops/pallas/kv_append.py:104",
     "deeppowers_tpu/ops/pallas/decode_attention.py:470"),
    ("stacked", "decode_attention", "scatter_rows_stacked", "#3+8",
     "deeppowers_tpu/ops/pallas/kv_append.py:315",
     "deeppowers_tpu/ops/pallas/decode_attention.py:470"),
    ("paged", "decode_attention_paged", "scatter_pool_rows", "#5+6",
     "deeppowers_tpu/ops/pallas/kv_append.py:207",
     "deeppowers_tpu/ops/pallas/decode_attention.py:780"))


def same_bits(torch, x, y) -> bool:
    """Equal bytes (NaN included)."""
    dt = {1: torch.int8, 2: torch.int16, 4: torch.int32,
          8: torch.int64}[x.element_size()]
    return torch.equal(x.view(dt), y.view(dt))


def fold_inputs(torch, store, hq, kh, d, layout, t, copies, seed):
    """A decode (t = 1) or verify (t = 5) step's operands over ATTN_LENS (8
    slots; the lengths count the step's rows): q (8, H*T, D), the step's
    rows k, v (8, T, Kh*D) bf16 at positions lens - T + j (and their pool
    rows), `copies` cache states of a 1024-row layout (stacked: a 2-layer
    stack whose layer 1 is used; paged: pools of ATTN_PAGE pages in a
    shuffled table), and `bind(state)`: (the attention's args, its
    kwargs, the writer of the same rows as a call, the rows' slots filled
    with NaN or the byte 77)."""
    from deeppowers_tpu_torch.ops.kernels import decode_attention as da
    from deeppowers_tpu_torch.ops.kernels import kv_append as ka
    from deeppowers_tpu_torch.quant.kvquant import STORE_BITS
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, s = 8, 1024
    kb, vb = STORE_BITS[store]
    lens = torch.tensor(ATTN_LENS, device="cuda", dtype=torch.int32)
    wp = s // ATTN_PAGE
    table = (torch.randperm(b * wp, generator=torch.Generator().manual_seed(
        seed)) + 1).reshape(b, wp).to(device="cuda", dtype=torch.int32)
    q = torch.randn(b, hq * t, d, generator=g, device="cuda").to(
        torch.bfloat16)
    k_new, v_new = (torch.randn(b, t, kh * d, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    pos = (lens[:, None] - t + torch.arange(t, device="cuda")).to(
        torch.int32).contiguous()
    prow = (table.long().gather(1, (pos // ATTN_PAGE).long()) * ATTN_PAGE
            + pos % ATTN_PAGE).to(torch.int32).reshape(-1)
    # a package without the fold (the parent of a paired run) has no
    # NewRows: the same fields in a tuple of that name serve its writers
    rows_t = getattr(da, "NewRows", None) or collections.namedtuple(
        "NewRows", "k v pos rows valid")
    new = rows_t(k_new, v_new, pos, prow,
                 torch.ones_like(prow, dtype=torch.bool))
    flat_k, flat_v = k_new.reshape(b * t, -1), v_new.reshape(b * t, -1)
    slots = (torch.arange(b, device="cuda", dtype=torch.int32)
             .repeat_interleave(t) if t > 1 else None)
    layer = torch.ones(1, dtype=torch.int32, device="cuda")
    lead = (2,) if layout == "stacked" else ()

    def side(bits):
        width = kh * d // 2 if bits == 4 else kh * d
        shape = ((b * wp + 1, ATTN_PAGE, width) if layout == "paged"
                 else (*lead, b, s, width))
        if bits == 16:
            return [torch.randn(shape, generator=g, device="cuda").to(
                torch.bfloat16)]
        r = kh * (2 if bits == 4 else 1)
        sshape = ((b * wp + 1, r, ATTN_PAGE) if layout == "paged"
                  else (*lead, b, r, s))
        return [torch.randint(-128, 128, shape, generator=g, device="cuda",
                              dtype=torch.int8),
                0.001 + 0.02 * torch.rand(sshape, generator=g, device="cuda")]

    def bind(state):
        kc, vc = state[0], state[2 if store != "bf16" else 1]
        ks, vs = (state[1], state[3]) if store != "bf16" else (None, None)
        full = {} if store == "bf16" else dict(k_scale=ks, v_scale=vs,
                                              kv_bits=kb, v_bits=vb)
        if layout == "stacked":
            kw = {} if store == "bf16" else dict(full, k_scale=ks[1],
                                                v_scale=vs[1])
            args = (q, kc[1], vc[1], lens)
            write = lambda: ka.scatter_rows_stacked(  # noqa: E731
                kc, vc, flat_k, flat_v, layer, pos.reshape(-1), slots=slots,
                **full)
        elif layout == "paged":
            kw, args = full, (q, kc, vc, table, lens)
            write = lambda: ka.scatter_pool_rows(  # noqa: E731
                kc, vc, flat_k, flat_v, new.rows, new.valid, **full)
        else:
            kw, args = full, (q, kc, vc, lens)
            write = lambda: ka.scatter_rows(  # noqa: E731
                kc, vc, flat_k, flat_v, pos.reshape(-1), slots=slots, **full)
        return args, kw, write

    def stale(state):
        for x in state:
            if layout == "paged":
                p = new.rows.long()
                if x.dim() == 3 and x.shape[1] == ATTN_PAGE and \
                        x.dtype != torch.float32:
                    x.view(-1, x.shape[2])[p] = (
                        77 if x.dtype == torch.int8 else float("nan"))
                else:
                    x[p // ATTN_PAGE, :, p % ATTN_PAGE] = float("nan")
                continue
            y = x[1] if layout == "stacked" else x
            bi = torch.arange(b, device="cuda")[:, None].expand(b, t)
            p = pos.long()
            if y.dtype == torch.float32:                  # (B, R, S)
                y.permute(0, 2, 1)[bi, p] = float("nan")
            else:                                         # (B, S, F')
                y[bi, p] = 77 if y.dtype == torch.int8 else float("nan")

    states = [side(kb) + side(vb) for _ in range(copies)]
    return q, lens, new, states, bind, stale


def fold_launch_from(layout, heads, store, t):
    """((phase, counter) that gives a fold row its launches, note): the
    note says when no phase of the run takes that store, layout and window
    at those heads (the counter is then read from a phase of the same
    model and layout)."""
    attn = "decode_attention_paged" if layout == "paged" else \
        "decode_attention"
    key = fold_key(attn, store, t)
    if heads == "llama2-7b":
        phase = {("contiguous", "k8v4", 1): "serve[llama2-7b]",
                 ("contiguous", "k8v4", SPEC_T):
                     "spec_serve[llama2-7b+draft]",
                 ("stacked", "k8v4", 1): "scan_path[llama2-7b]"}.get(
            (layout, store, t))
        if phase:
            return (phase, key), None
        return ("path[llama2-7b]", key), (
            "no phase of this run runs the 7B in this store, layout and "
            "window")
    if layout == "stacked":
        phase = {("bf16", 1): "scan_serve", ("bf16", SPEC_T):
                 "scan_serve[spec]", ("k8v4", 1): "scan_path[k8v4]"}.get(
            (store, t))
        if phase:
            return (phase, key), None
        return ("scan_serve", key), (
            "no phase of this run runs the stacked cache of TinyLlama in "
            "this store and window")
    lay = "paged" if layout == "paged" else "contiguous"
    phase = {("contiguous", "bf16", 1): "serve",
             ("contiguous", "int8", 1): "serve[int8]",
             ("contiguous", "bf16", SPEC_T): "spec_serve",
             ("paged", "bf16", 1): "paged_serve",
             ("paged", "k8v4", 1): "paged_serve[k8v4]",
             ("paged", "k8v4", SPEC_T): "spec_paged_serve[k8v4]"}.get(
        (lay, store, t))
    return (phase or (f"path[{store},{lay}]" if t == 1
                      else f"spec_path[{store},{lay}]"), key), None


def fold_cases(torch):
    """Each fold case in turn (FOLD_HEADS x FOLD_LAYOUTS x STORES x tokens
    1, 5), as a dict: its labels, `live` (the bytes of the attention's
    live rows at ATTN_LENS, the step's rows among them), `copies` (cache
    copies past the L2) and `fold_inputs`' operands."""
    i = 0
    for heads, hq, kh, d in FOLD_HEADS:
        for layout, attn, writer, tag, line, attn_line in FOLD_LAYOUTS:
            for store in STORES:
                for t in (1, SPEC_T):
                    i += 1
                    page = ATTN_PAGE if layout == "paged" else None
                    live = attention_live_bytes(store, kh, d, ATTN_LENS,
                                                page)
                    copies = max(1, -(-ATTN_COLD_BYTES // live))
                    q, lens, new, states, bind, stale = fold_inputs(
                        torch, store, hq, kh, d, layout, t, copies,
                        SEED + 60 + i)
                    yield dict(heads=heads, hq=hq, d=d, layout=layout,
                               attn=attn, writer=writer, tag=tag, line=line,
                               attn_line=attn_line, store=store, t=t,
                               live=live, copies=copies, q=q, lens=lens,
                               new=new, states=states, bind=bind,
                               stale=stale)
                    del q, lens, new, states, bind, stale
                    torch.cuda.empty_cache()


def fold_case_ms(torch, fn, case, order: str) -> dict:
    """ms a call of a fold case by CUDA-graph replay over its cache copies,
    in the turns `order` names: "p" the writer + attention pair, "f" the
    attention that writes the rows. {"p": [ms, ...], "f": [ms, ...]}."""
    t, new = case["t"], case["new"]
    bound = [case["bind"](st) for st in case["states"]]
    calls = {"p": [lambda a=a, k=k, w=w: (w(), fn(*a, tokens=t, **k))
                   for a, k, w in bound],
             "f": [lambda a=a, k=k: fn(*a, tokens=t, new=new, **k)
                   for a, k, _ in bound]}
    out = {"p": [], "f": []}
    for turn in order:
        out[turn].append(cuda_ms(torch, calls[turn], 20 * case["copies"]))
    return out


def fold_ms(torch) -> dict:
    """ms a call of each fold case, the attention that writes the rows
    (when the package has the fold) and the writer + attention pair, in
    turns pair, fold, STEP_REPS times (`fold_case_ms`): only the wrappers
    are used, so any checkout's package can be timed (`--fold-ms ROOT`)."""
    from deeppowers_tpu_torch.ops.kernels import decode_attention as da
    order = ("pf" if hasattr(da, "NewRows") else "p") * STEP_REPS
    out = {}
    for c in fold_cases(torch):
        name = f"{c['tag']},{c['heads']},{c['store']},t{c['t']}"
        ms = fold_case_ms(torch, getattr(da, c["attn"]), c, order)
        out[f"pair_ms[{name}]"] = ms["p"]
        if ms["f"]:
            out[f"fold_ms[{name}]"] = ms["f"]
    return out


def check_fold_kernels(torch):
    """#3+2, #3+8 and #5+6: the attention launch that writes the step's
    rows before it reads them, at tokens 1 and 5, TinyLlama's and the 7B's
    heads, every store, over ATTN_LENS. Against its plain route (the
    writer's plain version, then the attention's) on a clone of the same
    cache, with NaN or stale bytes in the rows' slots first: cache bytes
    and scales equal, each (slot, row) within 1e-2 of its max|ref|,
    finite. Timed over cache copies past the L2 beside the writer +
    attention pair it replaces, in turns pair, fold, fold, pair
    (`fold_case_ms`). The bound counts what the one function moves: the
    live rows and scales once (the step's rows among them, written in
    their stored form, never read back), the step's bf16 rows, their
    positions (and pool rows) and q read, the output written."""
    from deeppowers_tpu_torch.ops.kernels import decode_attention as da
    rows = []
    for c in fold_cases(torch):
        attn, store, t, new, q = c["attn"], c["store"], c["t"], c["new"], \
            c["q"]
        fn = getattr(da, attn)
        plain = getattr(da, attn + "_plain")
        name = (f"{attn}+{c['writer']}[{store}"
                + ("" if t == 1 else f":t{t}") + f", {c['heads']}]")
        state = c["states"][0]
        c["stale"](state)
        ref_state = [x.clone() for x in state]
        args, kw, _ = c["bind"](state)
        ref_args, ref_kw, _ = c["bind"](ref_state)
        key = (store if t == 1 else f"{store}:t{t}") + "+rows"
        before = fn.variant_launches[key]
        out = fn(*args, tokens=t, new=new, **kw)
        ref = plain(*ref_args, tokens=t, new=new, **ref_kw)
        torch.cuda.synchronize()
        if fn.variant_launches[key] != before + 1:
            fail(f"{name}: the call was not counted under {key}")
        if not all(same_bits(torch, x, y) for x, y in zip(state, ref_state)):
            fail(f"{name}: cache bytes or scales differ from the plain "
                 f"route's")
        err, worst = row_errors(out, ref)
        if not (torch.isfinite(out).all() and worst <= 1e-2):
            fail(f"{name}: a (slot, row) error is {worst:.3g} of its "
                 f"max|ref| (limit 1e-2), or not finite")
        ms = fold_case_ms(torch, fn, c, "pffp")
        p_ms, f_ms = ms["p"], ms["f"]
        t_p = cuda_ms(torch, [lambda: plain(
            *ref_args, tokens=t, new=new, **ref_kw)], 3, graph=False)
        index = new.pos.numel() * 4 + (
            new.rows.numel() * 4 + new.valid.numel()
            if c["layout"] == "paged" else 0)
        nb = c["live"] + 2 * new.k.numel() * 2 + index + 2 * q.numel() * 2
        bd, by = bound_ms(nb, 4 * int(c["lens"].sum()) * c["hq"] * t * c["d"])
        log(f"  {name} ({c['tag']}): max_abs_err={err:.3e} "
            f"worst_row_ratio={worst:.3e}, bytes and scales exact; fold "
            f"{f_ms[0]:.4f} / {f_ms[1]:.4f} ms, writer + attention "
            f"{p_ms[0]:.4f} / {p_ms[1]:.4f} ms over {c['copies']} cache "
            f"copies, plain {t_p:.4f} ms, bound {bd:.6f} ms ({by})")
        frm, note = fold_launch_from(c["layout"], c["heads"], store, t)
        row = {"name": name, "route": "cuda",
               "source": "deeppowers_tpu_torch/csrc/decode_attention.cuh",
               "replaces": c["line"], "attention_replaces": c["attn_line"],
               "fold": c["tag"], "max_abs_err": err,
               "ms": sum(f_ms) / 2, "ms_runs": f_ms,
               "pair_ms": sum(p_ms) / 2, "pair_ms_runs": p_ms,
               "plain_ms": t_p, "bound_ms": bd, "bound_by": by,
               "library_ms": None,
               "library_note": "no one PyTorch call writes the rows and "
                               "attends",
               "worst_row_ratio": worst, "cache_copies": c["copies"],
               "tokens": t, "launch_from": frm}
        if note:
            row["note"] = note
        rows.append(row)
        del out, ref, args, kw, ref_args, ref_kw, state, ref_state
    return rows


class int8_dots_off:
    """DPT_ATTN_INT8=0 inside the block, the JAX package's switch: #3 takes
    its bf16-dot kernel, which the kernel rows of the earlier slices hold
    against `decode_attention_plain`; the old value comes back after."""

    def __enter__(self):
        self.old = os.environ.get("DPT_ATTN_INT8")
        os.environ["DPT_ATTN_INT8"] = "0"

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("DPT_ATTN_INT8", None)
        else:
            os.environ["DPT_ATTN_INT8"] = self.old


#: the heads of #3's int8-dot rows: TinyLlama's in every store, the 7B's
#: in its k8v4, Mixtral's in its int8 (name, query heads, kv heads, head
#: dim, stores)
I8_HEADS = (("tinyllama", 32, 4, 64, ("int8", "int4", "k8v4")),
            ("llama2-7b", 32, 32, 128, ("k8v4",)),
            ("mixtral-8x7b", 32, 8, 128, ("int8",)))


def i8_launch_from(heads, layout, store, t):
    """((phase, counter), note) of an int8-dot row's launches: the phase
    whose decode (or verify) steps run that store, layout and window at
    those heads, else a phase of the same model whose counts were reset
    before it, with a note."""
    key = f"decode_attention[i8:{store}{'' if t == 1 else f':t{t}'}+rows]"
    phase = {("tinyllama", "contiguous", "int8", 1): "serve[int8]",
             ("tinyllama", "contiguous", "int4", 1): "path[int4,contiguous]",
             ("tinyllama", "contiguous", "k8v4", 1): "path[k8v4,contiguous]",
             ("tinyllama", "stacked", "k8v4", 1): "scan_path[k8v4]",
             ("llama2-7b", "contiguous", "k8v4", 1): "serve[llama2-7b]",
             ("llama2-7b", "contiguous", "k8v4", SPEC_T):
                 "spec_serve[llama2-7b+draft]",
             ("llama2-7b", "stacked", "k8v4", 1): "serve[llama2-7b,scan]",
             ("mixtral-8x7b", "contiguous", "int8", 1): "serve[mixtral-8x7b]",
             ("mixtral-8x7b", "stacked", "int8", 1):
                 "scan_path[mixtral-8x7b]"}.get((heads, layout, store, t))
    if phase is None and heads == "tinyllama" and layout == "contiguous":
        phase = f"spec_path[{store},contiguous]"
    if phase:
        return (phase, key), None
    home = {"tinyllama": "scan_serve", "llama2-7b": "path[llama2-7b]",
            "mixtral-8x7b": "path[mixtral-8x7b]"}[heads]
    return (home, key), ("no phase of this run runs this model in this "
                         "store, layout and window")


def check_i8_kernels(torch):
    """3i, #3's int8-dot variant (the TPU kernel's default for a K stored
    as int8 bytes): the launch that writes the step's rows and attends
    with int8_dots, at tokens 1 and 5, contiguous and on a stacked cache's
    layer views, over ATTN_LENS (8 slots of a 1024-row cache; at the 7B's
    heads the JAX block is 512, so the slots of 632 and 932 cross one) at
    I8_HEADS. Against `decode_attention_int8_dots_plain` on a clone of the
    same cache, with NaN or stale bytes in the rows' slots first: cache
    bytes and scales equal, each (slot, row) within 1e-2 of its max|ref|,
    finite, one launch counted under the variant's key. Timed over cache
    copies past the L2 beside the bf16-dot kernel on the same caches and
    rows, in turns bf16, int8, int8, bf16. The bound is the fold rows':
    the live rows and scales once, the step's rows, their positions, q and
    the output."""
    from deeppowers_tpu_torch.ops.kernels import decode_attention as da
    rows = []
    i = 0
    for heads, hq, kh, d, stores in I8_HEADS:
        for layout in ("contiguous", "stacked"):
            for store in stores:
                for t in (1, SPEC_T):
                    i += 1
                    rows.append(i8_case(torch, da, heads, hq, kh, d, layout,
                                        store, t, SEED + 80 + i))
                    torch.cuda.empty_cache()
    return rows


def i8_ms(torch) -> dict:
    """ms a call of the int8-dot variant and of the bf16-dot kernel, each
    writing the step's rows, at every case of `check_i8_kernels` (its
    inputs and seeds) over cache copies past the L2, in turns int8, bf16,
    STEP_REPS times: only the wrapper is used, so any checkout's package
    that has the variant can be timed (`--i8-ms ROOT`)."""
    from deeppowers_tpu_torch.ops.kernels import decode_attention as da
    out = {}
    i = 0
    for heads, hq, kh, d, stores in I8_HEADS:
        for layout in ("contiguous", "stacked"):
            for store in stores:
                for t in (1, SPEC_T):
                    i += 1
                    live = attention_live_bytes(store, kh, d, ATTN_LENS)
                    copies = max(1, -(-ATTN_COLD_BYTES // live))
                    q, lens, new, states, bind, stale = fold_inputs(
                        torch, store, hq, kh, d, layout, t, copies,
                        SEED + 80 + i)
                    calls = {dots: [lambda a=a, k=k, dots=dots:
                                    da.decode_attention(
                                        *a, tokens=t, new=new,
                                        int8_dots=dots, **k)
                                    for a, k in (bind(st)[:2]
                                                 for st in states)]
                             for dots in (True, False)}
                    name = f"{heads},{layout},{store},t{t}"
                    for dots in (True, False) * STEP_REPS:
                        out.setdefault(
                            f"{'i8' if dots else 'bf16_dots'}_ms[{name}]",
                            []).append(cuda_ms(torch, calls[dots],
                                               20 * copies))
                    del q, lens, new, states, bind, stale, calls
                    torch.cuda.empty_cache()
    return out


def i8_case(torch, da, heads, hq, kh, d, layout, store, t, seed):
    """One row of `check_i8_kernels`."""
    live = attention_live_bytes(store, kh, d, ATTN_LENS)
    copies = max(1, -(-ATTN_COLD_BYTES // live))
    q, lens, new, states, bind, stale = fold_inputs(
        torch, store, hq, kh, d, layout, t, copies, seed)
    fn, plain = da.decode_attention, da.decode_attention_int8_dots_plain
    name = (f"decode_attention_int8_dots[{store}"
            + ("" if t == 1 else f":t{t}") + f", {heads}, {layout}]")
    state = states[0]
    stale(state)
    ref_state = [x.clone() for x in state]
    args, kw, _ = bind(state)
    ref_args, ref_kw, _ = bind(ref_state)
    key = "i8:" + (store if t == 1 else f"{store}:t{t}") + "+rows"
    before = fn.variant_launches[key]
    out = fn(*args, tokens=t, new=new, int8_dots=True, **kw)
    ref = plain(*ref_args, tokens=t, new=new, **ref_kw)
    torch.cuda.synchronize()
    if fn.variant_launches[key] != before + 1:
        fail(f"{name}: the call was not counted under {key}")
    if not all(same_bits(torch, x, y) for x, y in zip(state, ref_state)):
        fail(f"{name}: cache bytes or scales differ from the plain route's")
    err, worst = row_errors(out, ref)
    if not (torch.isfinite(out).all() and worst <= 1e-2):
        fail(f"{name}: a (slot, row) error is {worst:.3g} of its max|ref| "
             f"(limit 1e-2), or not finite")
    bound = [bind(st)[:2] for st in states]
    calls = {dots: [lambda a=a, k=k, dots=dots: fn(
        *a, tokens=t, new=new, int8_dots=dots, **k) for a, k in bound]
        for dots in (False, True)}
    ms = {False: [], True: []}
    for dots in (False, True, True, False):
        ms[dots].append(cuda_ms(torch, calls[dots], 20 * copies))
    t_p = cuda_ms(torch, [lambda: plain(*ref_args, tokens=t, new=new,
                                        **ref_kw)], 3, graph=False)
    nb = live + 2 * new.k.numel() * 2 + new.pos.numel() * 4 + \
        2 * q.numel() * 2
    bd, by = bound_ms(nb, 4 * int(lens.sum()) * hq * t * d)
    block = da.int8_dots_block(args[1].shape[1], args[1].shape[2])
    log(f"  {name}: max_abs_err={err:.3e} worst_row_ratio={worst:.3e}, "
        f"bytes and scales exact; int8 dots {ms[True][0]:.4f} / "
        f"{ms[True][1]:.4f} ms, bf16 dots {ms[False][0]:.4f} / "
        f"{ms[False][1]:.4f} ms over {copies} cache copies (block "
        f"{block}), plain {t_p:.4f} ms, bound {bd:.6f} ms ({by})")
    frm, note = i8_launch_from(heads, layout, store, t)
    row = {"name": name, "route": "cuda",
           "source": "deeppowers_tpu_torch/csrc/decode_attention.cuh",
           "replaces": "deeppowers_tpu/ops/pallas/decode_attention.py:196",
           "pallas_call": "deeppowers_tpu/ops/pallas/decode_attention.py:470",
           "max_abs_err": err, "ms": sum(ms[True]) / 2, "ms_runs": ms[True],
           "bf16_dots_ms": sum(ms[False]) / 2, "bf16_dots_ms_runs": ms[False],
           "plain_ms": t_p, "bound_ms": bd, "bound_by": by,
           "library_ms": None,
           "library_note": "no one PyTorch call requantizes q and p to int8 "
                           "and attends",
           "worst_row_ratio": worst, "cache_copies": copies, "tokens": t,
           "block_s": block, "launch_from": frm}
    if note:
        row["note"] = note
    return row


def check_scan_kt_kernels(torch, cfg):
    """#8 in four stores (8 rows, and a window's 8 x 5 rows, into layer 11
    of TinyLlama's (22, 8, 1024, F') stacked caches; one position past the
    cache, one negative), exact against its plain version, the bf16 rows
    beside one `index_put_` a side on the layer view; #7 int8 and k8v4 at
    tokens 1 and 5, at Llama-2-7B's heads (32 x 128) and TinyLlama's
    (4 x 64), 8 slots at KT_LENS (`kt_inputs`: committed chunks mirrored,
    stale bytes in the rest, NaN scales past the lengths), each row within
    1e-2 of the plain version's max|ref|, finite, and the kt bytes after
    the launch equal to the plain version's with stale chunks healed;
    timed over cache copies past the L2 beside #3 on the same caches
    (`kt_pair_ms`); #11 bf16 and int8
    at TinyLlama's heads over ATTN_LENS, bf16 beside sdpa. Every row
    carries `launch_from` (phase, counter): a phase whose counts start at 0
    and whose model and path could launch the row's variant (a note says
    so where its count is 0)."""
    from deeppowers_tpu_torch.ops.kernels import (decode_attention as da,
                                                  kv_append as ka)
    from deeppowers_tpu_torch.quant.kvquant import STORE_BITS
    from deeppowers_tpu_torch.runtime import kvcache_stacked as st

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    rows = []

    def row(name, src, line, ms, plain, bd, by, err, lib, frm, **kw):
        out = {"name": name, "route": "cuda",
               "source": f"deeppowers_tpu_torch/csrc/{src}",
               "replaces": f"deeppowers_tpu/ops/pallas/{line}",
               "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": bd, "bound_by": by, "library_ms": lib,
               "launch_from": frm}
        out.update(kw)
        return out

    # -- #8 -----------------------------------------------------------------
    n_layers, b, s_cache = cfg.num_layers, 8, 1024
    kh, d = cfg.kv_heads, cfg.dim_head
    f = kh * d
    layer = 11
    for store in STORES:
        kb, vb = STORE_BITS[store]
        cache = st.init_cache(n_layers, b, s_cache, kh, d,
                              kv_cache_dtype=store, device=dev)
        ref = st.init_cache(n_layers, b, s_cache, kh, d,
                            kv_cache_dtype=store, device=dev)
        lid = cache.layer_ids[layer:layer + 1]
        for t in (1, SPEC_T):
            kr, vr = (torch.randn(b * t, f, generator=g, device=dev).to(
                torch.bfloat16) for _ in range(2))
            pos = (torch.tensor(ATTN_LENS, device=dev)[:, None] - t
                   + torch.arange(t, device=dev)[None, :]).reshape(-1).to(
                torch.int32)
            pos[3], pos[-1] = s_cache + 1, -1
            slots = torch.arange(b, device=dev,
                                 dtype=torch.int32).repeat_interleave(t)
            ka.scatter_rows_stacked(cache.k, cache.v, kr, vr, lid, pos,
                                    slots=slots, **st.stack_args(cache))
            ka.scatter_rows_stacked_plain(ref.k, ref.v, kr, vr, lid, pos,
                                          slots=slots, **st.stack_args(ref))
            torch.cuda.synchronize()
            for name in ("k", "v", "k_scale", "v_scale"):
                a, r = getattr(cache, name), getattr(ref, name)
                if r is not None and not torch.equal(a, r):
                    fail(f"scatter_rows_stacked[{store}, T={t}]: {name} "
                         f"differs from the plain version")
            t_k = cuda_ms(torch, [lambda: ka.scatter_rows_stacked(
                cache.k, cache.v, kr, vr, lid, pos, slots=slots,
                **st.stack_args(cache))], 200)
            t_p = cuda_ms(torch, [lambda: ka.scatter_rows_stacked_plain(
                ref.k, ref.v, kr, vr, lid, pos, slots=slots,
                **st.stack_args(ref))], 20, graph=False)
            n_ok = b * t - 2
            per = {16: 2 * f, 8: f, 4: f // 2}
            sc = 0 if store == "bf16" else 4 * kh * (
                (2 if kb == 4 else 1) + (2 if vb == 4 else 1))
            bd, by = bound_ms(n_ok * (2 * 2 * f + per[kb] + per[vb] + sc)
                              + b * t * 8 + 4, 0)
            t_l = None
            if store == "bf16":
                keep = (pos >= 0) & (pos < s_cache)
                idx = (slots[keep].long(), pos[keep].long())
                kl, vl = ref.k[layer], ref.v[layer]
                krk, vrk = kr[keep], vr[keep]
                t_l = cuda_ms(torch, [lambda: (kl.index_put_(idx, krk),
                                               vl.index_put_(idx, vrk))], 200)
            # TinyLlama's stacked phases: scan_serve (bf16 rows), its
            # prompt-lookup request (5 rows a slot a verify step) and
            # scan_path[k8v4]
            frm = ("scan_serve[spec]" if t > 1 else
                   "scan_path[k8v4]" if store == KT_PATH_KV else
                   "scan_serve", f"scatter_rows_stacked[{store}]")
            log(f"  scatter_rows_stacked[{store}] {b} x {t} rows, layer "
                f"{layer} of ({n_layers}, {b}, {s_cache}, ·): exact, kernel "
                f"{t_k:.4f} ms, plain {t_p:.4f} ms"
                + (f", index_put_ {t_l:.4f} ms" if t_l else "")
                + f", bound {bd:.6f} ms")
            rows.append(row(
                f"scatter_rows_stacked[{store}" + ("" if t == 1 else
                                                   f", {b * t} rows") + "]",
                "kv_append.cu", "kv_append.py:315", t_k, t_p, bd, by, 0.0,
                t_l, frm, rows_per_slot=t,
                **({} if store == "bf16" or (store, t) == (KT_PATH_KV, 1)
                   else {"note": "no phase of this run runs the stacked "
                                 "cache of TinyLlama in this store"
                                 + (" with a verify window" if t > 1
                                    else "")})))
        del cache, ref

    # -- #7 -----------------------------------------------------------------
    for (heads, hq, kh7, d7), v_bits, t in kt_cases(cfg):
        store = "k8v4" if v_bits == 4 else "int8"
        copies = kt_copies(kh7, d7, v_bits, t)
        q, lens, sets = kt_inputs(torch, hq, kh7, d7, v_bits, t, copies,
                                  SEED + 50)
        kt, k, v, ks, vs = sets[0]
        kt_ref = kt.clone()
        before = kt.clone()
        out, _ = da.decode_attention_kt(q, kt, k, v, lens, ks, vs, tokens=t,
                                        v_bits=v_bits)
        ref, _ = da.decode_attention_kt_plain(q, kt_ref, k, v, lens, ks, vs,
                                              tokens=t, v_bits=v_bits)
        torch.cuda.synchronize()
        err, worst = row_errors(out, ref)
        healed = int((kt_ref != before).flatten(2).any(-1).sum())
        if not (torch.isfinite(out).all() and worst <= 1e-2
                and torch.equal(kt, kt_ref) and healed):
            fail(f"decode_attention_kt[{store}, {heads}, T={t}]: worst row "
                 f"ratio {worst:.3g} (limit 1e-2), or kt bytes differ from "
                 f"the plain version's, or no stale chunk healed")
        del before, kt_ref
        t_k, t_3 = kt_pair_ms(torch, da, q, lens, sets, t, v_bits)
        t_p = cuda_ms(torch, [lambda: da.decode_attention_kt_plain(
            q, kt, k, v, lens, ks, vs, tokens=t, v_bits=v_bits)], 3,
            graph=False)
        bd, by = verify_bound(torch, lens, t, hq, d7,
                              kt_live_bytes(kh7, d7, v_bits, t),
                              q.numel() * 2)
        key = f"decode_attention_kt[{store}" + ("]" if t == 1 else
                                                f":t{t}]")
        # the 7B's kt phases; at TinyLlama's heads the unrolled
        # contiguous phases of the store (the mirror off there)
        if heads == "llama2-7b":
            frm = ("serve[llama2-7b,kt]" if t == 1
                   else "kt_path[llama2-7b]"), key
        elif t > 1:
            frm = f"spec_path[{store},contiguous]", key
        else:
            frm = ("serve[int8]" if store == "int8"
                   else f"path[{store},contiguous]"), key
        on = heads == "llama2-7b" and store == KT_PATH_KV
        log(f"  decode_attention_kt[{store}] {heads} heads {hq}/{kh7} x "
            f"{d7}, T={t}, 8 slots {KT_LENS}: max_abs_err={err:.3e} "
            f"worst_row_ratio={worst:.3e}, kt bytes equal ({healed} stale "
            f"chunks healed), kernel {t_k[0]:.6f} ms (#3 on the same "
            f"inputs {t_3[0]:.6f} ms) over {copies} cache copies, plain "
            f"{t_p:.4f} ms, bound {bd:.6f} ms ({by})")
        rows.append(row(
            f"decode_attention_kt[{store}" + ("" if t == 1 else f":t{t}")
            + "]", "decode_attention_kt.cu", "decode_attention.py:1132",
            t_k[0], t_p, bd, by, err, None, frm, tokens=t, shape=heads,
            worst_row_ratio=worst, cache_copies=copies,
            decode_attention_ms=t_3[0],
            **({} if on else {"note": "no phase of this run runs the "
                              "mirror in this store and shape"})))
        del q, lens, sets, kt, k, v, ks, vs, out, ref
        torch.cuda.empty_cache()
    # -- #11 ----------------------------------------------------------------
    lens11 = torch.tensor(ATTN_LENS, device=dev, dtype=torch.int32)
    hq = cfg.num_heads
    for quantized in (False, True):
        q = torch.randn(b, hq, d, generator=g, device=dev).to(torch.bfloat16)
        if quantized:
            kc, vc = (torch.randint(-127, 128, (b, s_cache, kh, d),
                                    generator=g, device=dev,
                                    dtype=torch.int8) for _ in range(2))
            sc = tuple(torch.rand(b, kh, s_cache, generator=g, device=dev)
                       * 0.02 for _ in range(2))
        else:
            kc, vc = (torch.randn(b, s_cache, kh, d, generator=g,
                                  device=dev).to(torch.bfloat16)
                      for _ in range(2))
            sc = (None, None)
        out = da.decode_attention_kernel(q, kc, vc, lens11, *sc)
        ref = da.decode_attention_kernel_plain(q, kc, vc, lens11, *sc)
        torch.cuda.synchronize()
        err, worst = row_errors(out, ref)
        if not (torch.isfinite(out).all() and worst <= 1e-2):
            fail(f"decode_attention_kernel[quantized={quantized}]: worst "
                 f"row ratio {worst:.3g} (limit 1e-2)")
        t_k = cuda_ms(torch, [lambda: da.decode_attention_kernel(
            q, kc, vc, lens11, *sc)], 200)
        t_p = cuda_ms(torch, [lambda: da.decode_attention_kernel_plain(
            q, kc, vc, lens11, *sc)], 20, graph=False)
        live = int(lens11.sum())
        per = 1 if quantized else 2
        bd, by = bound_ms(2 * live * f * per + (8 * live * kh if quantized
                                                else 0)
                          + 2 * q.numel() * 2, 4 * live * hq * d)
        t_l = None
        if not quantized:
            rep = hq // kh
            k4 = kc.transpose(1, 2).repeat_interleave(rep, 1)
            v4 = vc.transpose(1, 2).repeat_interleave(rep, 1)
            mask = (torch.arange(s_cache, device=dev)[None, :]
                    < lens11[:, None].long())[:, None, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            t_l = cuda_ms(torch, [lambda: sdpa(q[:, :, None], k4, v4,
                                               attn_mask=mask)], 200)
        name = "int8" if quantized else "bf16"
        log(f"  decode_attention_kernel[{name}] B={b} H={hq} Kh={kh} D={d}: "
            f"max_abs_err={err:.3e} worst_row_ratio={worst:.3e}, kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms"
            + (f", sdpa {t_l:.4f} ms" if t_l else "")
            + f", bound {bd:.6f} ms")
        rows.append(row(f"decode_attention_kernel[{name}]",
                        "decode_attention.cu", "decode_attention.py:1219",
                        t_k, t_p, bd, by, err, t_l,
                        ("serve[int8]" if quantized else "serve",
                         f"decode_attention_kernel[{name}]"),
                        note="nothing in the package calls this kernel; its "
                             "entry point launches #3's CUDA kernel on the "
                             "flat view under its own count"))
    return rows


# ---------------------------------------------------------------------------
# phase 4: teacher-forced path check
# ---------------------------------------------------------------------------

PAGED_TABLE = (9, 4, 0, 0, 0, 0, 0, 0)     # slot 0's pages in a 12-page pool


def prompt_cache(torch, T, kvcache, params, cfg, ids, device, paged=False,
                 kv_cache_dtype="bf16", extra=0, kv_kt=False):
    """Prefill `ids` (one slot) and write its K/V into a fresh cache: the
    contiguous cache has 128 rows, or as many more as the prompt and
    `extra` tokens need (with the kt mirror when `kv_kt`); with `paged`,
    pages 9 and 4 of a 12-page pool whose other rows hold NaN (a quantized
    pool: random bytes, and NaN in its scale pools). Returns (the prompt's
    last logits, caches, lengths)."""
    import numpy as np
    from deeppowers_tpu_torch.runtime import kvcache_paged
    n = len(ids)
    x = torch.tensor([ids], device=device)
    lens = torch.tensor([n], device=device, dtype=torch.int32)
    last, kv = T.forward_prefill(params, cfg, x, lens, dtype=torch.bfloat16,
                                 logits_at=lens - 1)
    if paged:
        caches = kvcache_paged.init_paged_cache(
            cfg.num_layers, 1, 1024, cfg.kv_heads, cfg.dim_head,
            page_size=128, total_pages=12, device=device,
            kv_cache_dtype=kv_cache_dtype)
        for c in caches:
            if c.quantized:
                for pool in (c.k_pool, c.v_pool):
                    pool.copy_(torch.randint(-128, 128, pool.shape,
                                             dtype=torch.int8))
                c.k_scale.fill_(float("nan"))
                c.v_scale.fill_(float("nan"))
            else:
                c.k_pool.fill_(float("nan"))
                c.v_pool.fill_(float("nan"))
        kvcache_paged.with_table(caches, np.array([PAGED_TABLE],
                                                  dtype=np.int32))
        for c, (k, v) in zip(caches, kv):
            kvcache.write_prompt(c, k[0], v[0], 0)
    else:
        rows = max(128, -(-(n + extra) // 128) * 128)
        caches = kvcache.init_cache(cfg.num_layers, 1, rows, cfg.kv_heads,
                                    cfg.dim_head, device=device,
                                    kv_cache_dtype=kv_cache_dtype,
                                    kv_kt=kv_kt)
        for c, (k, v) in zip(caches, kv):
            kvcache.write_prompts(c, k, v, torch.tensor([0], device=device))
    return last, caches, lens


def forced_logits(torch, T, kvcache, params, cfg, ids, forced, device,
                  paged=False, kv_cache_dtype="bf16"):
    """Prefill `ids` then decode the forced tokens; every step's logits.
    The cache is `prompt_cache`'s: contiguous, or paged through the paged
    kernels; `kv_cache_dtype` picks the store of either layout."""
    out = []
    with torch.no_grad():
        last, caches, lens = prompt_cache(torch, T, kvcache, params, cfg, ids,
                                          device, paged, kv_cache_dtype,
                                          len(forced))
        out.append(last[0].float().cpu())
        for t in forced:
            lg, caches = T.forward_decode(
                params, cfg, torch.tensor([t], device=device), caches, lens,
                dtype=torch.bfloat16)
            out.append(lg[0].float().cpu())
            lens = lens + 1
    return out


def verify_logits(torch, T, params, cfg, ids, window, device, paged=False,
                  kv_cache_dtype="bf16", sequential=True):
    """Prefill `ids`, then verify the forced `window` (T tokens: the last
    sampled token and T - 1 drafts) in one forward_verify; and, on a fresh
    cache, the same tokens through T sequential forward_decode steps.
    Returns (verify logits (T, V), sequential logits (T, V) or None without
    `sequential`), f32 on the CPU. Caches as `prompt_cache` makes them."""
    from deeppowers_tpu_torch.runtime import kvcache
    win = torch.tensor([window], device=device)
    with torch.no_grad():
        _, caches, lens = prompt_cache(torch, T, kvcache, params, cfg, ids,
                                       device, paged, kv_cache_dtype,
                                       len(window))
        ver, _ = T.forward_verify(params, cfg, win, caches, lens,
                                  dtype=torch.bfloat16)
        if not sequential:
            return ver[0].float().cpu(), None
        _, caches, lens = prompt_cache(torch, T, kvcache, params, cfg, ids,
                                       device, paged, kv_cache_dtype,
                                       len(window))
        seq = []
        for t in window:
            lg, caches = T.forward_decode(
                params, cfg, torch.tensor([t], device=device), caches, lens,
                dtype=torch.bfloat16)
            seq.append(lg[0])
            lens = lens + 1
    return ver[0].float().cpu(), torch.stack(seq).float().cpu()


def lm124_path(torch, T, kvcache, counters, device="cuda"):
    """The LM124 preset (lm124_ckpt's config: 12 layers, hidden 768, GQA
    12/6, an untied 260-wide lm_head) with random int8 weights from the
    seed: eight greedy tokens through `InferenceEngine.generate` with every
    launch count set to 0 just before and read just after (the head must
    take #1's n4 instantiation), then the teacher-forced logits against the
    plain path on the CPU, rel L2 <= 5e-2. Returns (launches, phase
    info)."""
    from deeppowers_tpu_torch.config import (GenerationConfig, QuantConfig,
                                             RuntimeConfig)
    from deeppowers_tpu_torch.models.presets import LM124 as lcfg
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    params = T.fuse_params(T.quantize_params(T.init_params(
        lcfg, gen, dtype=torch.bfloat16, device=device), QuantConfig()), lcfg)
    rng = torch.Generator().manual_seed(SEED + 8)
    ids = torch.randint(0, lcfg.vocab_size, (40,), generator=rng).tolist()
    forced = torch.randint(0, lcfg.vocab_size, (3,), generator=rng).tolist()
    engine = InferenceEngine(params, lcfg, device=device, runtime=RuntimeConfig(
        max_batch_size=1, max_seq_len=512, prefill_buckets=(64, 128, 256, 512)))
    reset_counts(counters)
    res = engine.generate(ids, GenerationConfig(max_tokens=8, temperature=0.0))
    engine.synchronize()
    launches = read_counts(counters)
    if len(res.token_ids) != 8 or launches.get("dequant_matmul[n4]", 0) < 1:
        fail(f"path[lm124]: {len(res.token_ids)} tokens, launches {launches}")
    check_variants("path[lm124]", launches,
                   [fold_key("decode_attention", "bf16")], ["step_writers"])
    got = forced_logits(torch, T, kvcache, params, lcfg, ids, forced, device)
    ref = forced_logits(torch, T, kvcache, tree_to(params, "cpu"), lcfg, ids,
                        forced, "cpu")
    rel = max(((g - r).norm() / r.norm()).item() for g, r in zip(got, ref))
    if not all(torch.isfinite(g).all() for g in got) or not rel <= 5e-2:
        fail(f"path[lm124]: kernel vs plain logits rel L2 error {rel} > 5e-2")
    return launches, {"head_n": lcfg.vocab_size,
                      "launches_n4": launches["dequant_matmul[n4]"],
                      "tokens": len(res.token_ids),
                      "logits_rel_l2": f"{rel:.3e}"}


# BASELINE config 3 (bench.py:311-331): Llama-2-7B, W4A8 g128 weights,
# k8v4 KV; the path phase cuts the depth to LLAMA2_PATH_LAYERS
LLAMA2_PATH_LAYERS = 4
LLAMA2_KV = "k8v4"
LLAMA2_ON_PATH = ["dequant_matmul[w4a8g]", "quantize_activations"]
LLAMA2_OFF_PATH = [f"dequant_matmul[w{b}{a}{g}]" for b in (8, 4)
                   for a in ("", "a8") for g in ("", "g")
                   if (b, a, g) != (4, "a8", "g")]


def llama2_params(torch, T, cfg, gen, device, dtype=None):
    """Random W4A8 g128 weights drawn directly in quantized form
    (init_quantized_params, as bench.py's direct_quant), fused."""
    from deeppowers_tpu_torch.config import QuantConfig, QuantMode
    qcfg = QuantConfig(mode=QuantMode.INT4, group_size=128, act_bits=8)
    return T.fuse_params(T.init_quantized_params(
        cfg, qcfg, gen, dtype=dtype or torch.bfloat16, device=device), cfg)


def random_scales(torch, tree, gen):
    """Each quantized weight's scales times random factors in [0.5, 1.5)
    (init_quantized_params gives every scale one value, under which a wrong
    scale row or nibble plane would not show in the logits)."""
    from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor
    if isinstance(tree, dict):
        return {k: random_scales(torch, v, gen) for k, v in tree.items()}
    if isinstance(tree, list):
        return [random_scales(torch, v, gen) for v in tree]
    if isinstance(tree, QuantizedTensor):
        tree.scales = tree.scales * (0.5 + torch.rand(
            tree.scales.shape, generator=gen, device=tree.scales.device))
    return tree


def teacher_forced(torch, T, kvcache, params, cfg, ids, forced, device,
                   kv_cache_dtype, scan):
    """forced_logits, or with `scan` scan_forced_logits over
    stack_layer_params(params) (the stacked weights and cache that
    scan_layers "auto" gives a model of >= 16 layers)."""
    if scan:
        return scan_forced_logits(torch, T, T.stack_layer_params(params),
                                  cfg, ids, forced, device, kv_cache_dtype)
    return forced_logits(torch, T, kvcache, params, cfg, ids, forced, device,
                         kv_cache_dtype=kv_cache_dtype)


def scan_variants(kv, scan):
    """The row writer and attention that a path on `kv` must launch (#8 and
    #3 on the stacked cache, #2 and #3 on the unrolled one: the prompt's
    rows through the writer, the decode rows through #3's fold), and what
    it must not: the other writer, and any writer inside a decode or
    verify forward."""
    own = "scatter_rows_stacked" if scan else "scatter_rows"
    other = "scatter_rows" if scan else "scatter_rows_stacked"
    return ([f"{own}[{kv}]", f"decode_attention[{kv}]",
             fold_key("decode_attention", kv)], [other, "step_writers"])


def llama2_path(torch, T, kvcache, counters, scan=False):
    """Llama-2-7B at full width, LLAMA2_PATH_LAYERS layers, W4A8 g128 + k8v4
    KV, random scales: the teacher-forced logits through the kernels (launch
    counts from 0) against the plain path on the CPU, rel L2 <= 1e-2 (the
    a8 products are exact integers on both, so the two differ only by bf16
    rounding order and a quantized byte moved by one step). With `scan`
    (scan_path[llama2-7b]) the same weights stacked, through the scan
    forwards and the stacked cache on both sides: the default path of a
    32-layer 7B engine. Returns (launches, phase info)."""
    import dataclasses
    from deeppowers_tpu_torch.models.presets import LLAMA2_7B
    name = "scan_path[llama2-7b]" if scan else "path[llama2-7b]"
    cfg = dataclasses.replace(LLAMA2_7B, num_layers=LLAMA2_PATH_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    params = random_scales(torch, llama2_params(torch, T, cfg, gen, "cuda"),
                           gen)
    rng = torch.Generator().manual_seed(SEED + 11)
    ids = torch.randint(0, cfg.vocab_size, (40,), generator=rng).tolist()
    forced = torch.randint(0, cfg.vocab_size, (3,), generator=rng).tolist()
    reset_counts(counters)
    got = teacher_forced(torch, T, kvcache, params, cfg, ids, forced, "cuda",
                         LLAMA2_KV, scan)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    on, off = scan_variants(LLAMA2_KV, scan)
    check_variants(name, launches, LLAMA2_ON_PATH + on, LLAMA2_OFF_PATH + off)
    ref = teacher_forced(torch, T, kvcache, tree_to(params, "cpu"), cfg, ids,
                         forced, "cpu", LLAMA2_KV, scan)
    rel = max(((g - r).norm() / r.norm()).item() for g, r in zip(got, ref))
    if not all(torch.isfinite(g).all() for g in got) or not rel <= 1e-2:
        fail(f"{name}: kernel vs plain logits rel L2 error {rel} > 1e-2")
    return launches, {"layers": cfg.num_layers, "hidden": cfg.hidden_size,
                      "weights": "w4a8 g128", "kv": LLAMA2_KV,
                      "logits_rel_l2": f"{rel:.3e}",
                      "launches_rows": launches[on[0]],
                      "launches_w4a8g": launches["dequant_matmul[w4a8g]"],
                      "launches_quantizer": launches["quantize_activations"]}


def scan_forced_logits(torch, T, params, cfg, ids, forced, device,
                       kv_cache_dtype="bf16"):
    """forced_logits through the scan forwards: `params` stacked, the
    prompt written into a one-slot stacked cache by
    forward_prefill_scan_batch, the forced tokens through
    forward_decode_scan. Every step's logits, f32 on the CPU."""
    from deeppowers_tpu_torch.runtime import kvcache_stacked as st
    n = len(ids)
    rows = max(128, -(-(n + len(forced)) // 128) * 128)
    cache = st.init_cache(cfg.num_layers, 1, rows, cfg.kv_heads,
                          cfg.dim_head, device=device,
                          kv_cache_dtype=kv_cache_dtype)
    lens = torch.tensor([n], device=device, dtype=torch.int32)
    with torch.no_grad():
        cache, last = T.forward_prefill_scan_batch(
            params, cfg, torch.tensor([ids], device=device), lens,
            torch.tensor([0], device=device), cache, dtype=torch.bfloat16)
        out = [last[0].float().cpu()]
        for t in forced:
            lg, cache = T.forward_decode_scan(
                params, cfg, torch.tensor([t], device=device), cache, lens,
                dtype=torch.bfloat16)
            out.append(lg[0].float().cpu())
            lens = lens + 1
    return out


def layer_copies(torch, T, params, cfg, kv_cache_dtype):
    """Copies of a layer's worth of cache in one scan decode step of 8
    slots over a (22, 8, 1024, F') stacked cache, under torch.profiler:
    aten::copy_ and aten::clone ops whose input holds as many elements as
    one layer's K store. The attention reads each layer's views in place,
    so there must be none."""
    from torch.profiler import ProfilerActivity, profile
    from deeppowers_tpu_torch.runtime import kvcache_stacked as st
    cache = st.init_cache(cfg.num_layers, 8, 1024, cfg.kv_heads,
                          cfg.dim_head, device="cuda",
                          kv_cache_dtype=kv_cache_dtype)
    lens = torch.tensor(ATTN_LENS, device="cuda", dtype=torch.int32)
    toks = torch.arange(8, device="cuda", dtype=torch.int32) + 5
    with torch.no_grad():
        T.forward_decode_scan(params, cfg, toks, cache, lens)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            T.forward_decode_scan(params, cfg, toks, cache, lens)
            torch.cuda.synchronize()
    layer = 8 * 1024 * cfg.kv_size
    big = []
    for ev in prof.events():
        if ev.name in ("aten::copy_", "aten::clone"):
            for shape in ev.input_shapes or ():
                n = 1
                for x in shape or ():
                    n *= x
                if shape and n >= layer:
                    big.append((ev.name, shape))
    return big


def same_bytes_decode(torch, T, kvcache, params, stacked, cfg, ids, forced,
                      store):
    """Max |difference| of the decode logits over the unrolled cache and
    over a stacked cache holding the same bytes (the unrolled prefill's
    cache copied into each layer of the stack), the forced tokens through
    forward_decode and forward_decode_scan on the card: the same kernels
    on the same bytes."""
    from deeppowers_tpu_torch.runtime import kvcache_stacked as st
    with torch.no_grad():
        _, caches, lens = prompt_cache(torch, T, kvcache, params, cfg, ids,
                                       "cuda", kv_cache_dtype=store,
                                       extra=len(forced))
        stack = st.init_cache(cfg.num_layers, 1, caches[0].k.shape[1],
                              cfg.kv_heads, cfg.dim_head, device="cuda",
                              kv_cache_dtype=store)
        for i, c in enumerate(caches):
            for name in ("k", "v", "k_scale", "v_scale"):
                if getattr(c, name) is not None:
                    getattr(stack, name)[i].copy_(getattr(c, name))
        diff, lens_s = 0.0, lens.clone()
        for t in forced:
            tok = torch.tensor([t], device="cuda")
            a, caches = T.forward_decode(params, cfg, tok, caches, lens)
            b, stack = T.forward_decode_scan(stacked, cfg, tok, stack, lens_s)
            diff = max(diff, (a - b).abs().max().item())
            lens, lens_s = lens + 1, lens_s + 1
    return diff


def scan_path(torch, T, kvcache, params, cfg, ids, forced, counters,
              unrolled):
    """scan_path[bf16] and scan_path[k8v4]: the main path's TinyLlama
    weights stacked (`stack_layer_params`), teacher-forced through the
    stacked cache (prompt rows and decode rows through #8, attention on
    layer views through #3) against the same scan path on the CPU (rel L2
    <= 5e-2, the path phases' limit) and, printed, against the unrolled
    path on the card (`unrolled[store]`: the same kernels, but the scan
    prefill ends each layer with JAX's fused `_attn_tail`, so the prompt's
    cache bytes differ) and, printed, decode over the same bytes in both
    layouts (`same_bytes_decode`, 0 expected).
    #8 must launch and #2 must not; a profiled scan decode step must copy
    no layer of the cache. Returns {store: launches}."""
    stacked = T.stack_layer_params(params)
    stacked_cpu = T.stack_layer_params(tree_to(params, "cpu"))
    launches = {}
    for store in ("bf16", KT_PATH_KV):
        t0 = time.perf_counter()
        reset_counts(counters)
        got = scan_forced_logits(torch, T, stacked, cfg, ids, forced, "cuda",
                                 store)
        torch.cuda.synchronize()
        launches[store] = read_counts(counters)
        check_variants(f"scan_path[{store}]", launches[store],
                       [f"scatter_rows_stacked[{store}]",
                        f"decode_attention[{store}]",
                        fold_key("decode_attention", store)] + ROUTES_ON,
                       ["scatter_rows", "step_writers"])
        ref = scan_forced_logits(torch, T, stacked_cpu, cfg, ids, forced,
                                 "cpu", store)
        rel = max(((g - r).norm() / r.norm()).item()
                  for g, r in zip(got, ref))
        rel_u = max(((g - u).norm() / u.norm()).item()
                    for g, u in zip(got, unrolled[store]))
        rel_ud = max(((g - u).norm() / u.norm()).item()
                     for g, u in zip(got[1:], unrolled[store][1:]))
        if not all(torch.isfinite(g).all() for g in got) or not rel <= 5e-2:
            fail(f"scan_path[{store}]: kernel vs plain logits rel L2 error "
                 f"{rel} > 5e-2")
        same = same_bytes_decode(torch, T, kvcache, params, stacked, cfg,
                                 ids, forced, store)
        copies = layer_copies(torch, T, stacked, cfg, store)
        if copies:
            fail(f"scan_path[{store}]: a scan decode step copies a layer's "
                 f"cache: {copies[:4]}")
        phase_line(f"scan_path[{store}]", t0, logits_rel_l2=f"{rel:.3e}",
                   vs_unrolled_on_card=f"{rel_u:.3e}",
                   vs_unrolled_decode_steps=f"{rel_ud:.3e}",
                   decode_same_bytes_max_abs_diff=same,
                   layer_copies=len(copies),
                   launches_stacked=launches[store][
                       f"scatter_rows_stacked[{store}]"])
    return launches


KT_PATH_PROMPT = 252    # crosses chunk 0; the 4th decode step completes 1
KT_PATH_FORCED = 5


def kt_logits(torch, T, kvcache, params, cfg, ids, forced, window, device,
              kv_kt):
    """Prefill `ids` into a k8v4 cache (with the kt mirror when `kv_kt`),
    decode the forced tokens, then verify `window` in one forward_verify.
    Returns (every step's logits, f32 on the CPU, the verify window's
    rows last; the caches)."""
    with torch.no_grad():
        last, caches, lens = prompt_cache(
            torch, T, kvcache, params, cfg, ids, device,
            kv_cache_dtype=KT_PATH_KV, extra=len(forced) + len(window),
            kv_kt=kv_kt)
        out = [last[0].float().cpu()]
        for t in forced:
            lg, caches = T.forward_decode(
                params, cfg, torch.tensor([t], device=device), caches, lens,
                dtype=torch.bfloat16)
            out.append(lg[0].float().cpu())
            lens = lens + 1
        ver, _ = T.forward_verify(params, cfg,
                                  torch.tensor([window], device=device),
                                  caches, lens, dtype=torch.bfloat16)
        out.extend(ver[0].float().cpu())
    return out, caches


def kt_path(torch, T, kvcache, counters):
    """kt_path[llama2-7b]: Llama-2-7B at full width, LLAMA2_PATH_LAYERS
    layers, W4A8 g128 + k8v4 with the kt mirror (as DPT_KV_KT=1 gives it),
    unrolled: a KT_PATH_PROMPT-token prompt (its chunks transposed into the
    mirror), KT_PATH_FORCED decode steps (one completes chunk 1, which #7
    flushes) and a verify window of SPEC_T tokens that reads chunks 0 and
    1 from the mirror. Teacher-forced against the plain path on the CPU
    (rel L2 <= 1e-2, as path[llama2-7b]) and, printed, against the same
    run on the card without the mirror (#3). #7 must launch at tokens 1
    and 5, #3 must not; every mirror chunk below the length must equal its
    k rows. Returns (launches, phase info)."""
    import dataclasses
    from deeppowers_tpu_torch.models.presets import LLAMA2_7B
    cfg = dataclasses.replace(LLAMA2_7B, num_layers=LLAMA2_PATH_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    params = random_scales(torch, llama2_params(torch, T, cfg, gen, "cuda"),
                           gen)
    rng = torch.Generator().manual_seed(SEED + 32)
    ids = torch.randint(0, cfg.vocab_size, (KT_PATH_PROMPT,),
                        generator=rng).tolist()
    forced = torch.randint(0, cfg.vocab_size, (KT_PATH_FORCED,),
                           generator=rng).tolist()
    window = torch.randint(0, cfg.vocab_size, (SPEC_T,),
                           generator=rng).tolist()
    reset_counts(counters)
    got, caches = kt_logits(torch, T, kvcache, params, cfg, ids, forced,
                            window, "cuda", kv_kt=True)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    check_variants("kt_path[llama2-7b]", launches,
                   [f"decode_attention_kt[{KT_PATH_KV}]",
                    f"decode_attention_kt[{KT_PATH_KV}:t{SPEC_T}]",
                    f"scatter_rows[{KT_PATH_KV}]"] + LLAMA2_ON_PATH,
                   ["decode_attention"])
    n = KT_PATH_PROMPT + KT_PATH_FORCED + SPEC_T
    for c in caches:
        for ch in range(n // 128):
            if not torch.equal(c.kt[0, ch], c.k[0, ch * 128:(ch + 1) * 128].t()):
                fail(f"kt_path[llama2-7b]: mirror chunk {ch} differs from "
                     f"its k rows")
    ref, _ = kt_logits(torch, T, kvcache, tree_to(params, "cpu"), cfg, ids,
                       forced, window, "cpu", kv_kt=True)
    plain, _ = kt_logits(torch, T, kvcache, params, cfg, ids, forced, window,
                         "cuda", kv_kt=False)
    rel = max(((g - r).norm() / r.norm()).item() for g, r in zip(got, ref))
    rel_m = max(((g - r).norm() / r.norm()).item()
                for g, r in zip(got, plain))
    if not all(torch.isfinite(g).all() for g in got) or not rel <= 1e-2:
        fail(f"kt_path[llama2-7b]: kernel vs plain logits rel L2 error {rel}"
             f" > 1e-2")
    return launches, {
        "layers": cfg.num_layers, "kv": KT_PATH_KV + "+kt",
        "steps": f"prefill({KT_PATH_PROMPT})+decode({KT_PATH_FORCED})"
                 f"+verify({SPEC_T})",
        "logits_rel_l2": f"{rel:.3e}",
        "vs_no_mirror_on_card": f"{rel_m:.3e}",
        "launches_kt": launches[f"decode_attention_kt[{KT_PATH_KV}]"],
        "launches_kt_t5":
            launches[f"decode_attention_kt[{KT_PATH_KV}:t{SPEC_T}]"]}


TTFT_PROMPT = 512
TTFT_REPS = 5


def serve_llama2(torch, T, counters):
    """Llama-2-7B, all 32 layers, W4A8 g128 + k8v4 contiguous KV: serve's
    traffic (8 requests of 16..900 bytes, 32 tokens each) once through the
    scheduler and the HTTP server, where the W4A8 g128 variant of #1 and
    the quantizer must launch and no other weight variant; then a profiled
    decode step of 8 slots; then a 512-token prompt alone on the warm
    engine, TTFT_REPS times (TTFT as bench.py:324-330 measures it: the
    prefill and the first token)."""
    from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
    from deeppowers_tpu_torch.models.presets import LLAMA2_7B as cfg
    from deeppowers_tpu_torch.quant.kvquant import KV_CACHE_DTYPES
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

    t0 = time.perf_counter()
    params = llama2_params(torch, T, cfg, torch.Generator(
        device="cuda").manual_seed(SEED + 12), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok = ByteTokenizer()
    engine = InferenceEngine(
        params, cfg, device="cuda", eos_token_id=tok.eos_token_id,
        kv_cache_dtype=LLAMA2_KV,
        runtime=RuntimeConfig(max_batch_size=8, max_seq_len=1024,
                              prefill_buckets=(64, 128, 256, 512, 1024),
                              scan_layers=False))
    engine.generate(tok.encode("warm up"), GenerationConfig(
        max_tokens=2, temperature=0.0))
    prompts = [prompt_text(n, i) for i, n in enumerate(PROMPT_BYTES)]
    results, launches, wall, sched = run_requests(
        torch, engine, prompts, MAX_TOKENS, counters, tok)
    check_variants(
        "serve[llama2-7b]", launches,
        LLAMA2_ON_PATH + ROUTES_ON + ["flash_attention_prefill",
                          "flash_attention_chunk",
                          f"scatter_rows[{LLAMA2_KV}]",
                          f"decode_attention[{LLAMA2_KV}]",
                          fold_key("decode_attention", LLAMA2_KV)]
        + i8_keys(LLAMA2_KV),
        LLAMA2_OFF_PATH + ["scatter_pool_rows", "decode_attention_paged",
                           "grouped_dequant_matmul",
                           "grouped_dequant_matmul_ncat", "step_writers"]
        + [f"{k}[{v}]" for k in ("scatter_rows", "decode_attention")
           for v in KV_CACHE_DTYPES if v != LLAMA2_KV])
    out = summary(results, wall, sched, launches)
    out.update(kv_bytes=engine.kv_nbytes, param_bytes=T.param_nbytes(params),
               init_s=init_s)
    out["profile"] = profile_decode(torch, engine, tok)
    check_step_quantizer("serve[llama2-7b]", out["profile"])
    out["profile_bf16_dots"] = profile_bf16_dots(torch, engine, tok,
                                                 "serve[llama2-7b]")
    gen = GenerationConfig(max_tokens=1, temperature=0.0)
    ttft = []
    for i in range(TTFT_REPS):
        ids = [4 + (j * 7 + i) % 250 for j in range(TTFT_PROMPT)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.add_request(ids, gen)
        torch.cuda.synchronize()
        ttft.append((time.perf_counter() - t1) * 1e3)
    engine.pop_finished()
    out["ttft_512_ms"] = ttft
    del engine
    torch.cuda.empty_cache()
    # the default (scan) path of the 7B: the same weights stacked
    # (scan_layers "auto"), the same prompt alone, TTFT_REPS times
    scan = InferenceEngine(
        params, cfg, device="cuda", eos_token_id=tok.eos_token_id,
        kv_cache_dtype=LLAMA2_KV,
        runtime=RuntimeConfig(max_batch_size=8, max_seq_len=1024,
                              prefill_buckets=(64, 128, 256, 512, 1024)))
    if not scan.scan_layers:
        fail("serve[llama2-7b]: scan_layers='auto' did not stack the 7B")
    scan.generate(tok.encode("warm up"), GenerationConfig(
        max_tokens=2, temperature=0.0))
    ttft = []
    for i in range(TTFT_REPS):
        ids = [4 + (j * 7 + i) % 250 for j in range(TTFT_PROMPT)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scan.add_request(ids, gen)
        torch.cuda.synchronize()
        ttft.append((time.perf_counter() - t1) * 1e3)
    scan.pop_finished()
    out["ttft_512_scan_ms"] = ttft
    # and decode steps of 8 slots on the stacked cache, counted from 0:
    # #3's int8-dot variant over the layer views
    reset_counts(counters)
    out["profile_scan"] = profile_decode(torch, scan, tok, steps=2)
    torch.cuda.synchronize()
    out["launches_scan"] = read_counts(counters)
    check_variants("serve[llama2-7b] scan decode", out["launches_scan"],
                   i8_keys(LLAMA2_KV), ["scatter_rows", "step_writers"])
    del scan
    torch.cuda.empty_cache()
    # the dispatch phase's checks on the 7B's default (scan) engine
    t1 = time.perf_counter()
    out["dispatch"] = dispatch_model(torch, "llama2-7b", params, cfg,
                                     LLAMA2_KV, scan=True)
    out["dispatch_s"] = time.perf_counter() - t1
    out["params"] = params          # spec_serve[llama2-7b+draft] reuses them
    return out


def serve_llama2_kt(torch, T, counters, l7_params):
    """serve[llama2-7b,kt]: serve[llama2-7b]'s weights and traffic once,
    with the kt mirror that DPT_KV_KT=1 turns on (BASELINE config 3 as
    bench.py:61-68 builds it, `kv_kt=kt_auto(...)`): decode reads K through
    #7, which must launch where #3 must not. Then a profiled decode step."""
    from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
    from deeppowers_tpu_torch.models.presets import LLAMA2_7B as cfg
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    before = os.environ.get("DPT_KV_KT")
    os.environ["DPT_KV_KT"] = "1"
    try:
        engine = InferenceEngine(
            l7_params, cfg, device="cuda", eos_token_id=tok.eos_token_id,
            kv_cache_dtype=LLAMA2_KV,
            runtime=RuntimeConfig(max_batch_size=8, max_seq_len=1024,
                                  prefill_buckets=(64, 128, 256, 512, 1024),
                                  scan_layers=False))
    finally:
        if before is None:
            os.environ.pop("DPT_KV_KT")
        else:
            os.environ["DPT_KV_KT"] = before
    if engine.caches[0].kt is None:
        fail("serve[llama2-7b,kt]: DPT_KV_KT=1 gave no kt mirror")
    engine.generate(tok.encode("warm up"), GenerationConfig(
        max_tokens=2, temperature=0.0))
    prompts = [prompt_text(n, i) for i, n in enumerate(PROMPT_BYTES)]
    results, launches, wall, sched = run_requests(
        torch, engine, prompts, MAX_TOKENS, counters, tok)
    check_variants(
        "serve[llama2-7b,kt]", launches,
        LLAMA2_ON_PATH + ROUTES_ON + [f"decode_attention_kt[{LLAMA2_KV}]",
                          f"scatter_rows[{LLAMA2_KV}]",
                          "flash_attention_prefill", "flash_attention_chunk"],
        LLAMA2_OFF_PATH + ["decode_attention", "scatter_pool_rows",
                           "decode_attention_paged"])
    out = summary(results, wall, sched, launches)
    out["kv_bytes"] = engine.kv_nbytes
    out["profile"] = profile_decode(torch, engine, tok)
    return out


# BASELINE config 5 (bench.py:337-359): Mixtral-8x7B, W4A8 g128 weights,
# int8 KV, 8 slots; the path phase cuts the depth to MIXTRAL_PATH_LAYERS
MIXTRAL_PATH_LAYERS = 2
MIXTRAL_KV = "int8"
MIXTRAL_PROMPT = 320          # b·s >= 256: the prefill takes #10 and #9
MIXTRAL_ON_PATH = ["grouped_dequant_matmul_ncat[w4a8g]",
                   "grouped_dequant_matmul[w4a8g]", "dequant_matmul[w4a8g]",
                   "quantize_activations", "quantize_segments",
                   "quantize_segments[plain]", "quantize_segments[glu]"]
MIXTRAL_OFF_PATH = (LLAMA2_OFF_PATH + [
    f"{k}[{v}]" for k in ("grouped_dequant_matmul",
                          "grouped_dequant_matmul_ncat")
    for v in ("w8", "w8g", "w8a8", "w8a8g", "w4", "w4g", "w4a8")])
FLIPPED_ROUTES_MAX = 1e-2


def check_segment_modes(phase, launches) -> None:
    """Each a8 launch of #10 follows one 9q launch in plain mode and each
    of #9 one in GLU mode (the pre-pass computes the layer's SiLU GLU), and
    9q launches nowhere else."""
    plain, glu = (launches.get(f"quantize_segments[{m}]", 0)
                  for m in ("plain", "glu"))
    ncat = launches.get("grouped_dequant_matmul_ncat[w4a8g]", 0)
    grouped = launches.get("grouped_dequant_matmul[w4a8g]", 0)
    if (plain, glu) != (ncat, grouped) or \
            launches.get("quantize_segments", 0) != plain + glu:
        fail(f"{phase}: 9q launched {plain} times in plain mode and {glu} in "
             f"GLU mode ({launches.get('quantize_segments', 0)} in all) for "
             f"{ncat} a8 launches of #10 and {grouped} of #9")


def mixtral_params(torch, T, cfg, gen, device, dtype=None, scales=False):
    """Random W4A8 g128 weights drawn directly in quantized form
    (init_quantized_params, as bench.py's direct_quant; the router stays
    float), with random scales when `scales` (drawn on the stacked
    experts, so that the cat layout and its stacked w_out scales agree),
    fused as the engine fuses them: the experts in the cat layout."""
    from deeppowers_tpu_torch.config import QuantConfig, QuantMode
    qcfg = QuantConfig(mode=QuantMode.INT4, group_size=128, act_bits=8)
    tree = T.init_quantized_params(cfg, qcfg, gen,
                                   dtype=dtype or torch.bfloat16,
                                   device=device)
    if scales:
        tree = random_scales(torch, tree, gen)
    return T.fuse_params(tree, cfg)


class recorded_routes:
    """Within the context every call of the model's routing (`T.route`)
    appends its expert ids (T, k) to the list it yields, left on their
    device (no host sync in the forward); the calls of one forward come
    in layer order."""

    def __init__(self, T):
        self.T, self.routes = T, []

    def __enter__(self):
        route = self.orig = self.T.route

        def recorded(*args):
            idx, w = route(*args)
            self.routes.append(idx)
            return idx, w

        self.T.route = recorded
        return self.routes

    def __exit__(self, *exc):
        self.T.route = self.orig


def flipped_routes(routes, ref_routes):
    """(routes whose top-k expert set differs, all routes) between two
    recordings of the same forwards: a (token, layer) near-tie of the
    router that rounding tipped the other way."""
    flipped = total = 0
    for a, b in zip(routes, ref_routes):
        a, b = a.cpu().sort(-1).values, b.cpu().sort(-1).values
        flipped += int((a != b).any(-1).sum())
        total += a.shape[0]
    return flipped, total


def mixtral_path(torch, T, kvcache, counters, scan=False):
    """Mixtral-8x7B at full width (hidden 4096, 32/8 heads, 8 experts of
    ffn 14336, top-2), MIXTRAL_PATH_LAYERS layers, W4A8 g128 with random
    scales + int8 KV: a MIXTRAL_PROMPT-token prompt (the prefill takes
    #10 and #9) and three forced decode steps (the cat path through #1),
    teacher-forced, launch counts from 0, against the plain path on the
    CPU. The routes of every token and layer are recorded on both: at most
    FLIPPED_ROUTES_MAX of them may pick another top-2 set (a near-tie that
    bf16 rounding tipped), and every logits vector of a token whose own
    routes agree is within 1e-2 rel L2, as path[llama2-7b]'s W4A8 (the
    integer sums are exact; sound runs read 4.4e-4 to 1.6e-3, and one
    wrong scale row of one expert must not pass). With `scan`
    (scan_path[mixtral-8x7b]) the same weights stacked (the cat experts
    too), through the scan forwards and the stacked cache on both sides:
    #10 and #9 on views of the stacked experts. Returns (launches, phase
    info)."""
    import dataclasses
    from deeppowers_tpu_torch.models.presets import MIXTRAL_8X7B
    name = "scan_path[mixtral-8x7b]" if scan else "path[mixtral-8x7b]"
    cfg = dataclasses.replace(MIXTRAL_8X7B, num_layers=MIXTRAL_PATH_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    params = mixtral_params(torch, T, cfg, gen, "cuda", scales=True)
    rng = torch.Generator().manual_seed(SEED + 15)
    ids = torch.randint(0, cfg.vocab_size, (MIXTRAL_PROMPT,),
                        generator=rng).tolist()
    forced = torch.randint(0, cfg.vocab_size, (3,), generator=rng).tolist()
    reset_counts(counters)
    with recorded_routes(T) as routes:
        got = teacher_forced(torch, T, kvcache, params, cfg, ids, forced,
                             "cuda", MIXTRAL_KV, scan)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    on, off = scan_variants(MIXTRAL_KV, scan)
    check_variants(name, launches, MIXTRAL_ON_PATH + on,
                   MIXTRAL_OFF_PATH + off)
    check_segment_modes(name, launches)
    t0 = time.perf_counter()
    with recorded_routes(T) as ref_routes:
        ref = teacher_forced(torch, T, kvcache, tree_to(params, "cpu"), cfg,
                             ids, forced, "cpu", MIXTRAL_KV, scan)
    cpu_s = time.perf_counter() - t0
    flips, total = flipped_routes(routes, ref_routes)
    # the tokens whose logits each vector is: the prompt's last, then each
    # forced one; a vector is exempt when its own token's route flipped
    layers = cfg.num_layers
    own = [[r[-1:] for r in routes[:layers]]] + [
        routes[layers * (i + 1):layers * (i + 2)] for i in range(len(forced))]
    own_ref = [[r[-1:] for r in ref_routes[:layers]]] + [
        ref_routes[layers * (i + 1):layers * (i + 2)]
        for i in range(len(forced))]
    rels, exempt = [], []
    for i, (g, r) in enumerate(zip(got, ref)):
        rel = ((g - r).norm() / r.norm()).item()
        rels.append(rel)
        if flipped_routes(own[i], own_ref[i])[0]:
            exempt.append(i)
    if not all(torch.isfinite(g).all() for g in got):
        fail(f"{name}: logits not finite")
    if flips > FLIPPED_ROUTES_MAX * total:
        fail(f"{name}: {flips} of {total} routes flipped "
             f"(limit {FLIPPED_ROUTES_MAX:.0%})")
    bad = [r for i, r in enumerate(rels) if i not in exempt and not r <= 1e-2]
    if bad:
        fail(f"{name}: kernel vs plain logits rel L2 {rels} "
             f"(exempt: {exempt}) > 1e-2")
    return launches, {
        "layers": cfg.num_layers, "hidden": cfg.hidden_size,
        "experts": f"{cfg.num_experts} top-{cfg.num_experts_per_tok}",
        "weights": "w4a8 g128", "kv": MIXTRAL_KV,
        "steps": f"prefill({len(ids)})+decode({len(forced)})",
        "logits_rel_l2": json.dumps([float(f"{r:.3e}") for r in rels]),
        "flipped_routes": f"{flips}/{total}", "exempt": exempt,
        "cpu_ref_s": f"{cpu_s:.1f}",
        "launches_ncat_w4a8g": launches[MIXTRAL_ON_PATH[0]],
        "launches_grouped_w4a8g": launches[MIXTRAL_ON_PATH[1]],
        "launches_w4a8g": launches["dequant_matmul[w4a8g]"],
        "launches_rows": launches[on[0]]}


def serve_mixtral(torch, T, counters):
    """Mixtral-8x7B whole (32 layers, 8 experts), W4A8 g128 + int8
    contiguous KV (BASELINE config 5, bench.py:342-357): serve's traffic (8
    requests of 16..900 bytes, 32 tokens each) once through the scheduler
    and the HTTP server, its routes recorded; the W4A8 g128 variants of
    #10, #9 and #1 and the quantizer must launch, no other weight variant,
    and every expert must take routed pairs.
    Then a profiled decode step of 8 slots and a 512-token prompt alone on
    the warm engine, TTFT_REPS times."""
    from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
    from deeppowers_tpu_torch.models.presets import MIXTRAL_8X7B as cfg
    from deeppowers_tpu_torch.quant.kvquant import KV_CACHE_DTYPES
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

    t0 = time.perf_counter()
    params = mixtral_params(torch, T, cfg, torch.Generator(
        device="cuda").manual_seed(SEED + 16), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok = ByteTokenizer()
    engine = InferenceEngine(
        params, cfg, device="cuda", eos_token_id=tok.eos_token_id,
        kv_cache_dtype=MIXTRAL_KV,
        runtime=RuntimeConfig(max_batch_size=8, max_seq_len=1024,
                              prefill_buckets=(64, 128, 256, 512, 1024),
                              scan_layers=False))
    engine.generate(tok.encode("warm up"), GenerationConfig(
        max_tokens=2, temperature=0.0))
    prompts = [prompt_text(n, i) for i, n in enumerate(PROMPT_BYTES)]
    with recorded_routes(T) as routes:
        results, launches, wall, sched = run_requests(
            torch, engine, prompts, MAX_TOKENS, counters, tok)
    check_variants(
        "serve[mixtral-8x7b]", launches,
        MIXTRAL_ON_PATH + ROUTES_ON + ["flash_attention_prefill",
                           "flash_attention_chunk",
                           f"scatter_rows[{MIXTRAL_KV}]",
                           f"decode_attention[{MIXTRAL_KV}]",
                           fold_key("decode_attention", MIXTRAL_KV)]
        + i8_keys(MIXTRAL_KV),
        MIXTRAL_OFF_PATH + ["scatter_pool_rows", "decode_attention_paged",
                            "step_writers"]
        + [f"{k}[{v}]" for k in ("scatter_rows", "decode_attention")
           for v in KV_CACHE_DTYPES if v != MIXTRAL_KV])
    check_segment_modes("serve[mixtral-8x7b]", launches)
    # random weights make every token's hidden state alike after a few
    # layers (the JAX package's forward on the same draw does the same),
    # so past layer 0 the routes crowd onto two or four experts; every
    # expert must still take pairs over the run
    pairs = torch.zeros(cfg.num_layers, cfg.num_experts, dtype=torch.long)
    for i, idx in enumerate(routes):
        pairs[i % cfg.num_layers] += torch.bincount(
            idx.flatten().cpu(), minlength=cfg.num_experts)
    if pairs.sum(0).min() < 1:
        fail(f"serve[mixtral-8x7b]: an expert took no routed pair: "
             f"{pairs.tolist()}")
    out = summary(results, wall, sched, launches)
    out.update(kv_bytes=engine.kv_nbytes, param_bytes=T.param_nbytes(params),
               init_s=init_s, pairs_per_expert=pairs.sum(0).tolist(),
               pairs_layer0=pairs[0].tolist(),
               idle_layers=int((pairs == 0).any(1).sum()),
               forwards=len(routes) // cfg.num_layers)
    out["profile"] = profile_decode(torch, engine, tok)
    check_step_quantizer("serve[mixtral-8x7b]", out["profile"])
    out["profile_bf16_dots"] = profile_bf16_dots(torch, engine, tok,
                                                 "serve[mixtral-8x7b]")
    gen = GenerationConfig(max_tokens=1, temperature=0.0)
    ttft = []
    for i in range(TTFT_REPS):
        ids = [4 + (j * 7 + i) % 250 for j in range(TTFT_PROMPT)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.add_request(ids, gen)
        torch.cuda.synchronize()
        ttft.append((time.perf_counter() - t1) * 1e3)
    engine.pop_finished()
    out["ttft_512_ms"] = ttft
    # a prefill's kernels: 9q twice a layer, and nothing between #10 and
    # #9 (the GLU is computed in #9's pre-pass)
    pp = out["prefill_profile"] = moe_prefill_profile(torch, engine)
    if pp["segments"]["traced"] != 2 * cfg.num_layers or \
            pp["between"]["traced"]:
        fail(f"serve[mixtral-8x7b]: a profiled prefill ran 9q "
             f"{pp['segments']['traced']} times (want {2 * cfg.num_layers}) "
             f"and {pp['between']['traced']} kernels between #10 and #9 "
             f"(want 0): {pp['between']['names']}")
    del engine
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["dispatch"] = dispatch_model(torch, "mixtral-8x7b", params, cfg,
                                     MIXTRAL_KV)
    out["dispatch_s"] = time.perf_counter() - t1
    return out


# ---------------------------------------------------------------------------
# trained: the repo's trained MoE checkpoint, loaded by the port and scored
# ---------------------------------------------------------------------------

TRAINED_CKPT = "moelm_ckpt"
TRAINED_SEQS = 8                # sequences a perplexity row scores
TRAINED_LEN = 512               # prefill rows' tokens a sequence
TRAINED_CACHED_LEN = 128        # cached rows' (S = 128: #3 takes 3i)
TRAINED_REL = 1e-2              # |ppl_card / ppl_cpu - 1|
TRAINED_SPEC_BYTES = 300        # served requests' prompts, from the text
TRAINED_SPEC_TOKENS = 32
#: a greedy stream with prompt lookup may leave the one without it only
#: where the latter's top two logits lie this close: bf16 verify steps of
#: 40 rows round otherwise than decode steps of 8 (a split at a gap of
#: 0.083 was seen on the card), where a wrong verify step leaves it at a
#: confident token
TRAINED_TIE_GAP = 0.25
TRAINED_CALIB = 16               # GPTQ's calibration sequences (MoE)
TRAINED_WEIGHTS = {"bf16": None, "int8": {},
                   "w4a8 g128": dict(mode="int4", group_size=128,
                                     act_bits=8),
                   "w4a8 g128 gptq": dict(mode="int4", group_size=128,
                                          act_bits=8, gptq=True)}
#: (row, weights, KV store or None for the prefill) and the kernel
#: counts that row must raise
TRAINED_ROWS = (
    ("bf16", "bf16", None, ["flash_attention_prefill"]),
    ("int8", "int8", None, ["flash_attention_prefill", "dequant_matmul[w8]",
                            "dequant_matmul[mma]"]),
    ("w4a8 g128", "w4a8 g128", None,
     ["flash_attention_prefill", "dequant_matmul[mma]"] + MIXTRAL_ON_PATH),
    ("w4a8 g128 + k8v4 KV", "w4a8 g128", "k8v4",
     ["dequant_matmul[gemv]", "dequant_matmul[w4a8g]", "quantize_activations",
      "decode_attention[k8v4+rows]", "decode_attention[i8:k8v4+rows]"]),
    ("bf16 + int8 KV", "bf16", "int8",
     ["decode_attention[int8+rows]", "decode_attention[i8:int8+rows]"]),
    ("w4a8 g128 gptq", "w4a8 g128 gptq", None,
     ["flash_attention_prefill", "dequant_matmul[mma]"] + MIXTRAL_ON_PATH),
    ("w4a8 g128 gptq + int8 KV", "w4a8 g128 gptq", "int8",
     ["dequant_matmul[gemv]", "dequant_matmul[w4a8g]", "quantize_activations",
      "decode_attention[int8+rows]", "decode_attention[i8:int8+rows]"]),
)


def trained_text(root: str) -> str:
    path = os.path.join(root, TRAINED_CKPT, "ppl_eval.txt")
    with open(path, encoding="utf-8") as f:
        return f.read()


def trained_weights(torch, T, params, cfg, calib=None):
    """{name: params}: the float weights as loaded (f32), and each
    quantized recipe made from them on their device and fused as the
    engine fuses them (wqkv, w_gu; W4A8 g128 experts in the cat layout,
    per-channel int8 experts stacked); a "gptq" recipe by GPTQ over the
    `calib` sequences (quant/gptq.py, on the weights' device). Returns
    (weights, GPTQ's seconds)."""
    from deeppowers_tpu_torch.config import QuantConfig, QuantMode
    from deeppowers_tpu_torch.quant.gptq import gptq_quantize
    out, gptq_s = {}, None
    for name, q in TRAINED_WEIGHTS.items():
        if q is None:
            out[name] = params
            continue
        q = dict(q)
        mode = QuantMode(q.pop("mode", "int8"))
        qcfg = QuantConfig(mode=mode, **{k: v for k, v in q.items()
                                         if k != "gptq"})
        if q.get("gptq"):
            t0 = time.perf_counter()
            qp = gptq_quantize(params, cfg, calib, qcfg)
            if qp["embedding"].is_cuda:
                torch.cuda.synchronize()
            gptq_s = round(time.perf_counter() - t0, 3)
        else:
            qp = T.quantize_params(params, qcfg)
        out[name] = T.fuse_params(qp, cfg)
    return out, gptq_s


def trained_ppl(torch, weights, cfg, seqs, cached, row):
    """One row's perplexity at bf16 on the weights' device: the prefill
    over `seqs`, or the decode path over `cached` through the row's KV
    store."""
    from deeppowers_tpu_torch.runtime.evaluate import (cached_perplexity,
                                                       perplexity)
    _, wname, store, _ = row
    if store is None:
        return perplexity(weights[wname], cfg, seqs,
                          batch_size=TRAINED_SEQS, dtype=torch.bfloat16)
    return cached_perplexity(weights[wname], cfg, cached,
                             kv_cache_dtype=store, batch_size=TRAINED_SEQS,
                             dtype=torch.bfloat16)


def expert_share(torch, routes, num_experts: int) -> dict:
    """The share of routed (token, expert) pairs each expert took, over
    all layers and per layer (min and max over experts)."""
    per_layer = [torch.bincount(r.reshape(-1).cpu(), minlength=num_experts)
                 for r in routes]
    total = torch.stack(per_layer).sum(0)
    shares = [c.double() / c.sum() for c in per_layer]
    return {"all": [round(float(x), 4) for x in total.double()
                    / total.sum()],
            "layer_min": [round(float(s.min()), 4) for s in shares],
            "layer_max": [round(float(s.max()), 4) for s in shares],
            "idle_expert_layers": sum(int((c == 0).any()) for c in per_layer)}


def first_split(a, b) -> int:
    """The first index where two token lists differ (len of the shorter
    when one is the other's prefix)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def tie_gap(torch, T, params, cfg, ids, pair):
    """The top-2 gap of the logits after `ids` (one bf16 prefill on the
    weights' device), or None unless the two tokens of `pair` are the top
    two."""
    dev = params["embedding"].device
    x = torch.tensor([ids], device=dev)
    lens = torch.tensor([len(ids)], device=dev, dtype=torch.int32)
    with torch.no_grad():
        logits, _ = T.forward_prefill(params, cfg, x, lens,
                                      dtype=torch.bfloat16, logits_at=lens - 1)
    top = logits[0].float().topk(2)
    if set(top.indices.tolist()) != set(pair):
        return None
    return float(top.values[0] - top.values[1])


def trained_spec(torch, T, params, cfg, counters, text):
    """8 served requests whose prompts are TRAINED_SPEC_BYTES-byte windows
    of the trained text, greedy, TRAINED_SPEC_TOKENS tokens: first on an
    engine without speculation, then with prompt lookup (K = SPEC_K,
    n-gram 3), each admitted in one round (`run_requests`'
    `admit_together`: the two runs prefill alike, whatever the requests'
    arrival times). The greedy streams must be equal, or part only where the
    plain engine's next token is a near tie: the two tokens there its top
    two after the common prefix, within TRAINED_TIE_GAP (a bf16 prefill of
    prompt and prefix on the card). Returns the acceptance mean and
    histogram, the streams' agreement and the speculative run's
    launches."""
    from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    raw = text.encode("utf-8")
    step = len(raw) // 8
    prompts = [raw[i * step:i * step + TRAINED_SPEC_BYTES].decode(
        "utf-8", errors="ignore") for i in range(8)]
    streams = []
    for spec in (0, SPEC_K):
        engine = InferenceEngine(
            params, cfg, device="cuda", eos_token_id=tok.eos_token_id,
            runtime=RuntimeConfig(max_batch_size=8, max_seq_len=512,
                                  prefill_buckets=(64, 128, 256, 512),
                                  speculative_tokens=spec,
                                  speculative_ngram=3))
        engine.generate(tok.encode("warm up"), GenerationConfig(
            max_tokens=2, temperature=0.0))
        results, launches, wall, sched = run_requests(
            torch, engine, prompts, TRAINED_SPEC_TOKENS, counters, tok,
            admit_together=True)
        streams.append([r["tokens"] for r in results])
        if spec:
            stats = sched.stats()["speculative"]
            check_variants("trained[spec]", launches,
                           [f"decode_attention[bf16:t{SPEC_T}]"],
                           ["decode_attention[bf16]"])
        del engine
    fused = T.fuse_params(params, cfg)
    splits = []
    for i, (plain, spec) in enumerate(zip(*streams)):
        if plain == spec:
            continue
        j = first_split(plain, spec)
        if j >= min(len(plain), len(spec)):
            fail(f"trained[spec]: request {i} stopped at {len(spec)} tokens "
                 f"with prompt lookup, {len(plain)} without")
        gap = tie_gap(torch, T, fused, cfg, tok.encode(prompts[i])
                      + plain[:j], (plain[j], spec[j]))
        splits.append({"request": i, "at": j, "gap": gap})
        if gap is None or not gap <= TRAINED_TIE_GAP:
            fail(f"trained[spec]: request {i} with prompt lookup leaves the "
                 f"greedy stream without it at token {j} ({spec[j]} for "
                 f"{plain[j]}), where the top-2 gap is {gap} (a near tie "
                 f"is <= {TRAINED_TIE_GAP}): {spec} against {plain}")
    same = sum(a == b for p, q in zip(*streams) for a, b in zip(p, q))
    return {"window_mean_accepted": stats["window_mean_accepted"],
            "accept_hist": stats["accept_hist"],
            "tokens": sum(len(x) for x in streams[1]),
            "equal_tokens": same, "splits": splits, "wall_s": wall,
            "launches": launches}


def check_narrow_heads(torch, cfg) -> dict:
    """#4, #3 and 3i at the trained model's heads of 32 dims (computed at
    64 over zero padding), on the card against their plain versions on the
    same inputs: the prefill rows' (8 x 512 tokens) flash attention, and
    the cached rows' decode attention over 8 slots of 128 positions (bf16,
    int8 and k8v4; tokens 1 and 5). Each (position or slot, row) within
    1e-2 of its max|ref|. Returns the worst ratio of each."""
    from deeppowers_tpu_torch.ops.kernels import decode_attention as da
    from deeppowers_tpu_torch.ops.kernels import flash_attention as fa
    from deeppowers_tpu_torch.quant.kvquant import quant_side
    hq, kh, d = cfg.num_heads, cfg.kv_heads, cfg.dim_head
    g = torch.Generator().manual_seed(SEED + 22)
    out = {}

    def worst(name, got, ref):
        err = (got.float().cpu() - ref.float()).abs().amax(-1)
        top = ref.float().abs().amax(-1).clamp_min(1e-30)
        ratio = float((err / top).max())
        if not torch.isfinite(got).all() or not ratio <= 1e-2:
            fail(f"trained: {name} at heads of {d}: worst row {ratio:.3e} "
                 f"of its max|ref| > 1e-2")
        out[name] = float(f"{ratio:.3e}")

    b, s = TRAINED_SEQS, TRAINED_LEN
    q, k, v = (torch.randn(b, s, h, d, generator=g).to(torch.bfloat16)
               for h in (hq, kh, kh))
    lens = torch.full((b,), s)
    got = fa.flash_attention_prefill(q.cuda(), k.cuda(), v.cuda(),
                                     lens.cuda())
    worst("flash_attention_prefill", got, fa.flash_attention_plain(
        q, k, v, lens))
    s = TRAINED_CACHED_LEN
    lens = torch.tensor([1, 17, 64, 65, 100, 127, 128, 128])
    for store, dots in (("bf16", False), ("int8", True), ("k8v4", True)):
        kb, vb = (16, 16) if store == "bf16" else (
            (8, 8) if store == "int8" else (8, 4))
        sides = []
        for bits in (kb, vb):
            x = torch.randn(b, s, kh, d, generator=g)
            if bits == 16:
                sides.append((x.reshape(b, s, kh * d).to(torch.bfloat16),
                              None))
            else:
                st, sc = quant_side(x, bits, 2 if bits == 4 else 1)
                sides.append((st.reshape(b, s, -1),
                              sc.transpose(-1, -2).contiguous()))
        (kc, ks), (vc, vs) = sides
        kw = {} if store == "bf16" else dict(k_scale=ks, v_scale=vs,
                                            kv_bits=kb, v_bits=vb)
        ckw = {n: (x.cuda() if torch.is_tensor(x) else x)
               for n, x in kw.items()}
        plain = (da.decode_attention_int8_dots_plain if dots
                 else da.decode_attention_plain)
        for t in (1, 5):
            qd = torch.randn(b, hq * t, d, generator=g).to(torch.bfloat16)
            lt = lens.clamp_min(t)      # a window's lengths hold its rows
            got = da.decode_attention(qd.cuda(), kc.cuda(), vc.cuda(),
                                      lt.cuda(), tokens=t, int8_dots=dots,
                                      **ckw)
            worst(f"decode_attention[{'i8:' if dots else ''}{store}"
                  f"{'' if t == 1 else f':t{t}'}]", got,
                  plain(qd, kc, vc, lt, tokens=t, **kw))
    return out


def trained_phase(torch, T, counters):
    """`moelm_ckpt` (6 layers, hidden 256, 8 experts top-2, byte vocabulary,
    trained) loaded by the port's loader straight onto the card, then
    perplexity at bf16 on its own text through each TRAINED_ROWS row: the
    prefill over TRAINED_SEQS sequences of TRAINED_LEN tokens for the float
    weights (float experts, the stacked grouped branch: T = 4096 routed
    tokens), int8 per-channel and W4A8 g128 (#10 / #9 behind 9q); the
    decode path over TRAINED_SEQS sequences of TRAINED_CACHED_LEN tokens
    through W4A8 g128 + k8v4 KV (the GEMV's cat experts, 3i) and float
    weights + int8 KV (3i); and W4A8 g128 + GPTQ, made on the card over
    TRAINED_CALIB windows from beyond the scored ones, through the prefill
    and the cat decode with int8 KV. Each row's launch counts are set to 0
    just before it and read just after, and it is held against the same
    function on the CPU (the kernels' plain versions, same weights) within
    TRAINED_REL. Then the experts' share of routed tokens on the text and
    prompt-lookup speculation served over it (`trained_spec`). Returns
    (launches by row, phase info)."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, TRAINED_CKPT)
    if not os.path.exists(os.path.join(path, "manifest.json")):
        fail(f"trained: {path} is missing (the chip run must carry it)")
    from deeppowers_tpu_torch.runtime.checkpoint import load_checkpoint
    from deeppowers_tpu_torch.scripts.eval_ppl import sequences
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer
    t0 = time.perf_counter()
    params, cfg, extra = load_checkpoint(path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if extra.get("trained", {}).get("tokenizer") != "byte":
        fail(f"trained: {TRAINED_CKPT} is not a byte-tokenizer checkpoint")
    text = trained_text(root)
    ids = ByteTokenizer().encode(text)
    windows = sequences(ids, TRAINED_LEN)
    seqs = windows[:TRAINED_SEQS]
    # GPTQ's calibration from beyond the scored windows, as the gate script
    # draws it
    calib = windows[TRAINED_SEQS:TRAINED_SEQS + TRAINED_CALIB]
    cached = sequences(ids, TRAINED_CACHED_LEN)[:TRAINED_SEQS]
    narrow = check_narrow_heads(torch, cfg)
    weights, gptq_s = trained_weights(torch, T, params, cfg, calib)
    cpu_weights = {k: tree_to(v, "cpu") for k, v in weights.items()}
    launches, rows, card_s, cpu_s = {}, {}, 0.0, 0.0
    share = None
    for row in TRAINED_ROWS:
        name, on = row[0], row[3]
        t1 = time.perf_counter()
        reset_counts(counters)
        if name == "bf16":
            with recorded_routes(T) as routes:
                got = trained_ppl(torch, weights, cfg, seqs, cached, row)
            share = expert_share(torch, routes, cfg.num_experts)
        else:
            got = trained_ppl(torch, weights, cfg, seqs, cached, row)
        torch.cuda.synchronize()
        launches[name] = read_counts(counters)
        check_variants(f"trained[{name}]", launches[name], on, [])
        t2 = time.perf_counter()
        ref = trained_ppl(torch, cpu_weights, cfg, seqs, cached, row)
        t3 = time.perf_counter()
        card_s += t2 - t1
        cpu_s += t3 - t2
        rel = abs(got / ref - 1)
        rows[name] = {"ppl": got, "cpu_ppl": ref, "rel": rel,
                      "card_s": round(t2 - t1, 3), "cpu_s": round(t3 - t2, 3)}
        log(f"trained[{name}] ppl card {got!r} cpu {ref!r} relative "
            f"{rel:.3e}, card {t2 - t1:.2f} s, cpu {t3 - t2:.2f} s")
        if not (rel <= TRAINED_REL):
            fail(f"trained[{name}]: card ppl {got} against the CPU's {ref}: "
                 f"relative {rel:.3e} > {TRAINED_REL}")
    # the KV rows' Δ against the float weights' prefill over their windows
    from deeppowers_tpu_torch.runtime.evaluate import perplexity
    kv_base = perplexity(weights["bf16"], cfg, cached,
                         batch_size=TRAINED_SEQS, dtype=torch.bfloat16)
    for name, r in rows.items():
        r["delta"] = r["ppl"] - (kv_base if "KV" in name
                                 else rows["bf16"]["ppl"])
    spec = trained_spec(torch, T, params, cfg, counters, text)
    launches["spec"] = spec.pop("launches")
    del weights, cpu_weights, params
    torch.cuda.empty_cache()
    return launches, {
        "checkpoint": TRAINED_CKPT, "layers": cfg.num_layers,
        "hidden": cfg.hidden_size,
        "experts": f"{cfg.num_experts} top-{cfg.num_experts_per_tok}",
        "load_s": f"{load_s:.2f}", "card_s": f"{card_s:.2f}",
        "gptq": f"{len(calib)}x{TRAINED_LEN} tokens, {gptq_s} s",
        "cpu_ref_s": f"{cpu_s:.2f}",
        "prefill": f"{TRAINED_SEQS}x{TRAINED_LEN}",
        "cached": f"{TRAINED_SEQS}x{TRAINED_CACHED_LEN}",
        "narrow_heads_worst_row": json.dumps(narrow),
        "rows": json.dumps(rows), "expert_share": json.dumps(share),
        "launches": json.dumps({row[0]: {k: launches[row[0]].get(k, 0)
                                         for k in row[3]}
                                for row in TRAINED_ROWS}),
        "spec": json.dumps(spec)}


# ---------------------------------------------------------------------------
# calibrated: zero-point weights through #1, and GPTQ on the card
# ---------------------------------------------------------------------------

#: TinyLlama-1.1B's matrices as an asymmetric decode step takes them (the
#: fuse keeps zero-point parts apart: wq, wk, wv and w_gate, w_in unfused):
#: (name, K, N, fold, matrices a step)
ZP_MATS = (("wq", 2048, 2048, "plain", 22), ("wk|wv", 2048, 256, "plain", 44),
           ("wo+res", 2048, 2048, "res", 22),
           ("w_gate|w_in", 2048, 5632, "plain", 44),
           ("w_out", 5632, 2048, "plain", 22),
           ("lm_head", 2048, 32000, "f32", 1))
#: the zero-point variants timed: (variant, bits, group) and their
#: symmetric twins' keys
ZP_VARIANTS = (("w8z", 8, 0, "w8"), ("w4gz", 4, 128, "w4g"))
#: every symmetric weight variant: none may launch where weights are
#: asymmetric
SYM_VARIANTS = [f"dequant_matmul[w{b}{a}{g}]" for b in (8, 4)
                for a in ("", "a8") for g in ("", "g")]
#: the GPTQ calibration: sequences x tokens, random ids from the seed
GPTQ_CALIB = (4, 512)
GPTQ_KINDS = ("qkv", "wo", "mlp_in", "mlp_out", "lm_head")


def zp_weight(torch, g, k, n, bits, group, device="cuda"):
    """An asymmetric QuantizedTensor of a random (K, N) float matrix whose
    first 64 columns are all positive (zero points far below the codes,
    |q - z| past 256 for int8: bf16(q - z) rounds) and next 64 all
    negative, quantized on `device`."""
    from deeppowers_tpu_torch.quant.quantize import quantize
    w = torch.randn(k, n, generator=g, device=device) * 0.02
    w[:, :64] = w[:, :64].abs() + 0.05
    w[:, 64:128] = -w[:, 64:128].abs() - 0.03
    return quantize(w, bits=bits, group_size=group, symmetric=False)


def check_zp_kernels(torch):
    """#1's zero-point variants (w8z: int8 per-channel, w4gz: int4 g128,
    asymmetric) at TinyLlama-1.1B's matrices, M = 8 (the GEMV: a decode
    step of 8 slots) and M = 512 (the tensor-core kernel: a 512-token
    prefill), each against `dequant_matmul_plain` with the same zero points
    (#1's gate, 2e-2 of a row's max|ref|), timed beside its bound (weight,
    scale and zero-point bytes), the plain version, torch.matmul on the
    bf16 dequantized weight and its symmetric twin (the same codes and
    scales without zero points, "sym_ms"). Rows: a step's matrices
    (ZP_MATS) per variant and M."""
    from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
    from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor
    from deeppowers_tpu_torch.quant.quantize import dequantize
    g = torch.Generator(device="cuda").manual_seed(SEED + 31)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)

    rows = []
    for var, bits, group, twin in ZP_VARIANTS:
        for m in (8, 512):
            tot = dict(ms=0.0, sym=0.0, plain=0.0, lib=0.0, bytes=0.0,
                       ops=0.0)
            err_max = 0.0
            for name, k, n, mode, per in ZP_MATS:
                if m == 512 and mode == "f32":
                    per = 0          # a prefill takes logits at one row
                q0 = zp_weight(torch, g, k, n, bits, group)
                w_bytes = q0.data.numel()
                copies = max(1, -(-200_000_000 // w_bytes)) if m == 8 else 1
                qws = [q0] + [QuantizedTensor(
                    q0.data.clone(), q0.scales.clone(),
                    q0.zero_points.clone(), bits, group)
                    for _ in range(copies - 1)]
                syms = [QuantizedTensor(q.data, q.scales, None, bits, group)
                        for q in qws]
                x = rn(m, k)
                kw = {"residual": rn(m, n)} if mode == "res" else {}
                out_dtype = torch.float32 if mode == "f32" else torch.bfloat16

                def plain(q=q0):
                    return dm.dequant_matmul_plain(
                        x, q.data, q.scales, bits=bits,
                        zero_points=q.zero_points, out_dtype=out_dtype, **kw)

                got = dm.dequant_matmul(x, q0, out_dtype=out_dtype, **kw)
                ref = plain()
                torch.cuda.synchronize()
                err, ratio = check_dm(f"dequant_matmul[{var}] {name} M={m}",
                                      got, ref)
                err_max = max(err_max, err)
                # at M = 8 the kernel and the library each stream at least
                # 200 MB of weight copies a timed replay, past the 50 MB L2
                w0 = dequantize(q0, torch.bfloat16)
                lib_copies = (max(1, -(-200_000_000 // (w0.numel() * 2)))
                              if m == 8 else 1)
                wbf = [w0] + [w0.clone() for _ in range(lib_copies - 1)]
                t_k = cuda_ms(torch, [lambda q=q: dm.dequant_matmul(
                    x, q, out_dtype=out_dtype, **kw) for q in qws],
                    max(50, copies) if m == 8 else 10)
                t_s = cuda_ms(torch, [lambda q=q: dm.dequant_matmul(
                    x, q, out_dtype=out_dtype, **kw) for q in syms],
                    max(50, copies) if m == 8 else 10)
                t_p = cuda_ms(torch, [lambda q=q: plain(q) for q in qws[:2]],
                              3, graph=False)
                t_l = cuda_ms(torch, [lambda w=w: torch.matmul(x, w)
                                      for w in wbf],
                              max(50, lib_copies) if m == 8 else 10)
                nbytes = (w_bytes + q0.scales.numel() * 4
                          + q0.zero_points.numel() * 4 + x.numel() * 2
                          + m * n * (4 if mode == "f32" else 2)
                          + (m * n * 2 if mode == "res" else 0))
                ops = 2 * m * k * n
                bd, by = bound_ms(nbytes, ops)
                log(f"  dequant_matmul[{var}] {name} M={m} K={k} N={n}: "
                    f"max_abs_err={err:.3e} worst row ratio {ratio:.3e}, "
                    f"kernel {t_k:.4f} ms, symmetric twin [{twin}] "
                    f"{t_s:.4f} ms, plain {t_p:.4f} ms, torch.matmul bf16 "
                    f"{t_l:.4f} ms, bound {bd:.4f} ms ({by}), x{per}")
                for key, v in (("ms", t_k), ("sym", t_s), ("plain", t_p),
                               ("lib", t_l), ("bytes", nbytes), ("ops", ops)):
                    tot[key] += per * v
                del qws, syms, wbf, w0
            bd, by = bound_ms(tot["bytes"], tot["ops"])
            rows.append({
                "name": f"dequant_matmul[{var}, M={m}]", "route": "cuda",
                "source": GEMV_SRC if m == 8 else MMA_SRC,
                "replaces": "deeppowers_tpu/ops/pallas/dequant_matmul.py:528",
                "max_abs_err": err_max, "ms": tot["ms"],
                "plain_ms": tot["plain"], "bound_ms": bd, "bound_by": by,
                "library_ms": tot["lib"], "variant": var,
                "sym_ms": tot["sym"], "sym_variant": twin,
                "shape": ("TinyLlama-1.1B asymmetric decode step, 8 slots: "
                          "22 layers x (wq, wk, wv, wo, w_gate, w_in, "
                          "w_out) + lm_head" if m == 8 else
                          "TinyLlama-1.1B asymmetric 512-token prefill: 22 "
                          "layers x (wq, wk, wv, wo, w_gate, w_in, w_out)")})
            torch.cuda.empty_cache()
    return rows


def asym_params(torch, T, cfg, gen, device):
    """TinyLlama's random bf16 weights quantized asymmetrically: the
    attention int8 per-channel (w8z), the MLP and the lm_head int4 g128
    (w4gz), then fused as the engine fuses them (zero-point parts stay
    apart)."""
    from deeppowers_tpu_torch.config import QuantConfig, QuantMode
    params = T.init_params(cfg, gen, dtype=torch.bfloat16, device=device)
    qa = T.quantize_params(params, QuantConfig(mode=QuantMode.INT8,
                                               symmetric=False))
    qb = T.quantize_params(params, QuantConfig(
        mode=QuantMode.INT4, group_size=128, symmetric=False))
    out = dict(qb)
    out["layers"] = [dict(lb, attn=la["attn"])
                     for la, lb in zip(qa["layers"], qb["layers"])]
    return T.fuse_params(out, cfg)


def served_run(torch, params, cfg, counters, phase, want, zero,
               device="cuda"):
    """serve's 8 requests once through the scheduler and the HTTP server,
    on an engine at the default runtime (a 22-layer model stacks its
    layers: scan_layers "auto"), every launch count from 0; `want` must
    launch, `zero` must not. Returns (summary, launches)."""
    from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    engine = InferenceEngine(
        params, cfg, device=device, eos_token_id=tok.eos_token_id,
        runtime=RuntimeConfig(max_batch_size=8, max_seq_len=1024,
                              prefill_buckets=(64, 128, 256, 512, 1024)))
    engine.generate(tok.encode("warm up"), GenerationConfig(
        max_tokens=2, temperature=0.0))
    prompts = [prompt_text(n, i) for i, n in enumerate(PROMPT_BYTES)]
    results, launches, wall, sched = run_requests(
        torch, engine, prompts, MAX_TOKENS, counters, tok)
    check_variants(phase, launches, want, zero)
    out = summary(results, wall, sched, launches)
    out["scan_layers"] = bool(engine.scan_layers)
    return out, launches


def ulp_moved(torch, e):
    """bf16 `e` with a third of its values (a seeded draw) one ulp up: the
    CPU's own spread of a path under rounding-sized input changes."""
    bits = e.view(torch.int16).clone()
    pick = torch.rand(e.shape, generator=torch.Generator().manual_seed(
        SEED + 44)) < 1 / 3
    bits[pick] += 1
    return bits.view(torch.bfloat16)


def kind_weights(params, i, kind):
    """The matrices of layer i (or the lm_head) that share a Hessian."""
    if kind == "lm_head":
        return [params["lm_head"]["w"]]
    layer = params["layers"][i]
    names = {"qkv": ("attn", ("wq", "wk", "wv")), "wo": ("attn", ("wo",)),
             "mlp_in": ("mlp", ("w_gate", "w_in")),
             "mlp_out": ("mlp", ("w_out",))}[kind]
    return [layer[names[0]][nm]["w"] for nm in names[1]]


def output_errors(torch, fparams, qparams, stats, cfg) -> dict:
    """Per matrix kind, ||X (W - W_q)|| over the calibration inputs X,
    from the Hessians H = X^T X: sqrt(sum over layers and matrices of
    tr(D^T H D)), D = W - dequant(W_q), in f64 on the weights' device."""
    from deeppowers_tpu_torch.quant.quantize import dequantize
    out = {}
    for kind in GPTQ_KINDS:
        tot = 0.0
        layers = [None] if kind == "lm_head" else range(cfg.num_layers)
        for i in layers:
            h = (stats[-1] if i is None else stats[i])[kind].double()
            for w, q in zip(kind_weights(fparams, i, kind),
                            kind_weights(qparams, i, kind)):
                d = w.double() - dequantize(q).double()
                tot += float((d * (h @ d)).sum())
        out[kind] = tot ** 0.5
    return out


def quantized_matrices(tree, path=""):
    """(path, QuantizedTensor) of every quantized matrix in a params tree."""
    from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor
    if isinstance(tree, QuantizedTensor):
        return [(path, tree)]
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, list) else ())
    return [m for k, v in items
            for m in quantized_matrices(v, f"{path}/{k}" if path else str(k))]


def check_matrices(torch, params, what):
    """#1 on every quantized matrix of `params` (all layers and the lm_head,
    fused as the engine runs them) at M = 8 (the GEMV) and M = 512 (the
    tensor-core kernel), random bf16 activations, each against
    `dequant_matmul_plain` on the same weights under #1's gate (2e-2 of a
    row's max|ref|): a comparison that stays tight at full depth, where
    teacher-forced logits through the a8 row quantizer do not. Returns
    (matrices, worst row ratio)."""
    from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
    g = torch.Generator(device="cuda").manual_seed(SEED + 45)
    mats = quantized_matrices(params)
    worst = 0.0
    for name, q in mats:
        k = q.shape[0]
        for m in (8, 512):
            x = (torch.randn(m, k, generator=g, device="cuda")
                 .to(torch.bfloat16))
            got = dm.dequant_matmul(x, q)
            ref = dm.dequant_matmul_plain(
                x, q.data, q.scales, bits=q.bits, act_bits=q.act_bits,
                zero_points=q.zero_points, out_dtype=torch.bfloat16)
            worst = max(worst, check_dm(f"{what} {name} M={m}", got, ref)[1])
    return len(mats), worst


def gptq_weights(torch, T, cfg, gen, device):
    """TinyLlama's random bf16 weights and W4A8 g128 + GPTQ made from
    them on `device`, calibrated over GPTQ_CALIB random sequences: (float
    params, GPTQ params, RTN params, Hessians, seconds {xtx, gptq})."""
    from deeppowers_tpu_torch.config import QuantConfig, QuantMode
    from deeppowers_tpu_torch.quant.gptq import collect_xtx, gptq_quantize
    fparams = T.init_params(cfg, gen, dtype=torch.bfloat16, device=device)
    rng = torch.Generator().manual_seed(SEED + 41)
    n, s = GPTQ_CALIB
    calib = torch.randint(0, cfg.vocab_size, (n, s), generator=rng).tolist()
    qcfg = QuantConfig(mode=QuantMode.INT4, group_size=128, act_bits=8)
    t0 = time.perf_counter()
    stats = collect_xtx(fparams, cfg, calib)
    if device == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    gq = gptq_quantize(fparams, cfg, calib, qcfg, stats=stats)
    if device == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return fparams, gq, T.quantize_params(fparams, qcfg), stats, {
        "xtx_s": round(t1 - t0, 3), "gptq_s": round(t2 - t1, 3)}


def calibrated_phase(torch, T, kvcache, counters):
    """TinyLlama-1.1B at full width through asymmetric weights and GPTQ.
    (a) Asymmetric weights (`asym_params`): teacher-forced logits
    against the CPU's kernel function (rel L2 <= 5e-2), then serve's 8
    requests, the zero-point launch counts of both routes above 0 and no
    symmetric variant launched. (b) W4A8 g128 + GPTQ made on the card
    over GPTQ_CALIB tokens (`gptq_weights`), its seconds; per matrix kind
    GPTQ's output error against round-to-nearest's, GPTQ lower on every
    kind; #1 on each of its matrices at full depth against the plain
    version (`check_matrices`); then its teacher-forced logits against the
    CPU (its first LLAMA2_PATH_LAYERS layers, rel L2 <= 5e-2, beside the
    CPU's own spread under one-ulp input changes) and serve's 8 requests
    at full depth. Returns (launches by run, phase info)."""
    import dataclasses
    from deeppowers_tpu_torch.models.presets import TINYLLAMA_1_1B as cfg
    rng = torch.Generator().manual_seed(SEED + 42)
    ids = torch.randint(0, cfg.vocab_size, (40,), generator=rng).tolist()
    forced = torch.randint(0, cfg.vocab_size, (3,), generator=rng).tolist()
    info, launches = {}, {}

    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
    params = asym_params(torch, T, cfg, gen, "cuda")
    zp_on = ["dequant_matmul[w8z]", "dequant_matmul[w4gz]"] + ROUTES_ON
    reset_counts(counters)
    got = forced_logits(torch, T, kvcache, params, cfg, ids, forced, "cuda")
    torch.cuda.synchronize()
    launches["calibrated[asym,path]"] = read_counts(counters)
    check_variants("calibrated[asym,path]", launches["calibrated[asym,path]"],
                   zp_on, SYM_VARIANTS)
    ref = forced_logits(torch, T, kvcache, tree_to(params, "cpu"), cfg, ids,
                        forced, "cpu")
    rel = max(((g - r).norm() / r.norm()).item() for g, r in zip(got, ref))
    if not all(torch.isfinite(g).all() for g in got) or not rel <= 5e-2:
        fail(f"calibrated[asym]: kernel vs plain logits rel L2 {rel} > 5e-2")
    srv, launches["calibrated[asym]"] = served_run(
        torch, params, cfg, counters, "calibrated[asym]", zp_on,
        SYM_VARIANTS)
    info["asym"] = {"logits_rel_l2": f"{rel:.3e}",
                    "tok_per_s": round(srv["tok_per_s"], 1),
                    "ttft_ms_p50": srv["ttft_ms_p50"],
                    "decode_step_ms_p50": srv["decode_step_ms_p50"],
                    "scan_layers": srv["scan_layers"],
                    "launches": {k: launches["calibrated[asym]"].get(k, 0)
                                 for k in zp_on}}
    del params
    torch.cuda.empty_cache()

    fparams, gq, rtn, stats, secs = gptq_weights(torch, T, cfg, gen, "cuda")
    errs = {"gptq": output_errors(torch, fparams, gq, stats, cfg),
            "rtn": output_errors(torch, fparams, rtn, stats, cfg)}
    log(f"calibrated[gptq] W4A8 g128 over {GPTQ_CALIB[0]}x{GPTQ_CALIB[1]} "
        f"tokens on the card: Hessians {secs['xtx_s']} s, GPTQ "
        f"{secs['gptq_s']} s; ||X(W - Wq)|| per kind, GPTQ "
        + json.dumps(errs["gptq"]) + ", RTN " + json.dumps(errs["rtn"]))
    worse = [k for k in GPTQ_KINDS if not errs["gptq"][k] < errs["rtn"][k]]
    if worse:
        fail(f"calibrated[gptq]: GPTQ's output error is not below RTN's "
             f"for {worse}: {errs}")
    del fparams, rtn, stats
    torch.cuda.empty_cache()
    params = T.fuse_params(gq, cfg)
    n_mats, mat_ratio = check_matrices(torch, params, "calibrated[gptq]")
    log(f"calibrated[gptq] #1 on all {n_mats} GPTQ matrices at M = 8 and "
        f"512 against the plain version: worst row ratio {mat_ratio:.3e}")
    gptq_on = ["dequant_matmul[w4a8g]", "quantize_activations"] + ROUTES_ON
    # teacher-forced over its first LLAMA2_PATH_LAYERS layers, rel L2 <=
    # 5e-2 (the TinyLlama paths' limit). Random TinyLlama weights behind the
    # a8 row quantizer are chaotic: a one-ulp change of a third of the
    # embedding moves these logits on the CPU alone about as far as the
    # card's rounding does, so this limit holds the path's wiring, and
    # check_matrices above holds the kernels at full depth. The CPU's own
    # one-ulp spread is measured beside it.
    cut_cfg = dataclasses.replace(cfg, num_layers=LLAMA2_PATH_LAYERS)
    cut = dict(params, layers=params["layers"][:LLAMA2_PATH_LAYERS])
    reset_counts(counters)
    got = forced_logits(torch, T, kvcache, cut, cut_cfg, ids, forced, "cuda")
    torch.cuda.synchronize()
    launches["calibrated[gptq,path]"] = read_counts(counters)
    check_variants("calibrated[gptq,path]",
                   launches["calibrated[gptq,path]"], gptq_on, [])
    cpu_cut = tree_to(cut, "cpu")
    ref = forced_logits(torch, T, kvcache, cpu_cut, cut_cfg, ids, forced,
                        "cpu")
    rel_g = max(((g - r).norm() / r.norm()).item() for g, r in zip(got, ref))
    if not all(torch.isfinite(g).all() for g in got) or not rel_g <= 5e-2:
        fail(f"calibrated[gptq]: kernel vs plain logits over "
             f"{LLAMA2_PATH_LAYERS} layers rel L2 {rel_g} > 5e-2")
    ulp = forced_logits(torch, T, kvcache, dict(cpu_cut, embedding=ulp_moved(
        torch, cpu_cut["embedding"])), cut_cfg, ids, forced, "cpu")
    ulp_rel = max(((g - r).norm() / r.norm()).item()
                  for g, r in zip(ulp, ref))
    srv, launches["calibrated[gptq]"] = served_run(
        torch, params, cfg, counters, "calibrated[gptq]", gptq_on, [])
    info["gptq"] = {"calibration": f"{GPTQ_CALIB[0]}x{GPTQ_CALIB[1]}",
                    **secs, "output_error": errs,
                    "gain": {k: round(1 - errs["gptq"][k] / errs["rtn"][k], 4)
                             for k in GPTQ_KINDS},
                    "matrices": n_mats,
                    "matrix_worst_row_ratio": f"{mat_ratio:.3e}",
                    "logits_rel_l2": f"{rel_g:.3e}",
                    "path_layers": LLAMA2_PATH_LAYERS,
                    "cpu_one_ulp_rel_l2": f"{ulp_rel:.3e}",
                    "tok_per_s": round(srv["tok_per_s"], 1),
                    "decode_step_ms_p50": srv["decode_step_ms_p50"]}
    del params, gq
    torch.cuda.empty_cache()
    order = ("calibrated[asym]", "calibrated[asym,path]", "calibrated[gptq]",
             "calibrated[gptq,path]")     # the served runs count first
    return ({k: launches[k] for k in order},
            {k: json.dumps(v) for k, v in info.items()})


def spec_path(torch, T, params, cfg, counters):
    """The teacher-forced verify window on the card: a 40-token prompt, then
    forward_verify over T = 5 forced tokens, through each store on each
    layout, with launch counts from 0 (the tokens = 5 variant of #3 or #5
    must launch once a layer, writing the window's rows itself: no row
    writer inside the verify or the decode forwards).
    Held against the same on the plain path on the CPU and against five
    sequential forward_decode steps on the card, rel L2 <= 5e-2 per window
    row (both keep the residual stream in bf16 and differ in rounding
    order). Returns {(store, layout): launches}."""
    rng = torch.Generator().manual_seed(SEED + 24)
    ids = torch.randint(0, cfg.vocab_size, (40,), generator=rng).tolist()
    window = torch.randint(0, cfg.vocab_size, (SPEC_T,),
                           generator=rng).tolist()
    cpu_params = tree_to(params, "cpu")
    out = {}

    def rel(a, b):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()

    for dtype in STORES:
        for paged in (False, True):
            t0 = time.perf_counter()
            layout = "paged" if paged else "contiguous"
            reset_counts(counters)
            got, seq = verify_logits(torch, T, params, cfg, ids, window,
                                     "cuda", paged, dtype)
            torch.cuda.synchronize()
            launches = out[(dtype, layout)] = read_counts(counters)
            attn = ("decode_attention_paged" if paged else
                    "decode_attention") + f"[{dtype}:t{SPEC_T}]"
            fold = attn[:-1] + "+rows]"
            if launches.get(attn, 0) != cfg.num_layers or \
                    launches.get(fold, 0) != cfg.num_layers or \
                    launches.get("step_writers", 0):
                fail(f"spec_path[{dtype},{layout}]: {attn} launched "
                     f"{launches.get(attn, 0)} times for {cfg.num_layers} "
                     f"layers, {launches.get(fold, 0)} of them writing the "
                     f"window's rows; row writers inside the forwards "
                     f"{launches.get('step_writers', 0)}")
            ref, _ = verify_logits(torch, T, cpu_params, cfg, ids, window,
                                   "cpu", paged, dtype, sequential=False)
            r_cpu, r_seq = rel(got, ref), rel(got, seq)
            if not (torch.isfinite(got).all() and r_cpu <= 5e-2
                    and r_seq <= 5e-2):
                fail(f"spec_path[{dtype},{layout}]: verify logits rel L2 "
                     f"{r_cpu:.3e} against the plain path on the CPU, "
                     f"{r_seq:.3e} against sequential decode (limit 5e-2)")
            phase_line(f"spec_path[{dtype},{layout}]", t0, tokens=SPEC_T,
                       logits_rel_l2=f"{r_cpu:.3e}",
                       vs_sequential_decode=f"{r_seq:.3e}",
                       **{f"launches_{attn}": launches[attn]})
    return out


MARGIN_SEEDS = 3


def margins(torch, T, kvcache, cfg, params) -> None:
    """The card gates with the least room, held again over MARGIN_SEEDS
    other seeds so that the run shows how close each sits to its limit:
    #3's worst (slot, head) row ratio against its plain version per store
    at the kernels phase's shapes (limit 1e-2), the int8-dot variant that
    the main path runs against `decode_attention_int8_dots_plain` and the
    bf16-dot kernel (DPT_ATTN_INT8=0, which #5 shares) against
    `decode_attention_plain`, and the teacher-forced logits' rel L2 against the
    plain path on the CPU, contiguous layout, for the two stores closest
    to its limit of 5e-2 (int4, k8v4). A seed picks the attention inputs
    and the token ids; the weights stay seed 0's."""
    from deeppowers_tpu_torch.ops.kernels import decode_attention as da
    from deeppowers_tpu_torch.quant.kvquant import STORE_BITS, quant_side
    dev = torch.device("cuda")
    b, s_cache = 8, 1024
    hq, d, kh = cfg.num_heads, cfg.dim_head, cfg.kv_heads
    lens = torch.tensor(ATTN_LENS, device=dev, dtype=torch.int32)
    cpu_params = tree_to(params, "cpu")
    for seed in range(1, MARGIN_SEEDS + 1):
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(1000 + seed)
        q = torch.randn(b, hq, d, generator=g, device=dev).to(torch.bfloat16)
        line = {}
        for dtype in ("int8", "int4", "k8v4"):
            kb, vb = STORE_BITS[dtype]
            kc, ks = quant_side(torch.randn(b, s_cache, kh, d, generator=g,
                                            device=dev), kb,
                                2 if kb == 4 else 1)
            vc, vs = quant_side(torch.randn(b, s_cache, kh, d, generator=g,
                                            device=dev), vb,
                                2 if vb == 4 else 1)
            kw = dict(k_scale=ks.transpose(1, 2).contiguous(),
                      v_scale=vs.transpose(1, 2).contiguous(), kv_bits=kb,
                      v_bits=vb)
            for dots, plain, tag in (
                    (False, da.decode_attention_plain, ""),
                    (True, da.decode_attention_int8_dots_plain, "i8:")):
                got = da.decode_attention(q, kc, vc, lens, int8_dots=dots,
                                          **kw)
                ref = plain(q, kc, vc, lens, **kw)
                line[f"attn_row_ratio[{tag}{dtype}]"] = worst = row_errors(
                    got, ref)[1]
                if not (torch.isfinite(got).all() and worst <= 1e-2):
                    fail(f"margins seed {seed}: decode_attention[{tag}"
                         f"{dtype}] row error {worst:.3g} of its max|ref| "
                         f"(limit 1e-2)")
        rng = torch.Generator().manual_seed(2000 + seed)
        ids = torch.randint(0, cfg.vocab_size, (40,), generator=rng).tolist()
        forced = torch.randint(0, cfg.vocab_size, (3,), generator=rng).tolist()
        for dtype in ("int4", "k8v4"):
            got = forced_logits(torch, T, kvcache, params, cfg, ids, forced,
                                "cuda", kv_cache_dtype=dtype)
            ref = forced_logits(torch, T, kvcache, cpu_params, cfg, ids,
                                forced, "cpu", kv_cache_dtype=dtype)
            line[f"path_rel_l2[{dtype}]"] = rel = max(
                ((x - r).norm() / r.norm()).item() for x, r in zip(got, ref))
            if not rel <= 5e-2:
                fail(f"margins seed {seed}: path[{dtype}] rel L2 {rel} > 5e-2")
        phase_line(f"margins[seed={seed}]", t0, **{
            k: f"{v:.3e}" for k, v in line.items()})


# ---------------------------------------------------------------------------
# phase 5: serve
# ---------------------------------------------------------------------------

PROMPT_BYTES = (16, 64, 100, 200, 300, 450, 600, 900)
MAX_TOKENS = 32


def prompt_text(nbytes: int, i: int) -> str:
    base = f"request {i}: the quick brown fox jumps over the lazy dog. "
    return (base * (nbytes // len(base) + 1))[:nbytes]


def post(port: int, body: dict, timeout: float = 120.0) -> dict:
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


#: CUDA runtime calls that block the host until the device catches up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
ALLOC_CALLS = ("cudaMalloc", "cudaFree")
GRAPH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


def host_split(torch, prof, n: int) -> dict:
    """The host's side of a profiled region, per unit (a decode step, a
    prefill): device busy ms; top-level PyTorch ops issued from Python;
    kernel launches; calls that block on the device (count and ms);
    cudaMalloc and cudaFree calls (count and ms); and the host entries
    with the most self time."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    avg = prof.key_averages()
    by_key = {e.key: e for e in avg}

    def count(keys):
        return sum(by_key[k].count for k in keys if k in by_key) / n

    def ms(keys):
        return sum(by_key[k].cpu_time_total for k in keys
                   if k in by_key) / 1e3 / n

    busy = sum(e.self_device_time_total for e in avg
               if e.device_type == cuda) / 1e3 / n
    kernels = sum(e.count for e in avg if e.device_type == cuda) / n
    api = sum(e.count for e in avg if e.device_type == cpu
              and e.key.startswith(("cuda", "cu"))) / n
    ops = sum(1 for e in prof.events() if e.device_type == cpu
              and e.cpu_parent is None and e.name.startswith("aten::")) / n
    top = sorted((e for e in avg if e.device_type == cpu),
                 key=lambda e: -e.self_cpu_time_total)[:6]
    return {"busy_ms": busy, "ops": ops, "launches": count(LAUNCH_CALLS),
            "graph_launches": count(GRAPH_CALLS), "kernels": kernels,
            "api_calls": api,
            "syncs": count(SYNC_CALLS), "sync_ms": ms(SYNC_CALLS),
            "allocs": count(ALLOC_CALLS), "alloc_ms": ms(ALLOC_CALLS),
            "host_top": [(e.key[:40], round(e.self_cpu_time_total / 1e3 / n,
                                            4)) for e in top]}


def profile_decode(torch, engine, tok, steps: int = 5,
                   tokens_per_step: int = 1, prompt_bytes: int = 64):
    """Device busy share of full-batch decode steps and their host split:
    8 greedy requests, two warm steps, then `steps` steps under
    torch.profiler (each request's budget covers `tokens_per_step` tokens
    a step, a speculative window's most), and the device ms a step of the
    decode attention kernel (#3, #5 and #7 are one template,
    `attention_kernel`). Every one of them is one launch a call: no step
    may run a combine_kernel."""
    from deeppowers_tpu_torch.config import GenerationConfig
    from deeppowers_tpu_torch.ops.kernels import decode_attention as da
    from deeppowers_tpu_torch.ops.kernels import kv_append as ka
    from deeppowers_tpu_torch.ops.kernels.dequant_matmul import (
        quantize_activations)
    from torch.profiler import ProfilerActivity, profile

    def writers():
        return sum(f.launches for f in (ka.scatter_rows, ka.scatter_pool_rows,
                                        ka.scatter_rows_stacked))

    def folds():     # the "i8:" keys count the same launches again
        return sum(n for f in (da.decode_attention, da.decode_attention_paged)
                   for k, n in f.variant_launches.items()
                   if k.endswith("+rows") and not k.startswith("i8:"))
    for i in range(engine.num_slots):
        engine.add_request(tok.encode(prompt_text(prompt_bytes, i)),
                           GenerationConfig(
                               max_tokens=(steps + 4) * tokens_per_step,
                               temperature=0.0))
    engine.step()
    engine.step()
    torch.cuda.synchronize()
    q0, w0, f0 = quantize_activations.launches, writers(), folds()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    q_launches = (quantize_activations.launches - q0) / steps
    w_launches, f_launches = (writers() - w0) / steps, (folds() - f0) / steps
    split = host_split(torch, prof, steps)
    if split["busy_ms"] <= 0:
        fail("profile: no device time recorded for the decode steps")
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if any("combine_kernel" in e.key for e in dev):
        fail("profile: a decode step ran combine_kernel beside the attention "
             "kernel")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    quant = [e for e in dev if "quantize_rows_kernel" in e.key]
    attn = [e for e in dev if "attention_kernel" in e.key]
    while engine.active_requests:
        engine.step()
    engine.pop_finished()
    split.update(wall_ms=wall_ms, idle_share=1.0 - split["busy_ms"] / wall_ms,
                 top=[(e.key[:60], e.self_device_time_total / 1e3 / steps)
                      for e in top],
                 attention={"traced": sum(e.count for e in attn) / steps,
                            "ms": sum(e.self_device_time_total
                                      for e in attn) / 1e3 / steps},
                 row_writers=w_launches, folded_attention=f_launches,
                 quantizer={"launches": q_launches,
                            "traced": sum(e.count for e in quant) / steps,
                            "ms": sum(e.self_device_time_total
                                      for e in quant) / 1e3 / steps})
    return split


def i8_keys(store: str) -> list:
    """The counters of #3's int8-dot variant in a decode step of `store`:
    its launches, and those that wrote the step's rows."""
    return [f"decode_attention[i8:{store}]",
            f"decode_attention[i8:{store}+rows]"]


def profile_bf16_dots(torch, engine, tok, phase: str) -> dict:
    """`profile_decode` again with DPT_ATTN_INT8=0: #3's bf16-dot kernel
    in place of its int8-dot variant, which must then not launch."""
    from deeppowers_tpu_torch.ops.kernels import decode_attention as da

    def i8():
        return sum(n for k, n in da.decode_attention.variant_launches.items()
                   if k.startswith("i8:"))
    before = i8()
    with int8_dots_off():
        prof = profile_decode(torch, engine, tok)
    if i8() != before:
        fail(f"{phase}: DPT_ATTN_INT8=0 launched #3's int8-dot variant")
    return prof


# the row quantizer's launches in a decode step of the 7B and Mixtral: one
# a W4A8 matmul (32 layers x 4, and the lm_head)
A8_STEP_MATMULS = 4 * 32 + 1


def check_step_quantizer(phase, profile) -> None:
    """The profiled decode steps launched the row quantizer once for each
    of their W4A8 matmuls, and no more (the wrapper's count), and the
    profiler saw its kernel run."""
    got = profile["quantizer"]
    if got["launches"] != A8_STEP_MATMULS or not got["traced"]:
        fail(f"{phase}: {got['launches']} row quantizer launches a decode "
             f"step ({got['traced']} traced), expected {A8_STEP_MATMULS}")


def profile_prefill(torch, engine, tok, prompts):
    """Each prompt prefilled alone on the idle, warm engine (whole or in
    chunks, as the engine picks; max_tokens 1, so the slot retires at its
    first token): the wall ms of each, synchronized, in a pass without the
    profiler, then the host split of one prefill (the mean over the
    prompts) and the kernels with the most device time a prefill in a pass
    under torch.profiler."""
    from deeppowers_tpu_torch.config import GenerationConfig
    from torch.profiler import ProfilerActivity, profile
    gen = GenerationConfig(max_tokens=1, temperature=0.0)
    ids = [tok.encode(p) for p in prompts]

    def one(x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.add_request(x, gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    walls = [one(x) for x in ids]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in ids:
            one(x)
    engine.pop_finished()
    split = host_split(torch, prof, len(ids))
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    split["top"] = [(e.key[:60], round(e.self_device_time_total / 1e3
                                       / len(ids), 4))
                    for e in sorted(dev, key=lambda e: -e.self_device_time_total)
                    [:4]]
    split["wall_ms"] = walls
    return split


def moe_prefill_profile(torch, engine, reps: int = 2) -> dict:
    """A TTFT_PROMPT-token prompt prefilled alone on the warm MoE engine,
    once to warm, then `reps` times under torch.profiler: per prefill the
    host split (device busy ms, launches, PyTorch ops); 9q's launches and
    device ms; and the kernels between #10 and #9 of each MoE layer (after
    the layer's first 9q launch and #10's kernel, before its second 9q
    launch), where the layer's GLU runs as eager ops when #9's pre-pass does
    not compute it: their launches and device ms, and their names."""
    from deeppowers_tpu_torch.config import GenerationConfig
    from torch.profiler import ProfilerActivity, profile
    first = GenerationConfig(max_tokens=1, temperature=0.0)

    def prefill(i):
        ids = [4 + (j * 7 + i) % 250 for j in range(TTFT_PROMPT)]
        slot = engine.add_request(ids, first)
        while slot in engine.prefilling_slots:
            engine.continue_prefill(slot)
        torch.cuda.synchronize()
        engine.pop_finished()

    prefill(0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            prefill(i + 1)
    split = host_split(torch, prof, reps)
    cuda = torch.autograd.DeviceType.CUDA
    kern = sorted((e for e in prof.events() if e.device_type == cuda),
                  key=lambda e: e.time_range.start)
    seg = [i for i, e in enumerate(kern) if "quantize_segments" in e.name]
    between = [e for a, b in zip(seg[0::2], seg[1::2])
               for e in kern[a + 2:b]]

    def ms(events):
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps
    split.update(
        segments={"traced": len(seg) / reps,
                  "ms": ms([kern[i] for i in seg])},
        between={"traced": len(between) / reps, "ms": ms(between),
                 "names": sorted({e.name[:48] for e in between})})
    return split


def segments(torch) -> int:
    """cudaMalloc calls PyTorch's caching allocator has made so far."""
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


class StepWriters:
    """The row writers' (#2, #6, #8) launches made inside decode and verify
    forwards, where the attention launch writes the rows: 0 on every
    layout but the kt mirror's. Registered among the counters as
    "step_writers" by `count_step_writers`."""
    launches = 0


def count_step_writers(counters) -> None:
    """Wrap forward_decode and forward_verify where the package calls them
    (the transformer module, whose scan forwards call them, the engine and
    speculative decoding), so that counters["step_writers"] adds the row
    writers' launches made inside them."""
    from deeppowers_tpu_torch.models import transformer
    from deeppowers_tpu_torch.runtime import engine, speculative
    writers = [counters[k] for k in ("scatter_rows", "scatter_pool_rows",
                                     "scatter_rows_stacked")]
    step = counters.setdefault("step_writers", StepWriters())

    def wrap(fn):
        def counted(*args, **kw):
            before = sum(w.launches for w in writers)
            try:
                return fn(*args, **kw)
            finally:
                step.launches += sum(w.launches for w in writers) - before
        return counted

    names = ("forward_decode", "forward_verify")
    originals = {n: getattr(transformer, n) for n in names}
    for mod in (transformer, engine, speculative):
        for n in names:
            if hasattr(mod, n):
                setattr(mod, n, wrap(originals[n]))


def cpu_references_take_kernel_functions() -> None:
    """The CPU references of this run's path phases compute the card
    kernels' functions, as they did before the CPU engine took JAX's XLA
    function for weight-only products (ops/matmul.py): the weight-only
    products of CPU tensors go to the kernels' plain versions
    (`dequant_matmul_plain`). Those two functions differ by a bf16 rounding
    of the weight, which 22 layers and an int4 KV store amplify to 9e-2 of
    the logits (rel L2, TinyLlama). CUDA tensors never take that route, so
    the card's side of every phase is unchanged. Likewise #3 on a CPU
    tensor computes the int8-dot function wherever the card takes #3's
    int8-dot variant (`cpu_attention_function`), not the JAX package's
    CPU function (bf16 dots), which parts from it by up to 5% of a row."""
    from deeppowers_tpu_torch.ops import matmul
    from deeppowers_tpu_torch.ops.kernels import decode_attention as da
    matmul.cpu_weight_only_function("kernel")
    da.cpu_attention_function("kernel")


def fold_key(attn: str, store: str, t: int = 1) -> str:
    """The launch count of the attention `attn` ("decode_attention",
    "decode_attention_paged") that also wrote the step's rows, for a store
    and window: decode_attention[int8+rows], [int8:t5+rows]."""
    return f"{attn}[{store}{'' if t == 1 else f':t{t}'}+rows]"


def reset_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "variant_launches"):
            fn.variant_launches.clear()


def read_counts(counters) -> dict:
    """{kernel: launches} and, for a kernel with store variants,
    {"kernel[variant]": launches} for each variant."""
    out = {}
    for name, fn in counters.items():
        out[name] = fn.launches
        for var, n in getattr(fn, "variant_launches", {}).items():
            out[f"{name}[{var}]"] = n
    return out


#: the stores whose K is int8 bytes: #3 takes its int8-dot variant there
I8_STORES = ("int8", "int4", "k8v4")
I8_NOTE = ("the main path takes #3's int8-dot variant here (the "
           "decode_attention_int8_dots rows); this kernel runs with "
           "DPT_ATTN_INT8=0")


def bf16_dot_launches(counts: dict, key: str) -> int:
    """A counter's launches in a run; for #3 over a store of I8_STORES
    ("decode_attention[k8v4+rows]"), those of its bf16-dot kernel: the
    wrapper counts the int8-dot variant's launches under the store's key
    too, and under "i8:" + that key ("decode_attention[i8:k8v4+rows]")."""
    kernel, _, var = key.partition("[")
    n = counts.get(key, 0)
    if kernel == "decode_attention" and \
            var.split(":")[0].split("+")[0].split("]")[0] in I8_STORES:
        n -= counts.get(f"{kernel}[i8:{var}", 0)
    return n


def check_variants(phase, launches, want, zero) -> None:
    """Every `want` kernel[variant] launched, every `zero` one did not."""
    missing = [k for k in want if launches.get(k, 0) <= 0]
    extra = [k for k in zero if launches.get(k, 0) > 0]
    if missing or extra:
        fail(f"{phase}: kernels that should launch but did not: {missing}; "
             f"kernels that should not launch but did: {extra} "
             f"({launches})")


def run_requests(torch, engine, prompts, max_tokens, counters, tok,
                 on_engine=None, profiled=False, temps=None,
                 admit_together=False):
    """Serve `prompts` as concurrent HTTP requests through the scheduler and
    the server, in-process: greedy, or at `temps[i]`. Every launch count is
    set to 0 just before and read just after. With `profiled`, the
    scheduler's thread runs under torch.profiler (`sched.prof`). With
    `admit_together`, the scheduler starts once every request is queued,
    so that one admission round prefills them all and the prefill groups
    (whose token counts pick an MoE layer's branch) do not depend on the
    requests' arrival times. Returns (results, launches, wall s,
    scheduler)."""
    from deeppowers_tpu_torch.serving.scheduler import Scheduler
    from deeppowers_tpu_torch.serving.server import APIServer

    cls = Scheduler
    if profiled:
        from torch.profiler import ProfilerActivity, profile

        class ProfiledScheduler(Scheduler):
            """Its loop runs under torch.profiler, which records only the
            thread that starts it."""

            def _loop(self):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    super()._loop()
                self.prof = prof

        cls = ProfiledScheduler
    sched = cls(engine, encode=tok.encode, decode=tok.decode)
    server = APIServer(sched, host="127.0.0.1", port=0)
    reset_counts(counters)
    if not admit_together:
        sched.start()
    server.start()
    results = [None] * len(prompts)
    errors = []

    def one(i):
        try:
            results[i] = post(server.port, {
                "prompt": prompts[i], "max_tokens": max_tokens,
                "temperature": temps[i] if temps else 0.0}, timeout=240.0)
        except Exception as e:           # reported below, fails the run
            errors.append(f"request {i}: {e!r}")

    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        if admit_together:
            deadline = time.perf_counter() + 60.0
            while len(sched.queue) < len(prompts) and \
                    time.perf_counter() < deadline:
                time.sleep(0.005)
            sched.start()
        for t in threads:
            t.join(250)
        wall = time.perf_counter() - t0
        hung = [t.name for t in threads if t.is_alive()]
    finally:
        server.stop()
        sched.stop()
    launches = read_counts(counters)
    if hung or errors:
        fail(f"serve: requests failed or hung: {errors} {hung}")
    if sched.last_error is not None or sched.recovered_requests:
        fail(f"serve: the engine failed during serving:\n{sched.last_error}")
    alive = [t.name for t in threading.enumerate()
             if t.name in ("deeppowers-http", "deeppowers-scheduler")]
    if alive:
        fail(f"serve: threads still alive after stop: {alive}")
    for i, r in enumerate(results):
        want = len(tok.encode(prompts[i]))
        if r["usage"]["prompt_tokens"] != want:
            fail(f"request {i}: prompt tokens {r['usage']['prompt_tokens']}")
        if r["stop_reason"] == "max_tokens":
            if r["usage"]["completion_tokens"] != max_tokens:
                fail(f"request {i}: {r['usage']} for max_tokens")
        elif r["stop_reason"] != "eos" or r["tokens"][-1] != tok.eos_token_id:
            fail(f"request {i}: stop_reason {r['stop_reason']}")
    return results, launches, wall, sched


def summary(results, wall, sched, launches):
    gen = sum(r["usage"]["completion_tokens"] for r in results)
    ttft = sorted(r["timing"]["ttft_ms"] for r in results)
    step = sched.monitor.latency("decode_step")
    return {"wall_s": wall, "tokens": gen, "tok_per_s": gen / wall,
            "ttft_ms_p50": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
            "ttft_ms": [r["timing"]["ttft_ms"] for r in results],
            "decode_step_ms_p50": step.p50_ms, "steps": step.count,
            "stop_reasons": [r["stop_reason"] for r in results],
            "launches": launches}


def serve(torch, params, cfg, counters, kv_cache_dtype="bf16",
          passes=True):
    """Phase 6 (and 8 with int8 KV): contiguous KV, default
    prefill_chunk_size 512, so the 600- and 900-byte prompts prefill in
    chunks and the 450-byte one takes the flash kernel in bucket 512. The
    store's variants of #2 and #3 must launch, no other store's. With
    `passes`, also each prompt's prefill alone and the traffic twice more
    (warm, and under the profiler)."""
    from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
    from deeppowers_tpu_torch.quant.kvquant import KV_CACHE_DTYPES
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    engine = InferenceEngine(
        params, cfg, device="cuda", eos_token_id=tok.eos_token_id,
        kv_cache_dtype=kv_cache_dtype,
        runtime=RuntimeConfig(max_batch_size=8, max_seq_len=1024,
                              prefill_buckets=(64, 128, 256, 512, 1024),
                              scan_layers=False))
    # warm-up outside the measured run: first launches and allocator
    engine.generate(tok.encode("warm up"), GenerationConfig(
        max_tokens=2, temperature=0.0))
    prompts = [prompt_text(n, i) for i, n in enumerate(PROMPT_BYTES)]
    seg0 = segments(torch)
    results, launches, wall, sched = run_requests(
        torch, engine, prompts, MAX_TOKENS, counters, tok)
    seg1 = segments(torch)
    # a quantized store's prompt rows go through #2; a bf16 prompt is
    # written by indexing, and every decode row through #3's fold
    own = [f"decode_attention[{kv_cache_dtype}]",
           fold_key("decode_attention", kv_cache_dtype)] + (
        [f"scatter_rows[{kv_cache_dtype}]"] + i8_keys(kv_cache_dtype)
        if kv_cache_dtype != "bf16" else [])
    check_variants(
        f"serve[{kv_cache_dtype}]", launches,
        ["dequant_matmul", "flash_attention_prefill",
         "flash_attention_chunk"] + ROUTES_ON + own,
        ["scatter_pool_rows", "decode_attention_paged", "step_writers"]
        + [f"{k}[{v}]" for k in ("scatter_rows", "decode_attention")
           for v in KV_CACHE_DTYPES if v != kv_cache_dtype])
    out = summary(results, wall, sched, launches)
    out["token_ids"] = [r["tokens"] for r in results]
    out["segments"] = seg1 - seg0
    out["kv_bytes"] = engine.kv_nbytes
    # the profiler's first use in the process stays on the main thread
    out["profile"] = profile_decode(torch, engine, tok)
    if kv_cache_dtype != "bf16":
        out["profile_bf16_dots"] = profile_bf16_dots(
            torch, engine, tok, f"serve[{kv_cache_dtype}]")
    if not passes:
        return out
    out["prefill"] = profile_prefill(torch, engine, tok, prompts)
    seg1 = segments(torch)
    # the same traffic again on the warm engine: the difference from the
    # first pass is what that pass paid for first use of its shapes
    # (kernel loads, allocator growth), not for its work
    res2, _, wall2, sched2 = run_requests(torch, engine, prompts,
                                          MAX_TOKENS, counters, tok)
    warm = summary(res2, wall2, sched2, {})
    out["warm"] = {k: warm[k] for k in ("ttft_ms_p50", "ttft_ms_max",
                                        "ttft_ms", "decode_step_ms_p50")}
    out["warm"]["segments"] = segments(torch) - seg1
    # and once more with the scheduler's thread under the profiler: the
    # host split of the whole served run (every prefill and decode step)
    res3, _, wall3, sched3 = run_requests(torch, engine, prompts,
                                          MAX_TOKENS, counters, tok,
                                          profiled=True)
    prof = summary(res3, wall3, sched3, {})
    out["served_split"] = dict(
        host_split(torch, sched3.prof, 1), ttft_ms_p50=prof["ttft_ms_p50"],
        decode_step_ms_p50=prof["decode_step_ms_p50"], steps=prof["steps"])
    return out


# phase 7: 8 requests share a 300-byte system prompt (two full pages of
# 128 tokens), two are long, two short; 96 tokens each
SYSTEM_PROMPT = prompt_text(300, 99)
SUFFIX_BYTES = (20, 45, 70, 95, 120, 145, 170, 200)
PAGED_TOTAL_PAGES = 16     # full reservation would take 8 * 8 + 1 = 65
PAGED_MAX_TOKENS = 96


def paged_prompts():
    shared = [SYSTEM_PROMPT + prompt_text(n, 200 + i)
              for i, n in enumerate(SUFFIX_BYTES)]
    return shared + [prompt_text(700, 300), prompt_text(900, 301),
                     prompt_text(16, 302), prompt_text(40, 303)]


# spec_paged_serve's lazy slack: with K = 4 (budgets K rows longer, growth
# 2K + 2 rows ahead) the 16-page pool preempted in 17 of 18 arrival orders
# tried on the CPU at a slack of 64 rows, in all 18 (at least twice) at 32
SPEC_PAGED_SLACK = 32


def paged_engine(params, cfg, device, eos_token_id, kv_cache_dtype="bf16",
                 spec_k=0, slack=64):
    """Phase 7's engine (and 9's with k8v4 KV): 8 slots of 1024 tokens over
    PAGED_TOTAL_PAGES pages of 128, lazy reservation (`slack` rows), prefix
    cache, chunks of 512; with `spec_k`, prompt-lookup speculation of that
    many drafts (n-gram 3). Its continue_prefill counts chunks per request
    id in `engine.chunks`."""
    import collections
    from deeppowers_tpu_torch.config import RuntimeConfig
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine

    engine = InferenceEngine(
        params, cfg, device=device, eos_token_id=eos_token_id,
        kv_layout="paged", kv_total_pages=PAGED_TOTAL_PAGES,
        kv_cache_dtype=kv_cache_dtype,
        runtime=RuntimeConfig(max_batch_size=8, max_seq_len=1024,
                              prefill_buckets=(64, 128, 256, 512, 1024),
                              kv_page_size=128, kv_reserve="lazy",
                              kv_lazy_slack=slack, enable_prefix_cache=True,
                              prefill_chunk_size=512,
                              speculative_tokens=spec_k,
                              speculative_ngram=3))
    engine.chunks = collections.Counter()
    real = engine.continue_prefill

    def counted(slot):
        engine.chunks[engine._slots[slot].request_id] += 1
        return real(slot)

    engine.continue_prefill = counted
    return engine


def serve_paged(torch, params, cfg, counters, kv_cache_dtype="bf16",
                spec_k=0):
    """Phase 7 (and 9 with k8v4 KV, and spec_paged_serve[k8v4] with
    `spec_k` drafts): oversubscribed serving with shared system prompts.
    The store's variants of #5 (its verify variant under speculation, and
    then not its one-token one) and #6 must launch, no other store's and no
    contiguous-layout kernel."""
    from deeppowers_tpu_torch.config import GenerationConfig
    from deeppowers_tpu_torch.quant.kvquant import KV_CACHE_DTYPES
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    engine = paged_engine(params, cfg, "cuda", tok.eos_token_id,
                          kv_cache_dtype, spec_k,
                          SPEC_PAGED_SLACK if spec_k else 64)
    engine.generate(tok.encode("warm up"), GenerationConfig(
        max_tokens=2, temperature=0.0))
    engine.chunks.clear()
    hits0 = engine.prefix_cache_stats["hits"]
    results, launches, wall, sched = run_requests(
        torch, engine, paged_prompts(), PAGED_MAX_TOKENS, counters, tok)
    out = summary(results, wall, sched, launches)
    out.update(preempted=sched.preempted_requests,
               prefix=engine.prefix_cache_stats,
               hits=engine.prefix_cache_stats["hits"] - hits0,
               max_chunks=max(engine.chunks.values(), default=0),
               chunked_requests=len(engine.chunks))
    if out["preempted"] < 1:
        fail("paged serve: no request was preempted")
    if out["hits"] < 1:
        fail("paged serve: no prefix-cache hit")
    if out["max_chunks"] < 2:
        fail("paged serve: no request went through 2 or more chunks")
    attn = f"decode_attention_paged[{kv_cache_dtype}]"
    verify = f"decode_attention_paged[{kv_cache_dtype}:t{spec_k + 1}]"
    # a quantized store's chunks go through #6; bf16 chunks are written by
    # indexing, and every decode and verify row through #5's fold
    check_variants(
        f"paged serve[{kv_cache_dtype}]", launches,
        ([f"scatter_pool_rows[{kv_cache_dtype}]"]
         if kv_cache_dtype != "bf16" else [])
        + [verify if spec_k else attn,
           fold_key("decode_attention_paged", kv_cache_dtype, spec_k + 1),
           "flash_attention_chunk"] + ROUTES_ON,
        ["scatter_rows", "decode_attention", "step_writers"]
        + ([attn] if spec_k else [])
        + [f"{k}[{v}]" for k in ("scatter_pool_rows", "decode_attention_paged")
           for v in KV_CACHE_DTYPES if v != kv_cache_dtype])
    out["kv_bytes"] = engine.kv_nbytes
    if spec_k:
        out["speculative"] = sched.stats()["speculative"]
    # a lazy reservation holds prompt + 64 + K rows: 8 prompts of 56 bytes
    # take one page of 128 each, as 64 bytes do without speculation
    out["profile"] = profile_decode(torch, engine, tok,
                                    tokens_per_step=spec_k + 1,
                                    prompt_bytes=64 - 2 * spec_k)
    return out


SPEC_TEMPERATURE = 0.8        # spec_serve's one sampled request


def serve_spec(torch, params, cfg, counters, plain_tokens):
    """spec_serve[tinyllama]: the scheduler and the HTTP server over a
    contiguous bf16 cache with prompt-lookup speculation (K = 4, n-gram 3):
    serve's 8 greedy requests and one more at temperature 0.8. The bf16
    verify variant of #3 and #2 must launch, the one-token #3 and the paged
    kernels must not. Also the share of the greedy requests' tokens equal,
    position by position, to serve's stream of the same prompts without
    speculation on the card (printed, not gated: bf16 at M = 40 rounds
    otherwise than at M = 8, and a flipped near-tie changes the rest of a
    stream), and a profiled step."""
    from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    engine = InferenceEngine(
        params, cfg, device="cuda", eos_token_id=tok.eos_token_id,
        runtime=RuntimeConfig(max_batch_size=8, max_seq_len=1024,
                              prefill_buckets=(64, 128, 256, 512, 1024),
                              speculative_tokens=SPEC_K,
                              speculative_ngram=3, scan_layers=False))
    engine.generate(tok.encode("warm up"), GenerationConfig(
        max_tokens=2, temperature=0.0))
    prompts = [prompt_text(n, i) for i, n in enumerate(PROMPT_BYTES)]
    prompts.append(prompt_text(200, len(PROMPT_BYTES)))
    temps = [0.0] * len(PROMPT_BYTES) + [SPEC_TEMPERATURE]
    results, launches, wall, sched = run_requests(
        torch, engine, prompts, MAX_TOKENS, counters, tok, temps=temps)
    check_variants(
        "spec_serve", launches,
        [f"decode_attention[bf16:t{SPEC_T}]",
         fold_key("decode_attention", "bf16", SPEC_T),
         "dequant_matmul", "flash_attention_prefill",
         "flash_attention_chunk"] + ROUTES_ON,
        ["decode_attention[bf16]", "scatter_pool_rows",
         "decode_attention_paged", "step_writers"])
    out = summary(results, wall, sched, launches)
    out["speculative"] = sched.stats()["speculative"]
    out["spec_mean_accepted"] = engine.spec_mean_accepted
    same = total = 0
    for r, want in zip(results, plain_tokens):
        got = r["tokens"]
        total += len(got)
        same += sum(a == b for a, b in zip(got, want))
    out["equal_to_plain"] = same / max(total, 1)
    out["kv_bytes"] = engine.kv_nbytes
    out["profile"] = profile_decode(torch, engine, tok,
                                    tokens_per_step=SPEC_T)
    return out


def serve_scan(torch, params, cfg, counters):
    """scan_serve: serve's traffic (TinyLlama int8 weights, bf16 KV) at the
    default scan_layers "auto", which stacks TinyLlama's 22 layers, with
    the prefix cache: the 8 requests (the 600- and 900-byte prompts in two
    chunks), then the same 8 again, whose prompts now match retired slots
    (prefix copies across all layers of the stacked cache, then chunks from
    the match). Every cache row goes through #8 and none through #2. Then
    each prompt's prefill alone on a warm scan engine without the prefix
    cache (as serve's on the unrolled one), and one greedy request with
    prompt-lookup speculation (K = 4) on a scan engine: the bf16 verify
    variant of #3 and #8 at 5 rows a slot."""
    from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    rt = dict(max_batch_size=8, max_seq_len=1024,
              prefill_buckets=(64, 128, 256, 512, 1024))
    engine = InferenceEngine(params, cfg, device="cuda",
                             eos_token_id=tok.eos_token_id,
                             runtime=RuntimeConfig(enable_prefix_cache=True,
                                                   **rt))
    if not engine.scan_layers:
        fail("scan_serve: scan_layers='auto' did not stack TinyLlama")
    engine.generate(tok.encode("warm up"), GenerationConfig(
        max_tokens=2, temperature=0.0))
    prompts = [prompt_text(n, i) for i, n in enumerate(PROMPT_BYTES)]
    results, launches, wall, sched = run_requests(
        torch, engine, prompts, MAX_TOKENS, counters, tok)
    res2, launches2, wall2, sched2 = run_requests(
        torch, engine, prompts, MAX_TOKENS, counters, tok)
    on = ["scatter_rows_stacked[bf16]", "decode_attention[bf16]",
          fold_key("decode_attention", "bf16"),
          "dequant_matmul", "flash_attention_prefill",
          "stage_activations"] + ROUTES_ON
    off = ["scatter_rows", "scatter_pool_rows", "decode_attention_paged",
           "step_writers"]
    check_variants("scan_serve", launches, on + ["flash_attention_chunk"],
                   off)
    # the second pass prefills from its prefix matches in chunks; a prompt
    # takes #4 whole only when another request took its retired slot first
    # (arrival order decides), so #4 is required through its chunk entry
    check_variants("scan_serve (second pass)", launches2,
                   [k for k in on if k != "flash_attention_prefill"]
                   + ["flash_attention_chunk"], off)
    prefix = engine.prefix_cache_stats
    if prefix["hits"] < 1:
        fail(f"scan_serve: no prefix copy in the second pass {prefix}")
    out = summary(results, wall, sched, launches)
    out["prefix"] = prefix
    again = summary(res2, wall2, sched2, {})
    out["second_pass"] = {k: again[k] for k in (
        "tok_per_s", "ttft_ms_p50", "ttft_ms_max", "decode_step_ms_p50")}
    out["kv_bytes"] = engine.kv_nbytes
    out["profile"] = profile_decode(torch, engine, tok)
    del engine
    plain = InferenceEngine(params, cfg, device="cuda",
                            eos_token_id=tok.eos_token_id,
                            runtime=RuntimeConfig(**rt))
    plain.generate(tok.encode("warm up"), GenerationConfig(
        max_tokens=2, temperature=0.0))
    out["prefill"] = profile_prefill(torch, plain, tok, prompts)
    del plain
    spec = InferenceEngine(params, cfg, device="cuda",
                           eos_token_id=tok.eos_token_id,
                           runtime=RuntimeConfig(speculative_tokens=SPEC_K,
                                                 speculative_ngram=3, **rt))
    reset_counts(counters)
    r = spec.generate(tok.encode(prompt_text(200, len(PROMPT_BYTES))),
                      GenerationConfig(max_tokens=MAX_TOKENS,
                                       temperature=0.0))
    spec.synchronize()
    sl = read_counts(counters)
    check_variants("scan_serve (speculative request)", sl,
                   [f"decode_attention[bf16:t{SPEC_T}]",
                    fold_key("decode_attention", "bf16", SPEC_T),
                    "scatter_rows_stacked[bf16]"] + ROUTES_ON,
                   ["scatter_rows", "decode_attention[bf16]", "step_writers"])
    out["speculative"] = {"scan": spec.scan_layers,
                          "tokens": len(r.token_ids),
                          "spec_steps": spec.spec_steps,
                          "window_mean": spec.spec_window_mean,
                          "launches": sl}
    return out


def draft_share(torch, T, engine, tok, steps: int = 5) -> dict:
    """The draft model's K forwards against a whole speculative step, on 8
    greedy slots after two warm steps: each step is preceded by the same
    K draft decode steps alone (their rows are rewritten by the step's own
    draft), both synchronized and timed by the host clock."""
    from deeppowers_tpu_torch.config import GenerationConfig
    for i in range(engine.num_slots):
        engine.add_request(tok.encode(prompt_text(64, i)), GenerationConfig(
            max_tokens=(steps + 4) * SPEC_T, temperature=0.0))
    engine.step()
    engine.step()
    dparams, dcfg = engine._draft
    draft, whole = 0.0, 0.0
    for _ in range(steps):
        st = engine.state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            x, lens = st.tokens, st.lengths
            for _ in range(SPEC_K):
                lg, _ = T.forward_decode(dparams, dcfg, x,
                                         engine._draft_caches, lens,
                                         dtype=engine.act_dtype,
                                         active=st.active)
                x, lens = lg.argmax(-1).to(torch.int32), lens + 1
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        draft += t1 - t0
        whole += time.perf_counter() - t1
    while engine.active_requests:
        engine.step()
    engine.pop_finished()
    return {"draft_ms": draft * 1e3 / steps, "step_ms": whole * 1e3 / steps,
            "draft_share": draft / whole}


SELF_DRAFT_MIN = 3.0      # mean accepted tokens a window, of SPEC_T


def serve_llama2_spec(torch, T, counters, l7_params, tiny_params, tiny_cfg):
    """spec_serve[llama2-7b+draft]: Llama-2-7B W4A8 g128 + k8v4 (serve
    [llama2-7b]'s weights) verifying K = 4 drafts of TinyLlama-1.1B int8
    (the main path's weights; the vocabulary, 32000, is shared), serve's
    traffic once through the scheduler and the HTTP server. The k8v4
    verify variant of #3 (target) and its one-token variant (draft), #1's
    W4A8 g128 (target) and int8 (draft) variants must launch, no paged
    kernel. Random weights make the two models disagree, so a window
    accepts about one token. Then the draft's share of a step, a profiled
    step, and the self-draft check: TinyLlama drafting for itself,
    greedy, must accept at least SELF_DRAFT_MIN of 5 tokens a window."""
    from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
    from deeppowers_tpu_torch.models.presets import LLAMA2_7B as cfg
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    rt = RuntimeConfig(max_batch_size=8, max_seq_len=1024,
                       prefill_buckets=(64, 128, 256, 512, 1024),
                       speculative_tokens=SPEC_K, scan_layers=False)
    engine = InferenceEngine(l7_params, cfg, device="cuda",
                             eos_token_id=tok.eos_token_id,
                             kv_cache_dtype=LLAMA2_KV, runtime=rt,
                             draft_params=tiny_params, draft_cfg=tiny_cfg)
    engine.generate(tok.encode("warm up"), GenerationConfig(
        max_tokens=2, temperature=0.0))
    prompts = [prompt_text(n, i) for i, n in enumerate(PROMPT_BYTES)]
    results, launches, wall, sched = run_requests(
        torch, engine, prompts, MAX_TOKENS, counters, tok)
    check_variants(
        "spec_serve[llama2-7b+draft]", launches,
        ROUTES_ON + [f"decode_attention[{LLAMA2_KV}:t{SPEC_T}]",
         f"decode_attention[{LLAMA2_KV}]", "dequant_matmul[w4a8g]",
         "dequant_matmul[w8]", "quantize_activations",
         f"scatter_rows[{LLAMA2_KV}]",
         fold_key("decode_attention", LLAMA2_KV, SPEC_T),
         fold_key("decode_attention", LLAMA2_KV)],
        ["scatter_pool_rows", "decode_attention_paged",
         f"decode_attention[bf16:t{SPEC_T}]", "decode_attention[bf16]",
         "step_writers"])
    out = summary(results, wall, sched, launches)
    out["speculative"] = sched.stats()["speculative"]
    out["spec_mean_accepted"] = engine.spec_mean_accepted
    out["cost_ratio"] = engine._spec_cost_ratio
    out["kv_bytes"] = engine.kv_nbytes
    out["draft"] = draft_share(torch, T, engine, tok)
    out["profile"] = profile_decode(torch, engine, tok,
                                    tokens_per_step=SPEC_T)
    del engine
    torch.cuda.empty_cache()
    own = InferenceEngine(tiny_params, tiny_cfg, device="cuda",
                          eos_token_id=tok.eos_token_id, runtime=rt,
                          draft_params=tiny_params, draft_cfg=tiny_cfg)
    own.generate_batch([tok.encode(p) for p in prompts], GenerationConfig(
        max_tokens=MAX_TOKENS, temperature=0.0))
    out["self_draft"] = {"window_mean": own.spec_window_mean,
                         "accept_hist": own.spec_accept_hist.tolist()}
    if own.spec_window_mean < SELF_DRAFT_MIN:
        fail(f"spec_serve[llama2-7b+draft]: TinyLlama drafting for itself "
             f"accepts {own.spec_window_mean:.3f} tokens a window, below "
             f"{SELF_DRAFT_MIN} of {SPEC_T} ({own.spec_accept_hist})")
    return out


# ---------------------------------------------------------------------------
# The dispatch phase: every decode dispatch a replayed CUDA graph
# (runtime/graphs.py), held against the eager step, through the engine

def clone_tree(torch, x, memo):
    """A copy of every tensor in x (dataclasses, tuples, lists), a tensor
    shared inside x (the paged layers' one table) copied once."""
    import dataclasses
    if isinstance(x, torch.Tensor):
        if id(x) not in memo:
            memo[id(x)] = x.clone()
        return memo[id(x)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: clone_tree(torch, getattr(x, f.name), memo)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(torch, v, memo) for v in x)
    if isinstance(x, dict):
        return {k: clone_tree(torch, v, memo) for k, v in x.items()}
    return x


def tensors_of(torch, x) -> list:
    """Every tensor in x, in `clone_tree`'s order."""
    import dataclasses
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x) if f.init
                for t in tensors_of(torch, getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors_of(torch, v)]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in tensors_of(torch, x[k])]
    return []


def engine_buffers(engine) -> dict:
    """What a decode step reads and writes: state, caches, draft caches,
    history, draft tail."""
    return {"state": engine.state, "caches": engine.caches,
            "draft_caches": engine._draft_caches,
            "history": engine._history, "tail": engine._draft_tail}


def graph_against_eager(torch, engine, name: str) -> dict:
    """One replay of the variant of the engine's next decode step against
    one eager call of the same function (`InferenceEngine._run_step`, the
    graph's plain version) on copies of the state, the caches, the history,
    the draft tail and the output rows, from the same generator state:
    emitted tokens, logprobs, state and every cache byte bit for bit, and
    every cache tensor at the address it had. The engine's own step is
    then one step ahead of its harvests: the caller drops it."""
    from deeppowers_tpu_torch.runtime.engine import clone_state
    key = engine._variant(True)
    live = engine_buffers(engine)
    ptrs = [t.data_ptr() for t in tensors_of(torch, live)]
    copy = clone_tree(torch, live, {})
    copy["state"] = clone_state(engine.state)
    out, row = torch.zeros_like(engine._out), torch.zeros_like(engine._row)
    rng = engine._rng.get_state()
    saved = engine.caches, engine._draft_caches
    engine.caches, engine._draft_caches = copy["caches"], copy[
        "draft_caches"]
    try:
        with torch.no_grad():
            engine._run_step(key, copy["state"], out, row, copy["history"],
                             copy["tail"])
    finally:
        engine.caches, engine._draft_caches = saved
    engine._rng.set_state(rng)
    cap0 = engine._graphs.capture_s
    engine._row.zero_()
    engine._out.zero_()
    with torch.no_grad():
        engine._replay(key, 1)
    torch.cuda.synchronize()
    got = tensors_of(torch, engine_buffers(engine))
    want = tensors_of(torch, copy)
    moved = sum(a != t.data_ptr() for a, t in zip(ptrs, got))
    bad = sum(not same_bits(torch, a, b) for a, b in zip(got, want))
    rows_ok = same_bits(torch, engine._out, out)
    if moved or bad or not rows_ok or len(got) != len(want):
        fail(f"dispatch[{name}]: the graph of variant {key} against the "
             f"eager step: {bad} of {len(got)} tensors differ, {moved} "
             f"moved, output rows equal {rows_ok}")
    return {"variant": list(key), "tensors": len(got),
            "bytes": sum(t.numel() * t.element_size() for t in got),
            "capture_s": round(engine._graphs.capture_s - cap0, 3)}


def dispatch_engine(params, cfg, eos, *, kv="bf16", layout="contiguous",
                    scan=False, pages=None, draft=None, **rt):
    """serve's engine (8 slots of 1024 tokens), with runtime fields `rt`."""
    from deeppowers_tpu_torch.config import RuntimeConfig
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine
    kw = dict(max_batch_size=8, max_seq_len=1024,
              prefill_buckets=(64, 128, 256, 512, 1024), scan_layers=scan)
    kw.update(rt)
    extra = {} if draft is None else dict(draft_params=draft[0],
                                          draft_cfg=draft[1])
    return InferenceEngine(params, cfg, device="cuda", eos_token_id=eos,
                           kv_cache_dtype=kv, kv_layout=layout,
                           kv_total_pages=pages, runtime=RuntimeConfig(**kw),
                           **extra)


def graph_check(torch, name, make, temperature=0.0) -> dict:
    """`graph_against_eager` on a fresh engine from `make()` holding serve's
    8 prompts (a decode step of 8 active slots)."""
    from deeppowers_tpu_torch.config import GenerationConfig
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    engine = make()
    for i, n in enumerate(PROMPT_BYTES):
        engine.add_request(tok.encode(prompt_text(n, i)), GenerationConfig(
            max_tokens=MAX_TOKENS, temperature=temperature,
            do_sample=temperature > 0, seed=SEED + i))
    out = graph_against_eager(torch, engine, name)
    engine.reset()
    return out


def served_tokens(engine, tok, prompts, max_tokens, temperature=0.0):
    """Each prompt's tokens through `generate_batch` (all slots at once)."""
    from deeppowers_tpu_torch.config import GenerationConfig
    res = engine.generate_batch(
        [tok.encode(p) for p in prompts], GenerationConfig(
            max_tokens=max_tokens, temperature=temperature,
            do_sample=temperature > 0, seed=SEED))
    return [r.token_ids for r in res]


DISPATCH_RUNTIMES = {"N=1 unpipelined": dict(pipelined_dispatch=False),
                     "N=1 pipelined": {}, "N=4": dict(
                         decode_steps_per_dispatch=4),
                     "auto": dict(decode_steps_per_dispatch=0)}


def greedy_streams(torch, name, make, runtimes) -> dict:
    """serve's 8 prompts, 32 greedy tokens each, through one fresh engine
    a runtime (`make(**fields)`): every runtime's tokens must be the
    first's. Returns {runtime: (dispatches, transfers, depth)}."""
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    prompts = [prompt_text(n, i) for i, n in enumerate(PROMPT_BYTES)]
    ref, out = None, {}
    for label in runtimes:
        engine = make(**DISPATCH_RUNTIMES[label])
        got = served_tokens(engine, tok, prompts, MAX_TOKENS)
        if ref is None:
            ref = got
        elif got != ref:
            diff = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
            fail(f"dispatch[{name}]: greedy streams at {label} differ from "
                 f"{runtimes[0]} in requests {diff}")
        out[label] = (engine.dispatch_count, engine.transfer_count,
                      engine._steps_per_dispatch)
        del engine
    return out


def lazy_preemption_streams(torch, params, cfg) -> dict:
    """Lazy paging that must preempt, at N = 1 and N = 4, through the
    engine: 2 slots over a 5-page pool of 128 rows, two requests of 300
    tokens; the younger is preempted (sooner at N = 4, which grows 4 rows
    ahead) and its tokens until then are a prefix of the other depth's;
    the older completes with the same tokens at both depths."""
    from deeppowers_tpu_torch.config import GenerationConfig
    done = {}
    for n in (1, 4):
        engine = dispatch_engine(params, cfg, None, layout="paged", pages=5,
                                 max_batch_size=2, kv_page_size=128,
                                 kv_reserve="lazy", kv_lazy_slack=16,
                                 decode_steps_per_dispatch=n)
        g = GenerationConfig(max_tokens=300, temperature=0.0)
        engine.add_request([1, 2, 3, 4], g, request_id="old")
        engine.add_request([5, 6, 7, 8], g, request_id="young")
        out = {}
        for _ in range(1000):
            engine.step()
            for r in engine.pop_finished():
                out[r.request_id] = (r.stop_reason, r.token_ids)
            if engine.active_requests == 0:
                break
        done[n] = out
        del engine
    (r1, o1), (r4, o4) = done[1]["old"], done[4]["old"]
    (y1, t1), (y4, t4) = done[1]["young"], done[4]["young"]
    short, long_ = sorted((t1, t4), key=len)
    if (r1, o1) != (r4, o4) or {y1, y4} != {"preempted"} or \
            long_[:len(short)] != short:
        fail(f"dispatch[lazy]: N = 4 against N = 1: old {r4} "
             f"{len(o4)} tokens vs {r1} {len(o1)} (equal {o1 == o4}); "
             f"young {y4} vs {y1}")
    return {"old_tokens": len(o1), "young_tokens": [len(t1), len(t4)]}


def sampled_graphs(torch, params, cfg, eos) -> dict:
    """A seeded engine's sampled streams (temperature 1, serve's prompts)
    are the same in two fresh engines; and two replays of the sampled
    variant from the same state draw different tokens (the generator is
    registered with the graph, so each replay advances it)."""
    from deeppowers_tpu_torch.config import GenerationConfig
    from deeppowers_tpu_torch.runtime.engine import clone_state
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    prompts = [prompt_text(n, i) for i, n in enumerate(PROMPT_BYTES)]
    runs = [served_tokens(dispatch_engine(params, cfg, eos), tok, prompts,
                          MAX_TOKENS, temperature=1.0) for _ in range(2)]
    if runs[0] != runs[1]:
        fail("dispatch[sampled]: two seeded engines sampled different "
             "streams")
    engine = dispatch_engine(params, cfg, eos)
    for i, p in enumerate(prompts):
        engine.add_request(tok.encode(p), GenerationConfig(
            max_tokens=MAX_TOKENS, temperature=1.0, seed=SEED + i))
    key = engine._variant(True)
    start = clone_state(engine.state)
    drawn = []
    for _ in range(2):
        for a, b in zip(tensors_of(torch, engine.state),
                        tensors_of(torch, start)):
            a.copy_(b)
        engine._row.zero_()
        with torch.no_grad():
            engine._replay(key, 1)
        drawn.append(engine._out[0].clone())
    n = len(prompts)
    same = int((drawn[0][:n] == drawn[1][:n]).sum())
    if key[2] is not True or same == n:
        fail(f"dispatch[sampled]: variant {key}: two replays from one state "
             f"drew the same {same} tokens")
    return {"variant": list(key), "same_tokens": same,
            "distinct_streams": len({tuple(t) for t in runs[0]})}


def dispatch_profile(torch, engine, tok, settle: bool = False) -> dict:
    """`profile_decode` of the engine's served step, a token of each slot
    a row: wall, device busy, idle share, kernels, host API calls and graph
    launches a dispatch and a token; the graphs' capture seconds and pool
    bytes. With `settle`, the auto depth settles first (8 requests of 160
    tokens)."""
    from deeppowers_tpu_torch.config import GenerationConfig
    if settle:
        engine.generate_batch(
            [tok.encode(prompt_text(64, i)) for i in range(engine.num_slots)],
            GenerationConfig(max_tokens=160, temperature=0.0))
        if not engine._auto_done:
            fail("dispatch: the auto depth did not settle in 160 tokens")
    n = engine._steps_per_dispatch
    pr = profile_decode(torch, engine, tok, tokens_per_step=n)
    out = {"depth": n, "pipelined": bool(engine.runtime.pipelined_dispatch),
           "wall_ms": pr["wall_ms"], "busy_ms": pr["busy_ms"],
           "idle_share": pr["idle_share"], "kernels": pr["kernels"],
           "launches": pr["launches"], "graph_launches":
           pr["graph_launches"], "api_calls": pr["api_calls"],
           "ops": pr["ops"], "syncs": pr["syncs"],
           "per_token": {k: pr[k] / n for k in ("wall_ms", "busy_ms",
                                                "kernels", "api_calls")},
           "quantizer": pr["quantizer"], "top": pr["top"]}
    g = engine._graphs
    out.update(variants=[list(k) for k in g.variants],
               capture_s=round(g.capture_s, 3), pool_bytes=g.pool_bytes())
    return out


def dispatch_model(torch, name, params, cfg, kv, scan=False) -> dict:
    """A model's dispatch checks: graph against eager, greedy streams at
    N = 1 pipelined and auto, and the profiled step at N = 1 (graph) and
    at the auto depth."""
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer()

    def make(**rt):
        return dispatch_engine(params, cfg, tok.eos_token_id, kv=kv,
                               scan=scan, **rt)

    out = {"graph": graph_check(torch, name, make)}
    out["streams"] = greedy_streams(torch, name, make,
                                    ["N=1 pipelined", "auto"])
    out["profile_n1"] = dispatch_profile(torch, make(), tok)
    out["profile_auto"] = dispatch_profile(
        torch, make(decode_steps_per_dispatch=0), tok, settle=True)
    torch.cuda.empty_cache()
    return out


def dispatch_phase(torch, params, cfg) -> dict:
    """The dispatch phase on TinyLlama int8 per-channel: graph against
    eager on the contiguous and the paged layout, with prompt-lookup and
    draft speculation (the model as its own draft) and a sampled variant;
    greedy streams at N = 1 unpipelined and pipelined, N = 4 and auto;
    lazy paging with preemption at N = 4; the sampled graphs; the profiled
    step at N = 1 and auto."""
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    eos = tok.eos_token_id

    def make(**kw):
        return lambda **rt: dispatch_engine(params, cfg, eos, **kw, **rt)

    out = {"graph": {
        "contiguous": graph_check(torch, "contiguous", make()),
        "paged": graph_check(torch, "paged", make(layout="paged")),
        "lookup": graph_check(torch, "lookup", make(
            speculative_tokens=SPEC_K, speculative_ngram=3)),
        "draft": graph_check(torch, "draft", make(
            draft=(params, cfg), speculative_tokens=SPEC_K)),
        "sampled": graph_check(torch, "sampled", make(), temperature=1.0)}}
    out["streams"] = greedy_streams(torch, "tinyllama", make(),
                                    list(DISPATCH_RUNTIMES))
    out["lazy"] = lazy_preemption_streams(torch, params, cfg)
    out["sampled"] = sampled_graphs(torch, params, cfg, eos)
    out["profile_n1"] = dispatch_profile(torch, make()(), tok)
    out["profile_auto"] = dispatch_profile(
        torch, make()(decode_steps_per_dispatch=0), tok, settle=True)
    torch.cuda.empty_cache()
    return out


DISPATCH_MS_STEPS = 50


def dispatch_ms(torch) -> dict:
    """The served step() at the default runtime of the package on the
    path, for a paired run of two checkouts: TinyLlama int8 and the 7B
    W4A8 g128 + k8v4, 8 slots of 64-byte prompts, 10 warm steps, then
    DISPATCH_MS_STEPS steps timed one by one (each one token a slot at
    N = 1, pipelined where the checkout pipelines)."""
    from deeppowers_tpu_torch.config import GenerationConfig, QuantConfig
    from deeppowers_tpu_torch.models import transformer as T
    from deeppowers_tpu_torch.models.presets import LLAMA2_7B, TINYLLAMA_1_1B
    from deeppowers_tpu_torch.runtime.engine import InferenceEngine
    from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer
    from deeppowers_tpu_torch.config import RuntimeConfig

    tok = ByteTokenizer()
    out = {}
    for name, cfg, kv in (("tinyllama", TINYLLAMA_1_1B, "bf16"),
                          ("llama2-7b", LLAMA2_7B, LLAMA2_KV)):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        if name == "tinyllama":
            params = T.init_params(cfg, gen, dtype=torch.bfloat16,
                                   device="cuda")
            params = T.quantize_params(params, QuantConfig())
        else:
            params = llama2_params(torch, T, cfg, gen, "cuda")
        engine = InferenceEngine(
            params, cfg, device="cuda", eos_token_id=None,
            kv_cache_dtype=kv,
            runtime=RuntimeConfig(max_batch_size=8, max_seq_len=1024,
                                  prefill_buckets=(64, 128, 256, 512,
                                                   1024)))
        for i in range(8):
            engine.add_request(tok.encode(prompt_text(64, i)),
                               GenerationConfig(max_tokens=200,
                                                temperature=0.0))
        for _ in range(10):
            engine.step()
        torch.cuda.synchronize()
        times = []
        for _ in range(DISPATCH_MS_STEPS):
            t1 = time.perf_counter()
            engine.step()
            times.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        times.sort()
        out[name] = {"step_ms_p50": times[len(times) // 2],
                     "step_ms_mean": sum(times) / len(times),
                     "step_ms_min": times[0], "steps": len(times),
                     "scan": bool(engine.scan_layers)}
        del engine, params
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# api_serve: the HTTP surface (OpenAI routes, streams, batch, async,
# structured output, top logprobs) on TinyLlama int8

API_TOP_K = 5
API_MERGES = 300                 # BPE merges trained in the phase
API_CORPUS_BYTES = 4096          # of moelm_ckpt/ppl_eval.txt
API_REGEX = r"(yes|no|maybe), [a-z]{3,8}\."
API_CHOICES = ["alpha", "beta", "gamma"]
API_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "color": {"enum": ["red", "green", "blue"]}},
    "required": ["ok", "color"]}


def api_tokenizer():
    """The port's BPE tokenizer trained on the head of the trained
    checkpoint's text, so that guides walk multi-byte tokens."""
    from deeppowers_tpu_torch.serving.tokenizer import BPETokenizer
    text = trained_text(os.path.dirname(os.path.abspath(__file__)))
    return BPETokenizer.train([text[:API_CORPUS_BYTES]],
                              vocab_size=260 + API_MERGES)


def http_call(port: int, method: str, path: str, body=None,
              timeout: float = 120.0):
    """(status, JSON payload, or the text of an event stream)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, body=None if body is None
                 else json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    text = r.read().decode()
    conn.close()
    if r.getheader("Content-Type") == "text/event-stream":
        return r.status, text
    return r.status, json.loads(text)


def sse_payloads(name: str, text: str) -> list:
    """The `data:` payloads of an event stream, each framed
    "data: ...\\n\\n"."""
    parts = text[:-2].split("\n\n") if text.endswith("\n\n") else []
    if not parts or not all(p.startswith("data: ") for p in parts):
        fail(f"api_serve: {name}: not an event stream: {text[:200]!r}")
    return [p[len("data: "):] for p in parts]


def guide_misfit(kind: str, text: str):
    """None when a guided output fits its guide, else what is wrong."""
    import re
    if kind == "regex":
        return None if re.fullmatch(API_REGEX, text) else "no match"
    if kind == "choice":
        return None if text in API_CHOICES else "not a choice"
    try:
        obj = json.loads(text)
    except ValueError as e:
        return f"not JSON: {e}"
    props = API_SCHEMA["properties"]
    if not isinstance(obj, dict) or set(obj) != set(props):
        return f"keys {sorted(obj) if isinstance(obj, dict) else obj}"
    if not isinstance(obj["ok"], bool) or \
            obj["color"] not in props["color"]["enum"]:
        return "types"
    return None


def heads_its_top(tokens, logprobs, tops) -> int:
    """How many greedy tokens neither head their top list nor tie its head
    (the lower id first among equals, as JAX orders them) with their
    logprob within 1e-4 of the top value."""
    bad = 0
    for tok, lp, top in zip(tokens, logprobs, tops):
        tied = [i for i, v in top if v == top[0][1]]
        if tok not in tied or abs(lp - top[0][1]) > 1e-4 or \
                len(top) != API_TOP_K:
            bad += 1
    return bad + abs(len(tokens) - len(tops))


def api_guides(tok):
    from deeppowers_tpu_torch.serving import structured as S
    return [S.compile_guide(API_REGEX, tok),
            S.guide_for_choice(API_CHOICES, tok),
            S.guide_for_json(API_SCHEMA, tok)]


def api_graph_check(torch, name, make, tok, guided: bool) -> dict:
    """`graph_against_eager` on a fresh engine holding serve's 8 prompts,
    every other one under a guide when `guided`: the variant must be the
    top-k one (guided or not)."""
    import dataclasses
    from deeppowers_tpu_torch.config import GenerationConfig
    engine = make()
    guides = api_guides(tok)
    for i, n in enumerate(PROMPT_BYTES):
        g = GenerationConfig(max_tokens=MAX_TOKENS, temperature=0.0)
        if guided and i % 2 == 0:
            g = dataclasses.replace(g, guide=guides[(i // 2) % 3])
        engine.add_request(tok.encode(prompt_text(n, i)), g)
    out = graph_against_eager(torch, engine, name)
    if out["variant"][-1] != API_TOP_K or out["variant"][-2] is not guided:
        fail(f"api_serve[{name}]: variant {out['variant']} is not the top-k "
             f"{'guided' if guided else 'unguided'} one")
    engine.reset()
    return out


def topk_ms(torch) -> dict:
    """The top-k of a step's logits (`top_logprobs`: k argmax passes)
    beside a stable descending sort of the vocabulary, the other way to
    JAX's tie order, at 8 rows (decode) and 40 (a window of 5 over 8
    slots), TinyLlama's vocabulary."""
    from deeppowers_tpu_torch.ops.sampling import top_logprobs
    out = {}
    for rows in (8, 40):
        x = torch.randn(rows, 32000, device="cuda").to(torch.bfloat16).float()

        def argmax_passes():
            top_logprobs(x, API_TOP_K)

        def stable():
            lp = x - torch.logsumexp(x, -1, keepdim=True)
            v, i = torch.sort(lp, dim=-1, descending=True, stable=True)
            v[:, :API_TOP_K].clone(), i[:, :API_TOP_K].int()

        out[rows] = {"argmax_passes_ms": cuda_ms(torch, [argmax_passes], 50),
                     "stable_sort_ms": cuda_ms(torch, [stable], 50)}
    return out


def api_serve(torch, params, cfg, counters) -> dict:
    """The HTTP surface on TinyLlama int8 per-channel, bf16 contiguous KV,
    8 slots of 1024, emit_top_logprobs 5 at the auto depth, pipelined: the
    OpenAI routes plain and streamed, the generate stream, batch and async
    routes, /metrics, /v1/models, a guided request of each kind, a 404;
    then a prompt-lookup engine (K = 4) serving a guided and a top-k
    request. Gates: guided outputs fit their guides, streamed deltas equal
    the plain text, greedy tokens head their top lists; the top-k, guided
    and guided prompt-lookup graphs equal their eager steps bit for bit.
    Also the phase's launches, the profiled step at N = 1 with top-k on
    and off, and `topk_ms`."""
    from deeppowers_tpu_torch.serving.scheduler import Scheduler
    from deeppowers_tpu_torch.serving.server import APIServer
    t_tok = time.perf_counter()
    tok = api_tokenizer()
    out = {"tokenizer_s": round(time.perf_counter() - t_tok, 3),
           "vocab": tok.vocab_size}

    def make(**rt):
        return dispatch_engine(params, cfg, tok.eos_token_id, **rt)

    def serving(engine):
        sched = Scheduler(engine, encode=tok.encode, decode=tok.decode,
                          tokenizer=tok, model_name="tinyllama-1.1b")
        srv = APIServer(sched, port=0)
        sched.start()
        srv.start()
        return sched, srv

    gates = []

    def gate(ok: bool, what: str) -> None:
        if not ok:
            gates.append(what)

    engine = make(emit_top_logprobs=API_TOP_K, decode_steps_per_dispatch=0)
    sched, srv = serving(engine)
    reset_counts(counters)
    port = srv.port
    greedy = {"temperature": 0.0}
    texts = {}
    try:
        prompt = prompt_text(300, 1)
        for route, body in (
                ("/v1/completions", {"prompt": prompt, "max_tokens": 24}),
                ("/v1/chat/completions", {"messages": [
                    {"role": "system", "content": "answer briefly"},
                    {"role": "user", "content": prompt_text(200, 2)}],
                    "max_tokens": 24})):
            status, plain = http_call(port, "POST", route, {**body, **greedy})
            gate(status == 200, f"{route} answered {status}")
            c = plain["choices"][0]
            want = c["message"]["content"] if "message" in c else c["text"]
            status, text = http_call(port, "POST", route,
                                     {**body, **greedy, "stream": True})
            evs = sse_payloads(route, text)
            gate(evs[-1] == "[DONE]", f"{route} stream without [DONE]")
            objs = [json.loads(e) for e in evs[:-1]]
            joined = "".join(o["choices"][0]["delta"].get("content", "")
                             if "delta" in o["choices"][0]
                             else o["choices"][0]["text"] for o in objs)
            gate(joined == want, f"{route}: streamed deltas {joined!r} != "
                 f"plain {want!r}")
            texts[route] = want
        body = {"prompt": prompt_text(450, 3), "max_tokens": 32,
                "temperature": 0.0, "do_sample": False}
        status, plain = http_call(port, "POST", "/api/v1/generate", body)
        status, text = http_call(port, "POST", "/api/v1/generate_stream",
                                 body)
        evs = [json.loads(e) for e in sse_payloads("generate_stream", text)]
        done = evs[-1]
        joined = "".join(e["text"] for e in evs[:-1])
        gate(done.get("done") is True and joined == done["text"]
             == plain["text"], "generate_stream: deltas, result and the "
             "plain request differ")
        gate(done["tokens"] == plain["tokens"], "generate_stream: tokens "
             "differ from the plain request's")
        out["top_misses"] = heads_its_top(done["tokens"], done["logprobs"],
                                          done["top_tokens"])
        gate(out["top_misses"] == 0, f"{out['top_misses']} greedy tokens do "
             f"not head their top lists")
        status, batch = http_call(port, "POST", "/api/v1/generate_batch", {
            "prompts": [prompt_text(64, 4), prompt_text(1400, 5),
                        prompt_text(600, 6)],
            "max_tokens": 8, "temperature": 0.0, "do_sample": False})
        gate(status == 200 and len(batch["results"]) == 3 and all(
            len(r["tokens"]) == 8 for r in batch["results"]),
            f"generate_batch answered {status}")
        status, acc = http_call(port, "POST", "/api/v1/generate_async", {
            "prompt": prompt_text(100, 7), "max_tokens": 16,
            "temperature": 0.0, "do_sample": False})
        gate(status == 202, f"generate_async answered {status}")
        codes = []
        for _ in range(1000):
            status, res = http_call(port, "GET", acc["result_url"])
            codes.append(status)
            if status != 202:
                break
            time.sleep(0.005)
        gate(status == 200 and len(res["tokens"]) == 16,
             f"result route answered {status}")
        out["async_polls"] = len(codes)
        guided = {}
        for kind, extra in (
                ("regex", {"guided_regex": API_REGEX}),
                ("choice", {"guided_choice": API_CHOICES}),
                ("json", {"response_format": {"type": "json_schema",
                                              "json_schema": {
                                                  "schema": API_SCHEMA}}})):
            status, res = http_call(port, "POST", "/v1/completions", {
                "prompt": prompt_text(120, 8), "max_tokens": 64, **greedy,
                **extra})
            text = res["choices"][0]["text"] if status == 200 else ""
            misfit = guide_misfit(kind, text)
            gate(status == 200 and misfit is None and
                 res["choices"][0]["finish_reason"] == "stop",
                 f"guided {kind}: {status} {text!r}: {misfit}")
            guided[kind] = text
        out["guided"] = guided
        status, metrics = http_call(port, "GET", "/metrics")
        gate(status == 200 and metrics["requests_completed"] >= 10,
             f"/metrics answered {status}")
        status, models = http_call(port, "GET", "/v1/models")
        gate(status == 200 and models["data"][0]["id"] == "tinyllama-1.1b",
             f"/v1/models answered {status}")
        status, _ = http_call(port, "POST", "/api/v1/nowhere",
                              {"prompt": "x"})
        gate(status == 404, f"an unknown route answered {status}")
        torch.cuda.synchronize()
        la = read_counts(counters)
        out["launches"] = {
            "#1 gemv": la.get("dequant_matmul[gemv]", 0),
            "#1 mma": la.get("dequant_matmul[mma]", 0),
            "#3": la.get("decode_attention", 0),
            "3i": sum(v for k, v in la.items()
                      if k.startswith("decode_attention[i8:")),
            "#2 rows inside #3": la.get(fold_key("decode_attention",
                                                 "bf16"), 0),
            "#2": la.get("scatter_rows", 0),
            "#4 prefill": la.get("flash_attention_prefill", 0),
            "#4 chunk": la.get("flash_attention_chunk", 0)}
        out["requests"] = metrics["requests_completed"]
        out["depth"] = engine._steps_per_dispatch
        out["variants"] = [list(k) for k in (
            engine._graphs.variants if engine._graphs else [])]
    finally:
        srv.stop()
        sched.stop()
    la = out["launches"]
    for key in ("#1 gemv", "#1 mma", "#2 rows inside #3"):
        gate(la[key] > 0, f"{key} did not launch")
    gate(la["#4 prefill"] + la["#4 chunk"] > 0, "#4 did not launch")
    del engine, sched, srv
    # the prompt-lookup engine: a guided and a top-k request
    spec = make(emit_top_logprobs=API_TOP_K, speculative_tokens=SPEC_K,
                speculative_ngram=3, decode_steps_per_dispatch=0)
    sched, srv = serving(spec)
    try:
        status, res = http_call(srv.port, "POST", "/v1/completions", {
            "prompt": prompt_text(300, 9), "max_tokens": 64,
            "guided_regex": API_REGEX, **greedy})
        text = res["choices"][0]["text"] if status == 200 else ""
        misfit = guide_misfit("regex", text)
        gate(status == 200 and misfit is None,
             f"lookup guided: {status} {text!r}: {misfit}")
        status, res = http_call(srv.port, "POST", "/api/v1/generate", {
            "prompt": prompt_text(300, 10), "max_tokens": 48,
            "temperature": 0.0, "do_sample": False})
        miss = heads_its_top(res["tokens"], res["logprobs"],
                             res["top_tokens"])
        gate(status == 200 and miss == 0,
             f"lookup top-k: {status}, {miss} tokens off their top lists")
        out["lookup"] = {"guided": text, "spec_steps": spec.spec_steps,
                         "window_mean": round(spec.spec_window_mean, 3),
                         "variants": [list(k) for k in (
                             spec._graphs.variants if spec._graphs else [])]}
        gate(spec.spec_steps > 0, "the prompt-lookup engine ran no window")
    finally:
        srv.stop()
        sched.stop()
    del spec, sched, srv
    if gates:
        fail("api_serve: " + "; ".join(gates))
    out["graph"] = {
        "top-k": api_graph_check(torch, "top-k", lambda: make(
            emit_top_logprobs=API_TOP_K), tok, False),
        "guided": api_graph_check(torch, "guided", lambda: make(
            emit_top_logprobs=API_TOP_K), tok, True),
        "guided+lookup": api_graph_check(torch, "guided+lookup", lambda: make(
            emit_top_logprobs=API_TOP_K, speculative_tokens=SPEC_K,
            speculative_ngram=3), tok, True)}
    out["profile_topk"] = dispatch_profile(
        torch, make(emit_top_logprobs=API_TOP_K), tok)
    out["profile_plain"] = dispatch_profile(torch, make(), tok)
    out["topk_ms"] = topk_ms(torch)
    torch.cuda.empty_cache()
    return out


def report_api(t0, out, smi_line) -> None:
    """The api_serve phase lines."""
    phase_line("api_serve", t0, requests=out["requests"], depth=out["depth"],
               tokenizer_s=out["tokenizer_s"], vocab=out["vocab"],
               graphs=json.dumps(out["graph"]), card=repr(smi_line))
    log("api_serve launches (bf16 KV: #2's decode rows are written inside "
        "#3, prompts by indexing; 3i takes int8-byte K only) "
        + json.dumps(out["launches"]))
    log("api_serve guided outputs " + json.dumps(out["guided"])
        + "; prompt lookup " + json.dumps(out["lookup"]))
    on, off = out["profile_topk"], out["profile_plain"]
    log(f"api_serve profiled step at N = 1, top-k {API_TOP_K} on: wall "
        f"{on['wall_ms']:.4f} ms, device busy {on['busy_ms']:.4f} ms; off: "
        f"wall {off['wall_ms']:.4f} ms, device busy {off['busy_ms']:.4f} ms;"
        f" kernels a step {on['kernels']:.1f} vs {off['kernels']:.1f} "
        f"card={smi_line!r}")
    log("api_serve top-k of a step's logits, ms (k argmax passes vs a "
        "stable sort) " + json.dumps(out["topk_ms"]) + f" card={smi_line!r}")


def report_dispatch(name, t0, out, smi_line) -> None:
    """The dispatch phase lines of one model."""
    phase_line(name, t0, graphs=json.dumps(out.get("graph")),
               streams=json.dumps(out.get("streams")), card=repr(smi_line))
    for k in ("lazy", "sampled"):
        if k in out:
            log(f"{name} {k} " + json.dumps(out[k]))
    for k in ("profile_n1", "profile_auto"):
        pr = out[k]
        log(f"{name} {k}: depth {pr['depth']}, a dispatch wall "
            f"{pr['wall_ms']:.3f} ms, device busy {pr['busy_ms']:.3f} ms, "
            f"idle share {pr['idle_share']:.3f}; a token "
            + json.dumps({a: round(b, 4) for a, b in pr["per_token"].items()})
            + "; " + json.dumps({a: pr[a] for a in (
                "kernels", "launches", "graph_launches", "api_calls", "ops",
                "syncs", "variants", "capture_s", "pool_bytes")})
            + f" card={smi_line!r}")


def report_serve(name, t0, out, smi_line, n_requests) -> None:
    """The phase line of a serve phase and its launches, prefix and
    profiler lines."""
    extra = {}
    if "preempted" in out:
        extra = dict(pool_pages=PAGED_TOTAL_PAGES,
                     preempted=out["preempted"], prefix_hits=out["hits"],
                     max_chunks=out["max_chunks"])
    phase_line(name, t0, requests=n_requests, tokens=out["tokens"],
               tok_per_s=f"{out['tok_per_s']:.1f}",
               ttft_ms_p50=out["ttft_ms_p50"], ttft_ms_max=out["ttft_ms_max"],
               decode_step_ms_p50=f"{out['decode_step_ms_p50']:.3f}",
               steps=out["steps"], kv_bytes=out["kv_bytes"], **extra,
               card=repr(smi_line))
    log(f"{name} stop_reasons " + json.dumps(out["stop_reasons"]))
    if "prefix" in out:
        log(f"{name} prefix cache " + json.dumps(out["prefix"]))
    log(f"{name} launches " + json.dumps(out["launches"]))
    log(f"{name} ttft_ms per request, in prompt order "
        + json.dumps(out["ttft_ms"]))
    pr = out["profile"]
    log(f"{name} decode step under torch.profiler (8 slots): wall "
        f"{pr['wall_ms']:.3f} ms, device busy {pr['busy_ms']:.3f} ms, idle "
        f"share {pr['idle_share']:.3f}; top device time per step (ms): "
        + json.dumps([[k, round(v, 4)] for k, v in pr["top"]]))
    log(f"{name} decode step host split " + json.dumps(
        {k: pr[k] for k in ("ops", "launches", "syncs", "sync_ms", "allocs",
                            "alloc_ms", "host_top")}))
    log(f"{name} profiled decode step: {pr['launches']:.1f} launches, "
        f"device busy {pr['busy_ms']:.3f} ms, row writers (#2, #6, #8) "
        f"{pr['row_writers']:.1f} and attention calls that wrote their rows "
        f"{pr['folded_attention']:.1f} a step card={smi_line!r}")
    if pr["quantizer"]["launches"]:
        log(f"{name} decode step: {pr['launches']:.1f} launches, the row "
            f"quantizer {pr['quantizer']['launches']:.1f} of them "
            f"({pr['quantizer']['traced']:.1f} traced), "
            f"{pr['quantizer']['ms']:.4f} device ms, busy "
            f"{pr['busy_ms']:.3f} ms card={smi_line!r}")
    if "warm" in out:
        log(f"{name} first pass: {out['segments']} cudaMalloc segments; the "
            f"same traffic again on the warm engine " + json.dumps(out["warm"]))
        log(f"{name} the same traffic with the scheduler's thread under "
            f"torch.profiler, totals of the run " + json.dumps(
                out["served_split"]))
    if "prefill" in out:
        log(f"{name} prefill of each prompt alone, warm engine " + json.dumps(
            out["prefill"]))
    if "speculative" in out:
        spec = dict(out["speculative"])
        for k in ("spec_mean_accepted", "equal_to_plain", "cost_ratio",
                  "draft", "self_draft"):
            if k in out:
                spec[k] = out[k]
        log(f"{name} speculative " + json.dumps(spec)
            + f" card={smi_line!r}")


# ---------------------------------------------------------------------------

def log_dots(phase, out, smi_line) -> None:
    """A serve phase's profiled decode step with #3's int8-dot variant
    (the default) beside the same step with its bf16-dot kernel
    (DPT_ATTN_INT8=0), and the 7B's on its stacked cache."""
    p, q = out["profile"], out["profile_bf16_dots"]
    scan = out.get("profile_scan")
    log(f"{phase} a profiled decode step: device busy {p['busy_ms']:.4f} "
        f"ms, #3 {p['attention']['ms']:.4f} ms "
        f"({p['attention']['traced']:.1f} launches) with the int8-dot "
        f"variant; {q['busy_ms']:.4f} ms, #3 {q['attention']['ms']:.4f} ms "
        f"({q['attention']['traced']:.1f} launches) with the bf16-dot "
        f"kernel (DPT_ATTN_INT8=0)"
        + (f"; on the stacked cache {scan['busy_ms']:.4f} ms, #3 "
           f"{scan['attention']['ms']:.4f} ms" if scan else "")
        + f" card={smi_line!r}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: " + smi.stderr.strip()


def main(argv) -> int:
    threading.Thread(target=watchdog, daemon=True, name="watchdog").start()
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; nothing to run\n")
        return 2
    if argv[:1] == ["--step-ms"] and len(argv) == 2:
        # #1's int8 decode step through the package of the checkout at
        # argv[1], for a paired run of two checkouts on one card
        sys.path.insert(0, os.path.abspath(argv[1]))
        from deeppowers_tpu_torch.models.presets import TINYLLAMA_1_1B
        from deeppowers_tpu_torch.ops.kernels import _build
        _build.library()
        log(json.dumps({"checkout": argv[1], "card": card_line(),
                        **step_ms(torch, TINYLLAMA_1_1B)}))
        return 0
    if argv[:1] == ["--ttft"] and len(argv) == 2:
        # TTFT where #4 and #9 run, through the package of the checkout at
        # argv[1], for a paired run of two checkouts on one card
        sys.path.insert(0, os.path.abspath(argv[1]))
        from deeppowers_tpu_torch.ops.kernels import _build
        _build.library()
        log(json.dumps({"checkout": argv[1], "card": card_line(),
                        **ttft_ms(torch)}))
        return 0
    if argv[:1] == ["--kt-ms"] and len(argv) == 2:
        # #7 and #3 on the same caches, through the package of the
        # checkout at argv[1], for a paired run of two checkouts on one card
        sys.path.insert(0, os.path.abspath(argv[1]))
        from deeppowers_tpu_torch.ops.kernels import _build
        _build.library()
        with int8_dots_off():       # #3's bf16-dot kernel, as in phase 3
            log(json.dumps({"checkout": argv[1], "card": card_line(),
                            **kt_ms(torch)}))
        return 0
    if argv[:1] == ["--slot-orders"] and len(argv) == 2:
        # #3 / #5 over slot orders of ATTN_LENS, through the package of the
        # checkout at argv[1], for a paired run of two checkouts on one card
        sys.path.insert(0, os.path.abspath(argv[1]))
        from deeppowers_tpu_torch.ops.kernels import _build
        _build.library()
        log(json.dumps({"checkout": argv[1], "card": card_line(),
                        **slot_order_ms(torch)}))
        return 0
    if argv[:1] == ["--fold-ms"] and len(argv) == 2:
        # the attention that writes the step's rows, and the writer +
        # attention pair, through the package of the checkout at argv[1]
        sys.path.insert(0, os.path.abspath(argv[1]))
        from deeppowers_tpu_torch.ops.kernels import _build
        _build.library()
        with int8_dots_off():       # #3's bf16-dot kernel, as in phase 3
            log(json.dumps({"checkout": argv[1], "card": card_line(),
                            **fold_ms(torch)}))
        return 0
    if argv[:1] == ["--i8-ms"] and len(argv) == 2:
        # #3's int8-dot variant beside its bf16-dot kernel, through the
        # package of the checkout at argv[1]
        sys.path.insert(0, os.path.abspath(argv[1]))
        from deeppowers_tpu_torch.ops.kernels import _build
        _build.library()
        log(json.dumps({"checkout": argv[1], "card": card_line(),
                        **i8_ms(torch)}))
        return 0
    if argv[:1] == ["--seg-ms"] and len(argv) == 2:
        # 9q's rows and a Mixtral prefill's device busy, through the
        # package of the checkout at argv[1]
        sys.path.insert(0, os.path.abspath(argv[1]))
        from deeppowers_tpu_torch.ops.kernels import _build
        _build.library()
        log(json.dumps({"checkout": argv[1], "card": card_line(),
                        **seg_ms(torch)}))
        return 0
    if argv[:1] == ["--dispatch-ms"] and len(argv) == 2:
        # the served step() at the default runtime, through the package of
        # the checkout at argv[1]
        sys.path.insert(0, os.path.abspath(argv[1]))
        from deeppowers_tpu_torch.ops.kernels import _build
        _build.library()
        log(json.dumps({"checkout": argv[1], "card": card_line(),
                        **dispatch_ms(torch)}))
        return 0
    if argv:
        sys.stderr.write("usage: chip_smoke.py [--step-ms CHECKOUT | "
                         "--ttft CHECKOUT | --kt-ms CHECKOUT | "
                         "--slot-orders CHECKOUT | --fold-ms CHECKOUT | "
                         "--i8-ms CHECKOUT | --seg-ms CHECKOUT | "
                         "--dispatch-ms CHECKOUT]\n")
        return 2
    from deeppowers_tpu_torch.config import QuantConfig
    from deeppowers_tpu_torch.models import transformer as T
    from deeppowers_tpu_torch.models.presets import TINYLLAMA_1_1B as cfg
    from deeppowers_tpu_torch.ops.kernels import _build
    from deeppowers_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_kernel, decode_attention_kt,
        decode_attention_paged)
    from deeppowers_tpu_torch.ops.kernels.dequant_matmul import (
        dequant_matmul, quantize_activations, stage_activations)
    from deeppowers_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_chunk, flash_attention_prefill)
    from deeppowers_tpu_torch.ops.kernels.grouped_matmul import (
        grouped_dequant_matmul, grouped_dequant_matmul_ncat,
        quantize_segments)
    from deeppowers_tpu_torch.ops.kernels.kv_append import (
        scatter_pool_rows, scatter_rows, scatter_rows_stacked)
    from deeppowers_tpu_torch.runtime import kvcache

    counters = {"dequant_matmul": dequant_matmul,
                "quantize_activations": quantize_activations,
                "stage_activations": stage_activations,
                "scatter_rows": scatter_rows,
                "decode_attention": decode_attention,
                "flash_attention_prefill": flash_attention_prefill,
                "flash_attention_chunk": flash_attention_chunk,
                "scatter_pool_rows": scatter_pool_rows,
                "decode_attention_paged": decode_attention_paged,
                "grouped_dequant_matmul": grouped_dequant_matmul,
                "grouped_dequant_matmul_ncat": grouped_dequant_matmul_ncat,
                "quantize_segments": quantize_segments,
                "scatter_rows_stacked": scatter_rows_stacked,
                "decode_attention_kt": decode_attention_kt,
                "decode_attention_kernel": decode_attention_kernel}
    count_step_writers(counters)
    cpu_references_take_kernel_functions()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    t0 = time.perf_counter()
    smi_line = card_line()
    log(smi_line)
    phase_line("device", t0, torch=torch.__version__, cuda=torch.version.cuda,
               card=repr(torch.cuda.get_device_name(0)),
               count=torch.cuda.device_count())

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    phase_line("build", t0, nvcc_s=f"{_build.build_info['seconds']:.2f}",
               cached=_build.build_info["cached"],
               per_source_s=json.dumps(_build.build_info.get("compile_s")),
               link_s=_build.build_info.get("link_s"))

    # 3. kernels (#3's rows of the earlier slices with its bf16-dot
    # kernel, DPT_ATTN_INT8=0; then its int8-dot variant's rows)
    t0 = time.perf_counter()
    with int8_dots_off():
        rows = check_kernels(torch, cfg)
        rows += check_wquant_kernels(torch)
        rows += check_verify_matmuls(torch, cfg)
        route_sweep(torch, cfg)
        rows += check_grouped_kernels(torch)
        rows += check_mixtral_gemv(torch)
        rows += check_scan_kt_kernels(torch, cfg)
        rows += check_fold_kernels(torch)
        rows += check_zp_kernels(torch)
    rows += check_i8_kernels(torch)
    phase_line("kernels", t0, checked=len(rows))

    # 4. path: full-width TinyLlama, teacher-forced against the plain path
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = T.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = T.fuse_params(T.quantize_params(params, QuantConfig()), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = torch.Generator().manual_seed(SEED + 2)
    ids = torch.randint(0, cfg.vocab_size, (40,), generator=rng).tolist()
    forced = torch.randint(0, cfg.vocab_size, (3,), generator=rng).tolist()
    reset_counts(counters)
    got = forced_logits(torch, T, kvcache, params, cfg, ids, forced, "cuda")
    torch.cuda.synchronize()
    check_variants("path", read_counts(counters),
                   [fold_key("decode_attention", "bf16")], ["step_writers"])
    ref = forced_logits(torch, T, kvcache, tree_to(params, "cpu"), cfg, ids,
                        forced, "cpu")
    # Tolerance: both paths keep the residual stream in bf16 (8 significant
    # bits), rounding at different points (fused vs separate norms and adds,
    # other summation orders) over 22 layers; that drift stays within a few
    # percent of the logits' norm, where a wrong kernel is off by O(1).
    rel = max(((g - r).norm() / r.norm()).item() for g, r in zip(got, ref))
    if not all(torch.isfinite(g).all() for g in got) or not rel <= 5e-2:
        fail(f"path: kernel vs plain logits rel L2 error {rel} > 5e-2")
    phase_line("path", t0, init_s=f"{init_s:.2f}",
               params_gb=f"{T.param_nbytes(params) / 1e9:.3f}",
               steps=f"prefill({len(ids)})+decode({len(forced)})",
               logits_rel_l2=f"{rel:.3e}")

    # 5. paged path: the same through the paged cache
    t0 = time.perf_counter()
    reset_counts(counters)
    got_p = forced_logits(torch, T, kvcache, params, cfg, ids, forced, "cuda",
                          paged=True)
    torch.cuda.synchronize()
    check_variants("paged_path", read_counts(counters),
                   [fold_key("decode_attention_paged", "bf16")],
                   ["step_writers"])
    ref_p = forced_logits(torch, T, kvcache, tree_to(params, "cpu"), cfg, ids,
                          forced, "cpu", paged=True)
    rel_p = max(((g - r).norm() / r.norm()).item()
                for g, r in zip(got_p, ref_p))
    rel_pc = max(((g - r).norm() / r.norm()).item()
                 for g, r in zip(ref_p, ref))
    if not all(torch.isfinite(g).all() for g in got_p) or not rel_p <= 5e-2:
        fail(f"paged path: kernel vs plain logits rel L2 error {rel_p} > 5e-2")
    phase_line("paged_path", t0, logits_rel_l2=f"{rel_p:.3e}",
               plain_paged_vs_plain_contiguous=f"{rel_pc:.3e}",
               pages=list(PAGED_TABLE[:2]))

    # 5b. the same through each quantized store on each layout; the card
    # run's launches are counted from 0
    path_launches = {}
    unrolled = {"bf16": got}
    for kv_dtype in ("int8", "int4", "k8v4"):
        for paged in (False, True):
            t0 = time.perf_counter()
            reset_counts(counters)
            got_q = forced_logits(torch, T, kvcache, params, cfg, ids, forced,
                                  "cuda", paged=paged,
                                  kv_cache_dtype=kv_dtype)
            torch.cuda.synchronize()
            layout = "paged" if paged else "contiguous"
            path_launches[(kv_dtype, layout)] = read_counts(counters)
            check_variants(
                f"path[{kv_dtype},{layout}]",
                path_launches[(kv_dtype, layout)],
                [fold_key("decode_attention_paged" if paged
                          else "decode_attention", kv_dtype)],
                ["step_writers"])
            ref_q = forced_logits(torch, T, kvcache, tree_to(params, "cpu"),
                                  cfg, ids, forced, "cpu", paged=paged,
                                  kv_cache_dtype=kv_dtype)
            rel_q = max(((g - r).norm() / r.norm()).item()
                        for g, r in zip(got_q, ref_q))
            rel_qb = max(((g - r).norm() / r.norm()).item()
                         for g, r in zip(ref_q, ref))
            if not all(torch.isfinite(g).all() for g in got_q) or \
                    not rel_q <= 5e-2:
                fail(f"path[{kv_dtype}, {layout}]: kernel vs plain logits "
                     f"rel L2 error {rel_q} > 5e-2")
            phase_line(f"path[{kv_dtype},{layout}]", t0,
                       logits_rel_l2=f"{rel_q:.3e}",
                       plain_vs_plain_bf16_kv=f"{rel_qb:.3e}")
            if not paged:
                unrolled[kv_dtype] = got_q

    # 5b''. the same weights stacked, through the scan forwards and the
    # stacked cache (bf16 and k8v4)
    scan_launches = scan_path(torch, T, kvcache, params, cfg, ids, forced,
                              counters, unrolled)

    # 5b'. a speculative verify window, teacher-forced, through each store
    # on each layout
    spec_launches = spec_path(torch, T, params, cfg, counters)

    # 5c. the tightest gates again over other seeds
    margins(torch, T, kvcache, cfg, params)

    # 5d. the shape of the repo's trained checkpoint lm124_ckpt (untied
    # lm_head, N = 260; random weights): #1's n4 instantiation on a model's
    # path, through the engine, and teacher-forced against the plain path
    t0 = time.perf_counter()
    lm_launches, lm = lm124_path(torch, T, kvcache, counters)
    phase_line("path[lm124]", t0, **lm)

    # 5e. Llama-2-7B at full width, W4A8 g128 + k8v4 (BASELINE config 3),
    # at a cut depth, teacher-forced against the plain path
    t0 = time.perf_counter()
    l7_launches, l7 = llama2_path(torch, T, kvcache, counters)
    phase_line("path[llama2-7b]", t0, **l7)

    # 5e''. the same weights stacked: the default (scan) path of the 7B
    t0 = time.perf_counter()
    l7s_launches, l7s = llama2_path(torch, T, kvcache, counters, scan=True)
    phase_line("scan_path[llama2-7b]", t0, **l7s)

    # 5e'. the same through the kt mirror (DPT_KV_KT=1): #7
    t0 = time.perf_counter()
    kt_launches, kt = kt_path(torch, T, kvcache, counters)
    phase_line("kt_path[llama2-7b]", t0, **kt)

    # 5f. Mixtral-8x7B at full width, W4A8 g128 + int8 KV (BASELINE config
    # 5), 2 layers: a prefill through #10 and #9, decode through #1
    t0 = time.perf_counter()
    mx_launches, mx = mixtral_path(torch, T, kvcache, counters)
    phase_line("path[mixtral-8x7b]", t0, **mx)

    # 5f'. the same weights stacked: the default (scan) path of Mixtral
    t0 = time.perf_counter()
    mxs_launches, mxs = mixtral_path(torch, T, kvcache, counters, scan=True)
    phase_line("scan_path[mixtral-8x7b]", t0, **mxs)

    # 5g. the trained MoE checkpoint, loaded by the port onto the card and
    # scored at bf16 on its own text against the CPU's plain function
    t0 = time.perf_counter()
    _, tr = trained_phase(torch, T, counters)
    phase_line("trained", t0, **tr)

    # 5h. the quantization recipes: asymmetric weights through #1's
    # zero-point GEMV and tensor-core kernel, and W4A8 g128 + GPTQ made on
    # the card, each teacher-forced against the CPU and served
    t0 = time.perf_counter()
    cal_launches, cal = calibrated_phase(torch, T, kvcache, counters)
    phase_line("calibrated", t0, **cal)

    # 6. serve, contiguous KV
    t0 = time.perf_counter()
    srv = serve(torch, params, cfg, counters)
    report_serve("serve", t0, srv, smi_line, len(PROMPT_BYTES))

    # 6b. serve with prompt-lookup speculation, contiguous bf16 KV
    t0 = time.perf_counter()
    ssrv = serve_spec(torch, params, cfg, counters, srv["token_ids"])
    report_serve("spec_serve", t0, ssrv, smi_line, len(PROMPT_BYTES) + 1)

    # 6c. serve's traffic on the stacked cache (scan_layers "auto")
    t0 = time.perf_counter()
    scsrv = serve_scan(torch, params, cfg, counters)
    report_serve("scan_serve", t0, scsrv, smi_line, len(PROMPT_BYTES))
    log(f"scan_serve tok/s {scsrv['tok_per_s']:.1f}, TTFT p50 "
        f"{scsrv['ttft_ms_p50']:.3f} ms, decode step p50 "
        f"{scsrv['decode_step_ms_p50']:.3f} ms against serve's "
        f"{srv['tok_per_s']:.1f}, {srv['ttft_ms_p50']:.3f} ms, "
        f"{srv['decode_step_ms_p50']:.3f} ms; its second pass (prefix "
        f"copies) " + json.dumps(scsrv["second_pass"]) + f" card={smi_line!r}")
    log(f"scan_serve prefill of each prompt alone (bytes {list(PROMPT_BYTES)})"
        f", ms: scan {json.dumps(scsrv['prefill']['wall_ms'])}, device busy "
        f"{scsrv['prefill']['busy_ms']:.3f} a prefill; unrolled (serve) "
        f"{json.dumps(srv['prefill']['wall_ms'])}, device busy "
        f"{srv['prefill']['busy_ms']:.3f}; top kernels a prefill, scan "
        + json.dumps(scsrv["prefill"]["top"]) + ", unrolled "
        + json.dumps(srv["prefill"]["top"]) + f" card={smi_line!r}")

    # 7. paged serve
    t0 = time.perf_counter()
    psrv = serve_paged(torch, params, cfg, counters)
    report_serve("paged_serve", t0, psrv, smi_line, len(paged_prompts()))

    # 8, 9. the serve phases again over quantized KV: int8 contiguous,
    # k8v4 paged (the deployed recipe)
    t0 = time.perf_counter()
    # (its prefill host split equals bf16's: one pass here)
    qsrv = serve(torch, params, cfg, counters, kv_cache_dtype="int8",
                 passes=False)
    report_serve("serve[int8]", t0, qsrv, smi_line, len(PROMPT_BYTES))
    log_dots("serve[int8]", qsrv, smi_line)
    t0 = time.perf_counter()
    qpsrv = serve_paged(torch, params, cfg, counters, kv_cache_dtype="k8v4")
    report_serve("paged_serve[k8v4]", t0, qpsrv, smi_line,
                 len(paged_prompts()))
    t0 = time.perf_counter()
    spsrv = serve_paged(torch, params, cfg, counters, kv_cache_dtype="k8v4",
                        spec_k=SPEC_K)
    report_serve("spec_paged_serve[k8v4]", t0, spsrv, smi_line,
                 len(paged_prompts()))

    # 9b. every decode dispatch a replayed CUDA graph (TinyLlama): graph
    # against eager, greedy streams across depths and pipelining, lazy
    # paging with preemption, sampled graphs, profiled steps
    t0 = time.perf_counter()
    dsp = dispatch_phase(torch, params, cfg)
    report_dispatch("dispatch[tinyllama]", t0, dsp, smi_line)

    # 9c. the HTTP surface: OpenAI routes plain and streamed, the stream,
    # batch and async routes, structured output, top logprobs
    t0 = time.perf_counter()
    report_api(t0, api_serve(torch, params, cfg, counters), smi_line)

    # 10. Llama-2-7B, all 32 layers, W4A8 g128 + k8v4, serve's traffic once
    t0 = time.perf_counter()
    lsrv = serve_llama2(torch, T, counters)
    report_serve("serve[llama2-7b]", t0, lsrv, smi_line, len(PROMPT_BYTES))
    log_dots("serve[llama2-7b]", lsrv, smi_line)
    report_dispatch("dispatch[llama2-7b]", time.perf_counter()
                    - lsrv["dispatch_s"], lsrv["dispatch"], smi_line)
    l7_served = {"launches": lsrv["launches"]}
    l7_scan_launches = lsrv["launches_scan"]
    tt = sorted(lsrv["ttft_512_ms"])
    ts = sorted(lsrv["ttft_512_scan_ms"])
    log(f"serve[llama2-7b] params {lsrv['param_bytes']} bytes (drawn in "
        f"{lsrv['init_s']:.2f} s); TTFT of a {TTFT_PROMPT}-token prompt "
        f"alone on the warm engine: p50 {tt[len(tt) // 2]:.3f} ms, max "
        f"{tt[-1]:.3f} ms, each " + json.dumps(lsrv["ttft_512_ms"])
        + f"; on the scan engine (scan_layers 'auto', the default): p50 "
        f"{ts[len(ts) // 2]:.3f} ms, max {ts[-1]:.3f} ms, each "
        + json.dumps(lsrv["ttft_512_scan_ms"]) + f" card={smi_line!r}")
    l7_params = lsrv.pop("params")

    # 10a. the same weights and traffic with the kt mirror (DPT_KV_KT=1)
    t0 = time.perf_counter()
    ktsrv = serve_llama2_kt(torch, T, counters, l7_params)
    report_serve("serve[llama2-7b,kt]", t0, ktsrv, smi_line,
                 len(PROMPT_BYTES))
    kp, lp = ktsrv["profile"], lsrv["profile"]
    log(f"serve[llama2-7b,kt] tok/s {ktsrv['tok_per_s']:.1f}, decode step "
        f"p50 {ktsrv['decode_step_ms_p50']:.3f} ms, kv_bytes "
        f"{ktsrv['kv_bytes']} against serve[llama2-7b]'s "
        f"{lsrv['tok_per_s']:.1f}, {lsrv['decode_step_ms_p50']:.3f} ms, "
        f"{lsrv['kv_bytes']}; a profiled decode step: device busy "
        f"{kp['busy_ms']:.4f} ms, #7 {kp['attention']['ms']:.4f} ms "
        f"({kp['attention']['traced']:.1f} launches), "
        f"{kp['launches']:.1f} launches, against {lp['busy_ms']:.4f} ms, "
        f"#3 {lp['attention']['ms']:.4f} ms "
        f"({lp['attention']['traced']:.1f} launches), "
        f"{lp['launches']:.1f} launches card={smi_line!r}")
    torch.cuda.empty_cache()

    # 10b. the same weights verifying drafts of TinyLlama-1.1B int8
    t0 = time.perf_counter()
    lspec = serve_llama2_spec(torch, T, counters, l7_params, params, cfg)
    report_serve("spec_serve[llama2-7b+draft]", t0, lspec, smi_line,
                 len(PROMPT_BYTES))
    log(f"spec_serve[llama2-7b+draft] decode step p50 "
        f"{lspec['decode_step_ms_p50']:.3f} ms against serve[llama2-7b]'s "
        f"{lsrv['decode_step_ms_p50']:.3f} ms; tok/s {lspec['tok_per_s']:.1f}"
        f" against {lsrv['tok_per_s']:.1f} card={smi_line!r}")
    del lsrv, l7_params
    torch.cuda.empty_cache()

    # 11. Mixtral-8x7B whole, W4A8 g128 + int8 KV, serve's traffic once
    t0 = time.perf_counter()
    msrv = serve_mixtral(torch, T, counters)
    report_serve("serve[mixtral-8x7b]", t0, msrv, smi_line, len(PROMPT_BYTES))
    log_dots("serve[mixtral-8x7b]", msrv, smi_line)
    report_dispatch("dispatch[mixtral-8x7b]", time.perf_counter()
                    - msrv["dispatch_s"], msrv["dispatch"], smi_line)
    tt = sorted(msrv["ttft_512_ms"])
    log(f"serve[mixtral-8x7b] params {msrv['param_bytes']} bytes (drawn and "
        f"fused in {msrv['init_s']:.2f} s), KV {msrv['kv_bytes']} bytes; "
        f"routed pairs per expert over {msrv['forwards']} forwards x 32 "
        f"layers {json.dumps(msrv['pairs_per_expert'])} (layer 0: "
        f"{json.dumps(msrv['pairs_layer0'])}; layers with an idle expert: "
        f"{msrv['idle_layers']}); TTFT of a {TTFT_PROMPT}-token prompt "
        f"alone on the warm engine: p50 {tt[len(tt) // 2]:.3f} ms, max "
        f"{tt[-1]:.3f} ms, each " + json.dumps(msrv["ttft_512_ms"]))
    pp = msrv["prefill_profile"]
    log(f"serve[mixtral-8x7b] profiled {TTFT_PROMPT}-token prefill: device "
        f"busy {pp['busy_ms']:.3f} ms, {pp['launches']:.1f} launches, "
        f"{pp['ops']:.1f} PyTorch ops; 9q {pp['segments']['ms']:.4f} ms "
        f"({pp['segments']['traced']:.1f} launches); kernels between #10 "
        f"and #9 {pp['between']['ms']:.4f} ms "
        f"({pp['between']['traced']:.1f} launches) card={smi_line!r}")

    # each row's launches: from the serve phase whose path runs it, else
    # from the teacher-forced path run of its store and layout; #1 at an odd
    # N from its width variant's count in the first run that launched it
    # (the main path's serve phase when none did)
    serves = {"serve": srv, "paged_serve": psrv, "serve[int8]": qsrv,
              "paged_serve[k8v4]": qpsrv, "serve[llama2-7b]": l7_served,
              "serve[mixtral-8x7b]": msrv, "spec_serve": ssrv,
              "spec_paged_serve[k8v4]": spsrv,
              "spec_serve[llama2-7b+draft]": lspec, "scan_serve": scsrv,
              "serve[llama2-7b,kt]": ktsrv}
    runs = {name: out["launches"] for name, out in serves.items()}
    runs.update({f"path[{v},{lay}]": c for (v, lay), c in path_launches.items()})
    runs.update({f"spec_path[{v},{lay}]": c
                 for (v, lay), c in spec_launches.items()})
    runs["path[lm124]"] = lm_launches
    runs["path[llama2-7b]"] = l7_launches
    runs["path[mixtral-8x7b]"] = mx_launches
    runs["scan_path[llama2-7b]"] = l7s_launches
    runs["scan_path[mixtral-8x7b]"] = mxs_launches
    runs["scan_serve[spec]"] = scsrv["speculative"]["launches"]
    runs.update({f"scan_path[{v}]": c for v, c in scan_launches.items()})
    runs["kt_path[llama2-7b]"] = kt_launches
    runs.update(cal_launches)
    runs["serve[llama2-7b,scan]"] = l7_scan_launches
    paged_kernels = ("scatter_pool_rows", "decode_attention_paged")
    for row in rows:
        if "launch_from" in row:
            phase, key = row.pop("launch_from")
            row["launches"] = bf16_dot_launches(runs[phase], key)
            row["launches_phase"] = phase
            if runs[phase].get(key, 0) and not row["launches"]:
                row.setdefault("note", I8_NOTE)
            if key.startswith(("scatter_rows[bf16", "scatter_pool_rows[bf16"))\
                    and not row["launches"]:
                row["note"] = ("a window's rows are written inside the "
                               "attention launch; a bf16 prompt by indexing")
            continue
        name = row["name"]
        kernel, _, var = name.partition("[")
        var = var.rstrip("]")
        layout = "paged" if kernel in paged_kernels else "contiguous"
        if "variant" in row:
            key = f"{kernel}[{row['variant']}]"
            phase = next((ph for ph, c in runs.items() if c.get(key, 0) > 0),
                         "serve")
        elif not var:
            phase, key = ("paged_serve" if layout == "paged" else "serve"), name
        elif (var, layout) in (("int8", "contiguous"), ("k8v4", "paged")):
            phase = ("paged_serve" if layout == "paged" else "serve") + \
                f"[{var}]"
            key = name
        else:
            phase, key = f"path[{var},{layout}]", name
        row["launches"] = bf16_dot_launches(runs[phase], key)
        row["launches_phase"] = phase
        if kernel in ("scatter_rows", "scatter_pool_rows") and \
                not row["launches"]:
            row["note"] = ("decode and verify rows are written inside the "
                           "attention launch (the #3+2 / #5+6 rows); a bf16 "
                           "prompt or chunk is written by indexing")
        if runs[phase].get(key, 0) and not row["launches"]:
            row.setdefault("note", I8_NOTE)
        if "variant" in row and not row["launches"]:
            row["note"] = ("no model of the repo has a weight of this width"
                           if row["variant"].startswith("n") else
                           "no phase of this run serves this weight variant")
    log(f"total {time.perf_counter() - T0:.2f}s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
