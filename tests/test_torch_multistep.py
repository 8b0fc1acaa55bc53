"""Multi-step dispatch and the pipelined harvest of the port's engine
against the JAX engine (`decode_steps_per_dispatch`, `pipelined_dispatch`,
JAX engine.py:738-755, 1512-1808; tests/test_multistep.py).

Tiny configs, f32 activations, both engines built with the same
RuntimeConfig. Every step()'s {slot: tokens}, the final tokens, the stop
reasons and both counters (dispatch_count, transfer_count) must equal the
JAX engine's, at depths 1, 3, 7 and 12, pipelined and not, with slots
admitted and retired while a dispatch is in flight; the port's own streams
must be the same at every depth and with or without pipelining. Also: the
depth invariance at the cache end, the auto depth from synthetic times,
speculation at N = 3, lazy paging with preemption at N = 4, and a
pipelined harvest across a cancel and a re-admission of the slot (the
epoch merge); a CPU rehearsal of chip_smoke.py's dispatch checks. The card
tests (graph against eager, the replay counters) carry the `cuda` marker
and skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.config import GenerationConfig as JGen
from deeppowers_tpu.config import RuntimeConfig as JRuntime
from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.models.presets import tiny_llama_config as jax_tiny_llama
from deeppowers_tpu.models.presets import tiny_moe_config as jax_tiny_moe
from deeppowers_tpu.models.presets import tiny_test_config as jax_tiny_test
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine

from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import (tiny_llama_config,
                                                 tiny_moe_config,
                                                 tiny_test_config)
from deeppowers_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(1)

DEPTHS = [1, 3, 7, 12]
PRESETS = {"tiny-llama": (jax_tiny_llama, tiny_llama_config),
           "tiny-moe": (jax_tiny_moe, tiny_moe_config),
           "tiny-test": (jax_tiny_test, tiny_test_config)}


def _model(name, max_seq_len=256, seed=3):
    jfn, tfn = PRESETS[name]
    jcfg = jfn(max_seq_len=max_seq_len)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed),
                             dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tfn(max_seq_len=max_seq_len), tparams


@pytest.fixture(scope="module")
def models():
    return {name: _model(name) for name in ("tiny-llama", "tiny-moe")}


def _engines(model, *, jax_too=True, eos=None, draft=None, layout=None,
             pages=None, **rt):
    jcfg, jparams, cfg, tparams = model
    kw = dict(max_batch_size=3, max_seq_len=128, prefill_buckets=(16, 32))
    kw.update(rt)
    common = dict(eos_token_id=eos)
    if layout is not None:
        common.update(kv_layout=layout, kv_total_pages=pages)
    jkw, tkw = dict(common), dict(common)
    if draft is not None:
        jkw.update(draft_params=draft[1], draft_cfg=draft[0])
        tkw.update(draft_params=draft[3], draft_cfg=draft[2])
    teng = InferenceEngine(tparams, cfg, runtime=RuntimeConfig(**kw),
                           act_dtype=torch.float32, device="cpu", **tkw)
    if not jax_too:
        return None, teng
    jeng = JEngine(jparams, jcfg, runtime=JRuntime(**kw),
                   act_dtype=jnp.float32, **jkw)
    return jeng, teng


def _gen(n, **kw):
    return (JGen(max_tokens=n, temperature=0.0, do_sample=False, **kw),
            GenerationConfig(max_tokens=n, temperature=0.0, do_sample=False,
                             **kw))


#: (step index before which it arrives, request id, prompt, max_tokens)
ARRIVALS = [(0, "a", [1, 2, 3, 4, 5], 17), (0, "b", [9, 8, 7], 6),
            (0, "c", [11, 12], 11), (2, "d", [20, 21, 22, 23], 9),
            (5, "e", [5, 6], 13), (9, "f", [30, 31, 32, 33, 34, 35], 4)]


def _drive(eng, jax_engine: bool, eos_stop=None):
    """Requests arriving over the run (a free slot each, else they wait):
    every step()'s {slot: tokens}, then each request's (stop reason,
    tokens), and the engine's counters."""
    pending = list(ARRIVALS)
    steps, done = [], {}
    for i in range(200):
        while pending and pending[0][0] <= i and eng.free_slots:
            _, rid, prompt, n = pending.pop(0)
            g = _gen(n, stop_token_ids=() if eos_stop is None
                     else (eos_stop,))[0 if jax_engine else 1]
            eng.add_request(prompt, g, request_id=rid)
        out = eng.step()
        steps.append({int(s): [int(t) for t in toks]
                      for s, toks in out.items()})
        for r in eng.pop_finished():
            done[r.request_id] = (r.stop_reason, list(r.token_ids))
        if not pending and not eng.active_requests and not out:
            break
    return steps, done, (eng.dispatch_count, eng.transfer_count)


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("n", DEPTHS)
@pytest.mark.parametrize("name", ["tiny-llama", "tiny-moe"])
def test_steps_match_jax(models, name, n, pipelined):
    """Six requests through three slots, admitted as slots free up while a
    dispatch may be in flight, retired by max_tokens inside a dispatch:
    each step()'s {slot: tokens}, each request's stop reason and tokens,
    dispatch_count and transfer_count are the JAX engine's."""
    jeng, teng = _engines(models[name], decode_steps_per_dispatch=n,
                          pipelined_dispatch=pipelined)
    want = _drive(jeng, True)
    got = _drive(teng, False)
    assert got[1] == want[1]
    assert got[0] == want[0]
    assert got[2] == want[2]
    assert len(got[1]) == len(ARRIVALS)


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-moe"])
def test_streams_equal_across_depths_and_pipelining(models, name):
    """The port's own streams: every request's stop reason and tokens are
    the same at every depth, pipelined or not, and with a stop id that
    cuts inside a dispatch."""
    runs = {}
    for n in DEPTHS:
        for pipelined in (False, True):
            _, teng = _engines(models[name], jax_too=False,
                               decode_steps_per_dispatch=n,
                               pipelined_dispatch=pipelined)
            runs[(n, pipelined)] = _drive(teng, False)[1]
    first = runs[(1, False)]
    assert all(r == first for r in runs.values())
    stop = first["a"][1][4]
    cut = {}
    for n in (1, 7):
        _, teng = _engines(models[name], jax_too=False,
                           decode_steps_per_dispatch=n)
        cut[n] = _drive(teng, False, eos_stop=stop)[1]
    assert cut[1] == cut[7]
    assert cut[1]["a"] == ("eos", first["a"][1][:first["a"][1].index(stop)
                                                 + 1])


def test_depth_invariant_at_cache_boundary():
    """JAX's test_depth_invariant_at_cache_boundary: tiny-test (max_seq_len
    64) and 80 tokens wanted, so every depth stops at the cache end, with
    the same tokens at depths 1, 7 and 12, and the JAX engine's."""
    model = _model("tiny-test", max_seq_len=64, seed=0)
    gj, gt = _gen(80)
    outs = {}
    for d in (1, 7, 12):
        jeng, teng = _engines(model, jax_too=d == 1, max_batch_size=2,
                              max_seq_len=256, prefill_buckets=(16,),
                              decode_steps_per_dispatch=d)
        res = teng.generate([1, 2, 3], gt)
        assert res.stop_reason == "max_seq"
        outs[d] = res.token_ids
        if jeng is not None:
            assert jeng.generate([1, 2, 3], gj).token_ids == res.token_ids
    assert outs[1] == outs[7] == outs[12]


@pytest.mark.parametrize("fixed,step_s,want", [(0.035, 0.0018, 32),
                                               (0.0001, 0.002, 1)])
def test_auto_depth_from_synthetic_times(models, fixed, step_s, want):
    """tests/test_multistep.py's two cases: from 7 dispatches at 4 and 7 at
    12 of D + n·s seconds, the auto depth climbs to 32 (D = 35 ms, s = 1.8
    ms) or stays at 1 (D = 0.1 ms, s = 2 ms), as the JAX engine's does."""
    jeng, teng = _engines(models["tiny-llama"], decode_steps_per_dispatch=0)
    for eng in (jeng, teng):
        assert eng._auto_dispatch and eng._steps_per_dispatch == 4
        for _ in range(7):
            eng._auto_observe(fixed + 4 * step_s)
        assert eng._steps_per_dispatch == 12 and not eng._auto_done
        for _ in range(7):
            eng._auto_observe(fixed + 12 * step_s)
        assert eng._auto_done and eng._steps_per_dispatch == want


def test_auto_depth_generation_matches_fixed_depth(models):
    """A generation long enough to pass both probes (4, then 12) gives the
    tokens of depth 1."""
    gj, gt = _gen(120)
    _, fixed = _engines(models["tiny-llama"], jax_too=False,
                        max_seq_len=256)
    _, auto = _engines(models["tiny-llama"], jax_too=False, max_seq_len=256,
                       decode_steps_per_dispatch=0)
    want = fixed.generate([1, 2, 3], gt).token_ids
    assert auto.generate([1, 2, 3], gt).token_ids == want
    assert auto._auto_times[4] and auto._auto_times[12]


REPETITIVE = [3, 1, 4, 1, 5, 9, 2, 6] * 3


@pytest.mark.parametrize("kind", ["lookup", "draft"])
def test_speculation_at_depth_3(models, kind):
    """Prompt-lookup and draft speculation (K = 3) at three steps a
    dispatch: greedy tokens equal the JAX engine's at depth 3 and the
    port's at depth 1; the harvest's rows are (step, window position), so
    each dispatch counts 3 windows a slot."""
    model = models["tiny-llama"]
    draft = model if kind == "draft" else None
    gj, gt = _gen(30)
    prompts = [REPETITIVE, [7, 7, 8, 7, 7, 8, 7, 7], [2, 4, 6, 8]]
    kw = dict(speculative_tokens=3, draft=draft)
    jeng, teng = _engines(model, decode_steps_per_dispatch=3, **kw)
    _, one = _engines(model, jax_too=False, **kw)
    want = [r.token_ids for r in jeng.generate_batch(prompts, gj)]
    got = [r.token_ids for r in teng.generate_batch(prompts, gt)]
    assert got == want
    assert [r.token_ids for r in one.generate_batch(prompts, gt)] == got
    assert teng.spec_steps == 3 * teng.dispatch_count
    assert teng.spec_accept_hist.sum() >= teng.spec_steps
    assert teng.spec_emitted == sum(len(t) - 1 for t in got)


def test_lazy_paging_preempts_at_depth_4(models):
    """A 5-page pool too small for two long requests under lazy
    reservation, at four steps a dispatch (growth of 4 rows ahead): the
    younger is preempted at the same step as in the JAX engine, and the
    older completes with the same tokens."""
    gj, gt = _gen(120)
    jeng, teng = _engines(models["tiny-llama"], layout="paged", pages=5,
                          max_batch_size=2, max_seq_len=256, kv_page_size=32,
                          prefill_chunk_size=32, prefill_buckets=(32, 64),
                          kv_reserve="lazy", kv_lazy_slack=16,
                          decode_steps_per_dispatch=4)
    done = []
    for eng, g in ((jeng, gj), (teng, gt)):
        eng.add_request([1, 2, 3, 4], g, request_id="old")
        eng.add_request([5, 6, 7, 8], g, request_id="young")
        out, steps = {}, []
        for _ in range(200):
            steps.append({int(s): list(t) for s, t in eng.step().items()})
            for r in eng.pop_finished():
                out.setdefault(r.request_id, []).append(
                    (r.stop_reason, r.token_ids))
            if eng.active_requests == 0:
                break
        done.append((out, steps, eng.dispatch_count, eng.transfer_count))
    assert done[1] == done[0]
    assert [s for s, _ in done[1][0]["young"]] == ["preempted"]


def test_pipelined_harvest_across_cancel_and_readmission(models):
    """Pipelined: a slot is cancelled and a new request takes it while a
    dispatch that ran the old occupant is in flight. The harvest of that
    dispatch must neither give the new request the old one's tokens nor
    bring back the old occupant's length (the epoch merge, JAX
    engine.py:1693-1712): every step's output, the tokens, the stop
    reasons and the counters are the JAX engine's."""
    logs = []
    for jax_engine in (True, False):
        jeng, teng = _engines(models["tiny-llama"], max_batch_size=2)
        eng = jeng if jax_engine else teng
        g = _gen(12)[0 if jax_engine else 1]
        steps, done = [], {}
        eng.add_request([1, 2, 3], g, request_id="x")
        eng.add_request([4, 5, 6, 7], g, request_id="y")
        for i in range(40):
            if i == 3:
                eng.cancel(0)
                eng.add_request([8, 9], g, request_id="z")
            out = eng.step()
            steps.append({int(s): [int(t) for t in v]
                          for s, v in out.items()})
            for r in eng.pop_finished():
                done[r.request_id] = (r.stop_reason, list(r.token_ids))
            if not eng.active_requests and not out:
                break
        logs.append((steps, done, eng.dispatch_count, eng.transfer_count,
                     eng._lengths_host.tolist()))
    assert logs[1] == logs[0]
    assert logs[1][1]["x"][0] == "cancelled"
    assert logs[1][1]["z"][0] == "max_tokens"


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py's dispatch "
                    "phase runs the graphs on the card)")
    return torch.device("cuda")


def _cuda_engine(dev, **rt):
    from deeppowers_tpu_torch.config import QuantConfig
    from deeppowers_tpu_torch.models import transformer as T
    # head width 64: the card's attention kernel takes D = 64 and 128
    cfg = tiny_llama_config(max_seq_len=256, vocab_size=512, hidden_size=256,
                            intermediate_size=512)
    params = T.quantize_params(T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0),
        dtype=torch.bfloat16, device=dev), QuantConfig())
    kw = dict(max_batch_size=4, max_seq_len=256, prefill_buckets=(16, 32))
    kw.update(rt)
    return InferenceEngine(params, cfg, device=dev,
                           runtime=RuntimeConfig(**kw))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4])
def test_cuda_graph_streams_equal_eager_steps(cuda_device, n):
    """On the card every dispatch replays a captured graph; its greedy
    tokens are those of the eager step (`_run_step` on the engine's own
    buffers, one step at a time) from the same admissions."""
    g = GenerationConfig(max_tokens=20, temperature=0.0)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8], [9, 10]]
    graphed = _cuda_engine(cuda_device, decode_steps_per_dispatch=n)
    got = [r.token_ids for r in graphed.generate_batch(prompts, g)]
    assert graphed._graphs.variants
    eager = _cuda_engine(cuda_device, pipelined_dispatch=False)
    for p in prompts:
        eager.add_request(p, g)
    want = {s: eager._slots[s].token_ids for s in range(len(prompts))}
    for _ in range(19):
        eager._row.zero_()
        with torch.no_grad():
            eager._run_step(eager._variant(True), eager.state, eager._out,
                            eager._row, eager._history, eager._draft_tail)
        rows = eager._out[0].long().tolist()
        for s in want:
            if rows[s] >= 0:
                want[s].append(rows[s])
    assert got == [want[s][:len(got[s])] for s in range(len(prompts))]


@pytest.mark.cuda
def test_cuda_replays_add_their_capture_counts(cuda_device):
    """Each replay adds the launches its capture recorded: a dispatch of
    4 steps counts 4 decode steps' launches of #1 and #3, as 4 eager steps
    would; the warm-up and the capture count none."""
    from deeppowers_tpu_torch.ops.kernels import decode_attention as da
    from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
    eng = _cuda_engine(cuda_device, decode_steps_per_dispatch=4,
                       pipelined_dispatch=False)
    eng.add_request([1, 2, 3], GenerationConfig(max_tokens=40,
                                                temperature=0.0))
    eng.step()
    a0, m0 = da.decode_attention.launches, dm.dequant_matmul.launches
    eng.step()
    layers = eng.cfg.num_layers
    assert da.decode_attention.launches - a0 == 4 * layers
    per_step = dm.dequant_matmul.launches - m0
    assert per_step % 4 == 0 and per_step > 0


class _EagerGraphs:
    """Stands in for runtime/graphs.StepGraphs on the CPU: a variant's
    warm-up once, the generator put back after it, then its step n times
    a replay. `twice` runs every step twice, a replay that is not the
    eager step."""

    capture_s = 0.0

    def __init__(self, generator, twice=False):
        self._generator, self._twice, self._seen = generator, twice, []

    @property
    def variants(self):
        return list(self._seen)

    def pool_bytes(self):
        return 0

    def replay(self, key, step, warm, n=1):
        if key not in self._seen:
            rng = self._generator.get_state()
            warm()
            self._generator.set_state(rng)
            self._seen.append(key)
        for _ in range(n * (2 if self._twice else 1)):
            step()


def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_dispatch_checks_run_on_cpu(monkeypatch):
    """A CPU rehearsal of chip_smoke.py's dispatch phase on tiny-llama
    int8 (three prompts, 8 tokens), the graphs replaced by eager steps:
    graph against eager in five variants, the greedy streams at its four
    runtimes, the sampled checks, lazy paging that preempts at N = 1 and
    4; and a replay that runs its step twice must fail the graph
    check."""
    from deeppowers_tpu_torch.config import QuantConfig
    from deeppowers_tpu_torch.models import transformer as T
    cs = _chip_smoke()
    cfg = tiny_llama_config(max_seq_len=1024, vocab_size=260)
    params = T.quantize_params(T.init_params(
        cfg, torch.Generator().manual_seed(0), dtype=torch.float32),
        QuantConfig())
    twice = []

    def engine(params, cfg, eos, *, kv="bf16", layout="contiguous",
               scan=False, pages=None, draft=None, **rt):
        kw = dict(max_batch_size=8, max_seq_len=1024,
                  prefill_buckets=(64, 128, 256, 512, 1024),
                  scan_layers=scan)
        kw.update(rt)
        extra = {} if draft is None else dict(draft_params=draft[0],
                                              draft_cfg=draft[1])
        eng = InferenceEngine(params, cfg, device="cpu", eos_token_id=eos,
                              kv_cache_dtype=kv, kv_layout=layout,
                              kv_total_pages=pages, act_dtype=torch.float32,
                              runtime=RuntimeConfig(**kw), **extra)
        eng._graphs = _EagerGraphs(eng._rng, twice=bool(twice))
        return eng

    monkeypatch.setattr(cs, "dispatch_engine", engine)
    monkeypatch.setattr(cs, "PROMPT_BYTES", (16, 40, 30))
    monkeypatch.setattr(cs, "MAX_TOKENS", 8)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    eos = 257

    def make(**kw):
        return lambda **rt: engine(params, cfg, eos, **kw, **rt)

    for name, kw, temp in (
            ("contiguous", {}, 0.0), ("paged", dict(layout="paged"), 0.0),
            ("lookup", dict(speculative_tokens=4, speculative_ngram=3), 0.0),
            ("draft", dict(draft=(params, cfg), speculative_tokens=4), 0.0),
            ("sampled", {}, 1.0)):
        got = cs.graph_check(torch, name, make(**kw), temperature=temp)
        assert got["tensors"] > 20 and got["variant"][0] in (
            "plain", "lookup", "draft")
    runs = cs.greedy_streams(torch, "tiny", make(),
                             list(cs.DISPATCH_RUNTIMES))
    assert runs["N=1 pipelined"][0] == runs["N=1 unpipelined"][0] + 1
    assert runs["N=4"][2] == 4
    sampled = cs.sampled_graphs(torch, params, cfg, eos)
    assert sampled["same_tokens"] < len(cs.PROMPT_BYTES)
    lazy = cs.lazy_preemption_streams(torch, params, cfg)
    assert lazy["old_tokens"] == 300 and max(lazy["young_tokens"]) < 300
    twice.append(True)
    with pytest.raises(RuntimeError, match="against the eager step"):
        cs.graph_check(torch, "twice", make())
