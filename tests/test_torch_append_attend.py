"""The decode / verify step's row writers folded into its attention launch:
`kvcache.append_attend` hands a step's K/V rows to #3 (contiguous, and a
stacked cache's layer views, where #2 and #8 wrote them before) or #5
(paged, where #6 did), which writes them before it reads the cache.

On the CPU the fold's route is the writers' plain versions, then the
attention's: its cache bytes, scales and outputs equal `append_token` /
`append_tokens` followed by the attention call bit for bit, on every
layout (the kt-mirror cache keeps #2, then #7) and store, at T = 1 and 5,
with an inactive slot, positions past the cache and a window that crosses
a page. A host emulation of the kernel's ownership map checks, for the
plans `attention_plan` gives TinyLlama's, the 7B's and Mixtral's heads,
that every new row is written by exactly one split of its cluster and
that the split's walk holds the row's tile.

No JAX here. The card cases (`cuda` marker) hold the kernel to the plain
route: cache bytes and scales exact, each output row within 1e-2 of its
max, finite, with stale or NaN bytes in the rows' slots before the call;
and one launch a call, no row writer. They run with `python -m pytest -m
cuda tests/test_torch_append_attend.py`.
"""

import copy

import numpy as np
import pytest
import torch

from deeppowers_tpu_torch.ops.kernels import decode_attention as da
from deeppowers_tpu_torch.ops.kernels import kv_append as ka
from deeppowers_tpu_torch.quant.kvquant import store_args
from deeppowers_tpu_torch.runtime import kvcache
from deeppowers_tpu_torch.runtime import kvcache_paged as kp
from deeppowers_tpu_torch.runtime import kvcache_stacked as ks

STORES = ("bf16", "int8", "int4", "k8v4")
LAYOUTS = ("contiguous", "stacked", "paged", "kt")
#: (query heads, kv heads, head_dim) of the served models
MODELS = {"tinyllama": (32, 4, 64), "llama2-7b": (32, 32, 128),
          "mixtral-8x7b": (32, 8, 128)}


def _bits_view(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes as integers, so that NaN compares equal."""
    return t.view({1: torch.int8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _same(a, b) -> bool:
    return torch.equal(_bits_view(a), _bits_view(b))


def _caches(layout, store, b, s, kh, d, page, dev, seed, layers=2):
    """A one-layer handle of a cache of `store` (the last of `layers`
    layers, stacked or unrolled, or one of the paged layout) over random
    rows and scales, the pool's pages in a shuffled table."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    kw = dict(kv_cache_dtype=store, device=dev)
    if layout == "paged":
        caches = kp.init_paged_cache(layers, b, s, kh, d, page_size=page,
                                     **kw)
        table = (torch.randperm(b * (s // page), generator=g) + 1).reshape(
            b, -1).numpy().astype(np.int32)
        kp.with_table(caches, table)
        layer = caches[-1]
        arrays = (layer.k_pool, layer.v_pool, layer.k_scale, layer.v_scale)
    elif layout == "stacked":
        cache = ks.init_cache(layers, b, s, kh, d, **kw)
        layer = ks.layers(cache)[-1]
        arrays = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    else:
        caches = kvcache.init_cache(layers, b, s, kh, d, kv_kt=layout == "kt",
                                    **kw)
        layer = caches[-1]
        arrays = (layer.k, layer.v, layer.k_scale, layer.v_scale)
    for arr in arrays:
        if arr is None:
            continue
        if arr.dtype == torch.int8:
            arr.copy_(torch.randint(-128, 128, arr.shape, generator=g,
                                    dtype=torch.int8))
        elif arr.dtype == torch.float32:
            arr.copy_(0.001 + 0.02 * torch.rand(arr.shape, generator=g))
        else:
            arr.copy_(torch.randn(arr.shape, generator=g).to(arr.dtype))
    if layout == "kt":
        # the mirror holds k's committed chunks, as its writers keep it
        c_n = layer.kt.shape[1]
        layer.kt.copy_(layer.k.reshape(b, c_n, da.KT_CHUNK, -1)
                       .transpose(2, 3))
    return layer


def _state(layer):
    """Every tensor a write may touch, for comparison."""
    if isinstance(layer, ks.StackedLayer):
        c = layer.cache
        return [c.k, c.v] + ([c.k_scale, c.v_scale] if c.quantized else [])
    if kvcache._is_paged(layer):
        return [layer.k_pool, layer.v_pool] + (
            [layer.k_scale, layer.v_scale] if layer.quantized else [])
    out = [layer.k, layer.v] + (
        [layer.k_scale, layer.v_scale] if layer.quantized else [])
    return out + ([layer.kt] if layer.kt is not None else [])


def _stale(layer, lens, s, page):
    """NaN (bf16) or the byte 77 and NaN scales at every row from each
    slot's cached length on: the slots the step's rows land in hold
    nothing that may be read."""
    dev = _state(layer)[0].device
    stale = torch.arange(s, device=dev)[None, :] >= torch.as_tensor(
        lens, device=dev)[:, None]                         # (B, S)
    if kvcache._is_paged(layer):
        bi, p = stale.nonzero(as_tuple=True)
        pid = layer.table[bi, p // page].long()
        sides = ((layer.k_pool, layer.k_scale), (layer.v_pool, layer.v_scale))
        for st, sc in sides:
            st.view(-1, st.shape[-1])[pid * page + p % page] = (
                77 if st.dtype == torch.int8 else float("nan"))
            if sc is not None:
                sc[pid, :, p % page] = float("nan")
        return
    if isinstance(layer, ks.StackedLayer):
        c, i = layer.cache, layer.index
        sides = ((c.k[i], None if c.k_scale is None else c.k_scale[i]),
                 (c.v[i], None if c.v_scale is None else c.v_scale[i]))
    else:
        sides = ((layer.k, layer.k_scale), (layer.v, layer.v_scale))
    for st, sc in sides:
        st[stale] = 77 if st.dtype == torch.int8 else float("nan")
        if sc is not None:
            sc.masked_fill_(stale[:, None, :], float("nan"))


def _step(t, b, s, page, dev):
    """(positions (B, T) with -1 for none, attended lengths (B,), cached
    lengths (B,)): slot 0 mid-cache, slot 1 inactive, slot 2 at the cache
    end (rows at or past S drop), slot 3 a window across a page edge."""
    base = [20, 0, s - 2 if t > 1 else s, page - 2 if t > 1 else page - 1]
    pos = torch.tensor(base, dtype=torch.long)[:, None] + torch.arange(t)
    pos[1] = -1
    att = [min(n + t, s) for n in base]
    att[1] = 0
    att[2] = s
    cached = [20, 0, s, base[3]]
    return pos.to(dev), torch.tensor(att, dtype=torch.int32, device=dev), \
        cached


def _old_route(layer, q, k_new, v_new, pos, att):
    """The step as the port ran it before the fold: the writer, then the
    attention call."""
    t = q.shape[1]
    if t == 1:
        kvcache.append_token(layer, k_new[:, 0], v_new[:, 0], pos[:, 0])
    else:
        kvcache.append_tokens(layer, k_new, v_new, pos)
    qf = da.fold_tokens(q)
    if getattr(layer, "kt", None) is not None:
        out = da.decode_attention_kt(qf, layer.kt, layer.k, layer.v, att,
                                     layer.k_scale, layer.v_scale, tokens=t,
                                     v_bits=layer.vbits)[0]
    elif kvcache._is_paged(layer):
        out = da.decode_attention_paged(qf, layer.k_pool, layer.v_pool,
                                        layer.table, att, tokens=t,
                                        **store_args(layer))
    elif isinstance(layer, ks.StackedLayer):
        c, i = layer.cache, layer.index
        out = da.decode_attention(qf, c.k[i], c.v[i], att, tokens=t,
                                  **ks.store_args(c, i))
    else:
        out = da.decode_attention(qf, layer.k, layer.v, att, tokens=t,
                                  **store_args(layer))
    return da.unfold_tokens(out, t)


def _inputs(t, b, hq, kh, d, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, t, hq, d, generator=g).to(torch.bfloat16)
    k = torch.randn(b, t, kh, d, generator=g).to(torch.bfloat16)
    v = torch.randn(b, t, kh, d, generator=g).to(torch.bfloat16)
    return q.to(dev), k.to(dev), v.to(dev)


CPU_SHAPE = dict(b=4, s=128, hq=4, kh=2, d=16, page=16)
#: every layout and store, the kt mirror on its int8-K stores only
FOLD_CASES = [(lay, st) for lay in LAYOUTS for st in STORES
              if lay != "kt" or st in ("int8", "k8v4")]


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("layout,store", FOLD_CASES)
def test_fold_route_is_append_then_attend(layout, store, t):
    """append_attend against append_token / append_tokens then the
    attention call, on the CPU: cache bytes, scales (and the kt mirror)
    and outputs equal bit for bit, over an inactive slot, rows past the
    cache and a window across a page."""
    b, s, hq, kh, d, page = (CPU_SHAPE[k] for k in
                             ("b", "s", "hq", "kh", "d", "page"))
    seed = 100 + LAYOUTS.index(layout) * 10 + STORES.index(store) + t
    layer = _caches(layout, store, b, s, kh, d, page, "cpu", seed)
    pos, att, cached = _step(t, b, s, page, "cpu")
    _stale(layer, cached, s, page)
    ref_layer = copy.deepcopy(layer)
    q, k_new, v_new = _inputs(t, b, hq, kh, d, "cpu", seed)
    want = _old_route(ref_layer, q, k_new, v_new, pos, att)
    at = kvcache.decode_rows(layer, pos)
    got = kvcache.append_attend(layer, q, k_new, v_new, att, at)
    assert got.shape == (b, t, hq, d)
    assert _same(got, want)
    for x, y in zip(_state(layer), _state(ref_layer)):
        assert _same(x, y)


def test_fold_kt_route_keeps_the_writer():
    """The kt-mirror cache's step writes its rows through `append_token`
    (#2), then attends through #7: the route is the layout's, and #7 is
    never handed rows."""
    layer = _caches("kt", "int8", 4, 128, 2, 16, 16, "cpu", 3)
    pos, att, _ = _step(1, 4, 128, 16, "cpu")
    calls = []
    real = kvcache.append_token
    try:
        kvcache.append_token = lambda *a, **k: calls.append(1) or real(*a,
                                                                      **k)
        q, k_new, v_new = _inputs(1, 4, 4, 2, 16, "cpu", 3)
        kvcache.append_attend(layer, q, k_new, v_new, att,
                              kvcache.decode_rows(layer, pos))
    finally:
        kvcache.append_token = real
    assert calls == [1]


def _walk(plan, split, length):
    """The kernel's walk of one split (csrc/decode_attention.cuh): for each
    position group, the tiles it lands, as (t0, live rows)."""
    s0 = split * plan.chunk
    s1 = min(s0 + plan.chunk, length)
    ntiles = -(-(s1 - s0) // plan.tile) if s1 > s0 else 0
    walks = {}
    for pg in range(plan.pw):
        mine = -(-(ntiles - pg) // plan.pw) if ntiles > pg else 0
        tiles = []
        for i in range(mine):
            t0 = s0 + (pg + i * plan.pw) * plan.tile
            tiles.append((t0, min(plan.tile, s1 - t0)))
        walks[pg] = tiles
    return walks


def _owner(plan, p, s):
    """The splits whose block writes new row p (`owns_new`)."""
    return [sp for sp in range(plan.nsplit)
            if 0 <= p < s and p // plan.chunk == sp]


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("page", [None, 16, 128])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_new_rows_are_written_once_inside_their_walk(model, page, t):
    """For the plans of the served heads (8 slots, S = 1024), at lengths
    at and around tile, split and page ends: every new row of a window
    (positions length - T .. length - 1) has exactly one owning split, and
    exactly one position group of that split lands the row's tile, with
    the row inside the tile's live rows, so the block that wrote the row
    is the block that reads it, after its barrier."""
    hq, kh, d = MODELS[model]
    s = 1024
    plan = da.attention_plan(8, kh, s, hq // kh * t, d, page)
    edges = {t, s}
    for step in (plan.tile, plan.chunk, page or plan.tile):
        for m in range(1, s // step + 1):
            edges |= {m * step - 1, m * step, m * step + 1}
    for length in sorted(n for n in edges if t <= n <= s):
        for p in range(length - t, length):
            owners = _owner(plan, p, s)
            assert len(owners) == 1, (length, p, plan)
            hits = [pg for pg, tiles in _walk(plan, owners[0],
                                              length).items()
                    for t0, n in tiles if t0 <= p < t0 + n]
            assert len(hits) == 1, (length, p, plan)
        # a position at or past S has no owner: it writes nothing
        assert _owner(plan, s, s) == [] and _owner(plan, -1, s) == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def _check_rows(out, ref):
    """Finite, and each (slot, token, head) row within 1e-2 of its own
    max|ref| (a row with nothing visible is exactly 0)."""
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().amax(-1)
    top = ref.float().abs().amax(-1)
    assert (err <= 1e-2 * top).all(), (err / top.clamp_min(1e-30)).max()


CARD_CASES = [(m, lay, t) for m in ("tinyllama", "llama2-7b")
              for lay in ("contiguous", "stacked", "paged16", "paged128")
              for t in (1, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_cuda_fold_matches_plain(cuda_device, case, store, monkeypatch):
    """The fold on the card against its plain route on copies of the same
    cache (8 slots, S = 1024, stale NaN in the rows' slots): cache bytes
    and scales equal, every output row within 1e-2 of its max|ref| and
    finite; one counted launch a call. #3's bf16-dot kernel
    (DPT_ATTN_INT8=0): the int8-dot variant's fold cases are
    tests/test_torch_decode_attention.py's."""
    monkeypatch.setenv("DPT_ATTN_INT8", "0")
    model, layout, t = case
    hq, kh, d = MODELS[model]
    b, s = 8, 1024
    page = int(layout[5:]) if layout.startswith("paged") else 128
    lay = "paged" if layout.startswith("paged") else layout
    seed = sum(map(ord, str(case) + store))
    layer = _caches(lay, store, b, s, kh, d, page, cuda_device, seed)
    g = torch.Generator(device="cpu").manual_seed(seed)
    cached = torch.randint(page - 3, s - t, (b,), generator=g)
    cached[:4] = torch.tensor([page - 1, 2 * page - 2, s - t, 0])
    pos = cached[:, None] + torch.arange(t)
    pos[3] = -1                                # an inactive slot
    att = (cached + t).to(torch.int32)
    att[3] = 0
    _stale(layer, cached.tolist(), s, page)
    ref = copy.deepcopy(layer)
    q, k_new, v_new = _inputs(t, b, hq, kh, d, cuda_device, seed)
    pos, att = pos.to(cuda_device), att.to(cuda_device)
    at = kvcache.decode_rows(layer, pos)
    new = at._replace(k=k_new.reshape(b, t, -1), v=v_new.reshape(b, t, -1))
    qf = da.fold_tokens(q)

    def call(c):
        """(attention args, store kwargs) over one copy of the layer."""
        if lay == "paged":
            return (qf, c.k_pool, c.v_pool, c.table, att), store_args(c)
        if lay == "stacked":
            st, i = c.cache, c.index
            return (qf, st.k[i], st.v[i], att), ks.store_args(st, i)
        return (qf, c.k, c.v, att), store_args(c)

    fn, plain = ((da.decode_attention_paged, da.decode_attention_paged_plain)
                 if lay == "paged" else
                 (da.decode_attention, da.decode_attention_plain))
    key = (store if t == 1 else f"{store}:t{t}") + "+rows"
    before = fn.variant_launches[key]
    args, kw = call(layer)
    out = fn(*args, tokens=t, new=new, **kw)
    args, kw = call(ref)
    want = plain(*args, tokens=t, new=new, **kw)
    torch.cuda.synchronize()
    assert fn.variant_launches[key] == before + 1
    for x, y in zip(_state(layer), _state(ref)):
        assert _same(x, y)
    _check_rows(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "stacked", "paged"])
def test_cuda_fold_is_one_launch(cuda_device, layout):
    """A k8v4 decode step's layer at TinyLlama's heads through
    `append_attend`: one attention kernel, no row writer, under
    torch.profiler."""
    hq, kh, d = MODELS["tinyllama"]
    b, s = 8, 1024
    layer = _caches(layout, "k8v4", b, s, kh, d, 128, cuda_device, 9)
    lens = torch.tensor([48, 96, 132, 232, 332, 482, 632, 932])
    pos = (lens - 1)[:, None].to(cuda_device)
    at = kvcache.decode_rows(layer, pos)
    q, k_new, v_new = _inputs(1, b, hq, kh, d, cuda_device, 9)
    att = lens.to(cuda_device, torch.int32)
    call = lambda: kvcache.append_attend(layer, q, k_new, v_new,  # noqa
                                         att, at)
    call()
    torch.cuda.synchronize()
    writers = (ka.scatter_rows.launches, ka.scatter_rows_stacked.launches,
               ka.scatter_pool_rows.launches)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower()]
    assert len([k for k in kernels if "attention_kernel" in k]) == 1, kernels
    assert not any("kv_append" in k for k in kernels), kernels
    assert writers == (ka.scatter_rows.launches,
                       ka.scatter_rows_stacked.launches,
                       ka.scatter_pool_rows.launches)
