"""Kernels #3 and #5 (csrc/decode_attention.cu): the host planner on the
CPU over the served shapes, and the one-launch kernel against its plain
versions on the card (the `cuda` marker).

No JAX here: the plain versions are held against the JAX package in
tests/test_torch_kernels.py, test_torch_paged.py, test_torch_kvquant.py
and test_torch_speculative.py. The card cases run with
`python -m pytest -m cuda tests/test_torch_decode_attention.py`.
"""

import inspect

import pytest
import torch

from deeppowers_tpu_torch.ops.kernels import decode_attention as da
from deeppowers_tpu_torch.quant.kvquant import STORE_BITS, quant_side

STORES = ("bf16", "int8", "int4", "k8v4")
#: (query heads, kv heads, head_dim) of the served models
MODELS = {"tinyllama": (32, 4, 64), "llama2-7b": (32, 32, 128),
          "mixtral-8x7b": (32, 8, 128)}
MAX_SEQ = 1024
#: shared memory a block may use on an H100 (bytes)
SMEM_LIMIT = 232_448
#: shared memory of an H100 SM, 1 KB of it reserved a block (bytes)
SM_SMEM = 233_472


def _smem(plan, rows, d, kb, vb):
    """The kernel's dynamic shared memory: the groups' rings (K and V of a
    kv head in their stored form and their f32 scales a position), or the
    partials they merge at the end, whichever is larger."""
    scales = (kb != 16) * (2 if kb == 4 else 1) + \
        (vb != 16) * (2 if vb == 4 else 1)
    row = d * kb // 8 + d * vb // 8 + 4 * scales
    ring = plan.pw * plan.stages * plan.tile * row
    part = (plan.pw * rows * (d + 2) + 2 * rows) * 4
    return max(ring, part)


@pytest.mark.parametrize("page", [None, 16, 128, 512])
@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_attention_plan_over_served_shapes(model, store, page):
    """The plan at max_seq 1024 for every R = 1..64 (and the model's own
    decode and verify rows, rep and rep * 5): splits within a portable
    cluster of 8, a whole number of tiles (16 positions or more) a split
    covering S exactly, a tile inside one page, the fill rule (one wave of
    blocks, split as far as the wave, the cluster and two tiles a group
    allow), warps and shared memory within a block, and the same plan for
    the same shapes."""
    hq, kh, d = MODELS[model]
    kb, vb = STORE_BITS[store]
    rep = hq // kh
    for b in (1, 8):
        for rows in sorted(set(range(1, da.MAX_ROWS + 1)) | {rep, rep * 5}):
            plan = da.attention_plan(b, kh, MAX_SEQ, rows, d, page)
            assert plan == da.attention_plan(b, kh, MAX_SEQ, rows, d, page)
            assert 1 <= plan.nsplit <= da.MAX_SPLITS
            assert plan.tile % 16 == 0 and plan.chunk % plan.tile == 0
            assert (plan.nsplit - 1) * plan.chunk < MAX_SEQ \
                <= plan.nsplit * plan.chunk
            if page is not None:
                assert page % plan.tile == 0     # a tile never crosses a page
            # the fill rule: one wave of blocks, split as far as the wave,
            # the cluster and two tiles a group allow
            wave = da.SMS * max(1, da.SM_WARPS[d] // (plan.mg * plan.pw))
            assert b * kh * plan.nsplit <= wave or plan.nsplit == 1
            assert plan.chunk >= 2 * plan.pw * plan.tile or plan.nsplit == 1
            assert plan.nsplit == da.MAX_SPLITS or \
                b * kh * (plan.nsplit + 1) > wave or \
                MAX_SEQ // (plan.nsplit + 1) < 2 * plan.pw * plan.tile
            assert plan.mg * 16 >= rows > (plan.mg - 1) * 16
            assert plan.mg * plan.pw <= da.MAX_WARPS
            assert 1 <= plan.stages <= da.STAGES
            assert plan.stages == da.STAGES or plan.stages * plan.pw * \
                plan.tile >= plan.chunk           # every group's tiles fit
            assert _smem(plan, rows, d, kb, vb) <= SMEM_LIMIT


def test_attention_plan_reads_shapes_only():
    """No length reaches the planner (no host sync on a decode step), and
    the served decode steps give the intended grids: TinyLlama's 32 (slot,
    kv head) pairs 4 splits of 8 groups, the 7B's 256 pairs 1 (they pass
    a wave), Mixtral's 64 pairs 2; a verify window of 5 at TinyLlama's
    heads (40 rows) 4 splits of 2 groups of 3 warps over 64-position
    tiles (16 through pages of 16)."""
    params = inspect.signature(da.attention_plan).parameters
    assert not any("len" in p for p in params)
    assert da.attention_plan(8, 4, 1024, 8, 64)[:5] == (4, 256, 16, 8, 1)
    assert da.attention_plan(8, 32, 1024, 1, 128).nsplit == 1
    assert da.attention_plan(8, 8, 1024, 4, 128).nsplit == 2
    verify = da.attention_plan(8, 4, 1024, 40, 64)
    assert verify[:5] == (4, 256, 64, 2, 3)
    assert da.attention_plan(8, 4, 1024, 40, 64, page=16).tile == 16


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def _edge_lengths(plan, page, s, tokens):
    """Lengths at 0, 1 and one below, at and above a tile, a split and a
    page edge, and at S (a window's lengths keep its T rows)."""
    edges = {0, 1, s - 1, s}
    for step in (plan.tile, plan.chunk, page or plan.tile):
        edges |= {step - 1, step, step + 1, 2 * step + 1}
    lens = sorted(n for n in edges if 0 <= n <= s)
    if tokens > 1:
        lens = sorted({max(n, tokens) for n in lens})
    return lens


def _cache(store, b, s, kh, d, lens, g, dev, lead=(), extra=0):
    """A cache of `store` over random K/V, (B, S, F') stores and (B, R, S)
    scales as views of (lead..., B, S + extra, ...) tensors; rows and scales
    past each length hold NaN (bf16) or random codes and NaN scales."""
    kb, vb = STORE_BITS[store]
    stale = torch.arange(s + extra, device=dev)[None, :] >= torch.tensor(
        lens, device=dev)[:, None]

    def side(bits):
        x = torch.randn(*lead, b, s + extra, kh, d, generator=g, device=dev)
        if bits == 16:
            x = x.reshape(*lead, b, s + extra, kh * d).to(torch.bfloat16)
            x[..., stale, :] = float("nan")
            return x[..., :s, :], None
        st, sc = quant_side(x, bits, 2 if bits == 4 else 1)
        st = st.reshape(*lead, b, s + extra, -1)
        sc = sc.transpose(-1, -2).contiguous()
        sc.masked_fill_(stale[:, None, :], float("nan"))
        return st[..., :s, :], sc[..., :s]
    (kc, ks), (vc, vs) = side(kb), side(vb)
    if lead:
        kc, vc = kc[-1], vc[-1]
        ks, vs = (ks[-1], vs[-1]) if ks is not None else (None, None)
    kw = {} if store == "bf16" else dict(k_scale=ks, v_scale=vs, kv_bits=kb,
                                        v_bits=vb)
    return kc, vc, kw


def _pool(x, table, page):
    """(B, S, F) rows into a pool of (1 + B * S / page) pages at the table's
    ids; page 0 holds NaN (bf16) or random bytes."""
    b, s, f = x.shape
    p = torch.full((table.numel() + 1, page, f), float("nan"),
                   device=x.device).to(x.dtype) if x.dtype == torch.bfloat16 \
        else torch.randint(-128, 128, (table.numel() + 1, page, f),
                           device=x.device, dtype=x.dtype)
    p[table.reshape(-1).long()] = x.reshape(b * (s // page), page, f)
    return p


def _scale_pool(sc, table, page):
    b, r, s = sc.shape
    p = torch.full((table.numel() + 1, r, page), float("nan"),
                   device=sc.device)
    p[table.reshape(-1).long()] = sc.reshape(b, r, s // page, page).transpose(
        1, 2).reshape(-1, r, page)
    return p


def _check_rows(out, ref):
    """Finite, and each (slot, row) within 1e-2 of its own max|ref| (a row
    with no visible position is exactly 0)."""
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().amax(-1)
    top = ref.float().abs().amax(-1)
    assert (err <= 1e-2 * top).all(), (err / top.clamp_min(1e-30)).max()


# (model, T, layout): every store over TinyLlama's heads at T = 1 and 5 on
# both layouts (contiguous, a stacked cache's layer view, a window view of
# a longer cache; pages of 16, 128 and 512), the 7B's and Mixtral's heads,
# and R = 64 (the limit) at D = 64 (MQA) and D = 128 (T = 4)
CARD_CASES = (
    [("tinyllama", t, lay) for t in (1, 5)
     for lay in ("contiguous", "stacked", "window", 16, 128, 512)]
    + [(m, t, lay) for m in ("llama2-7b", "mixtral-8x7b") for t in (1, 5)
       for lay in ("contiguous", 128)]
    + [("r64-d64", 1, "contiguous"), ("r64-d64", 1, 16),
       ("r64-d128", 4, "contiguous"), ("r64-d128", 4, 512)])
HEADS = dict(MODELS, **{"r64-d64": (64, 1, 64), "r64-d128": (16, 1, 128)})


@pytest.mark.cuda
@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_cuda_decode_attention_matches_plain(cuda_device, case, store,
                                             monkeypatch):
    """#3 (contiguous, layer and window views) and #5 (paged) against their
    plain versions at lengths 0, 1 and around each tile, split and page
    edge, with NaN in stale rows and stale scales: every (slot, row) within
    1e-2 of its max|ref|, finite; two calls give identical bytes; each call
    one counted launch. #3's bf16-dot kernel (DPT_ATTN_INT8=0; the
    int8-dot variant's cases are below)."""
    monkeypatch.setenv("DPT_ATTN_INT8", "0")
    model, t, layout = case
    hq, kh, d = HEADS[model]
    dev, s = cuda_device, MAX_SEQ
    kb, vb = STORE_BITS[store]
    g = torch.Generator(device=dev).manual_seed(
        sum(map(ord, str(case))) + kb + vb)
    page = layout if isinstance(layout, int) else None
    rows = hq // kh * t
    b = 8
    plan = da.attention_plan(b, kh, s, rows, d, page)
    lens = (_edge_lengths(plan, page, s, t) * 2)[:b]
    lens += [s] * (b - len(lens))
    lead, extra = {"stacked": ((2,), 0), "window": ((), 64)}.get(layout,
                                                                ((), 0))
    kc, vc, kw = _cache(store, b, s, kh, d, lens, g, dev, lead, extra)
    q = torch.randn(b, hq * t, d, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor(lens, device=dev)
    if page is None:
        fn, args = da.decode_attention, (q, kc, vc, lengths)
        ref = da.decode_attention_plain(q, kc, vc, lengths, tokens=t, **kw)
    else:
        table = (torch.randperm(b * (s // page), generator=torch.Generator()
                                .manual_seed(t)) + 1).reshape(b, -1).to(
            dev, torch.int32)
        pk = dict(kw)
        if kw:
            pk.update(k_scale=_scale_pool(kw["k_scale"], table, page),
                      v_scale=_scale_pool(kw["v_scale"], table, page))
        kw = pk
        fn = da.decode_attention_paged
        args = (q, _pool(kc, table, page), _pool(vc, table, page), table,
                lengths)
        ref = da.decode_attention_paged_plain(*args, tokens=t, **kw)
    before = fn.variant_launches[store if t == 1 else f"{store}:t{t}"]
    out = fn(*args, tokens=t, **kw)
    again = fn(*args, tokens=t, **kw)
    torch.cuda.synchronize()
    _check_rows(out, ref)
    assert torch.equal(out, again)
    assert fn.variant_launches[store if t == 1 else f"{store}:t{t}"] == \
        before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("model", ["tinyllama", "llama2-7b"])
def test_cuda_decode_attention_is_one_launch(cuda_device, model, paged):
    """One kernel a call (no combine kernel, no scratch memsets) at a k8v4
    decode step: TinyLlama's heads, whose plan splits each (slot, kv head)
    four ways into a cluster, and the 7B's, whose plan does not split."""
    dev, b, s = cuda_device, 8, MAX_SEQ
    hq, kh, d = MODELS[model]
    nsplit = da.attention_plan(b, kh, s, hq // kh, d).nsplit
    assert nsplit == (4 if model == "tinyllama" else 1)
    g = torch.Generator(device=dev).manual_seed(5)
    lens = [48, 96, 132, 232, 332, 482, 632, 932]
    kc, vc, kw = _cache("k8v4", b, s, kh, d, lens, g, dev)
    q = torch.randn(b, hq, d, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor(lens, device=dev)
    if paged:
        table = (torch.arange(b * 8, device=dev, dtype=torch.int32) + 1
                 ).reshape(b, 8)
        kw = dict(kw, k_scale=_scale_pool(kw["k_scale"], table, 128),
                  v_scale=_scale_pool(kw["v_scale"], table, 128))
        kp, vp = _pool(kc, table, 128), _pool(vc, table, 128)
        call = lambda: da.decode_attention_paged(  # noqa: E731
            q, kp, vp, table, lengths, **kw)
    else:
        call = lambda: da.decode_attention(q, kc, vc, lengths,  # noqa: E731
                                           **kw)
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower()]
    ours = [k for k in kernels if "attention_kernel" in k]
    assert len(ours) == 1, kernels
    assert not any("combine_kernel" in k or "memset" in k.lower()
                   for k in kernels), kernels


# ---------------------------------------------------------------------------
# #3's int8-dot variant (3i)
# ---------------------------------------------------------------------------

def _i8_smem(plan, rows, d, kb, vb, share, keep):
    """The int8-dot variant's dynamic shared memory: each group's ring of 2
    * stages stages (a tile's K or V and the f32 scales where the group
    keeps the scores of its whole share of a block; K and V where it keeps
    fewer), the kept scores (keep tiles of `rows` rows of tile + 8 floats a
    group), or the partials where larger; then the exchange ((max, two
    granule maxima) a row for each group and for two blocks) and q's codes
    (D codes, qs and two code sums a row)."""
    scales = (2 if kb == 4 else 1) + (2 if vb == 4 else 1)
    khb, vhb = d * kb // 8, d * vb // 8
    data = max(khb, vhb) if keep >= share else khb + vhb
    ring = plan.pw * 2 * plan.stages * plan.tile * (data + 4 * scales)
    kept = plan.pw * keep * rows * (plan.tile + 8) * 4
    part = (plan.pw * rows * (d + 2) + 2 * rows) * 4
    exchange = (plan.pw * rows + 2 * rows) * 3 * 4
    return -(-max(ring + kept, part) // 16) * 16 + \
        -(-exchange // 16) * 16 + rows * (d + 3 * 4)


def _group_tiles_per_block(plan, s, bs):
    """The most tiles one position group walks in one block of p's granule,
    over every split and group of the plan (the slot at length S)."""
    most = 0
    for split in range(plan.nsplit):
        s0 = split * plan.chunk
        ntiles = -(-(min(s0 + plan.chunk, s) - s0) // plan.tile)
        for blk in range(-(-s // bs)):
            tiles = [j for j in range(ntiles)
                     if blk * bs <= s0 + j * plan.tile < (blk + 1) * bs]
            for pg in range(plan.pw):
                most = max(most, sum(j % plan.pw == pg for j in tiles))
    return most


@pytest.mark.parametrize("store", ("int8", "int4", "k8v4"))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_int8_dots_plan_fits(model, store):
    """The int8-dot variant launches #3's plan with a block of p's granule
    that covers S or is a whole number of tiles (`int8_dots_block`), and
    its shared memory (the rings, the kept scores and the partials, then
    the exchange and q's codes: `_i8_smem`, which `int8_dots_smem` gives
    too) fits a block, at every R = 1..64 and the served rows. A group
    keeps the scores of at most its share of a block, which bounds the
    tiles it walks in any block (so that a ring of K-or-V stages never
    needs both), and as many tiles as fit; at the served rows up to
    max_seq 1024 all of them, and at 1024 with the blocks an SM the plan
    counts on."""
    hq, kh, d = MODELS[model]
    kb, vb = STORE_BITS[store]
    width = kh * d // 2 if kb == 4 else kh * d
    rep = hq // kh
    for s in (128, 1000, MAX_SEQ, 4096):
        bs = da.int8_dots_block(s, width)
        for rows in sorted(set(range(1, da.MAX_ROWS + 1)) | {rep, rep * 5}):
            plan = da.attention_plan(8, kh, s, rows, d)
            assert bs >= s or bs % plan.tile == 0
            share = -(-min(plan.chunk // plan.tile, -(-bs // plan.tile))
                      // plan.pw)
            assert _group_tiles_per_block(plan, s, bs) <= share
            keep = da.int8_dots_keep(plan, rows, d, kb, vb, bs)
            assert 0 <= keep <= share
            smem = _i8_smem(plan, rows, d, kb, vb, share, keep)
            assert smem == da.int8_dots_smem(plan, rows, d, kb, vb, bs, keep)
            assert smem <= SMEM_LIMIT
            if keep < share:
                assert _i8_smem(plan, rows, d, kb, vb, share,
                                keep + 1) > SMEM_LIMIT
            if rows in (rep, rep * 5) and s <= MAX_SEQ:
                assert keep == share
            if rows in (rep, rep * 5) and s == MAX_SEQ:
                blocks = max(1, da.SM_WARPS[d] // (plan.mg * plan.pw))
                assert blocks * (smem + 1024) <= SM_SMEM


def _i8_lengths(bs, chunk, s, t):
    """Two sets of 8 lengths: 0, 1, inside, at and past a block's end (or
    S), and S; then at a split's end and around it (multiples of the
    plan's chunk, or S). A window's keep its T rows."""
    sets = ([0, 1, 17, bs - 1, min(bs, s), min(bs + 1, s), 700, s],
            [0, chunk - 1, chunk, min(chunk + 1, s), min(2 * chunk, s),
             min(2 * chunk + 1, s), min(3 * chunk, s), s])
    return [[n if n == 0 else max(n, t) for n in lens] for lens in sets]


@pytest.mark.cuda
@pytest.mark.parametrize("with_rows", [False, True], ids=["read", "rows"])
@pytest.mark.parametrize("layout", ["contiguous", "stacked", "window"])
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("store", ["int8", "int4", "k8v4"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_cuda_int8_dots_matches_plain(cuda_device, model, store, t, layout,
                                      with_rows):
    """The int8-dot variant against `decode_attention_int8_dots_plain` at
    the served models' heads, S = 1024 (the 7B's k8v4 block is 512, so
    lengths cross it), lengths 0, 1, around a block's end and around a
    split's end (two sets of 8 slots), NaN in the scales past each length;
    with `rows`, the step's rows written by the launch first (over NaN
    scales and stale bytes in their slots): cache bytes and scales equal
    to the plain route's, every (slot, row) within 1e-2 of its max|ref|,
    finite; two calls identical; each call counted under "i8:" + its store
    and window (and "+rows")."""
    hq, kh, d = MODELS[model]
    dev, s, b = cuda_device, MAX_SEQ, 8
    kb, vb = STORE_BITS[store]
    g = torch.Generator(device=dev).manual_seed(
        sum(map(ord, model + store + layout)) + t + with_rows)
    width = kh * d // 2 if kb == 4 else kh * d
    plan = da.attention_plan(b, kh, s, hq // kh * t, d)
    for lens in _i8_lengths(da.int8_dots_block(s, width), plan.chunk, s,
                            t):
        lead, extra = {"stacked": ((2,), 0), "window": ((), 64)}.get(layout,
                                                                    ((), 0))
        kc, vc, kw = _cache(store, b, s, kh, d, lens, g, dev, lead, extra)
        q = torch.randn(b, hq * t, d, generator=g, device=dev).to(
            torch.bfloat16)
        lengths = torch.tensor(lens, device=dev)
        new = None
        if with_rows:
            k_new, v_new = (torch.randn(b, t, kh * d, generator=g, device=dev)
                            .to(torch.bfloat16) for _ in range(2))
            pos = torch.tensor([[n - t + j if n else -1 for j in range(t)]
                                for n in lens], device=dev, dtype=torch.int32)
            new = da.NewRows(k_new, v_new, pos)
            for sc in (kw["k_scale"], kw["v_scale"]):
                sc[torch.arange(b, device=dev)[:, None].expand(b, t).clamp(
                    0), :, pos.clamp(0).long()] = float("nan")
        state = [kc, vc, kw["k_scale"], kw["v_scale"]]
        ref_state = [x.clone() for x in state]
        ref_kw = dict(kw, k_scale=ref_state[2], v_scale=ref_state[3])
        ref = da.decode_attention_int8_dots_plain(
            q, ref_state[0], ref_state[1], lengths, tokens=t, new=new,
            **ref_kw)
        key = "i8:" + (store if t == 1 else f"{store}:t{t}")
        before = da.decode_attention.variant_launches[key]
        rows_before = da.decode_attention.variant_launches[key + "+rows"]
        out = da.decode_attention(q, kc, vc, lengths, tokens=t, new=new,
                                  int8_dots=True, **kw)
        again = da.decode_attention(q, kc, vc, lengths, tokens=t, new=new,
                                    int8_dots=True, **kw)
        torch.cuda.synchronize()
        _check_rows(out, ref)
        assert torch.equal(out, again)
        for x, y in zip(state, ref_state):     # bytes, NaN scales included
            bits = torch.int8 if x.dtype == torch.int8 else torch.int32
            assert torch.equal(x.view(bits), y.view(bits))
        assert da.decode_attention.variant_launches[key] == before + 2
        assert da.decode_attention.variant_launches[key + "+rows"] == \
            rows_before + (2 if with_rows else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(32, 128, "int4", 1024, 40, 5),
                                  (32, 128, "int4", 1024, 64, 1),
                                  (8, 128, "k8v4", 4096, 64, 4),
                                  (8, 128, "int8", 4096, 64, 1)],
                         ids=["7b-int4-r40", "7b-int4-r64", "mx-k8v4-r64",
                              "mx-int8-r64"])
def test_cuda_int8_dots_partial_keep_matches_plain(cuda_device, case):
    """Where a group cannot keep the scores of its whole share of a block
    (many rows a kv head: `int8_dots_keep` below the share), the second
    pass reads K again for the rest: against the plain version at lengths
    0, 1, around a block's end and S, NaN scales past each length, every
    (slot, row) within 1e-2 of its max|ref|, finite."""
    kh, d, store, s, rows, t = case
    dev, b = cuda_device, 8
    kb, vb = STORE_BITS[store]
    width = kh * d // 2 if kb == 4 else kh * d
    plan = da.attention_plan(b, kh, s, rows, d)
    bs = da.int8_dots_block(s, width)
    share = -(-min(plan.chunk // plan.tile, -(-bs // plan.tile)) // plan.pw)
    assert da.int8_dots_keep(plan, rows, d, kb, vb, bs) < share
    g = torch.Generator(device=dev).manual_seed(sum(case[:2]) + rows + t)
    lens = [n if n == 0 else max(n, t)
            for n in (0, 1, 17, bs - 1, bs, bs + 1, s - 300, s)]
    kc, vc, kw = _cache(store, b, s, kh, d, lens, g, dev)
    q = torch.randn(b, kh * rows, d, generator=g, device=dev).to(
        torch.bfloat16)
    lengths = torch.tensor(lens, device=dev)
    out = da.decode_attention(q, kc, vc, lengths, tokens=t, int8_dots=True,
                              **kw)
    ref = da.decode_attention_int8_dots_plain(q, kc, vc, lengths, tokens=t,
                                              **kw)
    torch.cuda.synchronize()
    _check_rows(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("store", ["int8", "int4", "k8v4"])
def test_cuda_int8_dots_switch(cuda_device, store, monkeypatch):
    """DPT_ATTN_INT8 as the JAX package reads it: unset, the default call
    is the int8-dot variant (bit for bit with int8_dots=True, counted under
    "i8:"); "0", it is the bf16-dot kernel (bit for bit with
    int8_dots=False, no "i8:" count); and the two differ."""
    hq, kh, d = MODELS["tinyllama"]
    dev, s, b = cuda_device, MAX_SEQ, 8
    g = torch.Generator(device=dev).manual_seed(11)
    lens = [48, 96, 132, 232, 332, 482, 632, 932]
    kc, vc, kw = _cache(store, b, s, kh, d, lens, g, dev)
    q = torch.randn(b, hq, d, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor(lens, device=dev)
    counts = da.decode_attention.variant_launches

    def call(**extra):
        return da.decode_attention(q, kc, vc, lengths, **kw, **extra)
    dots, plain = call(int8_dots=True), call(int8_dots=False)
    monkeypatch.delenv("DPT_ATTN_INT8", raising=False)
    n = counts["i8:" + store]
    assert torch.equal(call(), dots) and counts["i8:" + store] == n + 1
    monkeypatch.setenv("DPT_ATTN_INT8", "0")
    assert torch.equal(call(), plain) and counts["i8:" + store] == n + 1
    assert not torch.equal(dots, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["tinyllama", "llama2-7b"])
def test_cuda_int8_dots_is_one_launch(cuda_device, model):
    """One kernel a call for the int8-dot variant too (its block maxima
    meet in shared and distributed shared memory, not in a second
    launch): a k8v4 decode step over lengths that cross the 7B's block."""
    dev, b, s = cuda_device, 8, MAX_SEQ
    hq, kh, d = MODELS[model]
    g = torch.Generator(device=dev).manual_seed(6)
    lens = [48, 96, 132, 232, 332, 482, 632, 932]
    kc, vc, kw = _cache("k8v4", b, s, kh, d, lens, g, dev)
    q = torch.randn(b, hq, d, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor(lens, device=dev)
    call = lambda: da.decode_attention(q, kc, vc, lengths,  # noqa: E731
                                       int8_dots=True, **kw)
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower()]
    assert len([k for k in kernels if "attention_kernel" in k]) == 1, kernels
    assert not any("memset" in k.lower() for k in kernels), kernels
