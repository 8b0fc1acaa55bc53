"""Fused dequant matmul: wrapper, plain versions and launch counts.

Replaces the Pallas TPU kernel deeppowers_tpu/ops/pallas/dequant_matmul.py
(`dequant_matmul` :554 and `dequant_matmul_fused` :582, both through
`_dispatch` :351 to the pallas_call at :528, body `_make_kernel` :152);
this one wrapper covers both entry points. CUDA sources:
csrc/dequant_matmul.cu (the launcher of both routes, and the activation
quantizer), csrc/mma_kernel.cuh (the tensor-core kernel, its zero-point
instantiations in csrc/dequant_matmul_zp.cu) and csrc/gemv.cu (the decode
GEMV), each kernel taking every weight variant, the group size a runtime
value.

Takes every 2-D weight the JAX package makes: int8 or int4 (half-split
nibbles, quant/qtypes.py), per-channel scales (1, N) or per-group scales
(K/g, N), and act_bits 0 (bf16 activations) or 8 (dynamic per-row int8
activations, W8A8 / W4A8). Asymmetric weights (int32 zero points shaped as
the scales) are weight-only whatever their act_bits, as the JAX package's
route makes them (deeppowers_tpu/ops/matmul.py:92, :106-116; its Pallas
kernel never takes them, :199-222): each weight operand is bf16(q - z),
the value `_dequant_weights` (:28-41) converts, times the group's scale in
f32 (the device route's Decision in ROADMAP.md: JAX's XLA path rounds
bf16(q - z) * bf16(s)).

Weight-only (act_bits 0) computes y = a @ (q * s) [* rsqrt(mean(x^2) +
eps)] [+ bias] [+ residual] with f32 accumulation and one final cast,
where a is x, or bf16(x * g) with RMSNorm folded in (`rms_weight`), or
bf16(act(gate) * up) for a GLU input x = gate | up; the scale of a
weight row is that of its group, the group of unpacked row k being k // g
(a group may straddle int4's two nibble planes).

W8A8 / W4A8 (act_bits 8) computes what the JAX package's XLA path
computes (`_w8a8_matmul`, deeppowers_tpu/ops/matmul.py:44-72, behind
`rms_matmul` / `glu_matmul` :134-197): the norm or the GLU first, as
XLA computes the unfused ops (`_unfused_input`), then per-row int8
quantization over the whole K (quant/quantize.py `quantize_rows`), exact
int32 products per group, each group's sum times its scale, the row scale
last; bias and residual in the f32 epilogue. On the card a row scale
needs the whole row before any product, so the row quantizer
(`quantize_activations`, counted apart: a thread-block cluster of
`quant_plan` blocks a row) runs first. Folding it into the decode GEMV,
each column tile quantizing its rows' chunk while it stages, read slower
at every a8 decode shape of the 7B and Mixtral on an H100 (PERF.md §6):
the N / 128 tiles each redo the row's work.

Launch counts: `dequant_matmul.launches`, and in
`dequant_matmul.variant_launches` each launch under its width class ("n8"
N % 8 == 0, "n4" N % 4 == 0 otherwise, "n1" any other N: the load width
of the kernel's instantiation), under its weight variant (`variant`:
"w8", "w8g", "w8a8", "w8a8g", "w4", "w4g", "w4a8", "w4a8g") and under its
route ("gemv" for M <= GEMV_MAX_M, "mma" above: `route`); an asymmetric
weight's variant ends in "z" ("w8z", "w4gz"). The tensor-core
route's weight-only prologue is counted in `stage_activations.launches`,
the a8 quantizer in `quantize_activations.launches`.

Bound on an H100: at decode and verify sizes the weight bytes (int4: half
of int8's) over 3.35 TB/s; at prefill the 2*M*K*N operations (int8 tensor
cores for a8). The CUDA design (for M <= GEMV_MAX_M a GEMV that streams
the weight through mma.sync atoms, its K splits a thread-block cluster
that sums them in the same launch, planner `gemv_plan`; a pipelined wgmma
kernel above, planner `mma_plan`) is described in the sources.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import torch

from ...quant.qtypes import INT4_QMAX, QuantizedTensor, unpack_int4
from ...quant.quantize import quantize_rows
from ..activation import activation
from ..normalization import rms_norm
from . import _build

#: rows at or below which the decode GEMV runs (one n8 token tile, the C
#: side's guard); the tensor-core kernel takes every M above (`route`,
#: which the C side is handed). From chip_smoke.py's route sweep on an
#: H100 (PERF.md §6): at M = 8 the GEMV reads faster on one layer of
#: TinyLlama int8 and of Llama-2-7B W4A8 g128 (0.0585 / 0.1308 against
#: 0.0748 / 0.1651 ms); a two-tile version read slower than the tensor-core
#: kernel at M = 16 on TinyLlama's (0.0830 against 0.0767 ms), and was
#: dropped
GEMV_MAX_M = 8
#: the routes of one launch, in the C side's numbering (ROUTE_GEMV, ROUTE_MMA)
ROUTES = ("gemv", "mma")
#: the GEMV's block: weight columns, and stored rows a stage of its ring
GEMV_NT = 128
GEMV_BK = 64
#: bytes of activations a GEMV block stages at once
GEMV_ACT_BYTES = 32768
#: the CUDA kernels flush per-group sums at this K granularity
GROUP_ALIGN = 32
#: the tensor-core kernel's stage depths (unpacked K rows a stage: 64
#: where the scale groups allow it, else 32) and weight columns a block
#: (csrc MMA_NT)
MMA_BKS = (64, 32)
MMA_NT = 128
#: its token tiles: wgmma N sizes that both the bf16 and the s8 atoms take
MMA_TOKEN_TILES = (32, 48, 64, 128)
#: SMs of an H100: the planners fill them
_SMS = 132
#: blocks the GEMV's grid aims for, one an SM (on an H100, at decode
#: shapes, more blocks through deeper K splits read slower: PERF.md §6);
#: and its K splits at most (a portable cluster of a column tile's splits)
GEMV_BLOCKS = _SMS
GEMV_SPLITS = 8
#: the row quantizer's block (csrc QUANT_*): threads, activations an item
#: (one 16-byte store of int8 out), items a thread takes at most (a
#: block's slice in its shared memory); and its cluster at most (16
#: blocks: the non-portable size an H100 grants, where 8 rows of 8 blocks
#: would leave half the card idle)
QUANT_THREADS = 256
QUANT_ITEM = 16
QUANT_ITEMS = 4
QUANT_CLUSTER = 16


def _groups(scales: torch.Tensor, k: int, n: int):
    """(scale rows G, group length g) of a (G, N) scale table; G = 1 is
    per-channel."""
    rows = scales.numel() // n
    return rows, k // rows


def _unfused_input(x, k, rms_weight, rms_eps, glu, act):
    """The a8 matmul's input before quantization, as XLA computes the
    unfused ops (JAX ops/matmul.py:150, :171-173): rms_norm(x) in x's
    dtype; act(gate) op by op in x's dtype (ops/activation.py) times up in
    f32, not rounded (XLA keeps a bf16 product whose consumer converts it
    to f32 in f32: the quantizer's `astype(float32)`, :57; the product of
    two bf16 values is exact in f32); or x."""
    if glu:
        return activation(x[..., :k], act).float() * x[..., k:].float()
    if rms_weight is not None:
        return rms_norm(x, rms_weight, eps=rms_eps)
    return x


def _int_dot(xq, q, scales, rows, bits):
    """sum over groups of (xq_g @ q_g) * s_g with exact integer sums (f32
    holds a group's sum exactly while it stays below 2^24, else f64); the
    sums then round to f32 as JAX's int32 -> f32 cast rounds them."""
    m, k = xq.shape
    n = q.shape[1]
    g = k // rows
    wmax = INT4_QMAX + 1 if bits == 4 else 128
    dt = torch.float32 if g * 127 * wmax <= 2 ** 24 else torch.float64
    acc = torch.matmul(xq.to(dt).reshape(m, rows, g).transpose(0, 1),
                       q.to(dt).reshape(rows, g, n)).float()   # (G, M, N)
    return (acc * scales.reshape(rows, 1, n)).sum(0)


def _codes(q, zero_points, rows, dtype):
    """The weight operand of a weight-only product, (K, N) f32: q, or
    bf16(q - z) with zero points (each row's group's), as the kernels
    build it from bf16 activations (f32 q - z for others)."""
    if zero_points is None:
        return q.float()
    k, n = q.shape
    qz = (q.int().reshape(rows, k // rows, n)
          - zero_points.int().reshape(rows, 1, n)).reshape(k, n)
    return qz.to(torch.bfloat16 if dtype == torch.bfloat16
                 else torch.float32).float()


def dequant_matmul_plain(x, data, scales, *, bits=8, act_bits=0,
                         zero_points=None, rms_weight=None, rms_eps=1e-6,
                         glu=False, act="silu", residual=None, bias=None,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch, for weight data (K, N)
    int8 or (K/2, N) packed int4 and scales (G, N), zero points (G, N) or
    None. Weight-only: the activation block is rounded to x's dtype before
    the product, as both kernels round it to bf16; for f32 inputs
    everything stays f32; with zero points each weight is bf16(q - z)
    (f32 for f32 inputs) times its scale, whatever act_bits says. a8:
    JAX's `_w8a8_matmul` behind its unfused norm or GLU."""
    q = unpack_int4(data) if bits == 4 else data
    k, n = q.shape
    rows, g = _groups(scales, k, n)
    s = scales.float().reshape(rows, n)
    lead = x.shape[:-1]
    xf = x.float()
    if act_bits == 8 and zero_points is None:
        xq, xs = quantize_rows(_unfused_input(x, k, rms_weight, rms_eps, glu,
                                              act).reshape(-1, k))
        y = (_int_dot(xq, q, s, rows, bits) * xs).reshape(*lead, n)
    else:
        if glu:
            a = activation(xf[..., :k], act) * xf[..., k:]
        elif rms_weight is not None:
            a = xf * rms_weight.float()
        else:
            a = xf
        a = a.to(x.dtype).float()
        qf = _codes(q, zero_points, rows, x.dtype)
        if rows == 1:
            y = (a @ qf) * s
        else:
            y = a @ (qf.reshape(rows, g, n) * s[:, None]).reshape(k, n)
        if rms_weight is not None:
            y = y * torch.rsqrt((xf * xf).sum(-1, keepdim=True) / k + rms_eps)
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def width_variant(n: int) -> str:
    """The alignment class of an N-column weight, which sets how its rows
    reach the kernels (TMA when N % 16 == 0, else cp.async copies as wide
    as N allows: csrc/dequant_matmul.cu `wvec`)."""
    return "n8" if n % 8 == 0 else "n4" if n % 4 == 0 else "n1"


def weight_only(qw: QuantizedTensor) -> bool:
    """Whether a product with qw takes bf16 activations: act_bits 0, or
    zero points (asymmetric weights are weight-only, as JAX routes them)."""
    return qw.act_bits == 0 or qw.zero_points is not None


def variant(qw: QuantizedTensor) -> str:
    """The weight variant a launch is counted under: bits, "a8" for int8
    activations, "g" for per-group scales (of a 2-D or a stacked weight),
    "z" for zero points."""
    grouped = qw.scales.shape[-2] > 1
    return (f"w{qw.bits}" + ("" if weight_only(qw) else "a8")
            + ("g" if grouped else "")
            + ("z" if qw.zero_points is not None else ""))


def launch_keys(m: int, qw: QuantizedTensor, path: Optional[str] = None):
    """The keys of `dequant_matmul.variant_launches` one launch of an M-row
    product counts under: its width class, its weight variant and its
    route (`route(m)` unless another is named)."""
    return width_variant(qw.shape[1]), variant(qw), path or route(m)


def _check_weight(qw: QuantizedTensor) -> None:
    if not isinstance(qw, QuantizedTensor):
        raise TypeError("dequant_matmul needs a QuantizedTensor weight")
    if qw.bits not in (4, 8) or qw.act_bits not in (0, 8) \
            or qw.data.dim() != 2:
        raise ValueError(f"not a weight the JAX package makes: {qw!r}")
    if qw.zero_points is not None \
            and qw.zero_points.numel() != qw.scales.numel():
        raise ValueError(f"zero points must be shaped as the scales: {qw!r}")


def _padded_rows(m: int, k: int, dtype, device) -> torch.Tensor:
    """An (M, K) view of rows that start 16 bytes apart at least, as the
    tensor-core kernel's copies need."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    return torch.empty((m, -(-k // per) * per), dtype=dtype,
                       device=device)[:, :k]


QuantPlan = collections.namedtuple("QuantPlan", "blocks slice")


def quant_plan(m: int, k: int, glu: bool = False) -> QuantPlan:
    """The row quantizer's launch for M rows of K: `blocks` blocks a row,
    one thread-block cluster, each taking `slice` activations (a multiple
    of QUANT_ITEM; the last block the rest). From the shape alone:
    - enough blocks that a block's slice fits its shared memory
      (QUANT_ITEMS items a thread), since x is read once;
    - more, up to QUANT_CLUSTER, while M x blocks fills the card once (132
      SMs) and each thread keeps an item, for a row too long for one block
      (Mixtral's cat rows of 114688 at a decode step's 8 rows take 16
      blocks: 128) and for GLU rows, whose act(gate) (an exp and a
      division a value) is the work to spread (the 7B's 11008 take 3);
    - plain and RMSNorm rows that one block holds (K <= 16384) take one:
      a cluster's barrier costs more than such a row's spread saves
      (chip_smoke.py's plan sweep on an H100, PERF.md §6).
    A 512-token prefill thus takes one block a row up to K = 16384."""
    per_thread = QUANT_THREADS * QUANT_ITEM
    need = -(-k // (per_thread * QUANT_ITEMS))
    if need > QUANT_CLUSTER:
        raise NotImplementedError(
            f"the row quantizer takes K <= "
            f"{QUANT_CLUSTER * per_thread * QUANT_ITEMS}, got {k}")
    blocks = need
    if need > 1 or glu:
        fill = max(1, _SMS // max(m, 1))
        blocks = max(need, min(fill, -(-k // per_thread), QUANT_CLUSTER))
    piece = -(-k // blocks)
    slice_ = -(-piece // QUANT_ITEM) * QUANT_ITEM
    return QuantPlan(-(-k // slice_), slice_)


def quantize_activations(x: torch.Tensor, k: int, *,
                         rms_weight: Optional[torch.Tensor] = None,
                         rms_eps: float = 1e-6, glu: bool = False,
                         act: str = "silu", _padded: bool = False,
                         _plan: Optional[QuantPlan] = None):
    """(q, xs): the a8 matmul's input (x, rms_norm(x), or act(gate) * up
    for x = gate | up) quantized per row to int8, x: (M, K or 2K) ->
    ((M, K) int8, (M, 1) f32). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (csrc/dequant_matmul.cu, a cluster of
    `quant_plan` blocks a row, or `_plan`'s: timing other plans at one
    shape is what sets `quant_plan`), counted in
    `quantize_activations.launches`; `_padded` (the tensor-core route)
    starts q's rows 16 bytes apart."""
    if not x.is_cuda:
        return quantize_rows(_unfused_input(x, k, rms_weight, rms_eps, glu,
                                            act))
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.stride(-1) != 1:
        raise ValueError("quantize_activations takes (M, K) bf16 rows")
    m = x.shape[0]
    g = None
    if rms_weight is not None:
        g = rms_weight.to(torch.bfloat16).contiguous()
    if _padded:
        q = _padded_rows(m, k, torch.int8, x.device)
    else:
        q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    plan = _plan or quant_plan(m, k, glu)
    rc = _build.library().dpt_quantize_rows(
        x.data_ptr(), x.stride(0), None if g is None else g.data_ptr(),
        int(glu), int(act == "gelu"), float(rms_eps), m, k, q.data_ptr(),
        q.stride(0), xs.data_ptr(), plan.blocks, plan.slice,
        _build.stream())
    _build.check(rc, "quantize_activations")
    quantize_activations.launches += 1
    return q, xs


quantize_activations.launches = 0


def stage_activations_plain(x, k, *, rms_weight=None, rms_eps=1e-6,
                            glu=False, act="silu"):
    """(a, rf): the weight-only product's input as `dequant_matmul_plain`
    rounds it (x, x * g or act(gate) * up, in x's dtype) and the RMSNorm
    row factor rsqrt(mean(x^2) + eps), (..., 1) f32, or None without a
    norm."""
    xf = x.float()
    if glu:
        a = activation(xf[..., :k], act) * xf[..., k:]
    elif rms_weight is not None:
        a = xf * rms_weight.float()
    else:
        a = xf
    rf = None
    if rms_weight is not None:
        rf = torch.rsqrt((xf * xf).sum(-1, keepdim=True) / k + rms_eps)
    return a.to(x.dtype), rf


def dequant_product_plain(a, data, scales, *, bits=8, zero_points=None,
                          rf=None, bias=None, residual=None,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """The weight-only product behind `stage_activations_plain`: a @ (q *
    s) with each group's scale (bf16(q - z) with zero points), times the
    row factor rf, plus bias and residual, cast once; with it, the same
    bits as `dequant_matmul_plain`."""
    q = unpack_int4(data) if bits == 4 else data
    k, n = q.shape
    rows, g = _groups(scales, k, n)
    s = scales.float().reshape(rows, n)
    af = a.float()
    qf = _codes(q, zero_points, rows, a.dtype)
    if rows == 1:
        y = (af @ qf) * s
    else:
        y = af @ (qf.reshape(rows, g, n) * s[:, None]).reshape(k, n)
    if rf is not None:
        y = y * rf
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def stage_activations(x: torch.Tensor, k: int, *,
                      rms_weight: Optional[torch.Tensor] = None,
                      rms_eps: float = 1e-6, glu: bool = False,
                      act: str = "silu"):
    """The tensor-core route's weight-only prologue, once per row: (a, rf)
    as `stage_activations_plain` gives them, x: (M, K or 2K) bf16 -> ((M,
    K) bf16 with rows 16 bytes apart at least, (M, 1) f32 or None). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (csrc/dequant_matmul.cu `stage_rows_kernel`), counted in
    `stage_activations.launches`."""
    if not x.is_cuda:
        return stage_activations_plain(x, k, rms_weight=rms_weight,
                                       rms_eps=rms_eps, glu=glu, act=act)
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.stride(-1) != 1:
        raise ValueError("stage_activations takes (M, K) bf16 rows")
    m = x.shape[0]
    g = None
    if rms_weight is not None:
        g = rms_weight.to(torch.bfloat16).contiguous()
    a = _padded_rows(m, k, torch.bfloat16, x.device)
    rf = None if g is None else torch.empty((m, 1), dtype=torch.float32,
                                            device=x.device)
    rc = _build.library().dpt_stage_rows(
        x.data_ptr(), x.stride(0), None if g is None else g.data_ptr(),
        int(glu), int(act == "gelu"), float(rms_eps), m, k, a.data_ptr(),
        a.stride(0), None if rf is None else rf.data_ptr(), _build.stream())
    _build.check(rc, "stage_activations")
    stage_activations.launches += 1
    return a, rf


stage_activations.launches = 0


GemvPlan = collections.namedtuple("GemvPlan", "n_tiles seg chunk splits sub")


def gemv_plan(k: int, n: int, bits: int, rows_g: int, a8: bool) -> GemvPlan:
    """The decode GEMV's grid for an (M <= GEMV_MAX_M, K) x (K, N) product
    with `rows_g` scale rows: its column tiles of GEMV_NT, the segment
    (stored rows in which no scale group of
    either int4 plane ends: the group, or gcd(group, K/2) for int4; all
    rows per-channel), the K split in chunks of stored rows (a cluster of
    at most GEMV_SPLITS blocks a column tile), and the rows a block stages
    at once (`sub`, their activations within GEMV_ACT_BYTES). The grid
    aims at GEMV_BLOCKS blocks (one an SM). A chunk is a whole number of
    stages and of groups of both planes, so no chunk crosses a group; when
    an int4 group straddles the planes no such chunk is shorter than K/2,
    and K is not split."""
    rows = k // 2 if bits == 4 else k
    planes = 2 if bits == 4 else 1
    n_tiles = -(-n // GEMV_NT)
    seg, quantum, straddle = rows, GEMV_BK, False
    if rows_g > 1:
        g = k // rows_g
        seg = math.gcd(g, rows) if bits == 4 else g
        quantum = seg * GEMV_BK // math.gcd(seg, GEMV_BK)
        straddle = rows % g != 0
    want = min(GEMV_SPLITS, -(-GEMV_BLOCKS // n_tiles))
    if straddle:
        chunk = -(-rows // GEMV_BK) * GEMV_BK
    else:
        chunk = -(-(-(-rows // want)) // quantum) * quantum
    cap = GEMV_ACT_BYTES // (GEMV_MAX_M * planes * (1 if a8 else 2))
    sub = min(cap // GEMV_BK * GEMV_BK, -(-chunk // GEMV_BK) * GEMV_BK)
    return GemvPlan(n_tiles, seg, chunk, -(-rows // chunk), sub)


def route(m: int) -> str:
    """The kernel an (M, K) x (K, N) product takes: "gemv" for M <=
    GEMV_MAX_M, else "mma". The wrapper hands the C side this choice."""
    return "gemv" if m <= GEMV_MAX_M else "mma"


MmaPlan = collections.namedtuple("MmaPlan",
                                 "bn bk m_tiles n_tiles chunk splits")


def mma_plan(m: int, k: int, n: int, rows_g: int) -> MmaPlan:
    """The tensor-core kernel's grid for an (M, K) x (K, N) product with
    `rows_g` scale rows: the token tile (the least of MMA_TOKEN_TILES that
    holds M, else 128), the stage depth (the deepest of MMA_BKS that
    divides the group), and the K split. A verify step (token tile <= 64)
    is bytes-bound: K is split until at least two blocks an SM stream the
    weight. A prefill splits only when it fills less than half the card.
    A chunk (unpacked K rows, a multiple of the stage depth) never crosses
    a scale group: it divides the group or is a multiple of it."""
    bn = next((t for t in MMA_TOKEN_TILES if t >= m), MMA_TOKEN_TILES[-1])
    g = k // rows_g if rows_g > 1 else k
    bk = next(b for b in MMA_BKS if rows_g == 1 or g % b == 0)
    mt, nt = -(-m // bn), -(-n // MMA_NT)
    units = -(-k // bk)
    blocks = mt * nt
    want = -(-2 * _SMS // blocks) if bn <= 64 else _SMS // blocks
    chunk = units * bk
    if want > 1:
        chunk = max(1, units // want) * bk
        if rows_g > 1:
            chunk = (chunk // g * g if chunk >= g else
                     max(d for d in range(bk, chunk + 1, bk) if g % d == 0))
    return MmaPlan(bn, bk, mt, nt, chunk, -(-k // chunk))


def mma_flush_points(k: int, group: int, chunk: int, bk: int):
    """For each K chunk of the tensor-core kernel, the unpacked K offsets
    at which its blocks flush their group sums into the f32 totals: the
    end of every stage of `bk` rows that ends a group (of `group` rows; k
    for per-channel scales), and the chunk's end."""
    points = []
    for k0 in range(0, k, chunk):
        end = min(k, k0 + chunk)
        points.append([min(ku + bk, end) for ku in range(k0, end, bk)
                       if (ku + bk) % group == 0 or ku + bk >= end])
    return points


def dequant_matmul(x: torch.Tensor, qw: QuantizedTensor, *,
                   rms_weight: Optional[torch.Tensor] = None,
                   rms_eps: float = 1e-6, glu: bool = False,
                   act: str = "silu", residual: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """x @ dequant(qw) with RMSNorm (rms_weight), GLU (glu: x = gate|up,
    (..., 2K)), bias and residual folded in. x: (..., K); returns (..., N).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of its `route` or raises for what the kernel does not take."""
    if rms_weight is not None and glu:
        raise ValueError("rms and glu fusion are mutually exclusive")
    _check_weight(qw)
    if not x.is_cuda:
        return dequant_matmul_plain(
            x, qw.data, qw.scales, bits=qw.bits, act_bits=qw.act_bits,
            zero_points=qw.zero_points, rms_weight=rms_weight,
            rms_eps=rms_eps, glu=glu, act=act, residual=residual, bias=bias,
            out_dtype=out_dtype)
    m = x.numel() // x.shape[-1] if x.shape[-1] else 0
    return dequant_matmul_via(route(m), x, qw, rms_weight=rms_weight,
                              rms_eps=rms_eps, glu=glu, act=act,
                              residual=residual, bias=bias,
                              out_dtype=out_dtype)


def dequant_matmul_via(path: str, x: torch.Tensor, qw: QuantizedTensor, *,
                       rms_weight: Optional[torch.Tensor] = None,
                       rms_eps: float = 1e-6, glu: bool = False,
                       act: str = "silu",
                       residual: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """`dequant_matmul` on a CUDA tensor through the named route ("gemv"
    takes M <= GEMV_MAX_M only); `dequant_matmul` passes `route(M)`. Timing
    both routes at one M is what sets GEMV_MAX_M."""
    if path not in ROUTES:
        raise ValueError(f"unknown route {path!r}")
    if rms_weight is not None and glu:
        raise ValueError("rms and glu fusion are mutually exclusive")
    _check_weight(qw)
    _build.require_cuda(x, "x")
    k, n = qw.shape
    kx = 2 * k if glu else k
    if x.shape[-1] != kx:
        raise ValueError(f"x width {x.shape[-1]} != expected {kx}")
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"CUDA dequant_matmul takes bf16 x, got {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"unsupported out_dtype {out_dtype}")
    if act not in ("silu", "gelu"):
        raise ValueError(f"unknown activation {act!r}")
    data = qw.data
    if not data.is_contiguous() or data.data_ptr() % 16:
        raise ValueError("weight data must be contiguous and 16-byte aligned")
    scales = qw.scales.reshape(-1)
    rows_g, group = _groups(scales, k, n)
    if scales.dtype != torch.float32 or rows_g * n != scales.numel() \
            or rows_g * group != k:
        raise ValueError("scales must be (1, N) or (K/g, N) f32")
    zp = qw.zero_points
    if zp is not None:
        zp = zp.reshape(-1)
        if zp.dtype != torch.int32 or not zp.is_contiguous():
            zp = zp.to(torch.int32).contiguous()
        _build.require_cuda(zp, "zero points")
    a8 = not weight_only(qw)
    rows = k // 2 if qw.bits == 4 else k
    if rows_g > 1 and group % GROUP_ALIGN:
        raise NotImplementedError(
            f"CUDA dequant_matmul takes groups of a multiple of "
            f"{GROUP_ALIGN} rows, got {group}")
    if a8 and rows % 4:
        raise NotImplementedError(
            f"CUDA a8 dequant_matmul takes a multiple of 4 stored rows, "
            f"got {rows}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kx)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    m = x2.shape[0]
    if path == "gemv" and m > GEMV_MAX_M:
        raise ValueError(f"the GEMV takes M <= {GEMV_MAX_M}, got {m}")
    g = None
    if rms_weight is not None:
        g = rms_weight.to(torch.bfloat16).contiguous()
        if g.numel() != k:
            raise ValueError(f"rms_weight has {g.numel()} values, K={k}")
    bias_f = None if bias is None else bias.float().contiguous()
    res2 = None
    if residual is not None:
        res2 = residual.reshape(-1, n)
        if res2.dtype != torch.bfloat16 or res2.shape[0] != m:
            raise ValueError("residual must be bf16 (..., N) like the output")
        if res2.stride(-1) != 1:
            res2 = res2.contiguous()
    for t, what in ((data, "weight"), (scales, "scales")):
        _build.require_cuda(t, what)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    lib = _build.library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    xs = None
    if path == "gemv":
        plan = gemv_plan(k, n, qw.bits, rows_g, a8)
        kchunk, bn, bk, ws = plan.chunk, 0, plan.sub, None
        if a8:
            x2, xs = quantize_activations(x2, k, rms_weight=g,
                                          rms_eps=rms_eps, glu=glu, act=act)
            g, glu = None, False
    else:
        plan = mma_plan(m, k, n, rows_g)
        kchunk, bn, bk, ws = plan.chunk, plan.bn, plan.bk, None
        if plan.splits > 1:
            ws = torch.empty((plan.splits, m, n), dtype=torch.float32,
                             device=x.device)
        if a8:
            x2, xs = quantize_activations(x2, k, rms_weight=g,
                                          rms_eps=rms_eps, glu=glu, act=act,
                                          _padded=True)
        elif g is not None or glu or x2.data_ptr() % 16 or x2.stride(0) % 8:
            x2, xs = stage_activations(x2, k, rms_weight=g, rms_eps=rms_eps,
                                       glu=glu, act=act)
        g, glu = None, False
    rc = lib.dpt_dequant_matmul(
        x2.data_ptr(), x2.stride(0), ptr(xs), data.data_ptr(),
        scales.data_ptr(), ptr(zp), qw.bits, group if rows_g > 1 else 0,
        ptr(g),
        ptr(bias_f), ptr(res2), 0 if res2 is None else res2.stride(0),
        out.data_ptr(), int(out_dtype == torch.float32), ptr(ws), m, k, n,
        ROUTES.index(path), kchunk, bn, bk, int(a8), int(glu),
        int(act == "gelu"), float(rms_eps), _build.stream())
    _build.check(rc, "dequant_matmul")
    dequant_matmul.launches += 1
    for key in launch_keys(m, qw, path):
        dequant_matmul.variant_launches[key] += 1
    return out.reshape(*lead, n)


dequant_matmul.launches = 0
dequant_matmul.variant_launches = collections.Counter()
