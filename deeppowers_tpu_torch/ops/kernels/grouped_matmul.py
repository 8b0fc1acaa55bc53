"""Grouped dequant matmuls for MoE: wrappers, plain versions, launch counts.

Replaces the two grouped Pallas TPU kernels of
deeppowers_tpu/ops/pallas/dequant_matmul.py, both built on the body
`_make_kernel` :152:
  #9  `grouped_dequant_matmul` :620 (pallas_call :755): rows times stacked
      expert weights (E, K[/2], N) with scales (E, G, N);
  #10 `grouped_dequant_matmul_ncat` :775 (pallas_call :911): rows times
      the column block e·n_e .. (e+1)·n_e of one concatenated (K[/2],
      E·n_e) weight, the cat-fused gate|up of every expert.
Both run on #1's tensor-core kernel in its expert-tile modes
(csrc/dequant_matmul.cu `mma_kernel`, launcher `dpt_grouped_mma`), a8
behind the per-(row, group) pre-pass `quantize_segments`. The two differ
only in where an expert's weight lies: #9's expert is the third
coordinate of the map (N, stored rows, E), #10's the second of (n_e, E,
stored rows), a view of the cat whose pitches (n_e, E·n_e) each follow
the one before (`expert_map`); a column block that ends inside the next
expert's columns reads zeros past n_e, and no column past n_e is stored.
So #10 is #9 over that view: the plain versions agree bit for bit.

The rows are routed (token, expert) pairs sorted by expert, each expert's
segment padded to whole tiles of BLOCK_M rows, so every tile belongs to
one expert: `tile_expert[i]` names it, and -1 marks a dead tail tile,
which the kernels skip (its output rows are left undefined; the plain
versions write zeros). Each output row depends only on its own input row.

The function, per output row x of expert e (weights symmetric, int8 or
int4 in half-split nibbles, any group g dividing K):
- act_bits 0: y = sum over groups of (bf16(x)_g @ q_g) * s_g, f32
  accumulation; what kernel #1 computes.
- act_bits 8 (W8A8 / W4A8): what the Pallas body computes (`qdot` :198),
  which is NOT the row-wide function #1 follows (ROADMAP Decisions). The
  activations, rounded to bf16, are quantized per (row, nibble plane,
  segment): qs = max(amax, 1e-30) * fl(1/127), codes round-half-even of
  x / qs clipped to +-127; the products are exact int32 sums; each
  segment adds (sum * qs) * s in one fused multiply-add, in the Pallas
  body's order in the plain version (bit for bit with it on the CPU). The
  segment is the scale group when the group divides the Pallas kernel's
  K block (its `pre` regime), else that block (`_pick_block_k` :327,
  copied here). The CUDA path takes only weights whose segments are their
  groups (`a8_per_group`) and raises on the others: the pre-pass 9q
  (`quantize_segments`, whose plain version composed with
  `grouped_a8_product_plain` gives `grouped_dequant_matmul_plain`'s bits)
  quantizes each (row, group) once for the product.

9q's GLU mode: the MoE layer's #9 input is act(gate) * up of #10's
output gu (M_pad, 2K), the activation in f32, rounded to bf16
(`glu_rows_plain`). Under a8 the layer hands gu itself to #9
(`grouped_dequant_matmul(..., glu=True, act=...)`), whose pre-pass
computes those rows as it quantizes them, so they are never written. The
function is the eager ops', bit for bit: csrc `act_fn` gives F.silu's and
F.gelu(approximate="tanh")'s f32 results on every finite bf16 input (on
an H100, PERF.md §6, PR 20), and the product and its rounding are the
same ops.

9q's design (csrc/dequant_matmul.cu `quantize_segments_kernel`): a block
takes a 64-row tile and a chunk of each row (`segment_chunk`), every row
read once, a thread's 16-byte loads of a pass issued before it uses any,
five blocks an SM; each segment's max met in registers by warp shuffles;
the correctly rounded quotient from one reciprocal a segment (Markstein's
correction, so a zero needs no division); the scales staged so that they
go out 64 contiguous floats a segment. Bound: bytes, the rows read once
and the codes written once.

Launch counts: `grouped_dequant_matmul.launches`,
`grouped_dequant_matmul_ncat.launches`, `quantize_segments.launches`;
in the first two's `variant_launches` the launch under its weight variant
("w4a8g", "w4g", "w8g", "w8a8g", ...; `dequant_matmul.variant`), in 9q's
under its mode ("plain", "glu").

Bound on an H100: at a prefill's row counts the 2·rows·K·N operations over
the int8 (a8) or bf16 tensor-core peak; the weights of each expert with
rows are read once. The design is described in the source.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from ...quant.qtypes import QuantizedTensor, unpack_int4
from ..activation import activation
from . import _build
from .dequant_matmul import MMA_BKS, variant

#: rows of a tile: the routed layout's and the CUDA kernel's (64, a
#: token tile of its wgmma; each output row depends only on its own input
#: row, so it need not be the Pallas kernels' block)
BLOCK_M = 64
#: the CUDA kernel walks K in stages of this many unpacked rows, or 64
#: where the groups allow (`stage_depth`)
K_STEP = 32

# The Pallas kernel's measured stream rate by K block, relative to the
# best (deeppowers_tpu/ops/pallas/dequant_matmul.py:324); with
# `_pick_block_k` it decides the a8 quantization segment.
_BK_RATE = {2048: 1.0, 1024: 1.0, 512: 0.80, 256: 0.62}
_BLOCK_K = 1024


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _pick_block_k(k: int, want: int) -> int:
    """The Pallas kernel's K block for `k` stored rows (a copy of JAX
    `_pick_block_k`, dequant_matmul.py:327-348)."""
    best, best_score = min(want, 256), -1.0
    d = want
    while d >= 256:
        score = _BK_RATE.get(d, 1.0) * k / _round_up(k, d)
        if score > best_score + 1e-9:
            best, best_score = d, score
        d //= 2
    return best


def a8_segments(bits: int, k: int, group: int):
    """(segment, keff, keff_pad, g_eff): the Pallas grouped kernels' a8
    quantization segment for a (K, N) weight of `bits` and `group`
    (0 = per-channel), the stored rows of a nibble plane keff and that
    plane padded to whole K blocks. Raises NotImplementedError where the
    Pallas dispatcher raises (dequant_matmul.py:655-681)."""
    g_eff = group or k
    keff = k // 2 if bits == 4 else k
    bk = _pick_block_k(keff, _BLOCK_K)
    keff_pad = _round_up(keff, bk)
    whole = (k,) if bits == 8 else (k, k // 2)
    if g_eff in whole or (g_eff % bk == 0 and keff % g_eff == 0):
        pre = False
    elif bk % g_eff == 0:
        pre = True
    else:
        raise NotImplementedError(f"group {g_eff} vs K block {bk}")
    if pre and keff_pad != keff and keff % g_eff:
        raise NotImplementedError(
            f"ragged K with group {g_eff} not dividing {keff}")
    return (g_eff if pre else bk), keff, keff_pad, g_eff


def a8_per_group(bits: int, k: int, group: int) -> bool:
    """True when every a8 quantization segment of the Pallas kernels is
    exactly one scale group (the sets the CUDA kernel quantizes)."""
    seg, keff, _, g_eff = a8_segments(bits, k, group)
    return keff % g_eff == 0 and (seg == g_eff or g_eff == keff <= seg)


_RECIP_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def _rows_product(a: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                  bits: int, group: int, act_bits: int) -> torch.Tensor:
    """One expert's rows a (R, K) times its codes q (K, N) int8 with
    scales s (G, N): (R, N) f32, the kernels' function."""
    r, k = a.shape
    n = q.shape[1]
    rows_g = s.shape[0]
    a = a.to(torch.bfloat16).float()
    if act_bits != 8:
        g = k // rows_g
        part = torch.matmul(a.reshape(r, rows_g, g).transpose(0, 1),
                            q.float().reshape(rows_g, g, n))   # (G, R, N)
        return (part * s.reshape(rows_g, 1, n)).sum(0)
    seg, keff, keff_pad, g_eff = a8_segments(bits, k, group)
    planes = k // keff
    nseg = keff_pad // seg
    ap = F.pad(a.reshape(r, planes, keff), (0, keff_pad - keff))
    ap = ap.reshape(r, planes, nseg, seg)
    qs = ap.abs().amax(-1).clamp_min(1e-30) * _RECIP_127   # (R, P, S)
    ai = torch.round(ap / qs[..., None]).clamp(-127, 127)
    return _a8_sums(ai, qs, q, s, bits, group)


def _a8_sums(ai, qs, q, s, bits: int, group: int) -> torch.Tensor:
    """The a8 product of one expert's quantized rows: codes ai (R, P, S,
    seg) and scales qs (R, P, S) per (row, plane, segment, as
    `a8_segments` pads each plane) times its codes q (K, N) with scales s
    (G, N): exact integer sums, each segment's (sum * qs) * s added in one
    fused multiply-add in the Pallas body's order. (R, N) f32."""
    r = ai.shape[0]
    k, n = q.shape
    rows_g = s.shape[0]
    seg, keff, keff_pad, g_eff = a8_segments(bits, k, group)
    planes = k // keff
    nseg = keff_pad // seg
    qp = F.pad(q.reshape(planes, keff, n), (0, 0, 0, keff_pad - keff))
    # exact integer sums: f32 holds a segment's sum while below 2^24
    dt = torch.float32 if seg * 127 * 128 <= 2 ** 24 else torch.float64
    part = torch.matmul(ai.permute(1, 2, 0, 3).to(dt),
                        qp.reshape(planes, nseg, seg, n).to(dt)).float()
    srow = torch.tensor([[min((p * keff + j * seg) // g_eff, rows_g - 1)
                          for j in range(nseg)] for p in range(planes)],
                        device=s.device)
    part = part * qs.permute(1, 2, 0)[..., None]             # (P, S, R, N)
    sd = s[srow].double()                                    # (P, S, N)
    # out = fma(sum * qs, s, out) from 0, in the Pallas body's order (K
    # block, plane, segment), as XLA runs it on the CPU: the f64 product of
    # two f32 values is exact, so one f32 rounding of it plus out is the
    # fused op's (bar a double-rounding tie)
    per_block = max(1, _pick_block_k(keff, _BLOCK_K) // seg)
    out = torch.zeros((r, n), dtype=torch.float32, device=ai.device)
    for b0 in range(0, nseg, per_block):
        for p in range(planes):
            for j in range(b0, min(b0 + per_block, nseg)):
                out = (part[p, j].double() * sd[p, j]
                       + out.double()).float()
    return out


def _grouped_plain(xs, te, expert_weight, bits, group, act_bits, n,
                   out_dtype):
    """The plain version of both kernels: one expert at a time over the
    rows of its tiles (peak memory: one expert's partial sums)."""
    out = torch.zeros((xs.shape[0], n), dtype=torch.float32, device=xs.device)
    tile_e = te.to(torch.int64).repeat_interleave(BLOCK_M)
    for e in sorted(set(te.tolist()) - {-1}):
        rows = torch.nonzero(tile_e == e).flatten()
        q, s = expert_weight(e)
        out[rows] = _rows_product(xs[rows], q, s.float(), bits, group,
                                  act_bits)
    return out.to(out_dtype)


def grouped_dequant_matmul_plain(xs, qw: QuantizedTensor, tile_expert, *,
                                 out_dtype=torch.float32) -> torch.Tensor:
    """#9's arithmetic in plain PyTorch: xs (M_pad, K), stacked qw."""
    def weight(e):
        q = unpack_int4(qw.data[e]) if qw.bits == 4 else qw.data[e]
        return q, qw.scales[e]
    return _grouped_plain(xs, tile_expert, weight, qw.bits, qw.group_size,
                          qw.act_bits, qw.data.shape[-1], out_dtype)


def grouped_dequant_matmul_ncat_plain(xs, qw: QuantizedTensor, tile_expert,
                                      n_per_expert: int, *,
                                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """#10's arithmetic in plain PyTorch: xs (M_pad, K), cat qw."""
    ne = n_per_expert

    def weight(e):
        d = qw.data[:, e * ne:(e + 1) * ne]
        return (unpack_int4(d) if qw.bits == 4 else d), \
            qw.scales[:, e * ne:(e + 1) * ne]
    return _grouped_plain(xs, tile_expert, weight, qw.bits, qw.group_size,
                          qw.act_bits, ne, out_dtype)


def glu_rows_plain(gu: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """#9's input from #10's output gu (M, 2K), gate | up: bf16(act(f32
    gate) * f32 up), (M, K), act "silu" or "gelu" (tanh); the MoE layer's
    eager GLU (models/transformer.py `_moe_grouped_cat`) as it computes it
    on a bf16 model."""
    i = gu.shape[1] // 2
    return (activation(gu[:, :i].float(), act)
            * gu[:, i:].float()).to(torch.bfloat16)


def quantize_segments_plain(xs: torch.Tensor, seg: int, glu: bool = False,
                            act: str = "silu"):
    """(q, qs): the expert tiles' a8 activations xs (M, K), rounded to
    bf16, quantized per (row, segment of `seg` unpacked K values) as the
    Pallas body quantizes them where its segments are the scale groups: qs =
    max(amax, 1e-30) * fl(1/127), (K / seg, M) f32, segment-major as the
    kernel's flush reads it; q = x / qs rounded half to even, clipped to
    +-127, (M, K) int8. With `glu`, xs is #10's gate | up (M, 2K) and the
    rows are `glu_rows_plain(xs, act)`."""
    if glu:
        xs = glu_rows_plain(xs, act)
    m, k = xs.shape
    a = xs.to(torch.bfloat16).float().reshape(m, k // seg, seg)
    qs = a.abs().amax(-1).clamp_min(1e-30) * _RECIP_127      # (M, G)
    q = torch.round(a / qs[..., None]).clamp(-127, 127)
    return q.to(torch.int8).reshape(m, k), qs.t().contiguous()


#: at most this many values of a row a block of 9q takes, for segments
#: below 256 values (`segment_chunk`)
SEG_CHUNK = 256
#: the largest segment of 256 values or more: one chunk, up to four slots
#: a row (csrc SEG_SLOTS)
SEG_WIDE_MAX = 1024


def segment_chunk(k: int, seg: int) -> int:
    """Values of each row a block of the CUDA pre-pass takes: segments of
    8-128 values (seg / 8 lanes share one, met by warp shuffles) a chunk of
    the most whole segments dividing K up to SEG_CHUNK; segments of a
    multiple of 256 values (up to SEG_WIDE_MAX) one segment a chunk.
    Raises NotImplementedError for the other segment sizes, which no
    served weight has (a per-group a8 weight's segment is a power of two
    from 32; a per-channel one's, K, is at most 1024)."""
    if seg % 256 == 0 and seg <= SEG_WIDE_MAX:
        return seg
    if seg % 8 or seg > 128 or 32 % (seg // 8):
        raise NotImplementedError(
            f"CUDA quantize_segments takes segments of 8, 16, 32, 64 or 128 "
            f"values or a multiple of 256 up to {SEG_WIDE_MAX}, got {seg}")
    return max(c for c in range(seg, min(k, SEG_CHUNK) + 1, seg)
               if k % c == 0)


def quantize_segments(xs: torch.Tensor, seg: int,
                      tile_expert: torch.Tensor, glu: bool = False,
                      act: str = "silu"):
    """9q, the a8 pre-pass of #9 and #10: (q, qs) as
    `quantize_segments_plain` gives them, xs (M_pad, K) bf16 rows in tiles
    of BLOCK_M, or with `glu` #10's gate | up (M_pad, 2K), whose rows
    act(gate) * up (act "silu" or "gelu") the kernel computes itself. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (csrc/dequant_matmul.cu `quantize_segments_kernel`, counted in
    `quantize_segments.launches` and under "plain" or "glu" in
    `quantize_segments.variant_launches`), which skips the rows of dead
    tiles (their q and qs are left undefined), or raises."""
    if not xs.is_cuda:
        return quantize_segments_plain(xs, seg, glu, act)
    m, width = xs.shape
    k = width // 2 if glu else width
    if act not in ("silu", "gelu"):
        raise ValueError(f"act must be 'silu' or 'gelu', got {act!r}")
    if xs.dtype != torch.bfloat16 or not xs.is_contiguous() \
            or xs.data_ptr() % 16 or m % BLOCK_M or k % 8 or k % seg \
            or (glu and width % 2):
        raise NotImplementedError(
            f"quantize_segments takes contiguous (M, K) bf16 rows (GLU: (M, "
            f"2K)) in tiles of {BLOCK_M}, K % 8 == 0, and segments dividing "
            f"K, got {xs.dtype} {tuple(xs.shape)}, segment {seg}, glu {glu}")
    chunk = segment_chunk(k, seg)
    te = tile_expert.to(torch.int32).contiguous()
    q = torch.empty((m, k), dtype=torch.int8, device=xs.device)
    qs = torch.empty((k // seg, m), dtype=torch.float32, device=xs.device)
    rc = _build.library().dpt_quantize_segments(
        xs.data_ptr(), m, k, seg, chunk, int(glu), int(act == "gelu"),
        te.data_ptr(), q.data_ptr(), qs.data_ptr(), _build.stream())
    _build.check(rc, "quantize_segments")
    quantize_segments.launches += 1
    quantize_segments.variant_launches["glu" if glu else "plain"] += 1
    return q, qs


quantize_segments.launches = 0
quantize_segments.variant_launches = collections.Counter()


def grouped_a8_product_plain(q: torch.Tensor, qs: torch.Tensor,
                             qw: QuantizedTensor, tile_expert, *,
                             out_dtype=torch.float32) -> torch.Tensor:
    """#9's a8 product behind `quantize_segments_plain`: rows q (M_pad, K)
    int8 with scales qs (K / g, M_pad), each segment one scale group of
    the stacked a8 qw (`a8_per_group`), tile i times expert
    tile_expert[i]. With that pre-pass, the same bits as
    `grouped_dequant_matmul_plain`."""
    bits, k = qw.bits, qw.shape[1]
    seg, keff, keff_pad, g_eff = a8_segments(bits, k, qw.group_size)
    if not a8_per_group(bits, k, qw.group_size):
        raise NotImplementedError("a8 segments that are not scale groups")
    planes = k // keff
    out = torch.zeros((q.shape[0], qw.data.shape[-1]), dtype=torch.float32,
                      device=q.device)
    tile_e = tile_expert.to(torch.int64).repeat_interleave(BLOCK_M)
    for e in sorted(set(tile_expert.tolist()) - {-1}):
        rows = torch.nonzero(tile_e == e).flatten()
        r = rows.numel()
        # back to the (row, plane, segment) layout of `a8_segments`; a
        # padded segment's codes are 0, so it adds exactly nothing
        ai = F.pad(q[rows].float().reshape(r, planes, keff),
                   (0, keff_pad - keff)).reshape(r, planes, -1, seg)
        qr = F.pad(qs[:, rows].t().reshape(r, planes, keff // g_eff),
                   (0, keff_pad // seg - keff // g_eff), value=1.0)
        wq = unpack_int4(qw.data[e]) if bits == 4 else qw.data[e]
        out[rows] = _a8_sums(ai, qr, wq, qw.scales[e].float(), bits,
                             qw.group_size)
    return out.to(out_dtype)


def stage_depth(group: int) -> int:
    """Unpacked K rows a stage of the tensor-core kernel in its expert-tile
    modes: 64 where the scale group (K when per-channel) allows, else 32
    (`MMA_BKS`)."""
    return next(b for b in MMA_BKS if group % b == 0)


def _check(xs, qw, te, k, out_dtype, name, glu=False):
    """What the CUDA kernels take; returns the effective group."""
    if not isinstance(qw, QuantizedTensor) or qw.zero_points is not None:
        raise NotImplementedError(f"{name} takes symmetric QuantizedTensor "
                                  f"weights only, got {qw!r}")
    if qw.bits not in (4, 8) or qw.act_bits not in (0, 8):
        raise ValueError(f"not a weight the JAX package makes: {qw!r}")
    if xs.dtype != torch.bfloat16 or xs.dim() != 2 \
            or not xs.is_contiguous() or xs.data_ptr() % 16:
        raise NotImplementedError(f"CUDA {name} takes contiguous, 16-byte "
                                  f"aligned (M, K) bf16 rows, got {xs.dtype} "
                                  f"{tuple(xs.shape)}")
    if xs.shape[1] != (2 * k if glu else k):
        raise ValueError(f"xs width {xs.shape[1]} != {'2K' if glu else 'K'} "
                         f"for K {k}")
    if glu and qw.act_bits != 8:
        raise NotImplementedError(f"CUDA {name}: the GLU is computed in the "
                                  f"a8 pre-pass, got act_bits {qw.act_bits}")
    if xs.shape[0] % BLOCK_M or te.numel() != xs.shape[0] // BLOCK_M:
        raise ValueError(f"{te.numel()} tile experts for {xs.shape[0]} rows "
                         f"in tiles of {BLOCK_M}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"unsupported out_dtype {out_dtype}")
    data = qw.data
    if not data.is_contiguous() or data.data_ptr() % 16 \
            or not qw.scales.is_contiguous() \
            or qw.scales.dtype != torch.float32:
        raise ValueError("weight data must be contiguous and 16-byte aligned, "
                         "scales contiguous f32")
    rows_g = qw.scales.shape[-2]
    g_eff = k // rows_g
    if rows_g * g_eff != k or g_eff % K_STEP or (k // (2 if qw.bits == 4
                                                       else 1)) % K_STEP:
        raise NotImplementedError(
            f"CUDA {name} takes groups and stored rows of a multiple of "
            f"{K_STEP}, got K={k}, group {g_eff}, bits {qw.bits}")
    if qw.act_bits == 8 and not a8_per_group(qw.bits, k, qw.group_size):
        seg = a8_segments(qw.bits, k, qw.group_size)[0]
        raise NotImplementedError(
            f"CUDA {name}: a8 weight (bits {qw.bits}, K={k}, group "
            f"{g_eff}) whose Pallas quantization segments ({seg} rows) are "
            f"not its scale groups")
    for t, what in ((data, "weight"), (qw.scales, "scales"), (te, "te")):
        _build.require_cuda(t, what)
    return g_eff


def _count(fn, qw):
    fn.launches += 1
    fn.variant_launches[variant(qw)] += 1


def expert_map(cat: bool, rows: int, n: int, e: int):
    """(dims, pitches) of the 3-D tensor map through which the tensor-core
    kernel reads an expert's weight, in TMA's order (innermost first;
    int8 elements, pitches in bytes), as csrc/dequant_matmul.cu
    `launch_mma_bn` encodes it: stacked (#9, (E, rows, n)): dims (n, rows,
    E), pitches (n, rows·n), the expert the third coordinate; cat (#10,
    (rows, E·n)): dims (n, E, rows), pitches (n, E·n), the expert the
    second. TMA needs each pitch a multiple of 16 bytes."""
    if cat:
        return (n, e, rows), (n, e * n)
    return (n, rows, e), (n, rows * n)


def _launch(fn, name, xs, qw, te, k, n, e, cat, out_dtype, glu=False,
            act="silu"):
    """#9 (cat False) or #10 (cat True) on the tensor-core kernel."""
    g = _check(xs, qw, te, k, out_dtype, name, glu)
    rows = k // 2 if qw.bits == 4 else k
    if any(p % 16 for p in expert_map(cat, rows, n, e)[1]):
        raise NotImplementedError(
            f"CUDA {name} takes {'n_per_expert' if cat else 'N'} % 16 == 0 "
            f"(TMA's pitches), got {n}")
    te = te.to(torch.int32).contiguous()
    a8 = qw.act_bits == 8
    x, qs = quantize_segments(xs, g, te, glu, act) if a8 else (xs, None)
    out = torch.empty((xs.shape[0], n), dtype=out_dtype, device=xs.device)
    rc = _build.library().dpt_grouped_mma(
        x.data_ptr(), None if qs is None else qs.data_ptr(),
        qw.data.data_ptr(), qw.scales.data_ptr(), te.data_ptr(), qw.bits, g,
        int(a8), out.data_ptr(), int(out_dtype == torch.float32),
        xs.shape[0], k, n, e, stage_depth(g), int(cat), _build.stream())
    _build.check(rc, name)
    _count(fn, qw)
    return out


def grouped_dequant_matmul(xs: torch.Tensor, qw: QuantizedTensor,
                           tile_expert: torch.Tensor, *,
                           out_dtype=torch.float32,
                           glu: bool = False,
                           act: str = "silu") -> torch.Tensor:
    """#9: xs (M_pad, K) rows, tile i of BLOCK_M rows times expert
    tile_expert[i] of the stacked qw (data (E, K[/2], N), scales (E, G,
    N)) -> (M_pad, N). With `glu` xs is #10's gate | up (M_pad, 2K) and the
    rows are `glu_rows_plain(xs, act)`, act(gate) * up. A CPU tensor takes the
    plain version; a CUDA tensor launches the tensor-core kernel (a8:
    after `quantize_segments`, which computes the GLU itself) or raises
    (also for `glu` with a weight-only qw)."""
    if not xs.is_cuda:
        return grouped_dequant_matmul_plain(
            glu_rows_plain(xs, act) if glu else xs, qw, tile_expert,
            out_dtype=out_dtype)
    if qw.data.dim() != 3:
        raise ValueError("grouped_dequant_matmul expects stacked (E, K, N)")
    e, _, n = qw.data.shape
    return _launch(grouped_dequant_matmul, "grouped_dequant_matmul", xs, qw,
                   tile_expert, qw.shape[1], n, e, False, out_dtype, glu,
                   act)


grouped_dequant_matmul.launches = 0
grouped_dequant_matmul.variant_launches = collections.Counter()


def grouped_dequant_matmul_ncat(xs: torch.Tensor, qw: QuantizedTensor,
                                tile_expert: torch.Tensor, n_per_expert: int,
                                *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """#10: xs (M_pad, K) rows, tile i times the column block of expert
    tile_expert[i] of the 2-D cat qw (K[/2], E·n_per_expert) -> (M_pad,
    n_per_expert). A CPU tensor takes the plain version; a CUDA tensor
    launches the tensor-core kernel over the cat's expert view (a8: after
    `quantize_segments`) or raises."""
    if not xs.is_cuda:
        return grouped_dequant_matmul_ncat_plain(
            xs, qw, tile_expert, n_per_expert, out_dtype=out_dtype)
    if qw.data.dim() != 2:
        raise ValueError("grouped_dequant_matmul_ncat expects a 2-D cat")
    k, n_total = qw.shape
    ne = n_per_expert
    if n_total % ne:
        raise ValueError(f"cat N {n_total} not a multiple of {ne}")
    return _launch(grouped_dequant_matmul_ncat, "grouped_dequant_matmul_ncat",
                   xs, qw, tile_expert, k, ne, n_total // ne, True, out_dtype)


grouped_dequant_matmul_ncat.launches = 0
grouped_dequant_matmul_ncat.variant_launches = collections.Counter()


def expert_tiles(sorted_e: torch.Tensor, counts: torch.Tensor):
    """The row layout of a grouped matmul over P routed pairs sorted by
    expert (`sorted_e` (P,), `counts` (E,) pairs per expert): (dest (P,)
    row of each pair, tile_expert (n_tiles,) int32 with -1 for dead tail
    tiles, m_pad rows). Every expert's segment starts on a tile; m_pad =
    round_up(P, BLOCK_M) + E·BLOCK_M covers any routing, so the sizes are
    static and nothing is read back to the host."""
    p, e = sorted_e.numel(), counts.numel()
    m_pad = _round_up(p, BLOCK_M) + e * BLOCK_M
    tiles = (counts + BLOCK_M - 1) // BLOCK_M
    cum = torch.cumsum(tiles, 0)
    starts = torch.cumsum(counts, 0) - counts
    pad_starts = (cum - tiles) * BLOCK_M
    j = torch.arange(p, device=sorted_e.device)
    dest = pad_starts[sorted_e] + (j - starts[sorted_e])
    tile = torch.arange(m_pad // BLOCK_M, device=sorted_e.device)
    te = torch.where(tile < cum[-1], torch.searchsorted(cum, tile, right=True),
                     torch.full_like(tile, -1))
    return dest, te.to(torch.int32), m_pad
