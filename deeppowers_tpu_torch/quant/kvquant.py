"""KV-cache quantizers, ported from deeppowers_tpu/runtime/kvcache.py
(`_quant_kv` :192, `_dequant_kv` :202, `_quant_kv4` :208, `_dequant_kv4`
:229).

int8: symmetric per (..., head), scale = max(absmax, 1e-8) / 127.
int4: symmetric per (..., head, D/nh sub-block), scale = max(absmax, 1e-8)
/ 7, packed two to a byte half-split along D: the low nibble of byte j
holds feature j, the high nibble feature j + D/2. Scale rows are
sub-block-minor: head * nh + sub.

The bytes and scales equal the JAX package's bit for bit: f32 absmax,
IEEE division by 127 (or 7) and by the scale (XLA keeps both as
divisions here; a reciprocal product differs in the last bit), round half
to even (torch.round, like jnp.round), clip, nibbles as (hi << 4) |
(lo & 0xF). The CUDA append kernels (csrc/kv_append.cu) compute the same.

Also the store layout both cache layouts share (JAX `init_cache` :116-190,
`init_paged_cache` :140-178): `store_layout`, `new_store`, `quant_for`
(JAX `_quant_for` :252 and `_quant_side`) and `store_args`, which hands a
cache's scales and bits to the kernel wrappers.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: kv_cache_dtype -> (K store bits, V store bits); 16 is the bf16 store
STORE_BITS = {"bf16": (16, 16), "int8": (8, 8), "int4": (4, 4),
              "k8v4": (8, 4)}
KV_CACHE_DTYPES = tuple(STORE_BITS)


def flat_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., K, D) -> (..., K*D): rows as the flat stores keep them."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def gather_scale(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """A paged (P, R, page) scale pool gathered through a (B, WP) page
    table -> head-major (B, R, WP*page), the contiguous layout's scales."""
    b, wp = table.shape
    g = pool[table.reshape(-1).long()].reshape(b, wp, *pool.shape[1:])
    return g.transpose(1, 2).reshape(b, pool.shape[1], wp * pool.shape[2])


def _div(a: torch.Tensor, qmax: float) -> torch.Tensor:
    """a / qmax by IEEE division on every device: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal instead, which differs
    in the last bit for some inputs."""
    return a / torch.full_like(a, qmax)


def quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (..., head) symmetric int8. x: (..., K, D) -> ((..., K*D) int8,
    (..., K) f32 scales)."""
    xf = x.float()
    scale = _div(xf.abs().amax(-1, keepdim=True).clamp_min(1e-8), 127.0)
    q = torch.round(xf / scale).clamp(-128, 127).to(torch.int8)
    return flat_heads(q), scale[..., 0]


def quant_kv4(x: torch.Tensor, nh: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (..., head, D/nh sub-block) symmetric int4, packed half-split.
    x: (..., K, D) -> ((..., K*D/2) int8, (..., K*nh) f32 scales)."""
    *lead, k, d = x.shape
    xr = x.float().reshape(*lead, k, nh, d // nh)
    scale = _div(xr.abs().amax(-1, keepdim=True).clamp_min(1e-8), 7.0)
    q = torch.round(xr / scale).clamp(-8, 7).reshape(*lead, k, d).to(
        torch.int32)
    packed = ((q[..., d // 2:] & 0x0F) << 4) | (q[..., :d // 2] & 0x0F)
    return flat_heads(packed.to(torch.int8)), scale[..., 0].reshape(*lead, k * nh)


def unpack4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 bytes -> (lo, hi) sign-extended nibbles as int32."""
    p = packed.to(torch.int32)
    return ((p & 0x0F) ^ 0x08) - 0x08, p >> 4


def dequant_kv(q4: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """q4: (..., S, K, D) int8 view; scale: (..., K, S) head-major."""
    sc = scale.transpose(-1, -2)[..., None]               # (..., S, K, 1)
    return (q4.float() * sc).to(dtype)


def dequant_kv4(packed4: torch.Tensor, scale: torch.Tensor, dtype
                ) -> torch.Tensor:
    """packed4: (..., S, K, D/2) int8 view; scale: (..., K*nh, S)
    head-major, nh sub-block scales per head (sub-minor)."""
    lo, hi = (t.float() for t in unpack4(packed4))
    k = packed4.shape[-2]
    nh = scale.shape[-2] // k
    sc = scale.transpose(-1, -2)                         # (..., S, K*nh)
    if nh == 1:
        return (torch.cat([lo, hi], -1) * sc[..., None]).to(dtype)
    sc = sc.reshape(*sc.shape[:-1], k, nh)
    return torch.cat([lo * sc[..., 0:1], hi * sc[..., 1:2]], -1).to(dtype)


def quant_side(x: torch.Tensor, bits: int, nh: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cache side's rows: int8 (bits 8) or packed int4 with nh scales
    per head. x: (..., K, D)."""
    return quant_kv(x) if bits != 4 else quant_kv4(x, nh=nh)


def dequant_side(stored4: torch.Tensor, scale: torch.Tensor, bits: int,
                 dtype) -> torch.Tensor:
    """Inverse of quant_side over (..., S, K, w) stored rows and (..., K*nh,
    S) head-major scales."""
    if bits == 4:
        return dequant_kv4(stored4, scale, dtype)
    return dequant_kv(stored4, scale, dtype)


def store_variant(k_scale, kv_bits: int = 8, v_bits: int = 0) -> str:
    """The kv_cache_dtype of a store given as JAX's kernels take it (scales
    or None, kv_bits, v_bits with 0 meaning "as K"): "bf16" without
    scales."""
    if k_scale is None:
        return "bf16"
    bits = (kv_bits, v_bits or kv_bits)
    for name, b in STORE_BITS.items():
        if b == bits:
            return name
    raise NotImplementedError(f"KV store bits {bits} not supported")


def scale_heads(scale: torch.Tensor, bits: int) -> int:
    """Kv heads of a side from its scale rows: an int4 side carries two
    sub-block scales per head, an int8 side one."""
    return scale.shape[-2] // (2 if bits == 4 else 1)


def store_layout(kv_cache_dtype: str, num_kv_heads: int, head_dim: int):
    """(K bits, V bits, K scale rows, V scale rows) of a quantized store."""
    if kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"unknown kv_cache_dtype {kv_cache_dtype!r}")
    k_bits, v_bits = STORE_BITS[kv_cache_dtype]
    if 4 in (k_bits, v_bits) and head_dim % 2:
        raise ValueError(f"{kv_cache_dtype} KV needs an even head_dim")

    def rows(bits):
        return num_kv_heads * (2 if bits == 4 else 1)

    return k_bits, v_bits, rows(k_bits), rows(v_bits)


def new_store(kv_cache_dtype: str, lead: int, minor: int, num_kv_heads: int,
              head_dim: int, *, dtype=torch.bfloat16, device=None) -> dict:
    """Zero-filled K/V stores of one layer, shared by both cache layouts:
    {k, v: (lead, minor, F'), k_scale, v_scale: (lead, R, minor) f32 or
    None, head_width, bits, v_bits}, where (lead, minor) is (slots,
    positions) or (pages, page rows). Zeros, never torch.empty: a NaN in a
    row no slot has written yet must not be able to reach attention."""
    f = num_kv_heads * head_dim
    if kv_cache_dtype == "bf16":
        return dict(k=torch.zeros((lead, minor, f), dtype=dtype, device=device),
                    v=torch.zeros((lead, minor, f), dtype=dtype, device=device),
                    k_scale=None, v_scale=None, head_width=head_dim, bits=8,
                    v_bits=0)
    kb, vb, kr, vr = store_layout(kv_cache_dtype, num_kv_heads, head_dim)

    def zeros(*shape, dt=torch.int8):
        return torch.zeros(shape, dtype=dt, device=device)

    return dict(k=zeros(lead, minor, f // 2 if kb == 4 else f),
                v=zeros(lead, minor, f // 2 if vb == 4 else f),
                k_scale=zeros(lead, kr, minor, dt=torch.float32),
                v_scale=zeros(lead, vr, minor, dt=torch.float32),
                head_width=head_dim // 2 if kb == 4 else head_dim,
                bits=kb, v_bits=0 if vb == kb else vb)


def quant_for(rows: torch.Tensor, scale: torch.Tensor, bits: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat (N, Kh*D) rows quantized for one side of a quantized store of
    either layout whose (lead, R, minor) scale table is `scale`: int8, or
    packed int4 with the R / Kh sub-block scales per head the table
    declares (JAX `_quant_for` :252, `_quant_side`). Returns ((N, F')
    stored rows, (N, R) scales)."""
    kh = scale_heads(scale, bits)
    return quant_side(rows.reshape(rows.shape[0], kh, rows.shape[1] // kh),
                      bits, scale.shape[-2] // kh)


def store_args(cache) -> dict:
    """The keyword arguments that tell a kernel wrapper (kv_append,
    decode_attention) how a cache of either layout stores its rows."""
    if not cache.quantized:
        return {}
    return dict(k_scale=cache.k_scale, v_scale=cache.v_scale,
                kv_bits=cache.bits, v_bits=cache.v_bits)
