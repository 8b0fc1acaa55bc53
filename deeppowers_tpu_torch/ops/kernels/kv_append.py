"""In-place KV-cache row append: wrapper, plain version and launch count.

Replaces the Pallas TPU kernel deeppowers_tpu/ops/pallas/kv_append.py
(`scatter_rows` :116 -> `_scatter_one` :69, pallas_call :104, body
`_kernel` :43) for flat (B, S, F) bf16 caches, one token per slot, K and V
of one layer in one launch. CUDA source: csrc/kv_append.cu.

Writes rows[b] into cache[b, positions[b]] IN PLACE (the JAX version
returns aliased buffers); a position outside [0, S) is dropped, with no
write and no fault. Bound on an H100: 2*B*F*2 bytes, far below the fixed
cost of a launch; the point of the kernel is to touch nothing else.
"""

from __future__ import annotations

import torch

from . import _build


def scatter_rows_plain(k_cache, v_cache, k_rows, v_rows, positions) -> None:
    """The kernel's effect in plain PyTorch (in place)."""
    s = k_cache.shape[1]
    pos = positions.long()
    keep = (pos >= 0) & (pos < s)
    slots = torch.arange(k_cache.shape[0], device=k_cache.device)[keep]
    k_cache[slots, pos[keep]] = k_rows[keep].to(k_cache.dtype)
    v_cache[slots, pos[keep]] = v_rows[keep].to(v_cache.dtype)


def scatter_rows(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_rows: torch.Tensor, v_rows: torch.Tensor,
                 positions: torch.Tensor) -> None:
    """k_cache, v_cache: (B, S, F), updated in place. k_rows, v_rows:
    (B, F). positions: (B,) int. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if not k_cache.is_cuda:
        scatter_rows_plain(k_cache, v_cache, k_rows, v_rows, positions)
        return
    b, s, f = k_cache.shape
    for t, name in ((v_cache, "v_cache"), (k_rows, "k_rows"),
                    (v_rows, "v_rows"), (positions, "positions")):
        _build.require_cuda(t, name)
    if (k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16
            or v_cache.shape != k_cache.shape or not k_cache.is_contiguous()
            or not v_cache.is_contiguous()):
        raise NotImplementedError("CUDA scatter_rows takes contiguous bf16 "
                                  "(B, S, F) caches of one shape")
    for r in (k_rows, v_rows):
        if r.shape != (b, f) or r.dtype != torch.bfloat16 or r.stride(-1) != 1:
            raise ValueError(f"rows must be bf16 (B, F) = {(b, f)} with "
                             f"contiguous features, got {tuple(r.shape)} {r.dtype}")
    pos = positions.to(torch.int32).contiguous()
    if pos.shape != (b,):
        raise ValueError(f"positions must be (B,), got {tuple(pos.shape)}")
    rc = _build.library().dpt_kv_append(
        k_cache.data_ptr(), v_cache.data_ptr(), k_rows.data_ptr(),
        k_rows.stride(0), v_rows.data_ptr(), v_rows.stride(0),
        pos.data_ptr(), b, s, f, _build.stream())
    _build.check(rc, "scatter_rows")
    scatter_rows.launches += 1


scatter_rows.launches = 0
