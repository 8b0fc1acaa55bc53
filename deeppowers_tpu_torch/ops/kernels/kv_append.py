"""In-place KV-cache row appends: wrappers, plain versions and launch
counts of two kernels, one token per slot, K and V of one layer in one
launch, bf16. CUDA source: csrc/kv_append.cu.

`scatter_rows` replaces the Pallas TPU kernel
deeppowers_tpu/ops/pallas/kv_append.py (`scatter_rows` :116 ->
`_scatter_one` :69, pallas_call :104, body `_kernel` :43) for flat
(B, S, F) caches: rows[b] go to cache[b, positions[b]]; a position outside
[0, S) is dropped, with no write and no fault.

`scatter_pool_rows` replaces `scatter_pool_rows` :225 (pallas_call :207,
body `_kernel_pool` :146) for the paged layout's (P, page, F) pools,
values only (the scale pools of quantized KV are not ported): rows[b] go
to absolute row row_idx[b] of the flat (P*page, F) view where valid[b];
an invalid row is not written at all. (The TPU kernel writes the old
content back into its 8-row tile, a tiling artefact.)

Both write IN PLACE (the JAX versions return aliased buffers). Bound on
an H100: 2*B*F*2 bytes, far below the fixed cost of a launch; the point
of the kernels is to touch nothing else.
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


def scatter_pool_rows_plain(k_pool, v_pool, k_rows, v_rows, row_idx,
                            valid) -> None:
    """The kernel's effect in plain PyTorch (in place)."""
    f = k_pool.shape[2]
    rows = row_idx.long()[valid]
    k_pool.view(-1, f)[rows] = k_rows[valid].to(k_pool.dtype)
    v_pool.view(-1, f)[rows] = v_rows[valid].to(v_pool.dtype)


def scatter_pool_rows(k_pool: torch.Tensor, v_pool: torch.Tensor,
                      k_rows: torch.Tensor, v_rows: torch.Tensor,
                      row_idx: torch.Tensor, valid: torch.Tensor) -> None:
    """k_pool, v_pool: (P, page, F), updated in place. k_rows, v_rows:
    (B, F). row_idx: (B,) absolute rows of the (P*page, F) view; valid:
    (B,) bool. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    if not k_pool.is_cuda:
        scatter_pool_rows_plain(k_pool, v_pool, k_rows, v_rows, row_idx, valid)
        return
    p, ps, f = k_pool.shape
    b = row_idx.shape[0]
    for t, name in ((v_pool, "v_pool"), (k_rows, "k_rows"), (v_rows, "v_rows"),
                    (row_idx, "row_idx"), (valid, "valid")):
        _build.require_cuda(t, name)
    if (k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16
            or v_pool.shape != k_pool.shape or not k_pool.is_contiguous()
            or not v_pool.is_contiguous()):
        raise NotImplementedError("CUDA scatter_pool_rows takes contiguous "
                                  "bf16 (P, page, F) pools of one shape")
    for r in (k_rows, v_rows):
        if r.shape != (b, f) or r.dtype != torch.bfloat16 or r.stride(-1) != 1:
            raise ValueError(f"rows must be bf16 (B, F) = {(b, f)} with "
                             f"contiguous features, got {tuple(r.shape)} {r.dtype}")
    if valid.shape != (b,) or row_idx.dim() != 1:
        raise ValueError("row_idx and valid must be (B,)")
    rows = row_idx.to(torch.int32).contiguous()      # no copy when int32
    ok = valid.to(torch.bool).contiguous()           # no copy when bool
    rc = _build.library().dpt_kv_append_pool(
        k_pool.data_ptr(), v_pool.data_ptr(), k_rows.data_ptr(),
        k_rows.stride(0), v_rows.data_ptr(), v_rows.stride(0),
        rows.data_ptr(), ok.data_ptr(), b, p * ps, f, _build.stream())
    _build.check(rc, "scatter_pool_rows")
    scatter_pool_rows.launches += 1


scatter_pool_rows.launches = 0
