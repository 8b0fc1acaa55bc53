"""Parameter trees from numpy: the bridge from the JAX package's params.

`params_from_numpy` takes a JAX-package parameter tree whose leaves have
been turned into numpy arrays (the caller does the np.asarray on the JAX
side, so this package never imports JAX) and returns the port's tree:
same nesting and keys, torch tensors on `device`. A quantized leaf is any
object carrying QuantizedTensor's fields (data, scales, zero_points, bits,
group_size[, act_bits]) as numpy arrays or ints.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..quant.qtypes import QuantizedTensor


def tensor_from_numpy(arr, device=None, dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> torch tensor on `device`."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(resolve_device(device))


def _is_quantized(node) -> bool:
    # a numpy array has a `data` attribute of its own: test arrays first
    return not isinstance(node, np.ndarray) and all(
        hasattr(node, f) for f in ("data", "scales", "bits", "group_size"))


def params_from_numpy(tree: Any, *, device=None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Convert a numpy-leaved parameter tree. Float leaves are cast to
    `dtype` when given (QuantizedTensor scales stay f32, int data stays
    int8)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device=device, dtype=dtype) for v in tree]
    if _is_quantized(tree):
        zp = getattr(tree, "zero_points", None)
        return QuantizedTensor(
            data=tensor_from_numpy(tree.data, device),
            scales=tensor_from_numpy(tree.scales, device, torch.float32),
            zero_points=None if zp is None else tensor_from_numpy(zp, device),
            bits=int(tree.bits), group_size=int(tree.group_size),
            act_bits=int(getattr(tree, "act_bits", 0) or 0))
    return tensor_from_numpy(tree, device, dtype)
