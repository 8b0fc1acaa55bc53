"""Checkpoint save and load, ported from deeppowers_tpu/runtime/checkpoint.py.

The format is the JAX package's, byte for byte, so either package reads
what the other writes:

  <dir>/manifest.json    tree structure, dtypes, quantization metadata,
                         TransformerConfig (format v2)
  <dir>/arrays/NNNNN.npy one file a leaf; bf16 stored as a uint16 view,
                         its dtype recorded in the manifest

Saving pulls one leaf to the host at a time; loading opens every .npy
memory-mapped and moves one leaf at a time to the device, so the host never
holds more than one tensor. v1 checkpoints (one `arrays.npz`) still load.
A QuantizedTensor is a structure node carrying its bits, group_size,
act_bits and the keys of its data, scales and zero points (JAX
`_flatten_for_save` :52-82).

Not ported: placing leaves straight into a device mesh (`mesh=`, JAX
:233-259, with the int4 row repack `_repack4_rows_host` :136-158), which
belongs to the parallel modes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.transformer import TransformerConfig
from ..quant.qtypes import QuantizedTensor

FORMAT_VERSION = 2


def _dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a tensor's dtype, as the JAX package records it
    ("float32", "bfloat16", "int8", ...)."""
    return str(t.dtype).replace("torch.", "")


def _leaf_meta(t: torch.Tensor) -> Dict:
    return {"dtype": _dtype_name(t), "shape": list(t.shape)}


def _flatten_for_save(tree: Any):
    """(leaves {key: tensor}, structure): the structure skeleton with
    {"__array__": key} markers and QuantizedTensor metadata nodes, keyed as
    JAX keys them ("layers[0].attn.wq.w", + ".data" / ".scales" /
    ".zero_points" for a quantized leaf)."""
    leaves: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, QuantizedTensor):
            meta = {"__quantized__": True, "bits": node.bits,
                    "group_size": node.group_size,
                    "act_bits": node.act_bits,
                    "data": path + ".data", "scales": path + ".scales",
                    "data_meta": _leaf_meta(node.data),
                    "scales_meta": _leaf_meta(node.scales)}
            leaves[path + ".data"] = node.data
            leaves[path + ".scales"] = node.scales
            if node.zero_points is not None:
                meta["zero_points"] = path + ".zero_points"
                meta["zero_points_meta"] = _leaf_meta(node.zero_points)
                leaves[path + ".zero_points"] = node.zero_points
            return meta
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{path}[{i}]") for i, v in enumerate(node)]
        leaves[path] = node
        return {"__array__": path, **_leaf_meta(node)}

    structure = walk(tree, "")
    return leaves, structure


def _host_array(t: torch.Tensor) -> np.ndarray:
    """One leaf on the host as numpy; bf16 as its uint16 view."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(path: str, params: Any,
                    cfg: Optional[TransformerConfig] = None,
                    extra: Optional[Dict] = None) -> None:
    """Write format v2: one .npy a leaf, one leaf on the host at a time
    (JAX `save_checkpoint` :89-114)."""
    os.makedirs(os.path.join(path, "arrays"), exist_ok=True)
    leaves, structure = _flatten_for_save(params)
    files: Dict[str, str] = {}
    for i, (key, leaf) in enumerate(leaves.items()):
        fname = f"{i:05d}.npy"
        files[key] = fname
        np.save(os.path.join(path, "arrays", fname), _host_array(leaf))
    manifest = {
        "format_version": FORMAT_VERSION,
        "structure": structure,
        "files": files,
        "config": dataclasses.asdict(cfg) if cfg else None,
        "extra": extra or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _make_loader(path: str, manifest: Dict) -> Callable[[str], np.ndarray]:
    """fetch(key) -> host array: memory-mapped for v2, from the npz for
    v1."""
    files = manifest.get("files")
    if files is not None:
        return lambda key: np.load(
            os.path.join(path, "arrays", files[key]), mmap_mode="r")
    npz = np.load(os.path.join(path, "arrays.npz"))
    return lambda key: npz[key]


def _to_device(arr: np.ndarray, want: str, device: torch.device,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One leaf host -> device. A bf16 leaf comes as its uint16 view; a
    float leaf is cast to `dtype` when given. The mmap is read once, into
    one host tensor of PyTorch's own, which then moves to the device."""
    src = np.asarray(arr)
    bf16 = want == "bfloat16" and src.dtype == np.uint16
    if bf16:
        src = src.view(np.int16)
    t = torch.empty(src.shape, dtype=torch.from_numpy(
        np.empty(0, src.dtype)).dtype)
    t.numpy()[...] = src
    if bf16:
        t = t.view(torch.bfloat16)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _meta_dtype(node: Dict, which: str, default: str) -> str:
    """A leaf's recorded dtype; v1 manifests record none."""
    return node.get(which, {}).get("dtype", default)


def load_checkpoint(path: str, *, device=None,
                    dtype: Optional[torch.dtype] = None
                    ) -> Tuple[Any, Optional[TransformerConfig], Dict]:
    """Load a v1 or v2 checkpoint onto `device` (CUDA unless the caller
    asks for the CPU), one leaf at a time. `dtype` casts the float leaves
    (QuantizedTensor scales stay f32, integer data stays as stored).
    Returns (params, cfg or None, extra), as JAX's `load_checkpoint`
    (:210-304) without a mesh."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format_version") not in (1, FORMAT_VERSION):
        raise ValueError(f"unsupported checkpoint version in {path}")
    cfg = None
    if manifest.get("config"):
        cfg = TransformerConfig(**manifest["config"])
    fetch = _make_loader(path, manifest)

    def walk(node):
        if isinstance(node, dict):
            if node.get("__quantized__"):
                zp = None
                if "zero_points" in node:
                    zp = _to_device(fetch(node["zero_points"]), _meta_dtype(
                        node, "zero_points_meta", "int32"), dev)
                return QuantizedTensor(
                    data=_to_device(fetch(node["data"]), _meta_dtype(
                        node, "data_meta", "int8"), dev),
                    scales=_to_device(fetch(node["scales"]), _meta_dtype(
                        node, "scales_meta", "float32"), dev),
                    zero_points=zp, bits=node["bits"],
                    group_size=node["group_size"],
                    act_bits=node.get("act_bits", 0))
            if "__array__" in node:
                return _to_device(fetch(node["__array__"]),
                                  node.get("dtype", "float32"), dev, dtype)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    params = walk(manifest["structure"])
    return params, cfg, manifest.get("extra", {})
