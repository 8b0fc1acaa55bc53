"""Build and bind the CUDA kernels: one nvcc call, one shared library.

All `csrc/*.cu` sources compile together with
  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
       -Xcompiler -fPIC -o libdpt_kernels.so csrc/*.cu
into `build/deeppowers_tpu_torch/<hash>/` under the checkout, at first use.
The hash covers the sources and the flags, so an unchanged tree loads the
library it built before. Each kernel has a plain `extern "C"` launcher that
returns cudaGetLastError(); `check` raises when that is not 0. Nothing here
runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "deeppowers_tpu_torch"
SOURCES = ("dequant_matmul.cu", "kv_append.cu", "decode_attention.cu",
           "flash_attention.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
SIGNATURES: Dict[str, list] = {
    "dpt_dequant_matmul": [_P, _LL, _P, _P, _P, _P, _P, _LL, _P, _I, _P,
                           _I, _I, _I, _I, _I, _I, _F, _P],
    "dpt_kv_append": [_P, _P, _P, _P, _P, _LL, _P, _LL, _P, _P, _I, _I, _I,
                      _I, _I, _I, _I, _P],
    "dpt_kv_append_pool": [_P, _P, _P, _P, _P, _LL, _P, _LL, _P, _P, _I, _I,
                           _I, _I, _I, _I, _I, _P],
    "dpt_decode_attention": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _LL, _P, _LL,
                             _LL, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
                             _P, _P, _P, _P],
    "dpt_decode_attention_paged": [_P, _LL, _P, _P, _P, _P, _P, _I, _I, _P, _I,
                                   _I, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P,
                                   _P, _P],
    "dpt_flash_attention": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P,
                            _I, _I, _I, _I, _I, _F, _P, _P],
}

_lib: Optional[ctypes.CDLL] = None
#: what the last build did: {"seconds", "cached", "path", "log"}
build_info: Dict[str, object] = {}


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME; the CUDA kernels of "
        "deeppowers_tpu_torch cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source with one nvcc call unless this tree's library
    already exists; returns the library path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libdpt_kernels.so"
    if lib.is_file():
        build_info.update(seconds=0.0, cached=True, path=str(lib))
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libdpt_kernels.{os.getpid()}.so"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    (out_dir / "nvcc.log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log[-6000:]}")
    os.replace(tmp, lib)
    build_info.update(seconds=seconds, cached=False, path=str(lib), log=log)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream() -> int:
    """Handle of PyTorch's current CUDA stream, for a launch."""
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require_cuda(t: torch.Tensor, name: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
