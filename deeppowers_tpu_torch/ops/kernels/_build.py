"""Build and bind the CUDA kernels: one shared library.

Each `csrc/*.cu` source compiles in an nvcc process of its own, all started
together,
  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
       -fPIC -Xptxas -v -c -o <source>.o csrc/<source>.cu
and one more nvcc call links the objects into libdpt_kernels.so, in
`build/deeppowers_tpu_torch/<hash>/` under the checkout, at first use. The
hash covers the sources and the flags, so an unchanged tree loads the
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
SOURCES = ("dequant_matmul.cu", "dequant_matmul_zp.cu", "gemv.cu",
           "kv_append.cu", "decode_attention.cu", "decode_attention_kt.cu",
           "decode_attention_i8.cu",
           "flash_attention.cu")
HEADERS = ("common.cuh", "decode_attention.cuh", "wgmma.cuh",
           "dequant_common.cuh", "mma_kernel.cuh", "kv_store.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
SIGNATURES: Dict[str, list] = {
    "dpt_dequant_matmul": [_P, _LL, _P, _P, _P, _P, _I, _I, _P, _P, _P, _LL,
                           _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _F, _P],
    "dpt_quantize_rows": [_P, _LL, _P, _I, _I, _F, _I, _I, _P, _LL, _P, _I,
                          _I, _P],
    "dpt_stage_rows": [_P, _LL, _P, _I, _I, _F, _I, _I, _P, _LL, _P, _P],
    "dpt_kv_append": [_P, _P, _P, _P, _P, _LL, _P, _LL, _P, _P, _I, _I, _I,
                      _I, _I, _I, _I, _P],
    "dpt_kv_append_stacked": [_P, _P, _P, _P, _P, _LL, _P, _LL, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "dpt_kv_append_pool": [_P, _P, _P, _P, _P, _LL, _P, _LL, _P, _P, _I, _I,
                           _I, _I, _I, _I, _I, _P],
    "dpt_decode_attention": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _LL, _P, _LL,
                             _LL, _P] + [_I] * 14 + [_F, _P]
                            + [_P, _LL, _LL, _P, _LL, _LL, _P, _P],
    "dpt_decode_attention_i8": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _LL,
                                _P, _LL, _LL, _P] + [_I] * 14 + [_F, _P]
                               + [_P, _LL, _LL, _P, _LL, _LL, _P, _I, _I,
                                  _P],
    "dpt_decode_attention_paged": [_P, _LL, _P, _P, _P, _P, _P, _I, _I, _P]
                                  + [_I] * 14 + [_F, _P, _I]
                                  + [_P, _LL, _LL, _P, _LL, _LL, _P, _P, _P,
                                     _P],
    "dpt_decode_attention_kt": [_P, _LL, _P, _P, _P, _P, _P, _P]
                               + [_I] * 13 + [_F, _P, _P],
    "dpt_grouped_mma": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I,
                        _I, _I, _I, _P],
    "dpt_quantize_segments": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                              _P],
    "dpt_flash_attention": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P,
                            _I, _I, _I, _I, _I, _I, _I, _F, _P, _P],
}

_lib: Optional[ctypes.CDLL] = None
#: what the last build did: {"seconds", "cached", "path", "log",
#: "compile_s" (each source's nvcc seconds), "link_s"}
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


def _run(cmds, timeout):
    """Run the commands as processes started together; [(rc, output,
    seconds)] in order. A process past `timeout` is killed and raises."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    out = []
    try:
        for p in procs:
            left = max(1.0, timeout - (time.perf_counter() - t0))
            text = p.communicate(timeout=left)[0]
            out.append((p.returncode, text, time.perf_counter() - t0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def build() -> Path:
    """Compile every source (one nvcc process each, in parallel) and link
    them, unless this tree's library already exists; returns its path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libdpt_kernels.so"
    if lib.is_file():
        build_info.update(seconds=0.0, cached=True, path=str(lib))
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    tmp = out_dir / f"libdpt_kernels.{tag}.so"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    t0 = time.perf_counter()
    compiled = _run(cmds, NVCC_TIMEOUT_S)
    log = "".join(" ".join(c) + "\n" + text for c, (_, text, _) in
                  zip(cmds, compiled))
    failed = [(s, rc) for s, (rc, _, _) in zip(SOURCES, compiled) if rc]
    linked = None
    if not failed:
        linked = _run([link], NVCC_TIMEOUT_S)[0]
        log += " ".join(link) + "\n" + linked[1]
        if linked[0]:
            failed = [("link", linked[0])]
    seconds = time.perf_counter() - t0
    (out_dir / "nvcc.log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed {failed}:\n{log[-6000:]}")
    os.replace(tmp, lib)
    build_info.update(
        seconds=seconds, cached=False, path=str(lib), log=log,
        compile_s={s: round(t, 2) for s, (_, _, t) in zip(SOURCES, compiled)},
        link_s=round(linked[2], 2))
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
