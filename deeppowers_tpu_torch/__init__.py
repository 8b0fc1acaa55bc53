"""deeppowers_tpu_torch: the PyTorch/CUDA port of deeppowers_tpu for one
NVIDIA H100.

The JAX package (`deeppowers_tpu`) stays the reference; module paths here
mirror it (config, models, quant, ops, runtime, serving) so each module's
counterpart is easy to find. Every Pallas kernel on the ported path has a
hand-written CUDA kernel under `csrc/`, bound with ctypes in `ops/kernels/`.
Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
