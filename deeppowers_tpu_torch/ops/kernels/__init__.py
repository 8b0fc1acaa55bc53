"""Hand-written CUDA kernels for Hopper, one module per TPU kernel ported.

Each module holds the kernel's wrapper, its plain PyTorch version (taken
for CPU tensors only) and its launch count. The CUDA sources live in
`deeppowers_tpu_torch/csrc/` and are built by one nvcc call at first use
(`_build.library`)."""
