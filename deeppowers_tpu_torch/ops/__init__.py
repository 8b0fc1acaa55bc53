"""Compute ops: quantized matmul, attention, norms, rotary, sampling.

Plain PyTorch everywhere except the four hot paths, which launch the
hand-written CUDA kernels of ops/kernels/ on CUDA tensors."""
