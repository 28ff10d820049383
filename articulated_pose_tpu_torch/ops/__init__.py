"""Point-cloud ops: plain PyTorch (`core`) and the CUDA kernels (`kernels`)."""
