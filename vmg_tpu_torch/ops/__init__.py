"""Hand-written CUDA kernels of the slice and their plain PyTorch versions,
plus the plain tensor ops around them."""
