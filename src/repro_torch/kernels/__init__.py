"""Hand-written Hopper kernels (csrc/) with their plain PyTorch versions,
the ctypes loader that builds them, and the dispatch policy."""
