"""PyTorch/CUDA port of the carbon-aware approximate-computing system.

Laid out module for module beside the JAX package `repro`: the same names,
the same parameter layouts and the same numerics contracts, in PyTorch
idiom.  The four kernels of the approximate serving path (int8 row
quantization, the exact/trunc GEMM, the decode-shaped GEMM and flash
attention) are hand-written CUDA C++ for Hopper under `csrc/`, built with
nvcc at first use and bound with ctypes (`kernels/build.py`).

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; with no CUDA device and no explicit CPU request they raise.
"""
