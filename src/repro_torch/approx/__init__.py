"""Approximate int8 compute: quantization, the approximate GEMM, layers."""
