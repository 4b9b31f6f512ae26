"""Decoding ops: φ, QC tables, the grouped passes and their CUDA kernels."""
