"""Decoders and sequence kernels on torch tensors."""
