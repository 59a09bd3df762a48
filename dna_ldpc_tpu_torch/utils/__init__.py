"""Numpy helpers carried from ``dna_ldpc_tpu/utils``."""
