"""Numpy helpers carried from ``dna_ldpc_tpu/utils``."""

from . import dna, gf, io_formats  # noqa: F401
