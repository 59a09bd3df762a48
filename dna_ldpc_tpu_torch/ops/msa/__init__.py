"""Pair-HMM MSA for mixed-length clusters (MUSCLE replacement)."""
