"""PyTorch/CUDA port of the DNA data-storage decoder (``dna_ldpc_tpu``).

The JAX package stays the reference. This package runs the same trial
read-back — RS index filter, LLRs from clustered reads through the
pair-HMM MSA, batched BP with epsilon annealing — on an NVIDIA H100, with
the JAX package's two TPU kernels re-written by hand in CUDA
(``csrc/``). It imports ``torch`` and numpy, never ``jax``.
"""

__version__ = "0.1.0"
