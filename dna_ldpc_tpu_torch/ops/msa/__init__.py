"""Pair-HMM MSA for mixed-length clusters (MUSCLE replacement)."""

from ...utils.device import DEFAULT_DEVICE
from .align import align, align_clusters, mea_align, mea_score, upgma_join_order  # noqa: F401
from .pairhmm import pair_fwd_bwd, pair_posteriors  # noqa: F401


def msa_aligner(seqs, refine_iters: int = 100, seed: int = 0, device=DEFAULT_DEVICE, timings=None):
    """Aligner-interface adapter for pipeline.llr (list of seqs ->
    [(input ordinal, aligned row)]), the drop-in replacement for the
    reference's `MUSCLE -align` subprocess (decoder.py:39-41, 201-206);
    the cluster's pair-HMM runs on ``device``. ``timings``: ``align()``'s
    seconds per stage."""
    return align(list(seqs), refine_iters=refine_iters, seed=seed, device=device, timings=timings)
