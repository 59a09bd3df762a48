"""Seconds per trial in the MSA (``ops/msa/``: K2 over every pair, the
consistency transform, the progressive and refinement merges through
``merge_dp``, the column maps' download): the sum of
``phase_times["llr_pairhmm"]``, ``["llr_consistency"]``,
``["llr_msa_device"]`` and ``["llr_msa_collect"]`` (and the host-aligner
fallback's ``["llr_progressive_refine"]`` where it ran), mean over the
window's trials."""

from benchlib.readers import mean_phase


def read(rec):
    return mean_phase(rec, ("llr_pairhmm", "llr_consistency", "llr_msa_device", "llr_msa_collect",
                            "llr_progressive_refine"))
