"""The outcome ``chip_smoke.py``'s phase 14 holds the card to at 65,480
reads of its smoke pool (``STRESS_REFERENCE``), made on the CPU.

Near this read count the pool's failures set in at a cliff that is not
monotone in the read count, so phase 14 does not only gate on a count
that recovers: at 65,480 reads the card's outcome must be the JAX
package's on the same reads. Here the JAX package computes the LLR table
through its per-cluster route (``aligner=msa_aligner``, one small cluster
at a time; its own tests hold that route equal to the batched one) and
decodes it with its own BP; then the port's ``anneal_decode`` decodes the
same table on the CPU. Codewords are decoded 32 at a time and the
annealing rounds run on the ones that failed: every codeword decodes on
its own, so the outcome is the whole batch's.

Slow (deselected from the tier-1 run): about an hour on a CPU, most of it
in the JAX package's pair-HMM over ~3,900 clusters.
"""

import os
import sys

import numpy as np
import pytest
import torch

from dna_ldpc_tpu.ops.msa import msa_aligner as j_msa_aligner
from dna_ldpc_tpu.pipeline import decode as j_decode
from dna_ldpc_tpu.pipeline import llr as j_llr
from dna_ldpc_tpu.pipeline.simulate import ChannelModel, simulate_reads
from dna_ldpc_tpu_torch.pipeline import decode as t_decode
from dna_ldpc_tpu_torch.pipeline.simulate import encode_oligos

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import STRESS_REFERENCE  # noqa: E402
from trace_trial import smoke_trial  # noqa: E402

torch.set_num_threads(1)
CHUNK = 32


def _outcome(decode, anneal, graph, soft, cws, config):
    """(fail_first, fail_final, n_anneal_iters) of ``anneal`` over the whole
    table: first decodes in chunks, then the annealing rounds on the
    codewords that failed."""
    fail_first = []
    for lo in range(0, len(soft), CHUNK):
        bits = decode(soft[lo : lo + CHUNK])
        fail_first += [lo + int(i) + 1 for i in np.nonzero((bits != cws[lo : lo + CHUNK]).any(axis=1))[0]]
    idx = np.array(fail_first, np.int64) - 1
    _, first, final, n_iters = anneal(graph, soft[idx], cws[idx], config)
    assert [fail_first[i - 1] for i in first] == fail_first
    return fail_first, [fail_first[i - 1] for i in final], n_iters


@pytest.mark.slow
def test_stress_point_outcome_is_the_jax_packages():
    n_reads, *want = STRESS_REFERENCE
    cws, _, _ = smoke_trial()
    reads, quals = simulate_reads(encode_oligos(cws), n_reads, ChannelModel(), seed=123)
    filtered = j_llr.rs_filter_reads(reads, quals)
    table = j_llr.compute_trial_llrs(filtered, 0.02, aligner=j_msa_aligner, batch_msa=False)
    soft = table.T.copy()

    j_graph, j_config = j_decode.deployed_graph(), j_decode.TrialConfig()
    j_mode = j_decode._auto_bp_mode(j_graph)
    got_jax = _outcome(lambda s: j_decode._decode_batch(j_graph, s, j_config.max_iter, j_mode),
                       j_decode.anneal_decode, j_graph, soft, cws, j_config)
    assert list(got_jax) == want

    t_graph, t_config = t_decode.deployed_graph(), t_decode.TrialConfig(device="cpu")
    got_port = _outcome(lambda s: t_decode._decode_batch(t_graph, s, t_config.max_iter, "cpu"),
                        t_decode.anneal_decode, t_graph, soft, cws, t_config)
    assert list(got_port) == want
