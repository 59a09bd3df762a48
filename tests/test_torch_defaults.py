"""The port's library entry points run on the card unless the caller names
another device: called without ``device`` on a machine without CUDA each
raises — nothing falls back to the CPU — and with ``device="cpu"`` each
runs."""

import numpy as np
import pytest
import torch

from dna_ldpc_tpu_torch.models import LdpcGraph, build_rs_ldpc
from dna_ldpc_tpu_torch.models.codebook import N_STRANDS, PAYLOAD_BITS
from dna_ldpc_tpu_torch.ops import bp, product, simulation
from dna_ldpc_tpu_torch.ops.editdist import edit_distance_pairs_device
from dna_ldpc_tpu_torch.ops.msa.align import align_clusters
from dna_ldpc_tpu_torch.ops.msa.pairhmm import batch_post_ea
from dna_ldpc_tpu_torch.pipeline import decode, llr
from dna_ldpc_tpu_torch.utils.dna import seqs_to_matrix

torch.set_num_threads(1)

READS = ["ACGTTGCAAGCTTAGC", "ACGTTGCAGCTTAGC", "ACGTTGCAAGCTTAGC"]


def _mixed_cluster():
    """One strand read three times, once with a deletion: the MSA path."""
    rng = np.random.default_rng(0)
    strand = "".join("ACGT"[k] for k in rng.integers(0, 4, 136))
    reads = [strand, strand[:40] + strand[41:], strand]
    return llr.FilteredReads(reads, np.full(3, 30, np.int64), np.full(3, 7, np.int32), 3, 3)


def _trial_config(**kw):
    return decode.TrialConfig(**kw).device


def _sim_config(**kw):
    return simulation.SimConfig(**kw).device


def _compute_trial_llrs(**kw):
    table = llr.compute_trial_llrs(_mixed_cluster(), 0.02, **kw)
    assert table.shape == (N_STRANDS, PAYLOAD_BITS) and table[7].any() and not table[8].any()


def _process_mixed_clusters(**kw):
    out = np.zeros((N_STRANDS, PAYLOAD_BITS))
    filtered = _mixed_cluster()
    llr._process_mixed_clusters_batched(
        filtered, np.array([0]), np.array([3]), filtered.strands, np.array([0]), 0.02, out, **kw
    )
    assert out[7].any()


def _decode_llrs(**kw):
    graph = LdpcGraph.from_sparse(build_rs_ldpc(4, 8, 4))
    assert bool(bp.decode_llrs(graph, np.full(graph.n_vars, 4.0, np.float32), max_iter=5, **kw).success.all())


def _align_clusters(**kw):
    rows = align_clusters([READS], refine_iters=2, **kw)[0]
    assert [r.replace("-", "") for _, r in rows] == READS


def _batch_post_ea(**kw):
    post, ea, lx, ly, Lmax = batch_post_ea(READS[:1], READS[1:2], **kw)
    assert post.shape == (1, Lmax, Lmax) and float(ea[0]) > 10


def _edit_distance(**kw):
    mat = seqs_to_matrix(READS, fill=b"\x00")
    lens = np.array([len(s) for s in READS], np.int64)
    got = edit_distance_pairs_device(mat, lens, np.array([0, 0]), np.array([1, 2]), **kw)
    assert got.tolist() == [1, 0]


def _product_decode(**kw):
    H = build_rs_ldpc(3, 4, 2)
    graph = LdpcGraph.from_sparse(H, detect_blocked=False)
    bits, ok = product.product_decode(graph, graph, np.full((1, H.n_cols, H.n_cols), 3.0, np.float32),
                                      outer_iters=1, inner_iters=2, **kw)
    assert not bits.any() and bool(ok.all())


ENTRY_POINTS = [
    _trial_config, _sim_config, _compute_trial_llrs, _process_mixed_clusters, _decode_llrs, _align_clusters,
    _batch_post_ea, _edit_distance, _product_decode,
]


@pytest.mark.parametrize("entry", ENTRY_POINTS, ids=lambda f: f.__name__.lstrip("_"))
def test_entry_point_defaults_to_the_card(entry):
    entry(device="cpu")
    if torch.cuda.is_available():
        entry()  # a card is there: the default runs on it
    else:
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            entry()


def test_error_case_records_its_device():
    """``ErrorCase.device`` is where a batch was drawn, not a choice: it
    has no default."""
    with pytest.raises(TypeError):
        simulation.ErrorCase(1.0, (0, 0), 0, 0)
    case = simulation.ErrorCase(1.0, (0, 0), 0, 0, "cpu")
    assert simulation.ErrorCase.from_record(case.to_record()) == case
