"""The port's library entry points run on the card unless the caller names
another device: called without ``device`` on a machine without CUDA each
raises — nothing falls back to the CPU — and with ``device="cpu"`` each
runs."""

import functools

import numpy as np
import pytest
import torch

from dna_ldpc_tpu_torch.models import LdpcGraph, build_rs_ldpc
from dna_ldpc_tpu_torch.models.codebook import N_STRANDS, PAYLOAD_BITS
from dna_ldpc_tpu_torch.models.scldpc import couple
from dna_ldpc_tpu_torch.ops import bp, cluster, product, scldpc, simulation
from dna_ldpc_tpu_torch.ops.editdist import edit_distance_pairs_device
from dna_ldpc_tpu_torch.ops.msa import msa_aligner
from dna_ldpc_tpu_torch.ops.msa.align import align, align_clusters
from dna_ldpc_tpu_torch.ops.msa.ensemble import ensemble_align, perturb_params
from dna_ldpc_tpu_torch.ops.msa.pairhmm import batch_post_ea, batch_posteriors
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


def _per_cluster_llrs(**kw):
    _compute_trial_llrs(aligner=functools.partial(msa_aligner, **kw), batch_msa=False, **kw)


def _host_count_llrs(**kw):
    _compute_trial_llrs(use_native=False, **kw)  # every cluster through msa_aligner on the device


def _align(**kw):
    assert [r.replace("-", "") for _, r in align(READS, refine_iters=2, **kw)] == READS


def _msa_aligner(**kw):
    assert [r.replace("-", "") for _, r in msa_aligner(READS, refine_iters=2, **kw)] == READS


def _batch_posteriors_k2(**kw):
    (post,) = batch_posteriors(READS[:1], READS[1:2], **kw)
    assert post.shape == (16, 15) and post.max() > 0.5


def _batch_posteriors_general(**kw):
    (post,) = batch_posteriors(READS[:1], READS[1:2], params=perturb_params(1), **kw)
    assert post.shape == (16, 15) and post.max() > 0.5


def _ensemble_align(**kw):
    ens = ensemble_align(READS, replicates=2, refine_iters=2, **kw)
    assert len(ens) == 2 and all(r.replace("-", "") == READS[o] for o, r in ens[1])


def _kmer_cluster(**kw):
    assert cluster.kmer_cluster(READS, k=3, **kw).n_clusters == 1


def _super_align(**kw):
    assert [r.replace("-", "") for _, r in cluster.super_align(READS, k=3, **kw)] == READS


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


@functools.cache
def _chain():
    return couple(build_rs_ldpc(3, 6, 3), L=8, w=1, seed=1)


def _sc_window(name, **args):
    """An SC-LDPC decoder on the all-zero word of the small chain: BP on
    clean LLRs, the BEC variants with one erasure."""
    def run(**kw):
        chain = _chain()
        n = chain.n_vars + (chain.n_checks if name == "sliding_window_bec_ra" else 0)
        if name in ("sliding_window_decode", "pipeline_decode"):
            values = np.full((2, n), 4.0, np.float32)
        else:
            values = np.zeros((2, n), np.int8)
            values[:, 50] = 2
        out = getattr(scldpc, name)(chain, values, W=3, **args, **kw)
        out = out[0] if isinstance(out, tuple) else out
        assert out.shape == (2, n) and not out.any()

    run.__name__ = "_" + name
    return run


def _bec_decode_save(**kw):
    chain = _chain()
    values = np.zeros((1, chain.n_vars), np.int8)
    values[0, 50] = 2
    out, trace, n = scldpc.bec_decode_save(LdpcGraph.from_sparse(chain.H), values, [chain.b_v] * chain.L, **kw)
    assert not out.any() and trace[0].sum() > 0 and trace[-1].sum() == 0


def _bec_decode_target(**kw):
    chain = _chain()
    values = np.zeros((1, chain.n_vars), np.int8)
    values[0, 50] = 2
    out, _, clean = scldpc.bec_decode_target(LdpcGraph.from_sparse(chain.H), values, (1, chain.n_vars), **kw)
    assert clean and not out.any()


SC_ENTRY_POINTS = [
    _sc_window(name, **args) for name, args in [
        ("sliding_window_decode", {}), ("pipeline_decode", {}), ("sliding_window_bec", {}),
        ("sliding_window_bec_save", {}), ("sliding_window_bec_two", {}), ("sliding_window_bec_two_cross", {}),
        ("sliding_window_bec_two_indi", {}), ("sliding_window_bec_target", {}), ("sliding_window_bec_step", {"eta": 2}),
        ("sliding_window_bec_ra", {}), ("sliding_window_bec_oc", {"eta": 2}),
    ]
] + [_bec_decode_save, _bec_decode_target]

ENTRY_POINTS = [
    _trial_config, _sim_config, _compute_trial_llrs, _process_mixed_clusters, _decode_llrs, _align_clusters,
    _batch_post_ea, _edit_distance, _product_decode, _per_cluster_llrs, _align, _msa_aligner, _batch_posteriors_k2,
    _batch_posteriors_general, _ensemble_align, _kmer_cluster, _super_align, _host_count_llrs,
] + SC_ENTRY_POINTS


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
