"""The data recipe, the encoder and the plain reference, on the CPU: the
inputs are a function of the seed, the encoder's words satisfy H, the
reference agrees with itself and with the program's plain paths on small
inputs."""

import functools

import numpy as np
import pytest
import torch

from bench_helpers import BENCH_DIR  # noqa: F401  (puts the benchmark on the path)
from benchlib import code, common, recipe
from reference import bp as ref_bp, ingest, msa, pairhmm


@pytest.fixture(scope="module")
def encoder(tmp_path_factory):
    return code.load_encoder(cache_dir=str(tmp_path_factory.mktemp("enc")))


def _reads(encoder, seed, n_reads, channel=recipe.ChannelModel()):
    cws = encoder.random_codewords(272, common.stream(seed, "codewords"))
    reads, quals = recipe.simulate_reads(recipe.encode_oligos(cws), n_reads, channel, common.stream(seed, "reads-0"))
    return cws, reads, quals


def test_h_is_the_programs(encoder):
    common.check_program_h(code.deployed_checks())


def test_encoder_words_satisfy_h_and_cache(encoder, tmp_path):
    words = encoder.random_codewords(16, np.random.default_rng(3))
    assert not code.syndrome_weight(code.deployed_checks(), words).any()
    assert 0.45 < words.mean() < 0.55 and encoder.k == 16572
    again = code.load_encoder(cache_dir=str(tmp_path))
    cached = code.load_encoder(cache_dir=str(tmp_path))
    assert cached.build_s == 0.0 and np.array_equal(again.A, cached.A)


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 2**40 + 5])
def test_inputs_are_a_function_of_the_seed(encoder, seed):
    a = _reads(encoder, seed, 3000)
    b = _reads(encoder, seed, 3000)
    c = _reads(encoder, seed + 1, 3000)
    assert np.array_equal(a[0], b[0]) and a[1] == b[1] and a[2] == b[2]
    assert not np.array_equal(a[0], c[0]) and a[1] != c[1]


def test_reference_ingest_matches_the_programs_plain_path(encoder):
    from dna_ldpc_tpu_torch.pipeline.llr import compute_trial_llrs, rs_filter_reads

    channel = recipe.ChannelModel(substitution=0.02, insertion=0.0, deletion=0.0)
    _, reads, quals = _reads(encoder, 7, 20000, channel)
    table = compute_trial_llrs(rs_filter_reads(reads, quals), 0.02, device="cpu")
    strands = ingest.filter_reads(reads, quals)
    assert sum(len(v) for v in strands.values()) > 19000
    for s in range(recipe.N_STRANDS):
        assert np.array_equal(ingest.counted_row(strands.get(s, []), 0.02), table[s]), s


def test_reference_agrees_with_itself_on_a_tiny_trial(encoder):
    """A strand whose reads all have 136 nt gives the same row through
    the alignment route as through counting, and the route is repeatable."""
    channel = recipe.ChannelModel(insertion=0.0, deletion=0.0)
    _, reads, quals = _reads(encoder, 11, 8000, channel)
    strands = ingest.filter_reads(reads, quals)
    multi = [s for s, r in strands.items() if len(r) >= 3][:4]
    assert multi
    rows = msa.aligned_rows([strands[s] for s in multi], 0.02, "cpu", "bfloat16")
    again = msa.aligned_rows([strands[s] for s in multi], 0.02, "cpu", "bfloat16")
    for s, row, row2 in zip(multi, rows, again):
        assert np.array_equal(row, ingest.counted_row(strands[s], 0.02))
        assert np.array_equal(row, row2)


def test_reference_msa_matches_the_programs_per_cluster_route(encoder):
    from dna_ldpc_tpu_torch.ops.msa.align import align
    from dna_ldpc_tpu_torch.pipeline.llr import cluster_llr

    _, reads, quals = _reads(encoder, 13, 72000)
    strands = ingest.filter_reads(reads, quals)
    aligned = [s for s in sorted(strands) if ingest.needs_alignment(strands[s])][:6]
    aligner = functools.partial(align, device="cpu", use_native=False)
    rows = msa.aligned_rows([strands[s] for s in aligned], 0.02, "cpu", "bfloat16")
    for s, row in zip(aligned, rows):
        prog = cluster_llr([p for p, _ in strands[s]], [q for _, q in strands[s]], 0.02, aligner)
        prog = np.zeros(recipe.PAYLOAD_BITS) if prog is None else prog
        assert np.array_equal(row, prog), s


def test_reference_pair_hmm_equals_the_programs_plain_twin():
    from dna_ldpc_tpu_torch.ops.msa import pairhmm_cuda
    from dna_ldpc_tpu_torch.ops.msa.pairhmm import encode_pairs

    rng = np.random.default_rng(0)
    xs, ys = [], []
    for k in range(8):
        s = recipe.BASES[rng.integers(0, 4, 136)]
        t = s.copy()
        flip = rng.random(136) < 0.02
        t[flip] = recipe.BASES[rng.integers(0, 4, flip.sum())]
        if k % 2:
            t = np.delete(t, rng.integers(0, 136))
        xs.append(s.tobytes().decode())
        ys.append(t.tobytes().decode())
    mine = pairhmm.posteriors(xs, ys, "cpu", at_rest=None)
    X, Y, lx, ly = encode_pairs(xs, ys, 160)
    post, _ = pairhmm_cuda.post_ea_ref(*(torch.as_tensor(a) for a in (X, Y, lx, ly)), 160)
    for p in range(8):
        np.testing.assert_array_equal(post[p, : lx[p], : ly[p]].numpy(), mine[p])


def test_reference_bp_decodes_as_the_programs_plain_twin(encoder):
    from dna_ldpc_tpu_torch.ops.bp import bp_decode
    from dna_ldpc_tpu_torch.pipeline.decode import deployed_graph

    cws = torch.as_tensor(encoder.random_codewords(16, np.random.default_rng(1)))
    sigma = (1.0 / (2.0 * (16572 / 18432) * 10 ** (4.0 / 10))) ** 0.5
    gen = torch.Generator().manual_seed(4)
    llr = 2.0 * (1.0 - 2.0 * cws.float() + sigma * torch.randn(cws.shape, generator=gen)) / sigma**2
    mine = ref_bp.decode(torch.as_tensor(code.deployed_checks()), llr, 50)
    prog = bp_decode(deployed_graph(), llr, max_iter=50)
    both = mine.success & prog.success
    assert int((mine.success != prog.success).sum()) <= 1 and bool(both.any())
    assert torch.equal(mine.bits[both], prog.bits[both])
    assert torch.equal(mine.bits[both], cws[both].to(torch.uint8))


@pytest.mark.parametrize("precision", ["tfloat32", "bfloat16", "float8_e4m3fn"])
def test_reference_rounding_is_torchs(precision):
    """The MSA workers round in numpy (they load no torch); each precision
    rounds as torch's conversion does, on posteriors' range [0, 2]."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.random(100000) * 2, rng.random(50000) * 2.0 ** -6, rng.random(5000) * 2.0 ** -12,
                        [0.0, 2.0 ** -7, 2.0 ** -6, 1.0, 0.01]]).astype(np.float32)
    if precision == "tfloat32":   # torch has no tf32 tensors: 10 bits of mantissa, to nearest, ties to even
        i = x.view(np.uint32).astype(np.uint64)
        want = (((i + 0xFFF + ((i >> 13) & 1)) >> 13) << 13).astype(np.uint32).view(np.float32)
    else:
        want = torch.as_tensor(x).to(getattr(torch, precision)).float().numpy()
    assert np.array_equal(msa.rounded(x, precision), want)
