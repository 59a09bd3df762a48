"""The port's CUDA kernels against their plain torch twins, on the card.

This file imports neither ``jax`` nor the JAX package, so it runs on the
GPU machine (which has no ``jax``). The repository's conftest imports
``jax``, so run it there without conftest files:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device every test skips. Tolerances: K1 is bit-equal to
its twin (same rounding points, same summation order, the same libdevice
tanh/log); K2's posteriors agree within atol = rtol = 1e-4 and its EA
score equals the native ``mea_score`` of its own bf16-rounded posterior;
the MEA-DP kernel's codes and positions are bit-equal to its twin's (one
f32 add per cell, exact compares); edit distances are integers
(bit-equal); the device MSA, ``align()`` and the k-mer clusterer give the
CPU's rows and assignments; the general-table pair-HMM (plain torch)
agrees with the CPU within atol = rtol = 1e-4, and ``batch_posteriors``
within one bf16 step; the decoder zoo's
integer-valued decoders (quantized min-sum levels, Gallager, FAID, BEC
peeling) give the CPU's results exactly, float min-sum the CPU's outcomes
on converging words."""

import numpy as np
import pytest
import torch

from dna_ldpc_tpu_torch import native_lib
from dna_ldpc_tpu_torch.models import BlockedCode, build_rs_ldpc, dna_storage_blocked
from dna_ldpc_tpu_torch.ops import bp_cuda, cluster, decoders, faid
from dna_ldpc_tpu_torch.ops.editdist import edit_distance_pairs_device
from dna_ldpc_tpu_torch.ops.msa import device_msa, mea_cuda, msa_aligner, pairhmm, pairhmm_cuda
from dna_ldpc_tpu_torch.ops.msa.align import (
    _ea_dists, align, align_clusters, cluster_pairs, mea_score, upgma_join_order,
)
from dna_ldpc_tpu_torch.ops.msa.ensemble import perturb_params
from dna_ldpc_tpu_torch.ops.msa.consistency import consistency_core
from dna_ldpc_tpu_torch.ops.msa.pairhmm import encode_pairs
from dna_ldpc_tpu_torch.pipeline.simulate import group_union_codewords
from dna_ldpc_tpu_torch.utils.dna import seqs_to_matrix

pytestmark = pytest.mark.cuda
MAG = float(np.log(0.98 / 0.02))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _coverage_llrs(code, n, cov_mean, eps, seed):
    rng = np.random.default_rng(seed)
    cw = group_union_codewords(code, n, rng)
    cov = rng.poisson(cov_mean, cw.shape)
    errs = rng.binomial(cov, eps)
    return cw, ((cov - 2 * errs) * MAG * np.where(cw == 0, 1.0, -1.0)).astype(np.float32)


def _copies(rng, n, length=136):
    """n noisy reads of one random strand: 1% substitutions, 0-3 deletions."""
    base = rng.integers(0, 4, length)
    out = []
    for _ in range(n):
        s = base.copy()
        sub = rng.random(length) < 0.01
        s[sub] = (s[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        s = np.delete(s, rng.choice(length, int(rng.integers(0, 4)), replace=False))
        out.append("".join("ACGT"[k] for k in s))
    return out


def _reads(rng, n):
    """n read pairs, each two copies of its own strand."""
    pairs = [_copies(rng, 2) for _ in range(n)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _same_bp(k, r):
    for name in ("bits", "success", "unsat", "iterations"):
        assert torch.equal(getattr(k, name).cpu(), getattr(r, name).cpu()), name


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("B", [1, 40, 133])  # 133: one block more than the card has SMs
@pytest.mark.parametrize("cov_mean,eps", [(5.0, 0.02), (1.5, 0.05)])
@pytest.mark.parametrize("code_args", [(4, 12, 4), (6, 32, 3)])
def test_bp_kernel_small_code(dev, code_args, cov_mean, eps, B, early_stop):
    """The generic kernel with staged tiles (J and q at run time, tiles in
    shared memory): q = 16 and q = 64, neither a multiple of a warp's 32
    checks on its own."""
    code = BlockedCode.detect(build_rs_ldpc(*code_args))
    lay = bp_cuda.kernel_layout(code.J, code.q)
    assert lay.staged and not lay.unrolled
    _, llr = _coverage_llrs(code, B, cov_mean, eps, seed=11)
    t = torch.from_numpy(llr).to(dev)
    before = bp_cuda.launches
    k = bp_cuda.bp_decode_blocked(code, t, 50, early_stop=early_stop)
    r = bp_cuda.bp_decode_blocked_ref(code, t, 50, early_stop=early_stop)
    torch.cuda.synchronize()
    assert bp_cuda.launches == before + 1
    _same_bp(k, r)


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("code_args,GJq", [((8, 70, 3), (3, 70, 256)), ((9, 20, 3), (3, 20, 512))])
def test_bp_kernel_unstaged_code(dev, code_args, GJq, early_stop):
    """Codes the kernel reads in place from the slab, with their own int32
    pi table: 3 x 70 x 256, whose tiles do not fit beside the posterior and
    the backward buffer, and 3 x 20 x 512, whose 16 warps hide the loads
    (and whose pi entries do not fit a byte)."""
    code = BlockedCode.detect(build_rs_ldpc(*code_args))
    lay = bp_cuda.kernel_layout(code.J, code.q)
    assert (code.G, code.J, code.q) == GJq and not lay.staged and not lay.unrolled
    _, easy = _coverage_llrs(code, 8, 6.0, 0.01, seed=13)
    _, hard = _coverage_llrs(code, 4, 2.5, 0.04, seed=14)
    llr = np.concatenate([easy, hard])
    t = torch.from_numpy(llr).to(dev)
    k = bp_cuda.bp_decode_blocked(code, t, 30, early_stop=early_stop)
    _same_bp(k, bp_cuda.bp_decode_blocked_ref(code, t, 30, early_stop=early_stop))
    assert 0 < int(k.success.sum()) and int(k.iterations.max()) > 1


@pytest.mark.parametrize("G", [1, 2, 3])
def test_bp_kernel_unrolled_few_cosets(dev, G):
    """The unrolled kernel on 72 x 256 codes with 1, 2 and 3 cosets: one half
    of the block idle, one coset per half (no tile to prefetch), and an odd
    count (the halves take 2 and 1)."""
    code = BlockedCode.detect(build_rs_ldpc(8, 72, G))
    assert (code.G, code.J, code.q) == (G, 72, 256) and bp_cuda.kernel_layout(code.J, code.q).unrolled
    _, easy = _coverage_llrs(code, 10, 6.0, 0.01, seed=3)
    _, hard = _coverage_llrs(code, 6, 2.0, 0.05, seed=4)
    t = torch.from_numpy(np.concatenate([easy, hard])).to(dev)
    for early_stop in (True, False):
        k = bp_cuda.bp_decode_blocked(code, t, 12, early_stop=early_stop)
        _same_bp(k, bp_cuda.bp_decode_blocked_ref(code, t, 12, early_stop=early_stop))


def test_bp_kernel_deployed_code_more_words_than_sms(dev):
    """133 words of the deployed code (the unrolled kernel), some of
    them at the iteration cap: the last block starts when another ends."""
    code = dna_storage_blocked()
    assert bp_cuda.kernel_layout(code.J, code.q).unrolled
    _, easy = _coverage_llrs(code, 100, 3.7, 0.02, seed=21)
    _, hard = _coverage_llrs(code, 33, 1.5, 0.05, seed=22)
    t = torch.from_numpy(np.concatenate([easy, hard])).to(dev)
    k = bp_cuda.bp_decode_blocked(code, t, 25)
    _same_bp(k, bp_cuda.bp_decode_blocked_ref(code, t, 25))
    assert int((k.iterations == 25).sum()) > 0 and int(k.success.sum()) >= 100


def test_bp_kernel_deployed_code_edge_cases(dev):
    """The deployed 8 x 72 x 256 code: trial-like words, zero LLRs
    (erasures; decided at iteration 0), NaN and infinite inputs."""
    code = dna_storage_blocked()
    cw, llr = _coverage_llrs(code, 16, 3.7, 0.02, seed=4)
    llr[0] = 0.0
    llr[1, ::37] = np.nan
    llr[2, ::41] = np.inf
    llr[3, ::43] = -np.inf
    t = torch.from_numpy(llr).to(dev)
    k, r = bp_cuda.bp_decode_blocked(code, t, 100), bp_cuda.bp_decode_blocked_ref(code, t, 100)
    _same_bp(k, r)
    assert k.iterations[0].item() == 0 and k.success[0].item()
    ok = k.success.cpu().numpy()
    assert ok[4:].all() and (k.bits.cpu().numpy()[4:] == cw[4:]).all()


@pytest.mark.parametrize("cov_mean,eps", [(3.7, 0.02), (1.5, 0.05)])
def test_bp_kernel_fixed_work_matches_twin(dev, cov_mean, eps):
    """early_stop=False on the deployed code: equal to the twin in the same
    mode, and word for word to the early-stopped kernel."""
    code = dna_storage_blocked()
    _, llr = _coverage_llrs(code, 24, cov_mean, eps, seed=6)
    t = torch.from_numpy(llr).to(dev)
    before = bp_cuda.launches
    fixed = bp_cuda.bp_decode_blocked(code, t, 40, early_stop=False)
    early = bp_cuda.bp_decode_blocked(code, t, 40)
    torch.cuda.synchronize()
    assert bp_cuda.launches == before + 2
    _same_bp(fixed, bp_cuda.bp_decode_blocked_ref(code, t, 40, early_stop=False))
    _same_bp(fixed, early)


def test_decoder_zoo_on_device_matches_cpu(dev):
    """One batch of each decoder on the card and on the CPU, on the
    (4, 12, 4) and (4, 8, 3) codes' gather tables."""
    from dna_ldpc_tpu_torch.models import LdpcGraph
    from dna_ldpc_tpu_torch.models.mod2 import random_codewords

    for params in ((4, 12, 4), (4, 8, 3)):
        H = build_rs_ldpc(*params)
        g = LdpcGraph.from_sparse(H, detect_blocked=False)
        rng = np.random.default_rng(params[2])
        cw = random_codewords(H.to_dense(), 48, rng)
        llr = torch.from_numpy((2.5 * np.where(cw == 0, 1.0, -1.0) + rng.normal(0, 1.5, cw.shape)).astype(np.float32))
        hard = torch.from_numpy((cw ^ (rng.random(cw.shape) < 0.03)).astype(np.uint8))
        vals = torch.from_numpy(np.where(rng.random(cw.shape) < 0.3, 2, cw).astype(np.int8))
        runs = [
            lambda x: decoders.quantized_min_sum_decode(g, x, max_iter=30, offset=1.0),
            lambda x: decoders.quantized_min_sum_decode(g, x, max_iter=30, quantizer="quasi-uniform"),
            lambda x: decoders.gallager_decode(g, (x < 0).to(torch.uint8), 30, 1),
            lambda x: faid.faid_decode(g, (x < 0).to(torch.uint8), 30),
        ]
        for run in runs:
            _same_bp(run(llr.to(dev)), run(llr))
        for variant in (0, 2):
            _same_bp(decoders.gallager_decode(g, hard.to(dev), 30, variant), decoders.gallager_decode(g, hard, 30, variant))
        _same_bp(decoders.bec_peel(g, vals.to(dev), 50), decoders.bec_peel(g, vals, 50))
        if params[2] == 3:
            _same_bp(faid.faid_decode(g, hard.to(dev), 30, faid.lut_rule()), faid.faid_decode(g, hard, 30, faid.lut_rule()))
        k, c = decoders.min_sum_decode(g, llr.to(dev), 30), decoders.min_sum_decode(g, llr, 30)
        ok = c.success & k.success.cpu()
        assert ok.sum() > len(cw) // 2 and torch.equal(k.bits.cpu()[ok], c.bits[ok])


def _check_pairhmm(dev, xs, ys, Lmax):
    X, Y, lx, ly = encode_pairs(xs, ys, Lmax)
    args = [torch.as_tensor(a, device=dev) for a in (X, Y, lx, ly)]
    before = pairhmm_cuda.launches
    pk, ek = pairhmm_cuda.post_ea(*args, Lmax)
    pr, er = pairhmm_cuda.post_ea_ref(*args, Lmax)
    torch.cuda.synchronize()
    assert pairhmm_cuda.launches == before + 1
    torch.testing.assert_close(pk, pr, atol=1e-4, rtol=1e-4)
    pb = pk.to(torch.bfloat16).float().cpu().numpy()
    ea = ek.cpu().numpy()
    for p in range(len(xs)):
        q = pb[p, : lx[p], : ly[p]]
        assert not pk[p, lx[p]:].any() and not pk[p, :, ly[p]:].any(), p  # zeros outside the box
        assert np.float32(mea_score(q) if q.size else 0.0) == ea[p], p
        assert np.float32(native_lib.mea_score_native(q) if q.size else 0.0) == ea[p], p


def test_pairhmm_kernel_matches_twin(dev):
    rng = np.random.default_rng(7)
    xs, ys = _reads(rng, 64)
    xs += ["", "A", "ACGTN" * 20]
    ys += ["ACG", "", "ACGTA" * 20]
    _check_pairhmm(dev, xs, ys, 160)


@pytest.mark.parametrize("Lmax,P", [(160, 1), (160, 6), (97, 1), (97, 7), (33, 5), (230, 3), (230, 6)])
def test_pairhmm_kernel_strips_and_bands(dev, Lmax, P):
    """Lengths that stress the wavefront's tiling: lx + 1 a multiple of 32
    and one off it, reads of Lmax itself, empty reads, lx != ly, wildcards,
    one pair, and pair counts that leave a block's last warps empty; at
    Lmax = 230 reads above 191 nt are swept in two bands of rows."""
    rng = np.random.default_rng(Lmax + P)
    rs = lambda n: "".join("ACGTN"[k] for k in rng.choice(5, n, p=[0.24, 0.24, 0.24, 0.24, 0.04]))
    lens = [(Lmax, Lmax - 7), (31, Lmax), (32, 5), (0, 9), (Lmax - 1, 0), (Lmax // 2, Lmax // 2 + 3), (1, 1)]
    xs, ys = [], []
    for lx, ly in lens[:P]:
        x = rs(lx)
        y = (x[: min(lx, ly)] + rs(max(0, ly - lx)))[:ly]  # a related read, so the posterior has mass
        xs.append(x)
        ys.append(y)
    _check_pairhmm(dev, xs, ys, Lmax)


def test_edit_distance_device_matches_native(dev):
    rng = np.random.default_rng(3)
    xs, ys = _reads(rng, 128)
    seqs = xs + ys
    a, b = np.triu_indices(len(seqs), k=1)
    buf, offs, lens = native_lib.pack_seqs(seqs)
    got = edit_distance_pairs_device(
        seqs_to_matrix(seqs, fill=b"\x00"), lens.astype(np.int64), a, b, dev
    )
    np.testing.assert_array_equal(got, native_lib.edit_distance_batch_native(buf, offs, lens, a, b))


def test_consistency_and_align_clusters_on_device(dev, monkeypatch):
    """The consistency transform in full f32 on the card matches the CPU
    within 1e-5; align_clusters on the card gives the CPU's rows, through
    the device MSA and through the host-aligner flow."""
    rng = np.random.default_rng(5)
    x = (rng.random((4, 10, 40, 40)) * (rng.random((4, 10, 40, 40)) < 0.1)).astype(np.float32)
    inv = torch.full((4,), 0.2)
    got = consistency_core(torch.from_numpy(x).to(dev), inv.to(dev), 5, 2).cpu()
    torch.testing.assert_close(got, consistency_core(torch.from_numpy(x), inv, 5, 2), atol=1e-5, rtol=0)

    clusters = [_copies(rng, n) for n in (2, 3, 5, 4, 1)]
    want = align_clusters(clusters, refine_iters=10, device="cpu")
    assert align_clusters(clusters, refine_iters=10, device=dev) == want
    monkeypatch.setenv("DNA_LDPC_DEVICE_MSA", "0")
    assert align_clusters(clusters, refine_iters=10, device=dev) == want


@pytest.mark.parametrize("Cmax,kind", [(24, "quantised"), (192, "random"), (192, "quantised"), (286, "random")])
def test_mea_kernel_matches_twin(dev, Cmax, kind):
    """Random and few-valued (exact-tie) planes, widths 0 and Cmax included;
    Cmax = 286 is the largest the device MSA makes (nine columns a lane)."""
    rng = np.random.default_rng(Cmax)
    C = 48
    post = rng.random((C, Cmax, Cmax)).astype(np.float32)
    if kind == "quantised":
        post = (rng.integers(0, 3, (C, Cmax, Cmax)) * 0.5).astype(np.float32)
    wA = rng.integers(0, Cmax + 1, C).astype(np.int32)
    wB = rng.integers(0, Cmax + 1, C).astype(np.int32)
    wA[:3], wB[:3] = (0, Cmax, Cmax), (Cmax, 0, Cmax)
    args = [torch.from_numpy(a).to(dev) for a in (post, wA, wB)]
    before = mea_cuda.launches
    codes, pos = mea_cuda.mea_walk(*args, Cmax)
    codes_r, pos_r = mea_cuda.mea_walk_ref(*args, Cmax)
    torch.cuda.synchronize()
    assert mea_cuda.launches == before + 1
    assert torch.equal(codes, codes_r) and torch.equal(pos, pos_r)


def _merge_case(dev, nb, Cmax, C=6, seed=0):
    """A batched merge on the card: random pair posteriors with most of
    their mass on the diagonal, and two gapped profiles a cluster, drawn
    directly as column maps. Cluster 0 matches the second half of every
    read to the first letter of every other (its path runs down A before
    it crosses B: more than Cmax columns at Cmax >= 192, an overflow),
    cluster 1 has an empty read as its A, cluster 2 an empty B, and the
    last cluster is a pad (all-false masks)."""
    L = Cmax - device_msa.COLUMN_SLACK
    rng = np.random.default_rng(seed + 100 * nb + Cmax)
    gen = torch.Generator(device=dev).manual_seed(seed + nb + Cmax)
    npair = nb * (nb - 1) // 2
    P = torch.zeros((C, npair, L + 1, L + 1), device=dev)
    P[:, :, :L, :L] = torch.rand((C, npair, L, L), generator=gen, device=dev) * (
        torch.rand((C, npair, L, L), generator=gen, device=dev) < 0.3)
    idx = torch.arange(L, device=dev)
    P[:, :, idx, idx] += 0.5
    Pblock = device_msa.build_pblock(P, nb)
    del P
    blocks = Pblock.view(C, nb, L + 1, nb, L + 1)
    blocks[0] = 0
    blocks[0, :, L // 2 : L, :, 0] = 0.9
    mA = np.zeros((C, nb), bool)
    mB = np.zeros((C, nb), bool)
    cpos = np.full((C, nb, Cmax + 1), L, np.int32)
    for c in range(C - 1):
        nA = int(rng.integers(1, nb)) if nb > 2 else 1
        order = rng.permutation(nb)
        mA[c, order[:nA]] = True
        mB[c, order[nA:]] = True
        if nb > 2 and c == 3:
            mB[c, order[-1]] = False  # a sequence in neither operand
        for side in (order[:nA], order[nA:]):
            width = int(rng.integers(max(1, L - 12), L + 1))
            for s in side:
                cols = np.sort(rng.choice(width, width - int(rng.integers(0, min(6, width))), replace=False))
                cpos[c, s, cols] = np.arange(len(cols))
    cpos[1, mA[1]] = L
    cpos[2, mB[2]] = L
    cpos_t = torch.from_numpy(cpos).to(dev)
    tA, tB = torch.from_numpy(mA).to(dev), torch.from_numpy(mB).to(dev)
    cposA, wA = device_msa._project(cpos_t, tA, Cmax, L)
    cposB, wB = device_msa._project(cpos_t, tB, Cmax, L)
    return Pblock, cposA, cposB, tA, tB, wA, wB, Cmax, L


@pytest.mark.parametrize("Cmax", [64, 192, 286])
@pytest.mark.parametrize("nb", [2, 8, 32])
def test_merge_kernel_matches_twin(dev, nb, Cmax):
    """``merge_dp`` (BuildPost + DP + walk in one kernel) against
    BuildPost into device memory followed by the full-plane twin: codes
    and positions equal exactly, zero widths, a pad cluster and an
    overflowing cluster included."""
    args = _merge_case(dev, nb, Cmax)
    wA, wB = args[5], args[6]
    assert int(wA[1]) == 0 and int(wB[2]) == 0 and int(wA[-1]) == int(wB[-1]) == 0
    before = mea_cuda.merge_launches, mea_cuda.launches
    codes, pos = mea_cuda.merge_walk(*args)
    codes_r, pos_r = mea_cuda.merge_walk_ref(*args)
    torch.cuda.synchronize()
    assert (mea_cuda.merge_launches, mea_cuda.launches) == (before[0] + 1, before[1])
    assert torch.equal(codes, codes_r) and torch.equal(pos, pos_r)
    if Cmax >= 192:
        assert int((codes[0] != 0).sum()) > Cmax  # the overflowing cluster
    assert not codes[-1].any() and (codes[3] == 1).sum() > Cmax // 8


def test_merge_kernel_refuses_what_it_cannot_take(dev):
    args = list(_merge_case(dev, 2, 64))
    with pytest.raises(ValueError, match="several devices"):
        mea_cuda.merge_walk(args[0].cpu(), *args[1:])
    wide = torch.zeros((1, 300, 300), device=dev)
    with pytest.raises(ValueError, match="Cmax=300"):
        mea_cuda.mea_walk(wide, torch.zeros(1, dtype=torch.int32, device=dev), torch.zeros(1, dtype=torch.int32, device=dev), 300)


def test_run_msa_batch_on_device(dev):
    """One bucket-8 batch of the device MSA on the card gives the CPU's rows
    and overflow flags, through the merge kernel."""
    rng = np.random.default_rng(9)
    nb, Lmax = 8, 160
    clusters = [_copies(rng, n) for n in (3, 5, 8, 4, 6, 7, 8, 5)]
    slot = {pair: k for k, pair in enumerate(cluster_pairs(nb))}
    xs, ys, ids, joins = [], [], [], []
    for c, seqs in enumerate(clusters):
        lo = len(xs)
        for i, j in cluster_pairs(len(seqs)):
            xs.append(seqs[i])
            ys.append(seqs[j])
        ids.append((c, lo, len(seqs)))
    posts, ea = pairhmm.k2_posteriors(xs, ys, Lmax, torch.device("cpu"))
    flat = np.zeros(len(clusters) * len(slot), np.int64)
    mask = np.zeros(len(flat), bool)
    inv_n = np.ones(len(clusters), np.float32)
    for c, lo, n in ids:
        inv_n[c] = 1.0 / n
        joins.append(upgma_join_order(_ea_dists(clusters[c], ea[lo : lo + n * (n - 1) // 2])))
        for p, pair in enumerate(cluster_pairs(n)):
            flat[c * len(slot) + slot[pair]] = lo + p
            mask[c * len(slot) + slot[pair]] = True
    P = device_msa.assemble_transform(
        posts, torch.from_numpy(flat), torch.from_numpy(mask), torch.from_numpy(inv_n), nb, 2, len(clusters), Lmax
    )
    before = mea_cuda.merge_launches
    got, ovf = device_msa.run_msa_batch(P.to(dev), clusters, joins, nb, Lmax, 100, 0)
    assert mea_cuda.merge_launches > before
    want, want_ovf = device_msa.run_msa_batch(P, clusters, joins, nb, Lmax, 100, 0)
    assert got == want and np.array_equal(ovf, want_ovf) and not ovf.any()


def test_batch_posteriors_one_pair_and_general_tables_on_device(dev):
    """One pair through K2's route at Lmax 32 and 160, and the general-table
    path with perturbed tables, against the CPU."""
    rng = np.random.default_rng(12)
    for length in (30, 150):
        x, y = _copies(rng, 2, length)
        before = pairhmm_cuda.launches
        (card,) = pairhmm.batch_posteriors([x], [y], device=dev)
        assert pairhmm_cuda.launches == before + 1
        (host,) = pairhmm.batch_posteriors([x], [y], device="cpu")
        np.testing.assert_allclose(card, host, atol=1e-2, rtol=1e-2)  # one bf16 step
    xs, ys = _reads(rng, 24)
    params = perturb_params(4)
    enc = pairhmm._encode_batch(xs, ys, None)
    got, tot = pairhmm._posteriors_device(*(torch.as_tensor(a, device=dev) for a in enc[:6]), enc[6], params)
    want, want_tot = pairhmm._posteriors_device(*(torch.as_tensor(a) for a in enc[:6]), enc[6], params)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(tot.cpu(), want_tot, atol=1e-4, rtol=1e-4)


def test_align_three_reads_on_device(dev):
    """A 3-read cluster through align() with its pair-HMM on the card gives
    the CPU's rows, on the native and the numpy paths, and as msa_aligner."""
    rng = np.random.default_rng(13)
    seqs = _copies(rng, 3)
    want = align(seqs, refine_iters=10, device="cpu")
    before = pairhmm_cuda.launches
    assert align(seqs, refine_iters=10, device=dev) == want
    assert pairhmm_cuda.launches == before + 1
    assert align(seqs, refine_iters=10, use_native=False, device=dev) == want
    assert msa_aligner(seqs, refine_iters=10, device=dev) == want


def test_kmer_cluster_on_device(dev):
    """2,048 reads of 400 strands: the similarity products above 2^18 run on
    the card and give the CPU's assignment."""
    rng = np.random.default_rng(14)
    centers = [rng.integers(0, 4, 80) for _ in range(400)]
    reads = []
    for k in rng.integers(0, 400, 2048):
        s = centers[k].copy()
        sub = rng.random(80) < 0.02
        s[sub] = (s[sub] + 1) % 4
        reads.append("".join("ACGT"[b] for b in s))
    got = cluster.kmer_cluster(reads, k=4, threshold=0.7, device=dev)
    want = cluster.kmer_cluster(reads, k=4, threshold=0.7, device="cpu")
    np.testing.assert_array_equal(got.assignment, want.assignment)
    np.testing.assert_array_equal(got.centroids, want.centroids)


def test_sharded_cuda_decoder_one_rank_nccl(dev, tmp_path):
    """Codeword-axis data parallelism on a one-rank NCCL group, mesh (1, 1):
    the rank's K1 decode, gathered over ``cw``, equals ``bp_decode_blocked``
    on the same LLRs bit for bit, with one launch."""
    import torch.distributed as dist

    from dna_ldpc_tpu_torch.parallel import distributed
    from dna_ldpc_tpu_torch.parallel.mesh import build_mesh
    from dna_ldpc_tpu_torch.parallel.sharded_bp import make_sharded_cuda_decoder

    code = dna_storage_blocked()
    _, llr = _coverage_llrs(code, 48, 3.7, 0.02, seed=23)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        mesh = build_mesh()
        assert tuple(mesh.shape) == (1, 1)
        local = distributed.process_local_batch(llr, mesh)
        before = bp_cuda.launches
        got = distributed.allgather_result(make_sharded_cuda_decoder(code, mesh, 200)(local), mesh)
        torch.cuda.synchronize()
        assert bp_cuda.launches == before + 1
    finally:
        dist.destroy_process_group()
    _same_bp(got, bp_cuda.bp_decode_blocked(code, torch.from_numpy(llr).to(dev), 200))
