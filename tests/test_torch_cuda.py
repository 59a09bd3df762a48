"""The port's CUDA kernels against their plain torch twins, on the card.

This file imports neither ``jax`` nor the JAX package, so it runs on the
GPU machine (which has no ``jax``). The repository's conftest imports
``jax``, so run it there without conftest files:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device every test skips. Tolerances: K1 is bit-equal to
its twin (same rounding points, same summation order, the same libdevice
tanh/log); K2's posteriors agree within atol = rtol = 1e-4 and its EA
score equals the native ``mea_score`` of its own bf16-rounded posterior;
the merge kernel's codes and positions are bit-equal to its twin's (the
same f32 sums in the same order, exact compares); the consistency kernel
is within atol 1e-5 of its plain version on the float32 iterate and one
bf16 step on the assembled pairs, but where round two's mask meets an
iterate within 1e-6 of the threshold (another summation order), and
bit-equal to itself; edit distances are integers
(bit-equal); the device MSA, ``align()`` and the k-mer clusterer give the
CPU's rows and assignments; the general-table pair-HMM (plain torch)
agrees with the CPU within atol = rtol = 1e-4, and ``batch_posteriors``
within one bf16 step; the decoder zoo's
integer-valued decoders (quantized min-sum levels, Gallager, FAID, BEC
peeling) give the CPU's results exactly, float min-sum the CPU's outcomes
on converging words; the SC-LDPC window kernel gives its plain version's
(the eager ``bp_decode_generic`` on the card) bits, iterations, unsat and
posteriors bit for bit, at every Eb/No: the same float32 operations on the
same libdevice routines, with its sums taken in torch's order."""

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
from dna_ldpc_tpu_torch.ops.msa.consistency import consistency_clusters, consistency_core
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


# the chains of chip_smoke.py's phase 15 (lifting 64) and of the benchmark's sc-awgn-w6 (lifting 256), W = 6
SC_LIFTINGS = {64: (6, 6, 3), 256: (8, 6, 3)}


def _sc_window(lifting):
    from dna_ldpc_tpu_torch.models.scldpc import couple
    from dna_ldpc_tpu_torch.ops import scldpc

    chain = couple(build_rs_ldpc(*SC_LIFTINGS[lifting]), L=64, w=2, seed=0)
    return chain, scldpc._window_graph(chain, 6)


def _awgn(dev, F, n, ebno, seed, rate=31 / 64):
    """LLRs of the all-zero word under BPSK at ``ebno`` (dB)."""
    sigma = (1 / (2 * rate * 10 ** (ebno / 10))) ** 0.5
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (2 / sigma**2) * (1 + sigma * torch.randn((F, n), generator=gen, device=dev))


def _same_window(got, want):
    for name in ("bits", "success", "iterations", "unsat"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("ebno", [4.75, 2.75])
@pytest.mark.parametrize("F", [1, 7, 1024])
@pytest.mark.parametrize("lifting", sorted(SC_LIFTINGS))
def test_window_kernel_matches_plain(dev, lifting, F, ebno):
    """The window kernel against the eager decoder on the card, frame for
    frame, at 4.75 dB (most frames decode) and at the cell's 2.75 dB (a
    window alone decodes few), 20 iterations. Bound on the frames whose
    outcome or iteration count differs: 0 at both. The one way the two
    could part is the order of float32 sums (the exclusive product's log
    sum and the posterior's), where an ulp on a saturated message tips a
    frame near failure; the kernel takes torch's order on the card."""
    from dna_ldpc_tpu_torch.ops import window_bp
    from dna_ldpc_tpu_torch.ops.bp import bp_decode_generic

    _, graph = _sc_window(lifting)
    llr = _awgn(dev, F, graph.n_vars, ebno, seed=lifting + F)
    before = window_bp.launches
    got = window_bp.decode(graph, llr, 20)
    want = bp_decode_generic(graph, llr, 20)
    torch.cuda.synchronize()
    assert window_bp.launches == before + 1
    _same_window(got, want)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("lifting", sorted(SC_LIFTINGS))
def test_window_kernel_posteriors_after_fixed_iterations(dev, lifting, k):
    """Posteriors after k fixed iterations (no early stop) at 2.75 dB,
    against ``bp_posteriors``: tolerance 0 (see above)."""
    from dna_ldpc_tpu_torch.ops import window_bp
    from dna_ldpc_tpu_torch.ops.bp import bp_decode_generic, bp_posteriors

    _, graph = _sc_window(lifting)
    llr = _awgn(dev, 256, graph.n_vars, 2.75, seed=k)
    post = torch.empty_like(llr)
    got = window_bp._kernel(graph, llr, k, False, post)
    assert torch.equal(post, bp_posteriors(graph, llr, k))
    _same_window(got, bp_decode_generic(graph, llr, k, early_stop=False))


@pytest.mark.parametrize("lifting", sorted(SC_LIFTINGS))
def test_window_kernel_edge_cases(dev, lifting):
    """A strided view of a wider work array; frames decoded at iteration 0;
    one iteration; every variable frozen at +/-BIG (a codeword: done at 0;
    random signs: saturated messages to the cap); frames of each kind in one
    batch, each as it decodes alone."""
    from dna_ldpc_tpu_torch.ops import window_bp
    from dna_ldpc_tpu_torch.ops.bp import bp_decode_generic
    from dna_ldpc_tpu_torch.ops.scldpc import BIG

    _, graph = _sc_window(lifting)
    n = graph.n_vars
    work = _awgn(dev, 64, 3 * n + 5, 3.0, seed=1)
    view = work[:, n + 5 : 2 * n + 5]
    assert view.stride() == (3 * n + 5, 1)
    _same_window(window_bp.decode(graph, view, 20), bp_decode_generic(graph, view.contiguous(), 20))
    gen = torch.Generator(device=dev).manual_seed(2)
    signs = torch.where(torch.rand((8, n), generator=gen, device=dev) < 0.5, -BIG, BIG)
    cases = {
        "decoded at 0": torch.full((8, n), 3.0, device=dev),
        "one iteration": _awgn(dev, 8, n, 2.75, seed=3),
        "frozen codeword": torch.full((8, n), BIG, device=dev),
        "frozen random": signs,
    }
    for name, llr in cases.items():
        iters = 1 if name == "one iteration" else 20
        got, want = window_bp.decode(graph, llr, iters), bp_decode_generic(graph, llr, iters)
        _same_window(got, want)
        if name in ("decoded at 0", "frozen codeword"):
            assert (got.iterations == 0).all() and got.success.all(), name
        if name == "frozen random":
            assert (got.iterations == 20).all() and not got.success.any()
    mixed = torch.cat(list(cases.values()))
    _same_window(window_bp.decode(graph, mixed, 20), bp_decode_generic(graph, mixed, 20))


def test_window_kernel_routing_on_the_card(dev):
    """On the card every window goes through the kernel: a graph whose
    state exceeds one block's shared memory, a check degree it is not
    built for, a float64 tensor or a shape off the graph raise, and nothing
    is decoded eagerly."""
    from dna_ldpc_tpu_torch.models import LdpcGraph
    from dna_ldpc_tpu_torch.ops import window_bp
    from dna_ldpc_tpu_torch.utils.io_formats import SparseBinaryMatrix

    rng = np.random.default_rng(1)
    M, N = 16384, 32768
    rows = np.concatenate([rng.choice(M, 3, replace=False) for _ in range(N)])
    big = LdpcGraph.from_sparse(SparseBinaryMatrix.from_coo(M, N, rows, np.repeat(np.arange(N), 3)))
    assert not window_bp.fits(big)
    _, graph = _sc_window(64)
    before = window_bp.launches
    with pytest.raises(ValueError, match="bytes of state"):
        window_bp.decode(big, _awgn(dev, 4, N, 3.0, seed=1), 3)
    small = LdpcGraph.from_sparse(SparseBinaryMatrix.from_coo(4, 8, np.arange(8) % 4, np.arange(8)))
    assert small.dc_max == 2 and not window_bp.fits(small)
    with pytest.raises(ValueError, match="check degree 2"):
        window_bp.decode(small, _awgn(dev, 4, 8, 3.0, seed=1), 3)
    with pytest.raises(ValueError, match="float32"):
        window_bp.decode(graph, _awgn(dev, 4, graph.n_vars, 3.0, seed=1).double(), 3)
    with pytest.raises(ValueError, match="float32"):
        window_bp.decode(graph, torch.zeros((2, graph.n_vars + 1), device=dev), 3)
    torch.cuda.synchronize()
    assert window_bp.launches == before


def test_windowed_decoders_go_through_the_kernel(dev):
    """``pipeline_decode`` equals ``sliding_window_decode`` bit for bit on
    the card, and both launch the window kernel once a window (a tick)."""
    from dna_ldpc_tpu_torch.ops import scldpc, window_bp

    chain, graph = _sc_window(64)
    F = 48
    llr = _awgn(dev, F, chain.n_vars, 2.5, seed=9, rate=1 - chain.n_checks / chain.n_vars)
    before = window_bp.launches
    sw = scldpc.sliding_window_decode(chain, llr, W=6, iters=20, device=dev)
    assert window_bp.launches == before + chain.L
    pl = scldpc.pipeline_decode(chain, llr, W=6, iters=20, device=dev)
    assert window_bp.launches == before + chain.L + (chain.L + F - 1)
    assert np.array_equal(pl, sw)


def test_window_spans_on_the_card(dev, monkeypatch):
    """Each ``scldpc.window`` span counts ``kernel`` 1, the frames' largest
    iteration count and their sum times the edges (read when the record
    closes: no wait of its own) and, while a profiler records, its device
    seconds (CUDA events); the root one wait, the decisions' download. The
    same counts without a profiler. The tracer is told that a profiler
    records (``profiling.profiling``): a real session here made the CUDA
    trace of ``test_consistency_kernel_launches_no_gemm``, later in this
    file, miss a kernel."""
    from dna_ldpc_tpu_torch.ops import scldpc
    from dna_ldpc_tpu_torch.utils import profiling

    chain, graph = _sc_window(256)
    llr = _awgn(dev, 64, chain.n_vars, 2.75, seed=4)
    for traced in (True, False):
        seen = []
        monkeypatch.setattr(profiling, "profiling", lambda: traced)
        scldpc.sliding_window_decode(chain, llr, W=6, iters=20, device=dev,
                                     on_window=lambda t, res: seen.append(res.iterations.cpu()))
        record = profiling.recent_records("scldpc.sliding_window")[-1]
        assert record[0]["counts"] == {"waits": 1}
        spans = record[1:]
        assert len(spans) == len(seen) == chain.L
        for s, its in zip(spans, seen):
            assert s["counts"] == {"windows": 1, "kernel": 1, "iterations": int(its.max()),
                                   "edge_iterations": int(its.sum()) * graph.n_edges}
            assert (s["device_s"] > 0) if traced else s["device_s"] is None


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


@pytest.mark.parametrize("min_device_clusters", [1, 4])
def test_consistency_clusters_on_device(dev, min_device_clusters):
    """``consistency_clusters`` on the card against ``device="cpu"``
    (atol 2e-5, rtol 1e-4): a cluster of 2 passes through, and with the
    default ``min_device_clusters`` the lone clusters of 3 and 5 take the
    host loop (then bit-equal) while the four clusters of 4 are batched."""
    rng = np.random.default_rng(17)
    cluster_posts = []
    for n in (2, 3, 5, 4, 4, 4, 4):
        seqs = _copies(rng, n, length=60)
        pairs = cluster_pairs(n)
        cluster_posts.append(pairhmm.batch_posteriors([seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs],
                                                      device="cpu"))
    got = consistency_clusters(cluster_posts, min_device_clusters=min_device_clusters, device=dev)
    want = consistency_clusters(cluster_posts, min_device_clusters=min_device_clusters, device="cpu")
    for c, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            assert a.shape == b.shape
            if c < 3 and min_device_clusters == 4:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4)


# (n true, bucket): the device MSA's buckets (device_msa.MSA_BUCKETS) from 3 to 32 reads
CONSISTENCY_SIZES = [(3, 4), (4, 4), (5, 8), (8, 8), (9, 12), (12, 12), (16, 16), (32, 32)]


def _consistency_batch(rng, n, nb, L=160, C=3):
    """C - 1 clusters of n reads in bucket nb and one pad cluster: ragged
    true lengths in 1..L (one cluster's reads all at L), bf16 pair
    posteriors scattered through a larger pair tensor (the pad slots point
    at pair 0), zero outside each true box, some values on either side of
    MIN_SPARSE_PROB and some at n/2 times it (an iterate near the threshold
    in round two). Returns (posts bf16 [P, L, L], ids int64, mask, inv_n,
    lengths [C, nb])."""
    from dna_ldpc_tpu_torch.ops.msa.pairhmm import MIN_SPARSE_PROB

    npair = nb * (nb - 1) // 2
    lens = np.zeros((C, nb), np.int32)
    lens[0, :n] = L
    for c in range(1, C - 1):
        lens[c, :n] = rng.integers(1, L + 1, n)
    pos = np.arange(L)
    slots = list(zip(*np.triu_indices(nb, 1)))
    P = C * npair + 7
    posts = np.zeros((P, L, L), np.float32)
    ids = np.zeros(C * npair, np.int64)
    mask = np.zeros(C * npair, bool)
    where = iter(rng.permutation(np.arange(1, P)))
    for c in range(C):
        for s, (i, j) in enumerate(slots):
            if not (lens[c, i] and lens[c, j]):
                continue
            q = next(where)
            x = rng.random((L, L)) * (rng.random((L, L)) < 0.08)
            near = rng.random((L, L)) < 0.03  # round one's mask, on the input
            x = np.where(near, MIN_SPARSE_PROB * rng.choice([0.99, 0.999, 1.0, 1.001, 1.01], (L, L)), x)
            # round two's: where the product adds little, the iterate 2 x / n lands near the threshold
            near = rng.random((L, L)) < 0.03
            x = np.where(near, MIN_SPARSE_PROB * n / 2 * rng.choice([0.99, 0.999, 1.0, 1.001], (L, L)), x)
            box = (pos[:, None] < lens[c, i]) & (pos[None, :] < lens[c, j])
            posts[q] = np.where(box, x, 0.0)
            ids[c * npair + s], mask[c * npair + s] = q, True
    inv = np.array([1.0 / max(n, 1)] * (C - 1) + [1.0], np.float32)
    bf = torch.from_numpy(posts).to(torch.bfloat16)
    return bf, ids, mask, inv, lens


def _flips_explained(got, want, iterate, atol):
    """Entries of ``got`` and ``want`` apart by more than ``atol``, each of
    which must sit where the float32 iterate of round one lies within 1e-6
    of MIN_SPARSE_PROB (round two masks on it; the kernel and the plain
    version sum in other orders, so such an entry may fall on either side).
    Returns their count."""
    from dna_ldpc_tpu_torch.ops.msa.pairhmm import MIN_SPARSE_PROB

    off = np.abs(got - want) > atol
    near = np.abs(iterate - MIN_SPARSE_PROB) <= 1e-6
    assert not (off & ~near).any(), np.abs(got - want)[off & ~near].max()
    return int(off.sum())


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("n,nb", CONSISTENCY_SIZES)
def test_consistency_kernel_matches_plain(dev, n, nb, iters):
    """The consistency kernel against the plain version on the card, through
    both entries: ``consistency_core`` on the float32 slots within atol 1e-5
    and ``assemble_transform`` (bf16 posteriors gathered by the kernel
    through the pair ids) within one bf16 step of the plain gather + block
    product. Round two masks on the float32 iterate, where the two summation
    orders can put an entry within 1e-6 of the threshold on either side:
    those entries alone may differ, and they are counted. Two runs are
    bit-equal; the launch counter reads ``iters`` per call; the pad slots,
    the pad cluster and everything outside the true boxes stay zero."""
    from dna_ldpc_tpu_torch.ops.msa import consistency

    rng = np.random.default_rng(100 * n + iters)
    L = 160
    posts, ids, mask, inv, lens = _consistency_batch(rng, n, nb, L)
    C, npair = lens.shape[0], nb * (nb - 1) // 2
    slots = torch.from_numpy(ids)
    pm = posts.float()[slots].view(C, npair, L, L) * torch.from_numpy(mask)[:, None, None].view(C, npair, 1, 1)
    pm_d, inv_d = pm.to(dev), torch.from_numpy(inv).to(dev)

    before = consistency.launches
    got = consistency.consistency_core(pm_d, inv_d, nb, iters, lens)
    again = consistency.consistency_core(pm_d, inv_d, nb, iters, lens)
    assert consistency.launches == before + 2 * iters
    assert torch.equal(got, again)
    want = consistency.consistency_core_ref(pm_d, inv_d, nb, iters, lens)
    iterate = consistency.consistency_core_ref(pm_d, inv_d, nb, 1, lens).cpu().numpy()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    flips = _flips_explained(got, want, iterate, 1e-5)
    box = consistency._box_mask(lens, nb, L).numpy()
    assert not got[~box].any() and not got[-1].any()

    before = consistency.launches
    args = (posts.to(dev), torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev), inv_d, nb, iters, C, L)
    P = device_msa.assemble_transform(*args, lengths=lens)
    assert consistency.launches == before + iters
    assert torch.equal(P, device_msa.assemble_transform(*args, lengths=lens))
    # the plain flow: the gathered, masked bf16 pairs through the block product, rounded to bf16
    plain = torch.from_numpy(want).to(torch.bfloat16)
    bits = lambda t: t.view(torch.int16).cpu().numpy().astype(np.int32)  # noqa: E731 (non-negative values)
    ulps = np.abs(bits(P[:, :, :L, :L].contiguous()) - bits(plain))
    off = ulps > 1
    assert not (off & ~(np.abs(iterate - 0.01) <= 1e-6)).any(), ulps.max()
    assert not P[:, :, L].any() and not P[:, :, :, L].any()  # the gap row and column
    assert (P.float().cpu().numpy()[:, :, :L, :L] > 0).sum() > 0
    print(f"n={n} bucket {nb} iters {iters}: mask flips at the threshold {flips} (f32), {int(off.sum())} (bf16)")


def test_consistency_kernel_launches_no_gemm(dev):
    """Under the profiler, ``assemble_transform`` at the trial's shape
    launches the consistency kernel ``iters`` times and no library GEMM."""
    rng = np.random.default_rng(4)
    posts, ids, mask, inv, lens = _consistency_batch(rng, 5, 8, 160, C=8)
    C = lens.shape[0]
    args = (posts.to(dev), torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(inv).to(dev), 8, 2, C, 160)
    device_msa.assemble_transform(*args, lengths=lens)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        device_msa.assemble_transform(*args, lengths=lens)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    counts = {e.key: e.count for e in prof.key_averages()}
    assert sum(c for k, c in counts.items() if "consistency_kernel" in k) == 2, counts
    assert not [k for k in names if "gemm" in k.lower()], names


def test_consistency_clusters_long_reads_on_device(dev):
    """``consistency_clusters`` at min_device_clusters=1 on clusters of 3,
    5 and 9 reads, one of them with reads of ~250 nt (L = 256: boxes cut
    into several of the kernel's tiles), against ``device="cpu"`` within
    atol 2e-5, rtol 1e-4."""
    rng = np.random.default_rng(23)
    cluster_posts = []
    for n, length in ((3, 250), (5, 140), (9, 150), (5, 60)):
        seqs = _copies(rng, n, length=length)
        pairs = cluster_pairs(n)
        cluster_posts.append(pairhmm.batch_posteriors([seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs],
                                                      device="cpu"))
    got = consistency_clusters(cluster_posts, min_device_clusters=1, device=dev)
    want = consistency_clusters(cluster_posts, min_device_clusters=1, device="cpu")
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4)


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
    before = mea_cuda.merge_launches
    codes, pos = mea_cuda.merge_walk(*args)
    codes_r, pos_r = mea_cuda.merge_walk_ref(*args)
    torch.cuda.synchronize()
    assert mea_cuda.merge_launches == before + 1
    assert torch.equal(codes, codes_r) and torch.equal(pos, pos_r)
    if Cmax >= 192:
        assert int((codes[0] != 0).sum()) > Cmax  # the overflowing cluster
    assert not codes[-1].any() and (codes[3] == 1).sum() > Cmax // 8


def test_merge_kernel_refuses_what_it_cannot_take(dev):
    args = list(_merge_case(dev, 2, 64))
    with pytest.raises(ValueError, match="several devices"):
        mea_cuda.merge_walk(args[0].cpu(), *args[1:])
    # Cmax = 300 needs ten columns a lane (L = 268: nb (L + 1) = 538 rows of Pblock)
    nb, L, Cmax = 2, 268, 300
    cpos = torch.zeros((1, nb, Cmax + 1), dtype=torch.int32, device=dev)
    mask = torch.ones((1, nb), dtype=torch.bool, device=dev)
    widths = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="Cmax=300"):
        mea_cuda.merge_walk(torch.zeros((1, nb * (L + 1), nb * (L + 1)), dtype=torch.bfloat16, device=dev),
                            cpos, cpos, mask, mask, widths, widths, Cmax, L)


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


def _innermost(ranges, t):
    """The name of the shortest range of ``ranges`` ({name: (starts, ends)},
    each sorted) that holds host time ``t``, or None."""
    import bisect

    best = (float("inf"), None)
    for name, (starts, ends) in ranges.items():
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= ends[k]:
            best = min(best, (ends[k] - starts[k], name))
    return best[1]


def test_trial_spans_on_the_card(dev, tmp_path, capsys):
    """One warm trial of 72,000 reads (``trace_trial.smoke_trial``) under
    the profiler: no kernel is launched inside a ``kind="host"`` span of
    its record; ``msa.k2``'s event-timed seconds lie within 10 % of the
    trace's summed K2 kernel time. The same trial again under
    ``torch.cuda.set_sync_debug_mode("warn")``: the synchronizing
    operations the runtime reports, with the explicit synchronizes it does
    not report, are the ``waits`` the record counts."""
    import json
    import os
    import sys
    import warnings

    from dna_ldpc_tpu_torch.pipeline.decode import TrialConfig, decode_trial
    from dna_ldpc_tpu_torch.utils import profiling

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from trace_trial import smoke_trial

    cws, reads, quals = smoke_trial()
    decode_trial(reads, quals, cws, TrialConfig())  # warm: kernel builds, tables, allocator
    with profiling.device_trace(str(tmp_path)):
        res = decode_trial(reads, quals, cws, TrialConfig())
    assert res.fail_final == []
    record = profiling.recent_trials()[-1]
    kinds = {s["name"]: s["kind"] for s in record}
    with open(os.path.join(tmp_path, profiling.TRACE_FILE)) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ranges: dict = {}
    for e in sorted((e for e in events if e.get("cat") == "user_annotation" and e["name"] in kinds),
                    key=lambda e: e["ts"]):
        starts, ends = ranges.setdefault(e["name"], ([], []))
        starts.append(e["ts"])
        ends.append(e["ts"] + e["dur"])
    assert sum(len(s) for s, _ in ranges.values()) == len(record)
    # the call that launched each kernel: the CUDA runtime's, or the CUDA driver API's for some kernels
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    in_host, unmatched = {}, 0
    for e in kernels:
        t = launched.get(e["args"].get("correlation"))
        if t is None:
            unmatched += 1
            continue
        name = _innermost(ranges, t)
        if name is not None and kinds[name] == profiling.HOST:
            in_host.setdefault(name, set()).add(e["name"][:60])
    assert not in_host, in_host
    assert unmatched <= len(kernels) // 100, (unmatched, len(kernels))

    k2_events = sum(s["device_s"] for s in record if s["name"] == "msa.k2")
    k2_trace = sum(e["dur"] for e in kernels if "pairhmm" in e["name"]) / 1e6
    cons_events = sum(s["device_s"] or 0.0 for s in record if s["name"] == "msa.consistency")
    with capsys.disabled():
        print(f"\n{len(kernels)} kernels ({unmatched} without a launch call in the trace), {len(record)} spans; msa.k2 events {k2_events:.6f} s, trace {k2_trace:.6f} s; "
              f"msa.consistency events {cons_events:.6f} s")
    assert abs(k2_events - k2_trace) <= 0.1 * k2_trace

    explicit = []
    sync = torch.cuda.synchronize

    def counted_sync(*args, **kwargs):
        explicit.append(1)
        return sync(*args, **kwargs)

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.synchronize = counted_sync
            try:
                decode_trial(reads, quals, cws, TrialConfig())
            finally:
                torch.cuda.synchronize = sync
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    waits = sum(s["counts"].get("waits", 0) for s in profiling.recent_trials()[-1])
    sites: dict = {}
    for w in syncs:
        key = f"{os.path.basename(w.filename)}:{w.lineno}"
        sites[key] = sites.get(key, 0) + 1
    with capsys.disabled():
        print(f"waits counted {waits}; the runtime reported {len(syncs)} synchronizing operations, plus {len(explicit)} "
              f"explicit synchronizes; by site: {sorted(sites.items(), key=lambda kv: -kv[1])}")
    assert waits == len(syncs) + len(explicit)
