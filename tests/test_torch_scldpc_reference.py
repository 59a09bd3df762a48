"""The port's windowed SC-LDPC decoders against the benchmark's plain
windowed reference (``benchmarks/reference/scldpc.py``), on a small chain
of the cell's kind: ``couple(build_rs_ldpc(4, 6, 3), L=16, w=2)`` (a
48 x 96 base block), W = 4, 20 iterations, 8 AWGN frames a point.

Held here: the reference's coupling recipe gives the port's chain; the
port's window graph is sliced from the chain's sparse rows as the dense
slice gives it; the
reference's window schedule (its decode at the first, an interior and the
last anchor) equals ``reference/bp.py`` run directly on that window's rows
of the dense H, the decided blocks at +/-BIG; and the port's decisions
equal the reference's. At 4.5 and 5 dB every frame decodes, to the
same decisions on both sides, each window after the same number of
iterations (the results ``on_window`` hands out). At 2.5 and 3 dB, where some frames fail,
the same frames decode on both sides, and those do to the same bits;
the bits of a failing frame differ (the two clip the tanh-domain product at
1 - 2^-23 and 1 - 1e-5, and form it from logarithms and from running
products: saturated messages, which a window's +/-BIG blocks give from
the first iteration, carry the difference into the wrong bits).
"""

import os
import sys

import numpy as np
import pytest
import torch

from dna_ldpc_tpu_torch.models import build_rs_ldpc
from dna_ldpc_tpu_torch.models.scldpc import couple
from dna_ldpc_tpu_torch.ops import scldpc as t_sc

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks"))
from reference import bp as ref_bp  # noqa: E402
from reference import scldpc as ref_sc  # noqa: E402

torch.set_num_threads(1)

L, w, W, ITERS, B = 16, 2, 4, 20, 8


@pytest.fixture(scope="module")
def chains():
    H0 = build_rs_ldpc(4, 6, 3)
    port = couple(H0, L=L, w=w, seed=0)
    ref = ref_sc.couple(H0.indices.reshape(H0.n_rows, -1), H0.n_cols, L, w, 0)
    return port, ref


def _llrs(n, ebno, seed):
    rate = 1 - (L + w) / (2 * L)
    sigma = (1 / (2 * rate * 10 ** (ebno / 10))) ** 0.5
    gen = torch.Generator().manual_seed(seed)
    return 2 * (1 + sigma * torch.randn(B, n, generator=gen)) / sigma**2


def test_reference_chain_is_the_ports(chains):
    port, ref = chains
    assert np.array_equal(port.H.indptr, ref.indptr) and np.array_equal(port.H.indices, ref.indices)
    assert (ref.n_checks, ref.n_vars) == (port.H.n_rows, port.H.n_cols) == ((L + w) * 48, L * 96)


@pytest.mark.parametrize("t", [0, w, L - 1])
def test_reference_window_is_plain_bp_on_its_rows_of_h(chains, t):
    """The reference's window at anchor t: reference/bp.py on the dense H's
    check row blocks t..t+W-1 (clipped at the chain's end), over the
    variables they touch, the blocks before t at +/-BIG from the
    committed decisions and one extra +BIG variable padding the short
    rows of the termination."""
    port, ref = chains
    llr = _llrs(port.n_vars, 3.0, 11)
    decided, windows = ref_sc.sliding_window_decode(ref, llr, W, ITERS)
    dense = port.H.to_dense()
    b_v, b_c = port.b_v, port.b_c
    rows = dense[t * b_c : min(t + W, L + w) * b_c]
    c0, c1 = max(0, t - w) * b_v, min(t + W, L) * b_v
    assert not rows[:, :c0].any() and not rows[:, c1:].any()
    per_row = [np.nonzero(r[c0:c1])[0] for r in rows]
    dc = max(len(r) for r in per_row)
    checks = torch.tensor([list(r) + [c1 - c0] * (dc - len(r)) for r in per_row])
    frozen = torch.where(decided[:, c0 : t * b_v] == 0, ref_sc.BIG, -ref_sc.BIG)
    lw = torch.cat([frozen, llr[:, t * b_v : c1], torch.full((B, 1), ref_sc.BIG)], 1)
    plain = ref_bp.decode(checks, lw, ITERS, torch.float32)
    got = windows[t]
    assert torch.equal(plain.bits, got.bits) and torch.equal(plain.iterations, got.iterations)
    assert torch.equal(decided[:, t * b_v : (t + 1) * b_v], plain.bits[:, t * b_v - c0 : (t + 1) * b_v - c0])


@pytest.mark.parametrize("decoder", ["sliding_window_decode", "pipeline_decode"])
@pytest.mark.parametrize("ebno", [4.5, 5.0])
def test_port_decisions_equal_the_reference(chains, decoder, ebno):
    port, ref = chains
    llr = _llrs(port.n_vars, ebno, 7)
    got = getattr(t_sc, decoder)(port, llr.numpy(), W, ITERS, device="cpu")
    want, _ = ref_sc.sliding_window_decode(ref, llr, W, ITERS)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("ebno", [4.5, 5.0])
def test_on_window_hands_out_each_windows_result(chains, ebno):
    """``on_window`` receives every anchor's BpResult in order; where every
    frame decodes, its iteration counts are the reference's window by
    window, and the committed block is the result's."""
    port, ref = chains
    llr = _llrs(port.n_vars, ebno, 7)
    seen = []
    got = t_sc.sliding_window_decode(port, llr, W, ITERS, device="cpu", on_window=lambda t, r: seen.append((t, r)))
    _, windows = ref_sc.sliding_window_decode(ref, llr, W, ITERS)
    assert [t for t, _ in seen] == list(range(L))
    for (t, res), want in zip(seen, windows):
        assert torch.equal(res.iterations, want.iterations), t
        assert np.array_equal(res.bits[:, w * port.b_v : (w + 1) * port.b_v].numpy(),
                              got[:, t * port.b_v : (t + 1) * port.b_v])


@pytest.mark.parametrize("decoder", ["sliding_window_decode", "pipeline_decode"])
@pytest.mark.parametrize("ebno", [2.5, 3.0])
def test_port_outcomes_equal_the_reference_where_frames_fail(chains, decoder, ebno):
    port, ref = chains
    llr = _llrs(port.n_vars, ebno, 7)
    got = getattr(t_sc, decoder)(port, llr.numpy(), W, ITERS, device="cpu")
    want = ref_sc.sliding_window_decode(ref, llr, W, ITERS)[0].numpy()
    ok = ~got.any(1)
    assert np.array_equal(ok, ~want.any(1)) and 0 < ok.sum() < B
    assert np.array_equal(got[ok], want[ok])


def test_window_graph_is_sliced_from_the_sparse_chain(chains, monkeypatch):
    """The window graph is built from the chain's sparse rows, as the
    dense chain's slice gives it (the dense chain of the benchmark's cell
    is 50,688 x 98,304 bytes)."""
    from dna_ldpc_tpu_torch.models import LdpcGraph
    from dna_ldpc_tpu_torch.utils.io_formats import SparseBinaryMatrix

    port, _ = chains
    rows = port.H.to_dense()[w * port.b_c : (w + W) * port.b_c, : (W + w) * port.b_v]
    want = LdpcGraph.from_sparse(SparseBinaryMatrix.from_coo(rows.shape[0], rows.shape[1], *np.nonzero(rows)))

    def no_dense(self):
        raise AssertionError("the chain was made dense")

    monkeypatch.setattr(SparseBinaryMatrix, "to_dense", no_dense)
    t_sc._window_graph.cache_clear()
    got = t_sc._window_graph(port, W)
    for field in ("check_vars", "check_mask", "var_edge_ids", "var_mask", "edge_perm"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field
    assert (got.n_checks, got.n_vars, got.n_edges) == (want.n_checks, want.n_vars, want.n_edges)
