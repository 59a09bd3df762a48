"""The SC-LDPC window kernel's host side, on the CPU (``ops/window_bp.py``).

The kernel (``csrc/window_bp.cu``) runs only on the card, where
tests/test_torch_cuda.py holds it to its plain version; here: which
graphs it takes (the shared-memory fit), the uint16 tables it reads, its
bound against the benchmark's count, the route of a CPU tensor (the plain
version, ``bp_decode_generic``, with the same results and counts), the
windowed decoders' one entry, and the tracer's ring that the benchmark's
readers need for a window of several hundred calls."""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

from dna_ldpc_tpu_torch.models import build_rs_ldpc
from dna_ldpc_tpu_torch.models.ldpc_graph import LdpcGraph
from dna_ldpc_tpu_torch.models.scldpc import couple
from dna_ldpc_tpu_torch.ops import scldpc, window_bp
from dna_ldpc_tpu_torch.ops.bp import bp_decode_generic
from dna_ldpc_tpu_torch.utils import profiling, roofline
from dna_ldpc_tpu_torch.utils.io_formats import SparseBinaryMatrix

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the chain of chip_smoke.py's phase 15 (lifting 64) and of the benchmark's sc-awgn-w6 (lifting 256), W = 6
WINDOWS = {64: ((6, 6, 3), (1152, 3072, 6912), 52_240), 256: ((8, 6, 3), (4608, 12288, 27648), 208_912)}


def _window(lifting):
    args, _, _ = WINDOWS[lifting]
    return scldpc._window_graph(couple(build_rs_ldpc(*args), L=64, w=2, seed=0), 6)


def _random_graph(M, N, dv, seed):
    """A random code of N variables of degree dv over M checks."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.choice(M, dv, replace=False) for _ in range(N)])
    return LdpcGraph.from_sparse(SparseBinaryMatrix.from_coo(M, N, rows, np.repeat(np.arange(N), dv)))


def _llrs(graph, B, seed, sigma=0.8):
    gen = torch.Generator().manual_seed(seed)
    return 2 * (1 + sigma * torch.randn(B, graph.n_vars, generator=gen)) / sigma**2


@pytest.mark.parametrize("lifting", sorted(WINDOWS))
def test_window_graphs_fit_one_block(lifting):
    graph = _window(lifting)
    _, shape, smem = WINDOWS[lifting]
    assert (graph.n_checks, graph.n_vars, graph.n_edges) == shape
    assert (graph.dc_max, graph.dv_max) == (6, 3)
    # float32 messages of 6 slots a check, posteriors and LLRs, the unsat counter
    assert window_bp.smem_bytes(graph) == 4 * (6 * shape[0] + 2 * shape[1]) + 16 == smem
    assert window_bp.fits(graph)


@pytest.mark.parametrize(
    "n_checks,dc,n_vars,dv,fits",
    [
        (4608, 6, 12288, 3, True),               # the cell's window
        (9684, 6, 2, 3, True),                   # 232,448 bytes: 227 KB exactly
        (9684, 6, 3, 3, False),                  # 8 bytes more
        (4608, 9, 12288, 3, False),              # a check degree the kernel is not built for
        (4608, 5, 12288, 3, False),
        (4608, 6, 12288, 4, False),              # a variable degree it is not built for
        (4608, 6, 12288, 5, False),
        (4608, 1, 12288, 3, False),
    ],
)
def test_fit_is_the_blocks_shared_memory_and_the_degrees(n_checks, dc, n_vars, dv, fits):
    graph = types.SimpleNamespace(n_checks=n_checks, dc_max=dc, n_vars=n_vars, dv_max=dv)
    assert window_bp.SMEM_LIMIT == 227 * 1024
    assert window_bp.fits(graph) == fits


def test_a_graph_over_the_limit_takes_the_eager_path():
    graph = _random_graph(16384, 32768, 3, seed=1)   # 6 x 16,384 slots + 2 x 32,768 variables: 655 KB
    assert window_bp.smem_bytes(graph) > window_bp.SMEM_LIMIT and not window_bp.fits(graph)
    llr = _llrs(graph, 2, seed=2)
    got, want = window_bp.decode(graph, llr, 3), bp_decode_generic(graph, llr, 3)
    for name in ("bits", "success", "iterations", "unsat"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    with pytest.raises(ValueError, match="does not take this graph"):
        window_bp._kernel(graph, llr, 3, True)


@pytest.mark.parametrize("graph_of", ["lifting64", "lifting256", "irregular"])
def test_kernel_tables_address_the_graph(graph_of):
    """check_vars [dc, M]: each check slot's variable; var_slots [dv, N]:
    each variable's message index k * M + c, in the graph's table order
    (ascending checks); PAD wherever the graph has a pad."""
    if graph_of == "irregular":   # checks of degree 1-5, variables of degree 0-4
        rng = np.random.default_rng(4)
        M, N = 40, 90
        dense = (rng.random((M, N)) < 0.03).astype(np.uint8)
        dense[:, :4] = 0
        graph = LdpcGraph.from_sparse(SparseBinaryMatrix.from_coo(M, N, *np.nonzero(dense)))
        assert not graph.check_mask.all() and not graph.var_mask.all()
    else:
        graph = _window(int(graph_of[7:]))
    check_vars, var_slots = window_bp.kernel_tables(graph)
    M, N, dc, dv = graph.n_checks, graph.n_vars, graph.dc_max, graph.dv_max
    assert check_vars.dtype == var_slots.dtype == np.uint16
    assert check_vars.shape == (dc, M) and var_slots.shape == (dv, N)
    assert np.array_equal(check_vars.T == window_bp.PAD, ~graph.check_mask)
    assert np.array_equal(check_vars.T[graph.check_mask], graph.check_vars[graph.check_mask])
    assert np.array_equal(var_slots.T == window_bp.PAD, ~graph.var_mask)
    valid = var_slots != window_bp.PAD
    slots = var_slots.astype(np.int64)
    k, c = slots // M, slots % M
    v = np.broadcast_to(np.arange(N), (dv, N))
    assert (check_vars[k[valid], c[valid]] == v[valid]).all()   # each slot is one of its variable's
    assert (np.diff(c, axis=0)[valid[1:]] > 0).all()           # in ascending checks, pads last
    degree = np.bincount(graph.check_vars[graph.check_mask], minlength=N)
    assert np.array_equal(valid.sum(0), degree)                 # and every edge of the variable has one


def test_window_bound_counts_what_wbp_roofline_counts():
    """``roofline.window_bp_bound_ms`` against the benchmark's own reader of
    ``wbp_roofline.sc``, at the same peaks (an H100 at 1,980 MHz)."""
    spec = importlib.util.spec_from_file_location(
        "wbp_roofline", os.path.join(ROOT, "benchmarks", "metrics", "wbp_roofline.sc.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    try:
        spec.loader.exec_module(mod)
        from benchlib import peaks
    finally:
        sys.path.remove(os.path.join(ROOT, "benchmarks"))
    p = peaks.peaks_of("NVIDIA H100 80GB HBM3")
    iterations = [20] * 1000 + [7] * 24
    ms, by = roofline.window_bp_bound_ms(27648, 12288, iterations)
    want = mod.bound_s(27648 * sum(iterations), len(iterations) * 12288, p)
    assert by == "operations" and ms == pytest.approx(1e3 * want, rel=1e-12)


def test_cpu_tensors_take_the_plain_version():
    chain = couple(build_rs_ldpc(4, 6, 3), L=16, w=2, seed=0)
    graph = scldpc._window_graph(chain, 4)
    assert window_bp.fits(graph)
    llr = _llrs(graph, 6, seed=5)
    launches = window_bp.launches
    with profiling.span("test.window_bp", root=True):
        got = window_bp.decode(graph, llr, 20)
    want = bp_decode_generic(graph, llr, 20)
    for name in ("bits", "success", "iterations", "unsat"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert window_bp.launches == launches
    (root,) = profiling.recent_records("test.window_bp")[-1]
    assert "kernel" not in root["counts"]
    assert root["counts"]["iterations"] == int(want.iterations.max())


@pytest.mark.parametrize("decoder,root", [("sliding_window_decode", "scldpc.sliding_window"),
                                          ("pipeline_decode", "scldpc.pipeline")])
def test_window_spans_count_the_results_iterations_on_the_cpu(monkeypatch, decoder, root):
    """Each ``scldpc.window`` span's ``iterations`` is the largest of its
    frames' iteration counts and its ``edge_iterations`` their sum times
    the window's edges: what the kernel's side counts on the card."""
    L, W, F = 16, 4, 5
    chain = couple(build_rs_ldpc(4, 6, 3), L=L, w=2, seed=0)
    graph = scldpc._window_graph(chain, W)
    seen = []
    decode = window_bp.decode

    def keep(g, llr, max_iter):
        res = decode(g, llr, max_iter)
        seen.append(res.iterations)
        return res

    monkeypatch.setattr(window_bp, "decode", keep)
    llr = 2 * (1 + 0.75 * torch.randn(F, chain.n_vars, generator=torch.Generator().manual_seed(8))) / 0.75**2
    getattr(scldpc, decoder)(chain, llr, W, 20, device="cpu")
    spans = profiling.recent_records(root)[-1][1:]
    assert len(spans) == len(seen) == (L if decoder == "sliding_window_decode" else L + F - 1)
    for s, its in zip(spans, seen):
        assert s["name"] == "scldpc.window" and "kernel" not in s["counts"]
        assert s["counts"]["iterations"] == int(its.max())
        assert s["counts"]["edge_iterations"] == int(its.sum()) * graph.n_edges
    assert any(int(its.max()) > 1 for its in seen)


def test_counts_at_close_join_their_span_when_the_root_closes():
    """``count_at_close`` adds what its function reads from a copy of the
    tensor to the span open at the call, once the root closes; the tensor
    may change after the call; outside a record it counts nothing."""
    its = torch.tensor([3, 20, 7], dtype=torch.int32)
    profiling.count_at_close(its, lambda x: {"never": 1})
    with profiling.span("test.later", root=True):
        with profiling.span("test.window"):
            profiling.count("windows")
            profiling.count_at_close(its, lambda x: {"iterations": int(x.max()), "edge_iterations": int(x.sum()) * 5})
            its[1] = 0
        with profiling.span("test.window"):
            profiling.count_at_close(its, lambda x: {"iterations": int(x.max())})
            profiling.count_at_close(its, lambda x: {"iterations": 1})
    root, first, second = profiling.recent_records("test.later")[-1]
    assert root["counts"] == {}
    assert first["counts"] == {"windows": 1, "iterations": 20, "edge_iterations": 150}
    assert second["counts"] == {"iterations": 8}


def test_ring_holds_more_than_256_records_of_one_root():
    n = 300
    for k in range(n):
        with profiling.span("test.ring", root=True):
            profiling.count("k", k)
    records = profiling.recent_records("test.ring")
    assert profiling.RING >= 4096 and len(records) == n
    assert [r[0]["counts"]["k"] for r in records] == list(range(n))
