"""The port's numpy carry-overs equal the JAX package's originals, and the
port imports without ``jax`` (the GPU machine has none)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dna_ldpc_tpu.models import blocked as j_blocked
from dna_ldpc_tpu.models import codebook as j_codebook
from dna_ldpc_tpu.models import rs_index as j_rs_index
from dna_ldpc_tpu.models import rs_ldpc as j_rs_ldpc
from dna_ldpc_tpu.models.ldpc_graph import LdpcGraph as JGraph
from dna_ldpc_tpu.pipeline import simulate as j_simulate
from dna_ldpc_tpu.utils import dna as j_dna
from dna_ldpc_tpu.utils import gf as j_gf
from dna_ldpc_tpu_torch.models import blocked as t_blocked
from dna_ldpc_tpu_torch.models import codebook as t_codebook
from dna_ldpc_tpu_torch.models import rs_index as t_rs_index
from dna_ldpc_tpu_torch.models import rs_ldpc as t_rs_ldpc
from dna_ldpc_tpu_torch.models.ldpc_graph import LdpcGraph as TGraph
from dna_ldpc_tpu_torch.models.ldpc_graph import graph_from_reference
from dna_ldpc_tpu_torch.pipeline import simulate as t_simulate
from dna_ldpc_tpu_torch.pipeline.checkpoint import TrialCheckpoint
from dna_ldpc_tpu_torch.utils import dna as t_dna
from dna_ldpc_tpu_torch.utils import gf as t_gf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH_FIELDS = ("check_vars", "check_mask", "var_edge_ids", "var_mask", "edge_perm", "edge_var")


def test_deployed_pchk_equal():
    a, b = j_rs_ldpc.dna_storage_pchk(), t_rs_ldpc.dna_storage_pchk()
    assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols) == (2048, 18432)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


def test_deployed_blocked_code_equal():
    a, b = j_blocked.dna_storage_blocked(), t_blocked.dna_storage_blocked()
    assert (a.G, a.J, a.q) == (b.G, b.J, b.q) == (8, 72, 256)
    np.testing.assert_array_equal(a.pi, b.pi)
    np.testing.assert_array_equal(a.canonical_gather(), b.canonical_gather())
    np.testing.assert_array_equal(a.external_gather(), b.external_gather())


@pytest.mark.parametrize("params", [(4, 12, 4), (4, 8, 4), (3, 6, 3)])
def test_graph_tables_equal(params):
    H = j_rs_ldpc.build_rs_ldpc(*params)
    jg = JGraph.from_sparse(H)
    tg = TGraph.from_sparse(t_rs_ldpc.build_rs_ldpc(*params))
    rg = graph_from_reference(jg)
    for name in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(jg, name), getattr(tg, name), err_msg=name)
        np.testing.assert_array_equal(getattr(jg, name), getattr(rg, name), err_msg=name)
    assert (tg.blocked is None) == (jg.blocked is None)
    if jg.blocked is not None:
        for g in (tg, rg):
            np.testing.assert_array_equal(g.blocked.pi, jg.blocked.pi)
            np.testing.assert_array_equal(g.blocked.canonical_gather(), jg.blocked.canonical_gather())
    tabs = tg.to("cpu")
    assert torch.equal(tabs.check_vars, torch.as_tensor(jg.check_vars, dtype=torch.int64))
    assert torch.equal(tabs.edge_perm, torch.as_tensor(jg.edge_perm, dtype=torch.int64))
    assert tg.to("cpu") is tabs  # cached per device


def test_codebook_rank_equal():
    np.testing.assert_array_equal(j_codebook.codebook_rank(), t_codebook.codebook_rank())
    np.testing.assert_array_equal(j_codebook.index_codebook(), t_codebook.index_codebook())


def test_decode_index_bits_equal():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (4000, 32))
    bits[rng.random(bits.shape) < 0.002] = 2  # some non-ACGT symbols
    # valid codewords with up to 3 symbol errors exercise every decode branch
    msgs = rng.integers(0, 16, (2000, 4))
    cw = j_rs_index.rs_encode(msgs)
    for k in range(3):
        cw[k::4, rng.integers(0, 8)] ^= rng.integers(1, 16)
    cw_bits = ((cw[..., None] >> np.arange(3, -1, -1)) & 1).reshape(-1, 32)
    for words in (bits, cw_bits):
        a_bits, a_err = j_rs_index.decode_index_bits(words)
        b_bits, b_err = t_rs_index.decode_index_bits(words)
        np.testing.assert_array_equal(a_bits, b_bits)
        np.testing.assert_array_equal(a_err, b_err)


def test_dna_and_gf_helpers_equal():
    rng = np.random.default_rng(1)
    seqs = ["".join(rng.choice(list("ACGTN-"), rng.integers(1, 40))) for _ in range(50)]
    np.testing.assert_array_equal(j_dna.seqs_to_matrix(seqs), t_dna.seqs_to_matrix(seqs))
    m = j_dna.seqs_to_matrix(seqs)
    np.testing.assert_array_equal(j_dna.dna_to_bits(m), t_dna.dna_to_bits(m))
    np.testing.assert_array_equal(j_dna.dna_to_symbols(m), t_dna.dna_to_symbols(m))
    for s in (4, 8):
        np.testing.assert_array_equal(j_gf.get_field(s).exp_table, t_gf.get_field(s).exp_table)
        np.testing.assert_array_equal(j_gf.get_field(s).log_table, t_gf.get_field(s).log_table)


def test_simulate_reads_equal():
    oligos = t_simulate.encode_oligos(np.zeros((272, 18432), np.uint8))[:300]
    ch = dict(substitution=0.02, insertion=0.002, deletion=0.01)
    a = j_simulate.simulate_reads(oligos, 2000, j_simulate.ChannelModel(**ch), seed=3)
    b = t_simulate.simulate_reads(oligos, 2000, t_simulate.ChannelModel(**ch), seed=3)
    assert a == b


def test_synthetic_trial_helpers():
    """Group-union codewords satisfy H, and the oligo index prefixes are
    the RS-encoded strand indices the test suite's fabricated trials use."""
    code = t_blocked.dna_storage_blocked()
    cws = t_simulate.group_union_codewords(code, 6, np.random.default_rng(2))
    assert not t_rs_ldpc.dna_storage_pchk().mulvec(cws).any()
    assert cws.any(axis=1).sum() >= 5
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_pipeline_e2e import strand_index_dna

    np.testing.assert_array_equal(t_simulate.strand_index_dna(), strand_index_dna())
    words = np.resize(cws, (272, 18432))
    oligos = t_simulate.encode_oligos(words)
    assert len(oligos) == 18432 and {len(o) for o in oligos} == {152}
    payload_bits = t_dna.dna_to_bits(t_dna.seqs_to_matrix([o[16:] for o in oligos[:50]]))
    np.testing.assert_array_equal(payload_bits, words[:, :50].T)


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "ck.npz")
    ck = TrialCheckpoint(
        epsil=0.02, llr_table=np.arange(12, dtype=np.float64).reshape(3, 4),
        decoded_bits=np.ones((2, 4), np.uint8), fail_first=np.array([3, 7]),
        fail_current=np.array([7]), anneal_iters=4, n_reads_kept=99,
    )
    ck.save(path)
    back = TrialCheckpoint.load(path)
    assert back.epsil == 0.02 and back.anneal_iters == 4 and back.n_reads_kept == 99
    np.testing.assert_array_equal(back.llr_table, ck.llr_table)
    np.testing.assert_array_equal(back.fail_current, [7])


def test_port_imports_without_jax():
    """Every module of the port imports with ``jax`` and the JAX package
    blocked, as on the GPU machine."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dna_ldpc_tpu'] = None\n"
        "import dna_ldpc_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 39, names\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules if sys.modules[k] is not None)\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 39
