"""Multi-process BP parity: the port's mesh helpers, trial split and
sharded decoders against the JAX package's. The sharded decoders run in
spawned CPU processes joined by ``torch.distributed`` over gloo (a
``FileStore`` in the test's directory, so parallel test workers race for
no port); each worker blocks ``jax`` and the JAX package, as the GPU
machine lacks them. Their gathered results are held, in this process,
against the JAX package's single-device decoders under the assertions of
tests/test_sharding.py (bits, success, unsat, and iterations where those
assert them; converged rows for the K1 twin, whose bf16 messages make
mid-decode bits differ), as tests/test_distributed.py holds the JAX
multi-process run."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_ldpc_tpu.models import BlockedCode as JBlocked
from dna_ldpc_tpu.models import build_rs_ldpc
from dna_ldpc_tpu.models.ldpc_graph import LdpcGraph as JGraph
from dna_ldpc_tpu.models.rs_ldpc import dna_storage_pchk
from dna_ldpc_tpu.ops.bp import bp_decode_blocked as j_bp_decode_blocked
from dna_ldpc_tpu.ops.bp import decode_llrs as j_decode_llrs
from dna_ldpc_tpu.parallel import distributed as j_distributed
from dna_ldpc_tpu.parallel.mesh import build_mesh as j_build_mesh
from dna_ldpc_tpu_torch.parallel import distributed, mesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
sys.modules["jax"] = None
sys.modules["dna_ldpc_tpu"] = None
import numpy as np
import torch

torch.set_num_threads(1)

from dna_ldpc_tpu_torch.models import BlockedCode, LdpcGraph, build_rs_ldpc
from dna_ldpc_tpu_torch.models.rs_ldpc import dna_storage_pchk
from dna_ldpc_tpu_torch.ops.bp import bp_decode_generic
from dna_ldpc_tpu_torch.ops.bp_cuda import bp_decode_blocked_ref
from dna_ldpc_tpu_torch.parallel import distributed
from dna_ldpc_tpu_torch.parallel.mesh import build_mesh, mesh_device
from dna_ldpc_tpu_torch.parallel.sharded_bp import (
    make_sharded_cuda_decoder, make_sharded_decoder, sharded_blocked_decode, sharded_decode,
)

kind, store, inputs, out = sys.argv[1:5]
x = np.load(inputs)
saved = {}


def keep(name, local, m):
    full = distributed.allgather_result(local, m)
    for field in ("bits", "success", "iterations", "unsat"):
        saved[f"{name}_{field}"] = getattr(full, field).numpy()


if kind == "mesh4":
    rank = int(sys.argv[5])
    distributed.initialize(coordinator_address=store, num_processes=4, process_id=rank, backend="gloo")
    m22 = build_mesh(max_graph=2, device_type="cpu")
    m41 = build_mesh(n_graph=1, device_type="cpu")
    assert tuple(m22.shape) == (2, 2) and tuple(m41.shape) == (4, 1), (m22.shape, m41.shape)
    assert m22.get_local_rank("cw") == rank // 2 and m22.get_local_rank("graph") == rank % 2
    H = build_rs_ldpc(4, 8, 4)  # 64 x 128, gamma=4 cosets
    graph, code = LdpcGraph.from_sparse(H), BlockedCode.detect(H)
    # (2 cw, 2 graph): two cosets per rank; then pure codeword parallelism
    keep("mesh22", sharded_decode(graph, m22, x["mesh22"], max_iter=30), m22)
    local = sharded_decode(graph, m41, x["pure_dp"], max_iter=30)
    keep("pure_dp", local, m41)
    # a graph axis of one rank is bp_decode_generic operation for operation
    rows = slice(4 * rank, 4 * rank + 4)
    ref = bp_decode_generic(graph, torch.as_tensor(x["pure_dp"][rows]), 30)
    for field in ("bits", "success", "iterations", "unsat"):
        assert torch.equal(getattr(local, field), getattr(ref, field)), field
    keep("blocked", sharded_blocked_decode(code, m22, x["blocked"], max_iter=30), m22)
    cuda_fn = make_sharded_cuda_decoder(code, m41, max_iter=30)
    assert make_sharded_cuda_decoder(code, m41, max_iter=30) is cuda_fn  # built once per mesh
    keep("cuda", cuda_fn(distributed.process_local_batch(x["cuda"], m41)), m41)
    # the DEPLOYED 2048 x 18432 graph over (2, 2), tiny batch
    deployed = LdpcGraph.from_sparse(dna_storage_pchk())
    keep("deployed", sharded_decode(deployed, m22, x["deployed"], max_iter=10), m22)
    if rank == 0:
        full = bp_decode_blocked_ref(code, torch.as_tensor(x["cuda"]), 30)
        saved["cuda_twin_bits"] = full.bits.numpy()
        saved["cuda_twin_iterations"] = full.iterations.numpy()
else:  # two processes through initialize() from the environment
    distributed.initialize(coordinator_address=store, backend="gloo")
    rank = int(os.environ["RANK"])
    m = distributed.global_mesh(device_type="cpu")
    assert tuple(m.shape) == (1, 2), m.shape  # the graph axis stays inside the node
    m = distributed.global_mesh(max_graph=1, device_type="cpu")
    assert tuple(m.shape) == (2, 1), m.shape
    assert mesh_device(m) == torch.device("cpu")
    saved["trials"] = np.asarray(distributed.split_trials(272, 2, rank))
    H = dna_storage_pchk() if kind == "flagship" else build_rs_ldpc(4, 8, 4)
    llr = distributed.process_local_batch(x["llr"], m)
    assert llr.shape[0] == x["llr"].shape[0] // 2 and torch.equal(llr, torch.as_tensor(x["llr"][2 * rank : 2 * rank + 2]))
    decode = make_sharded_decoder(LdpcGraph.from_sparse(H), m, max_iter=int(x["max_iter"]))
    keep("two", decode(llr), m)
if rank == 0:
    np.savez(out, **saved)
# leave together and tear the groups down before exit: a gloo group left to the
# interpreter's shutdown can abort a rank whose peers have already gone
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print("WORKER_OK", rank, flush=True)
"""


def _coverage_llrs(rng, B, n):
    mag = np.log(0.98 / 0.02)
    cov = rng.poisson(3.7, (B, n))
    errs = rng.binomial(cov, 0.02)
    return ((cov - 2 * errs) * mag).astype(np.float32)


def _spawn(tmp_path, kind, n, inputs, timeout, env_of=None):
    """Run the worker in ``n`` processes; returns rank 0's saved arrays."""
    script, store, data, out = (tmp_path / name for name in ("worker.py", "store", "inputs.npz", "out.npz"))
    script.write_text(WORKER)
    np.savez(data, **inputs)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    procs = []
    for rank in range(n):
        extra = env_of(rank) if env_of else {}
        procs.append(subprocess.Popen(
            [sys.executable, str(script), kind, f"file://{store}", str(data), str(out)] + ([] if env_of else [str(rank)]),
            env={**env, **extra}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {rank}" in text, f"worker {rank} failed:\n{text[-4000:]}"
    return np.load(out)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("kw", [{}, {"max_graph": 4}, {"n_graph": 2}, {"max_graph": 1}, {"max_graph": 2}])
def test_mesh_shape_matches_jax(k, kw):
    """tests/test_sharding.py:29-36's layouts, on 1-8 of the 8 virtual devices."""
    if kw.get("n_graph", 1) > k:
        with pytest.raises(ValueError):
            mesh.mesh_shape(k, **kw)
        return
    assert mesh.mesh_shape(k, **kw) == j_build_mesh(devices=jax.devices()[:k], **kw).devices.shape


def test_mesh_shape_rejects_uneven_graph_axis():
    with pytest.raises(ValueError, match="not divisible"):
        mesh.mesh_shape(6, n_graph=4)


def test_split_trials_matches_jax():
    for n, k in ((10, 3), (272, 8), (5, 5), (3, 4), (272, 2), (0, 2)):
        for pid in range(k):
            assert distributed.split_trials(n, k, pid) == j_distributed.split_trials(n, k, pid)


def test_entry_points_need_the_card_by_default():
    """Without a card, the mesh constructors and an NCCL group raise before any
    process group is made; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is there")
    for call in (mesh.build_mesh, distributed.global_mesh,
                 lambda: distributed.initialize("localhost:29500", num_processes=2, process_id=0)):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            call()
    distributed.initialize("localhost:29500", num_processes=1, process_id=0)  # one process: a no-op
    assert not torch.distributed.is_initialized()


def test_four_process_mesh_matches_jax(tmp_path):
    """One spawn of four gloo ranks: the check-sharded decoder on (2 cw, 2
    graph) and (4 cw, 1 graph), the coset-sharded decoder on (2, 2), the
    K1 twin per rank on (4, 1), and the deployed graph over (2, 2) —
    tests/test_sharding.py:39-145's cases."""
    H = build_rs_ldpc(4, 8, 4)
    inputs = {
        "mesh22": _coverage_llrs(np.random.default_rng(0), 8, 128),
        "pure_dp": _coverage_llrs(np.random.default_rng(1), 16, 128),
        "deployed": _coverage_llrs(np.random.default_rng(2), 2, 18432),
    }
    rng = np.random.default_rng(5)
    inputs["blocked"] = _coverage_llrs(rng, 8, 128)
    rng = np.random.default_rng(0)
    mag = np.log(0.98 / 0.02)
    cov = rng.poisson(4.0, (8, 128))
    inputs["cuda"] = ((cov - 2 * rng.binomial(cov, 0.02)) * mag).astype(np.float32)
    got = _spawn(tmp_path, "mesh4", 4, inputs, timeout=240)

    g = JGraph.from_sparse(H)
    ref = j_decode_llrs(g, inputs["mesh22"], max_iter=30)
    for field in ("bits", "success", "unsat"):
        np.testing.assert_array_equal(got[f"mesh22_{field}"], np.asarray(getattr(ref, field)), err_msg=field)
    ref = j_decode_llrs(g, inputs["pure_dp"], max_iter=30)
    np.testing.assert_array_equal(got["pure_dp_bits"], np.asarray(ref.bits))

    code = JBlocked.detect(H)
    ref = j_bp_decode_blocked(code, jnp.asarray(inputs["blocked"]), max_iter=30)
    for field in ("bits", "success", "iterations"):
        np.testing.assert_array_equal(got[f"blocked_{field}"], np.asarray(getattr(ref, field)), err_msg=field)

    # K1's twin per rank: the twin's own full-batch result exactly, and the
    # JAX package's exact decoder on the converged rows
    np.testing.assert_array_equal(got["cuda_bits"], got["cuda_twin_bits"])
    np.testing.assert_array_equal(got["cuda_iterations"], got["cuda_twin_iterations"])
    ref = j_bp_decode_blocked(code, inputs["cuda"], max_iter=30, early_stop=True)
    conv, ref_conv = got["cuda_unsat"] == 0, np.asarray(ref.unsat) == 0
    np.testing.assert_array_equal(conv, ref_conv)
    both = conv & ref_conv
    assert both.any()
    np.testing.assert_array_equal(got["cuda_bits"][both], np.asarray(ref.bits)[both])

    ref = j_decode_llrs(JGraph.from_sparse(dna_storage_pchk()), inputs["deployed"], max_iter=10)
    np.testing.assert_array_equal(got["deployed_bits"], np.asarray(ref.bits))
    np.testing.assert_array_equal(got["deployed_iterations"], np.asarray(ref.iterations))


def _two_process(tmp_path, kind, H, max_iter, timeout):
    llr = _coverage_llrs(np.random.default_rng(0), 4, H.n_cols)
    env_of = lambda rank: {"WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": "2"}
    got = _spawn(tmp_path, kind, 2, {"llr": llr, "max_iter": max_iter}, timeout, env_of)
    assert got["trials"].tolist() == list(range(136))
    ref = j_decode_llrs(JGraph.from_sparse(H), llr, max_iter=max_iter)
    np.testing.assert_array_equal(got["two_bits"], np.asarray(ref.bits))
    np.testing.assert_array_equal(got["two_success"], np.asarray(ref.success))


def test_two_process_initialize_from_environment(tmp_path):
    """Two ranks configured through the environment (as torchrun sets it):
    ``initialize``, ``global_mesh``, ``process_local_batch`` and the
    gather, bit-identical to the JAX package's single-process decoder."""
    _two_process(tmp_path, "env", build_rs_ldpc(4, 8, 4), 20, timeout=120)


@pytest.mark.slow
def test_two_process_flagship_decode(tmp_path):
    """The DEPLOYED 2048 x 18432 graph across a real process boundary
    (max_iter=2 keeps the CPU cost bounded), bit-identical to the JAX
    package's single-process decoder."""
    _two_process(tmp_path, "flagship", dna_storage_pchk(), 2, timeout=900)
