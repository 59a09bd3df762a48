"""The port's public surface against the JAX package's, module by module.

One case per module of ``dna_ldpc_tpu/``, held against its twin of the
same path under ``dna_ldpc_tpu_torch/`` (``ops/bp_pallas.py`` against
``ops/bp_cuda.py`` and ``ops/msa/pairhmm_pallas.py`` against
``ops/msa/pairhmm_cuda.py``, where the CUDA kernels stand):

- names: every public name the JAX module defines at top level (a
  function, a class or an assignment; in an ``__init__`` also what it
  imports from its package: re-exports and submodules) is bound at top
  level in the twin, by a definition or an import;
- parameters: every parameter of a public function or class the JAX
  module defines (``inspect.signature``; for a class, its constructor's)
  is a parameter of the twin's.

Names are read from the sources (``ast``), so a submodule that some other
import set as an attribute of a package does not count as re-exported.
What the port leaves out on purpose or has under another name stands in
one table, ``EXCEPTIONS``, each with its reason (``ROADMAP.md``, "Left out
on purpose") or its counterpart in the port, which must resolve. The
table is exact: a new gap fails until it is ported or given a reason, and
an entry that no longer covers a gap fails too.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import pathlib
import subprocess
import sys
import types

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = "dna_ldpc_tpu", "dna_ldpc_tpu_torch"
TWIN_PATH = {"ops/bp_pallas.py": "ops/bp_cuda.py", "ops/msa/pairhmm_pallas.py": "ops/msa/pairhmm_cuda.py"}

SPARSE = "left out: the sparse top-k transport, a TPU relay-link workaround"
ROUTING = "left out: the XLA routing modes of ops/bp.py:202-352; blocked codes take K1 (ops/bp_cuda.py)"
PACKED = "left out: the packed readout of device_msa.py:408; the port's job holds the column maps, widths, flags"
BUCKETS = "left out: the power-of-two shape buckets, one compiled program per bucket on the TPU"
GENERATOR = "renamed: JAX's PRNG key is the port's torch.Generator"

# (JAX module, name or name.param) -> (reason, counterpart in the port as "module:name[.param]" or None)
EXCEPTIONS = {
    ("native_lib.py", "msa_progressive_refine_sparse_native"): (SPARSE, None),
    ("ops/bp.py", "bp_decode_blocked"): (ROUTING, "ops.bp_cuda:bp_decode_blocked"),
    ("ops/bp.py", "bp_decode.mode"): (ROUTING, None),
    ("ops/bp_pallas.py", "bp_decode_blocked_pallas"): ("renamed: the K1 kernel's entry", "ops.bp_cuda:bp_decode_blocked"),
    ("ops/channels.py", "awgn_llr.key"): (GENERATOR, "ops.channels:awgn_llr.gen"),
    ("ops/channels.py", "bsc_llr.key"): (GENERATOR, "ops.channels:bsc_llr.gen"),
    ("ops/channels.py", "bec_values.key"): (GENERATOR, "ops.channels:bec_values.gen"),
    ("ops/editdist.py", "edit_distance_pairs_device.min_pairs"): (BUCKETS, None),
    ("ops/editdist.py", "edit_distance_pairs_device.min_reads"): (BUCKETS, None),
    ("ops/msa/align.py", "align.pair_posts_sparse"): (SPARSE, "ops.msa.align:align.pair_posts"),
    ("ops/msa/align.py", "align_clusters.pair_chunk"): ("renamed: batches sized from a byte budget",
                                                        "ops.msa.pairhmm:BUDGET_BYTES"),
    ("ops/msa/align.py", "align_clusters.n_workers"): ("renamed: a module constant", "ops.msa.align:N_WORKERS"),
    ("ops/msa/consistency.py", "consistency_clusters.top_k"): (SPARSE, None),
    ("ops/msa/consistency.py", "consistency_clusters.cluster_sparse"): (SPARSE, None),
    ("ops/msa/device_msa.py", "NEG"): ("renamed: the MEA DP's off-plane value, beside the merge kernel",
                                       "ops.msa.mea_cuda:NEG"),
    ("ops/msa/device_msa.py", "build_pblock"): (
        "left out: the merge kernel reads each pair at its slot of the batch's pair tensor, transposed where "
        "s1 > s2; no block matrix is laid out", "ops.msa.mea_cuda:merge_walk"),
    ("ops/msa/device_msa.py", "MsaJob.packed"): (PACKED, None),
    ("ops/msa/device_msa.py", "MsaJob.nb"): (PACKED, None),
    ("ops/msa/device_msa.py", "assemble_transform.chunks"): (
        "renamed: one device tensor of every pair posterior, not a fixed-length tuple of chunks (a TPU compile "
        "economy)", "ops.msa.device_msa:assemble_transform.posts"),
    ("ops/msa/pairhmm.py", "SparseJob"): (SPARSE, None),
    ("ops/msa/pairhmm.py", "batch_posteriors_sparse"): (SPARSE, None),
    ("ops/msa/pairhmm.py", "batch_posteriors_sparse_start"): (SPARSE, None),
    ("ops/msa/pairhmm.py", "densify_sparse"): (SPARSE, None),
    ("ops/msa/pairhmm.py", "batch_posteriors.transport"): (SPARSE, None),
    ("ops/msa/pairhmm.py", "batch_posteriors.top_k"): (SPARSE, None),
    ("ops/msa/pairhmm.py", "use_pallas"): ("left out: the TPU kernel's selector; K2 runs for the default tables",
                                           "ops.msa.pairhmm:k2_posteriors"),
    ("ops/msa/pairhmm_pallas.py", "P_TILE"): ("renamed: the Pallas grid's pair tile; the CUDA kernel's layout",
                                              "ops.msa.pairhmm_cuda:kernel_layout"),
    ("ops/msa/pairhmm_pallas.py", "encode_batch_pallas"): ("renamed", "ops.msa.pairhmm:encode_pairs"),
    ("ops/msa/pairhmm_pallas.py", "batch_post_pallas"): ("renamed: the K2 kernel's entry", "ops.msa.pairhmm_cuda:post_ea"),
    ("ops/msa/pairhmm_pallas.py", "batch_post_ea_pallas"): ("renamed", "ops.msa.pairhmm:batch_post_ea"),
    ("ops/simulation.py", "dataclasses_replace"): (
        "left out: a public alias of dataclasses.replace, which the port calls directly", None),
    ("parallel/distributed.py", "initialize.local_device_ids"): (
        "renamed: one card per rank, the process's LOCAL_RANK; backend= picks NCCL or gloo",
        "parallel.distributed:initialize.backend"),
    ("parallel/mesh.py", "build_mesh.devices"): ("renamed: the mesh spans every rank of the default process group",
                                                 "parallel.mesh:build_mesh.device_type"),
    ("parallel/sharded_bp.py", "make_sharded_pallas_decoder"): (
        "renamed: K1 per rank", "parallel.sharded_bp:make_sharded_cuda_decoder"),
    ("pipeline/decode.py", "TrialConfig.bp_mode"): (ROUTING, None),
    ("pipeline/decode.py", "TrialConfig.max_decode_batch"): ("left out: read nowhere in the JAX package", None),
}
# what the port gained so that its surface is whole: never an exception
PORTED = {
    ("models/__init__.py", "codebook_lookup"), ("utils/__init__.py", "dna"), ("utils/__init__.py", "gf"),
    ("utils/__init__.py", "io_formats"), ("ops/msa/consistency.py", "N_BUCKETS"),
    ("ops/msa/consistency.py", "consistency_clusters"), ("ops/msa/device_msa.py", "refine_mask_table"),
}

MODULES = sorted(str(p.relative_to(ROOT / JAX_PKG)) for p in (ROOT / JAX_PKG).rglob("*.py"))


def _module_name(package: str, rel: str) -> str:
    parts = rel[:-3].split("/")
    return ".".join([package] + (parts[:-1] if parts[-1] == "__init__" else parts))


def _top_level_names(path: pathlib.Path, imports: str) -> set[str]:
    """Names a source file binds at top level (inside top-level if/try/with
    blocks too): definitions and assignments, plus imports — every import
    with ``imports="all"``, relative ones with ``"relative"``, none with
    ``"none"``."""
    names: set[str] = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                    names.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                if imports == "all" or (imports == "relative" and isinstance(node, ast.ImportFrom) and node.level):
                    names.update((a.asname or a.name).split(".")[0] for a in node.names)
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                for block in (node.body, getattr(node, "orelse", []), getattr(node, "finalbody", []),
                              *(h.body for h in getattr(node, "handlers", []))):
                    visit(block)

    visit(ast.parse(path.read_text()).body)
    return names


def _parameters(obj) -> list[str]:
    return list(inspect.signature(obj).parameters)


def _gaps(rel: str) -> set[tuple[str, str]]:
    """(rel, name) for each public name of the JAX module its twin lacks,
    (rel, name.param) for each parameter of a public function or class
    of the JAX module that the twin's lacks."""
    twin_rel = TWIN_PATH.get(rel, rel)
    j = importlib.import_module(_module_name(JAX_PKG, rel))
    t = importlib.import_module(_module_name(PORT_PKG, twin_rel))
    public = {n for n in _top_level_names(ROOT / JAX_PKG / rel, "relative" if rel.endswith("__init__.py") else "none")
              if not n.startswith("_")}
    bound = _top_level_names(ROOT / PORT_PKG / twin_rel, "all")
    gaps = {(rel, n) for n in public - bound}
    for n in sorted(public & bound):
        value = getattr(j, n)
        if isinstance(value, types.ModuleType) or not callable(value) or getattr(value, "__module__", None) != j.__name__:
            continue  # a constant, a submodule, or a re-export (its parameters are held where it is defined)
        twin_params = set(_parameters(getattr(t, n)))
        gaps |= {(rel, f"{n}.{p}") for p in _parameters(value) if p not in twin_params}
    return gaps


def _resolve(counterpart: str) -> None:
    """Import ``module:name[.param]`` of the port; raise if it is not there."""
    module, _, attr = counterpart.partition(":")
    name, _, param = attr.partition(".")
    obj = getattr(importlib.import_module(f"{PORT_PKG}.{module}"), name)
    if param and param not in _parameters(obj):
        raise AttributeError(f"{counterpart}: no parameter {param!r}")


@pytest.mark.parametrize("rel", MODULES)
def test_module_surface_matches_the_jax_package(rel):
    excused = {key for key in EXCEPTIONS if key[0] == rel}
    assert _gaps(rel) == excused
    for key in excused:
        reason, counterpart = EXCEPTIONS[key]
        assert reason.startswith(("left out: ", "renamed")), key
        if counterpart is not None:
            _resolve(counterpart)


def test_exceptions_cover_nothing_the_port_has():
    """The table names real modules, and nothing the port gained."""
    assert {rel for rel, _ in EXCEPTIONS} <= set(MODULES)
    assert not PORTED & set(EXCEPTIONS)


def test_utils_package_imports_without_torch():
    """``import dna_ldpc_tpu_torch.utils`` (now with its numpy submodules)
    loads no torch, so it cannot start CUDA."""
    code = "import sys, dna_ldpc_tpu_torch.utils as u; u.dna, u.gf, u.io_formats; assert 'torch' not in sys.modules"
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
