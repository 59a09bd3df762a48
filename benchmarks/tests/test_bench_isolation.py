"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program. Each check runs in a
fresh interpreter, so that what other tests imported does not count;
top-level module names are compared whole (``dna_ldpc_tpu_torch``, the
port, begins with ``dna_ldpc_tpu``, the JAX package's name)."""

import json
import subprocess
import sys

from bench_helpers import BENCH_DIR, REPO

PROBE = r"""
import glob, importlib.util, json, os, sys
sys.path.insert(0, {bench!r}); sys.path.insert(0, {repo!r})
for path in {paths}:
    for f in sorted(glob.glob(os.path.join({bench!r}, path))):
        name = "probe_" + os.path.relpath(f, {bench!r}).replace(os.sep, "_").replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, f)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
for mod in {extra}:
    importlib.import_module(mod)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(paths, extra=()) -> set:
    code = PROBE.format(bench=BENCH_DIR, repo=REPO, paths=list(paths), extra=list(extra))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_drivers_and_readers_load_no_jax():
    # the program's entries the drivers call are loaded too: they run in the same process
    loaded = _top_level(["run.py", "benchlib/*.py", "drivers/*.py", "metrics/*.py", "reference/*.py"],
                        ["dna_ldpc_tpu_torch.pipeline.decode", "dna_ldpc_tpu_torch.ops.simulation",
                         "dna_ldpc_tpu_torch.ops.msa.align"])
    assert "dna_ldpc_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "dna_ldpc_tpu"}


def test_reference_imports_nothing_of_the_program():
    loaded = _top_level(["reference/*.py", "benchlib/recipe.py", "benchlib/code.py"])
    assert not loaded & {"jax", "jaxlib", "flax", "dna_ldpc_tpu", "dna_ldpc_tpu_torch"}


def test_msa_workers_load_no_torch():
    """The plain MSA's worker processes import ``reference/msa.py`` alone:
    numpy, no torch, so that starting them is quick."""
    loaded = _top_level(["reference/msa.py"])
    assert "numpy" in loaded and "torch" not in loaded


def test_harness_refuses_without_a_card_and_prints_nothing(tmp_path):
    out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", "trial-72k", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
