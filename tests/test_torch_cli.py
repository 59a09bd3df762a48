"""CLI parity: ``python -m dna_ldpc_tpu_torch.cli simulate|decode`` with
``--device cpu`` against the JAX package's CLI on a fabricated full-size
trial (272 codewords of the deployed code) written to a temp directory in
the reference's formats. The report files must be equal but for the
"Total time" line; the carried file helpers and report writer must be
byte-equal to the JAX package's."""

import os
import sys

import numpy as np
import pytest
import torch

from dna_ldpc_tpu import cli as j_cli
from dna_ldpc_tpu.pipeline import report as j_report
from dna_ldpc_tpu.pipeline.decode import TrialResult as JResult
from dna_ldpc_tpu.utils import io_formats as j_io
from dna_ldpc_tpu_torch import cli as t_cli
from dna_ldpc_tpu_torch.models.blocked import dna_storage_blocked
from dna_ldpc_tpu_torch.ops import bp_cuda
from dna_ldpc_tpu_torch.pipeline import report as t_report
from dna_ldpc_tpu_torch.pipeline import simulate as t_simulate
from dna_ldpc_tpu_torch.pipeline.decode import TrialResult
from dna_ldpc_tpu_torch.utils import io_formats as t_io

# The suite runs in several worker processes that share the cores: one
# intra-op thread per process keeps OpenMP from oversubscribing them.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_pipeline_e2e import make_trial_reads  # noqa: E402


@pytest.fixture(scope="module")
def trial_dir(tmp_path_factory):
    """Codeword files, the oligo pool and one read/quality file pair (two
    clean reads per strand, 20 strands with an extra deletion read)."""
    d = tmp_path_factory.mktemp("trial")
    cws = t_simulate.group_union_codewords(dna_storage_blocked(), 272, np.random.default_rng(3))
    for i in range(272):
        t_io.write_vector(str(d / f"codeword_n18432_m1860_{i + 1}.txt"), cws[i])
    t_io.write_lines(str(d / "oligos.txt"), t_simulate.encode_oligos(cws))
    reads, quals = make_trial_reads(cws, coverage=2, deletion_strands=list(range(0, 2000, 100)))
    t_io.write_lines(str(d / f"{len(reads)}_RS_0.txt"), reads)
    t_io.write_lines(str(d / f"{len(reads)}_RS_Q_0.txt"), quals)
    return d, len(reads)


def _reports(out_dir) -> dict[str, str]:
    """Report files by name, without the "Total time" line."""
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            out[name] = "".join(line for line in f if not line.startswith("Total time"))
    return out


def _run_both(tmp_path, args):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert j_cli.main(args + ["--out-dir", str(tmp_path / "jax")]) == 0
    before = bp_cuda.launches
    assert t_cli.main(args + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert bp_cuda.launches == before  # --device cpu: the plain twins ran
    want, got = _reports(tmp_path / "jax"), _reports(tmp_path / "port")
    assert got == want and len(got) == 1
    return got


def test_cli_decode_matches_jax(trial_dir, tmp_path):
    d, rs = trial_dir
    got = _run_both(tmp_path, [
        "decode", "--rs", str(rs), "--start", "0", "--end", "2", "--epsil", "0.02",
        "--data-dir", str(d), "--codeword-dir", str(d),
    ])
    (text,) = got.values()
    assert "Decoding success" in text and "First decoding result:   272/272" in text


def test_cli_simulate_matches_jax(trial_dir, tmp_path):
    """72,000 reads from the oligo pool; a deletion rate of 5e-7 (a few
    reads with a deletion) keeps the mixed-length clusters (the MSA path)
    few enough for the CPU."""
    d, _ = trial_dir
    got = _run_both(tmp_path, [
        "simulate", "--rs", "72000", "--start", "0", "--end", "1", "--epsil", "0.02",
        "--oligos", str(d / "oligos.txt"), "--codeword-dir", str(d),
        "--del-rate", "5e-7", "--ins-rate", "0", "--seed", "4",
    ])
    assert list(got) == ["o_72000_0_0.020000_result.txt"]


def test_cli_device_must_exist(monkeypatch, trial_dir, tmp_path):
    """A CUDA device that is not there raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, rs = trial_dir
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["decode", "--rs", str(rs), "--data-dir", str(d), "--codeword-dir", str(d),
                    "--out-dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []


def test_file_helpers_and_report_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    for k, vals in enumerate([rng.integers(0, 2, 50), rng.normal(size=20).astype(np.float32)]):
        for fmt in (None, "%.3f") if vals.dtype.kind == "f" else (None,):
            jp, tp = tmp_path / f"j{k}{fmt}", tmp_path / f"t{k}{fmt}"
            j_io.write_vector(str(jp), vals, fmt)
            t_io.write_vector(str(tp), vals, fmt)
            assert tp.read_bytes() == jp.read_bytes()
            np.testing.assert_array_equal(t_io.read_vector(str(tp), vals.dtype), j_io.read_vector(str(jp), vals.dtype))
    lines = ["ACGT", "", "N" * 5]
    t_io.write_lines(str(tmp_path / "l"), lines)
    assert t_io.read_lines(str(tmp_path / "l")) == j_io.read_lines(str(tmp_path / "l")) == lines
    oligo_file = tmp_path / "o"
    oligo_file.write_text("ACGT\n\n  GGA \n")
    assert t_simulate.load_oligos(str(oligo_file)) == ["ACGT", "GGA"]
    for success, ff, fl in ((True, [3], []), (False, [2, 9], [9])):
        kw = dict(success=success, fail_first=ff, fail_final=fl, n_anneal_iters=4, n_erasure_strands=0,
                  decoded_bits=np.zeros((1, 1)), total_time=1.5)
        text = t_report.format_result(TrialResult(**kw), 72000)
        assert text == j_report.format_result(JResult(**kw), 72000)
        assert t_report.parse_result(text) == j_report.parse_result(text)
        path = t_report.write_result(TrialResult(**kw), 72000, 7, 0.02, str(tmp_path))
        assert os.path.basename(path) == j_report.result_filename(72000, 7, 0.02, success)
