"""Result report files in the reference's exact format (carried from
``dna_ldpc_tpu/pipeline/report.py``).

Reproduces the ``o_<rs>_<trial>_<eps>_result.txt`` / ``x_...`` files
written at ``ex_decoder/decoder.py:668-727`` line by line (header rule,
total time, sampling number, success/failure blocks with first/second
decoding counts and failure index lists) so downstream tooling and the
golden-file regression tests can compare outcomes directly.
"""

from __future__ import annotations

import os
import re

from .decode import TrialResult


def result_filename(rs: int, trial: int, epsil: float, success: bool) -> str:
    prefix = "o" if success else "x"
    return f"{prefix}_{rs}_{trial}_{epsil:f}_result.txt"


def format_result(result: TrialResult, rs: int) -> str:
    lines = []
    lines.append("=" * 78 + "\n")
    lines.append("                               Results                                        \n")
    lines.append("=" * 78 + "\n")
    lines.append("Total time: %f sec\n" % result.total_time)
    lines.append("Random Sampling Number: %d\n" % rs)
    if result.success:
        lines.append("Decoding success\n\n")
        lines.append("First decoding result:   %d/272\n" % (272 - len(result.fail_first)))
        lines.append("Second decoding result:  %d/272\n" % (272 - len(result.fail_final)))
        lines.append("Second decoding iteration number:  %d\n" % result.n_anneal_iters)
    else:
        lines.append("Decoding failure\n\n")
        lines.append("First decoding result:\t%d/272\n" % (272 - len(result.fail_first)))
        lines.append("Second decoding result:\t%d/272\n" % (272 - len(result.fail_final)))
    for label, fails in (
        ("First decoding failure index: ", result.fail_first),
        ("Second decoding failure index: ", result.fail_final),
    ):
        if not fails:
            lines.append(label + "None\n")
        else:
            lines.append(label + "".join(str(v) + " " for v in fails) + "\n")
    return "".join(lines)


def write_result(result: TrialResult, rs: int, trial: int, epsil: float, out_dir: str = ".") -> str:
    path = os.path.join(out_dir, result_filename(rs, trial, epsil, result.success))
    with open(path, "w") as f:
        f.write(format_result(result, rs))
    return path


def parse_result(text: str) -> dict:
    """Parse a reference (or ours) result file into comparable fields —
    used by the golden-file regression tests against
    ``ex_decoder/o_72000_7_*_result.txt``."""
    out: dict = {"success": "Decoding success" in text}
    m = re.search(r"Total time: ([0-9.]+)", text)
    out["total_time"] = float(m.group(1)) if m else None
    m = re.search(r"First decoding result:\s*(\d+)/272", text)
    out["first_ok"] = int(m.group(1)) if m else None
    m = re.search(r"Second decoding result:\s*(\d+)/272", text)
    out["second_ok"] = int(m.group(1)) if m else None
    m = re.search(r"Second decoding iteration number:\s*(\d+)", text)
    out["anneal_iters"] = int(m.group(1)) if m else None
    m = re.search(r"First decoding failure index: (.*)", text)
    if m:
        s = m.group(1).strip()
        out["fail_first"] = [] if s == "None" else [int(v) for v in s.split()]
    m = re.search(r"Second decoding failure index: (.*)", text)
    if m:
        s = m.group(1).strip()
        out["fail_final"] = [] if s == "None" else [int(v) for v in s.split()]
    return out
