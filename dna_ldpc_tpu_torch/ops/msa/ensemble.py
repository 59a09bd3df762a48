"""Ensemble alignment replicates and alignment-accuracy scoring.

Port of ``dna_ldpc_tpu/ops/msa/ensemble.py``: numpy copies of its host
functions, and ``ensemble_align`` with ``device=`` (replicate 0 of every
mode runs the default tables, so K2 on the card; perturbed replicates run
the general-table pair-HMM in plain torch).

Equivalents of MUSCLE v5's ensemble machinery, unused by the DNA decode
pipeline but part of the vendored engine's surface
(``MUSCLE/src/align.cpp:81-120`` -perturb / -stratified / -diversified /
-replicates; ``hmmparams.cpp`` PerturbProbs; ``qscorer.cpp`` + cmds
qscore/qscore2 accuracy scoring):

- ``perturb_params``: multiply every HMM probability by a seeded random
  factor exp(U(-delta, delta)) and renormalize — PerturbProbs;
- ``ensemble_align``: N replicates; ``stratified`` varies only the
  refinement/tie-break seed per replicate, ``diversified`` additionally
  perturbs the HMM and applies MUSCLE's guide-tree permutations
  (none/abc/acb/bca cycling per replicate, ``permutetree.cpp``);
- ``write_efa`` / ``read_efa``: the EFA (ensemble FASTA) container MUSCLE
  stores ensembles in (``ensemble.cpp:79-134``);
- ``column_confidence`` / ``select_by_cc``: per-replicate CC values
  (fraction of columns reproduced by the other replicates) and max-CC
  selection, MUSCLE's recommended way to pick from an ensemble;
- ``qscore``: Q (aligned-residue-pair recall) and TC (total-column)
  scores of a test alignment against a reference alignment.
"""

from __future__ import annotations

import numpy as np

from ...utils.device import DEFAULT_DEVICE, require_device
from .align import REFINE_ITERS, align
from .pairhmm import LOG_ZERO, nucleo_params


def perturb_params(seed: int, delta: float = 0.2):
    """Seeded multiplicative perturbation of the nucleotide HMM tables
    (log-space: add U(-delta, delta)), rows renormalized to stay
    probability tables."""
    start, trans6, match, ins = (a.copy() for a in nucleo_params())
    rng = np.random.default_rng(seed)

    def perturb_rows(table):
        live = table > LOG_ZERO / 2
        noise = rng.uniform(-delta, delta, table.shape).astype(np.float32)
        out = np.where(live, table + noise, table)
        # renormalize each row to its ORIGINAL probability mass (rows of
        # the match table are joint probabilities, not conditionals)
        def logmass(row):
            return np.log(np.exp(row - row.max()).sum()) + row.max()

        for r in range(out.shape[0]):
            if live[r].any():
                out[r][live[r]] += logmass(table[r][live[r]]) - logmass(out[r][live[r]])
        return out

    start = perturb_rows(start[None])[0]
    trans6 = perturb_rows(trans6)
    match = perturb_rows(match)
    ins = perturb_rows(ins[None])[0]
    return start, trans6, match, ins


def ensemble_align(
    seqs: list[str],
    replicates: int = 4,
    mode: str = "diversified",
    delta: float = 0.2,
    refine_iters: int = REFINE_ITERS,
    base_seed: int = 0,
    device=DEFAULT_DEVICE,
) -> list[list[tuple[int, str]]]:
    """Run ``replicates`` alignment replicates, their pair-HMMs on
    ``device``; returns one alignment ([(ordinal, row)]) per replicate,
    rows in input order."""
    if mode not in ("perturb", "stratified", "diversified"):
        raise ValueError(f"unknown ensemble mode {mode!r}")
    require_device(device)
    out = []
    for r in range(replicates):
        seed = base_seed * 1000 + r
        params = (
            perturb_params(seed, delta) if mode in ("perturb", "diversified") and r > 0
            else None
        )
        perm = "none"
        if mode == "diversified":
            perm = ("none", "abc", "acb", "bca")[r % 4]
        rows = align(
            seqs,
            refine_iters=refine_iters,
            seed=seed,
            hmm_params=params,
            tree_perm=perm,
            device=device,
        )
        out.append(sorted(rows))
    return out


def write_efa(
    path: str,
    ensemble: list[list[tuple[int, str]]],
    names: list[str] | None = None,
) -> None:
    """Write an ensemble in MUSCLE's EFA (ensemble FASTA) container: each
    MSA is introduced by a ``<name`` line followed by its FASTA records
    (``ensemble.cpp:119-134`` ToEFA), rows wrapped at 80 columns like
    WriteMFA (``myutils.cpp:2721``)."""
    with open(path, "w") as f:
        for k, aln in enumerate(ensemble):
            name = names[k] if names else f"replicate.{k}"
            f.write(f"<{name}\n")
            for ordinal, row in aln:
                f.write(f">s{ordinal}\n")
                for i in range(0, len(row), 80):
                    f.write(row[i : i + 80] + "\n")


def read_efa(path: str) -> tuple[list[str], list[list[tuple[int, str]]]]:
    """Parse an EFA file -> (msa names, alignments). A file not starting
    with '<' is invalid (``ensemble.cpp:87-88``). Labels of the form
    ``s<k>`` map back to ordinal k; other labels get their order of
    appearance."""
    names: list[str] = []
    ensemble: list[list[tuple[int, str]]] = []
    label, parts = None, []

    def flush_seq(aln):
        nonlocal label, parts
        if label is not None:
            ordinal = (
                int(label[1:]) if label[1:].isdigit() and label[0] == "s" else len(aln)
            )
            aln.append((ordinal, "".join(parts)))
        label, parts = None, []

    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line:
                continue
            if line[0] == "<":
                if not names and (label is not None or ensemble):
                    raise ValueError("invalid EFA: must start with '<'")
                if names:
                    flush_seq(ensemble[-1])
                names.append(line[1:])
                ensemble.append([])
            elif line[0] == ">":
                if not names:
                    raise ValueError("invalid EFA: must start with '<'")
                flush_seq(ensemble[-1])
                label = line[1:].split()[0] if len(line) > 1 else ""
            else:
                if not names:
                    raise ValueError("invalid EFA: must start with '<'")
                parts.append(line)
    if names:
        flush_seq(ensemble[-1])
    if not names:
        raise ValueError("empty EFA")
    return names, [sorted(a) for a in ensemble]


def _column_sets(alignment: list[tuple[int, str]]):
    """Each column as a frozenset of (seq ordinal, residue position) for
    the non-gap entries — the unit qscore/CC compare."""
    rows = {o: row for o, row in alignment}
    ordinals = sorted(rows)
    pos = {o: -1 for o in ordinals}
    width = len(rows[ordinals[0]])
    cols = []
    for c in range(width):
        entries = []
        for o in ordinals:
            ch = rows[o][c]
            if ch != "-":
                pos[o] += 1
                entries.append((o, pos[o]))
        if entries:
            cols.append(frozenset(entries))
    return cols


def column_confidence(ensemble: list[list[tuple[int, str]]]) -> np.ndarray:
    """CC value per replicate: mean fraction of its columns found
    identically in each other replicate."""
    col_sets = [set(_column_sets(a)) for a in ensemble]
    n = len(ensemble)
    cc = np.zeros(n)
    for i in range(n):
        mine = _column_sets(ensemble[i])
        if not mine or n == 1:
            cc[i] = 1.0
            continue
        scores = [
            sum(c in col_sets[j] for c in mine) / len(mine)
            for j in range(n) if j != i
        ]
        cc[i] = float(np.mean(scores))
    return cc


def select_by_cc(ensemble: list[list[tuple[int, str]]]):
    """The max-CC replicate (alignment, cc_values)."""
    cc = column_confidence(ensemble)
    return ensemble[int(np.argmax(cc))], cc


def _aligned_pairs(alignment: list[tuple[int, str]]):
    pairs = set()
    for col in _column_sets(alignment):
        entries = sorted(col)
        for a in range(len(entries)):
            for b in range(a + 1, len(entries)):
                pairs.add((entries[a], entries[b]))
    return pairs


def qscore(test: list[tuple[int, str]], ref: list[tuple[int, str]]) -> dict:
    """Q = fraction of reference aligned residue pairs present in the test
    alignment; TC = fraction of reference columns reproduced exactly
    (qscorer.cpp semantics)."""
    ref_pairs = _aligned_pairs(ref)
    test_pairs = _aligned_pairs(test)
    q = len(ref_pairs & test_pairs) / len(ref_pairs) if ref_pairs else 1.0
    ref_cols = _column_sets(ref)
    test_cols = set(_column_sets(test))
    tc = sum(c in test_cols for c in ref_cols) / len(ref_cols) if ref_cols else 1.0
    return {"Q": q, "TC": tc}
