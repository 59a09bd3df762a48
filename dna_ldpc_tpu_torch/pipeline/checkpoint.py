"""Carried from ``dna_ldpc_tpu/pipeline/checkpoint.py`` as numpy code: the
JAX package cannot be imported without ``jax``. tests/test_torch_models.py
holds it equal to the original.

Trial checkpoint/resume.

The reference pipeline is implicitly resumable because every stage
round-trips through named files (soft files, dec files, .mat files —
SURVEY.md §5 "Checkpoint / resume"). This module makes that explicit: a
single compressed npz captures the expensive intermediate state of a trial
(the [18432, 272] LLR table — i.e. everything up to and including the
MSA/counting stage — plus decoder progress), so an interrupted run resumes
after ingest instead of re-aligning ~18k clusters.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

_VERSION = 1


@dataclass
class TrialCheckpoint:
    epsil: float
    llr_table: np.ndarray          # [18432, 272] post-ingest soft info
    decoded_bits: np.ndarray | None = None   # [272, 18432] after first decode
    fail_first: np.ndarray | None = None     # 1-based indices
    fail_current: np.ndarray | None = None
    anneal_iters: int = 0
    n_reads_kept: int = 0

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        np.savez_compressed(
            tmp,
            version=_VERSION,
            epsil=self.epsil,
            llr_table=self.llr_table,
            decoded_bits=(
                self.decoded_bits if self.decoded_bits is not None else np.zeros(0, np.uint8)
            ),
            fail_first=(
                self.fail_first if self.fail_first is not None else np.full(1, -1, np.int64)
            ),
            fail_current=(
                self.fail_current if self.fail_current is not None else np.full(1, -1, np.int64)
            ),
            anneal_iters=self.anneal_iters,
            n_reads_kept=self.n_reads_kept,
        )
        os.replace(tmp + ".npz", path)

    @classmethod
    def load(cls, path: str) -> "TrialCheckpoint | None":
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            if int(z["version"]) != _VERSION:
                return None
            decoded = z["decoded_bits"]
            ff = z["fail_first"]
            fc = z["fail_current"]
            return cls(
                epsil=float(z["epsil"]),
                llr_table=z["llr_table"],
                decoded_bits=decoded if decoded.size else None,
                fail_first=None if (ff.size == 1 and ff[0] == -1) else ff,
                fail_current=None if (fc.size == 1 and fc[0] == -1) else fc,
                anneal_iters=int(z["anneal_iters"]),
                n_reads_kept=int(z["n_reads_kept"]),
            )
