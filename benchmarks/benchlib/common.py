"""Helpers the drivers share: seed streams, loading the program's built
code, and the check that the program decodes the H the benchmark made."""

from __future__ import annotations

import time
import zlib

import numpy as np

from benchlib import code


# The nearest precision below each that the configurations state (float32 with
# TF32 off, bfloat16): the control of ``correct`` computes the plain reference
# in it (``run.py --control``).
LOWER = {"float32": "tfloat32", "bfloat16": "float8_e4m3fn"}


def limits(config: dict, traffic: dict) -> dict:
    """The limits of ``correct`` in a cell: the configuration's, and where
    the traffic mix states its own for a number (the readings that set a
    limit depend on the load, such as the reads per strand), the mix's."""
    return {**config["limits"], **traffic.get("limits", {})}


def stream(seed: int, tag: str) -> np.random.Generator:
    """An independent numpy generator for one use (``tag``) of ``seed``."""
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), zlib.crc32(tag.encode())]))


def sub_seed(seed: int, tag: str, k: int) -> int:
    """A 63-bit seed for the k-th use of ``tag`` under ``seed``."""
    ss = np.random.SeedSequence([seed % (1 << 64), zlib.crc32(tag.encode()), k])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def load_program(device) -> dict:
    """Load (building at the first run in a checkout) the program's CUDA
    kernels and native host library; returns their seconds."""
    import torch

    from dna_ldpc_tpu_torch import cuda_lib, native_lib

    out = {}
    if torch.device(device).type == "cuda":
        t0 = time.time()
        cuda_lib.load()
        out["cuda_kernels_load_s"] = round(time.time() - t0, 4)
    t0 = time.time()
    native_lib.load()
    out["native_library_load_s"] = round(time.time() - t0, 4)
    return out


def check_program_h(checks: np.ndarray) -> None:
    """Raise unless the program's deployed pchk has exactly the edges of
    ``checks`` (the benchmark's own construction)."""
    from dna_ldpc_tpu_torch.models.rs_ldpc import dna_storage_pchk

    H = dna_storage_pchk()
    rows = np.repeat(np.arange(H.n_rows), H.row_weights())
    theirs = np.zeros((H.n_rows, H.n_cols), bool)
    theirs[rows, H.indices] = True
    if not np.array_equal(theirs, code.dense_h(checks, H.n_cols).astype(bool)):
        raise RuntimeError("the program's deployed parity-check matrix is not the benchmark's H")


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
