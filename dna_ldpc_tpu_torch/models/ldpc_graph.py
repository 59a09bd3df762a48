"""Dense edge-table representation of a Tanner graph.

The same numpy tables as ``dna_ldpc_tpu/models/ldpc_graph.py``
(``LdpcGraph.from_sparse``), built without ``jax``:

- ``check_vars``  [M, dc_max]: the variable index of each check-side edge
  slot (padded with -1);
- ``var_edge_ids`` [N, dv_max]: the flat check-major edge id of each
  variable-side edge slot (padded with E, a dummy slot);
- ``edge_perm``   [E]: for each check-major edge, its position in the
  flattened variable-major layout.

``to(device)`` gives the gather tables as torch tensors;
``graph_from_reference`` rebuilds a graph from another package's tables,
so both decoders can run on identical tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.io_formats import SparseBinaryMatrix
from .blocked import BlockedCode


@dataclasses.dataclass(frozen=True)
class GraphTensors:
    """The generic decoder's gather tables on one device (int64 indices)."""

    check_vars: torch.Tensor    # [M, dc_max], -1 padding
    check_mask: torch.Tensor    # [M, dc_max] bool
    var_edge_ids: torch.Tensor  # [N, dv_max], == M * dc_max padding
    edge_perm: torch.Tensor     # [M * dc_max], == N * dv_max padding


@dataclasses.dataclass(frozen=True, eq=False)
class LdpcGraph:
    """Static decoding tables for one LDPC code (numpy-held)."""

    n_checks: int
    n_vars: int
    dc_max: int
    dv_max: int
    n_edges: int
    check_vars: np.ndarray      # [M, dc_max] int32, -1 padding
    check_mask: np.ndarray      # [M, dc_max] bool
    var_edge_ids: np.ndarray    # [N, dv_max] int32, == n_edges padding
    var_mask: np.ndarray        # [N, dv_max] bool
    edge_perm: np.ndarray       # [E] int32: check-major edge -> var-major slot
    edge_var: np.ndarray        # [E] int32: variable of each check-major edge
    regular: bool
    # permutation-block (protograph) structure, when the code has one —
    # routes blocked codes to the fused decoder (ops/bp_cuda.py)
    blocked: BlockedCode | None = None

    @classmethod
    def from_sparse(cls, H: SparseBinaryMatrix, detect_blocked: bool = True) -> "LdpcGraph":
        M, N = H.n_rows, H.n_cols
        row_w = H.row_weights()
        col_w = H.col_weights()
        dc = int(row_w.max(initial=0))
        dv = int(col_w.max(initial=0))
        E = H.nnz

        check_vars = np.full((M, dc), -1, dtype=np.int32)
        check_mask = np.zeros((M, dc), dtype=bool)
        slot = np.concatenate([np.arange(w) for w in row_w]) if E else np.zeros(0, np.int64)
        rows = np.repeat(np.arange(M), row_w)
        check_vars[rows, slot] = H.indices
        check_mask[rows, slot] = True

        # edge id in check-major flat order = position in the padded
        # [M, dc] grid of the (row-sorted) CSR stream
        flat_ids = rows * dc + slot

        # variable-major tables: edges grouped by variable, stable in check
        # order (the reference's column lists are sorted by row index)
        order = np.argsort(H.indices, kind="stable")
        var_sorted = H.indices[order]
        ids_sorted = flat_ids[order]
        var_edge_ids = np.full((N, dv), M * dc, dtype=np.int32)
        var_mask = np.zeros((N, dv), dtype=bool)
        vslot = np.concatenate([np.arange(w) for w in col_w]) if E else np.zeros(0, np.int64)
        var_edge_ids[var_sorted, vslot] = ids_sorted
        var_mask[var_sorted, vslot] = True

        # edge_perm: padded-check-major edge id -> flat var-major position
        perm = np.full(M * dc, N * dv, dtype=np.int32)
        perm[ids_sorted] = var_sorted * dv + vslot

        regular = bool(np.all(row_w == dc) and np.all(col_w == dv))
        blocked = BlockedCode.detect(H) if detect_blocked and regular else None
        return cls(
            blocked=blocked,
            n_checks=M,
            n_vars=N,
            dc_max=dc,
            dv_max=dv,
            n_edges=int(E),
            check_vars=check_vars,
            check_mask=check_mask,
            var_edge_ids=var_edge_ids,
            var_mask=var_mask,
            edge_perm=perm,
            edge_var=check_vars.reshape(-1),
            regular=regular,
        )

    def to(self, device) -> GraphTensors:
        """The gather tables as torch tensors on ``device`` (cached per
        graph instance and device)."""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_tensors", {})
        if device not in cache:
            as_t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
            cache[device] = GraphTensors(
                check_vars=as_t(self.check_vars),
                check_mask=torch.as_tensor(self.check_mask, device=device),
                var_edge_ids=as_t(self.var_edge_ids),
                edge_perm=as_t(self.edge_perm),
            )
        return cache[device]


def graph_from_reference(ref) -> LdpcGraph:
    """Build the port's graph from another graph object's numpy tables
    (``check_vars``, ``check_mask``, ``var_edge_ids``, ``var_mask``,
    ``edge_perm`` and, when blocked, ``blocked.pi`` with its
    ``canonical_gather()`` / ``external_gather()``), so that a test can
    run both packages' decoders on identical tables."""
    check_vars = np.asarray(ref.check_vars, np.int32)
    check_mask = np.asarray(ref.check_mask, bool)
    var_edge_ids = np.asarray(ref.var_edge_ids, np.int32)
    var_mask = np.asarray(ref.var_mask, bool)
    M, dc = check_vars.shape
    N, dv = var_edge_ids.shape
    blocked = None
    rb = getattr(ref, "blocked", None)
    if rb is not None:
        ext = np.asarray(rb.external_gather(), np.int32)
        blocked = BlockedCode(
            n_checks=M, n_vars=N, q=int(rb.q), G=int(rb.G), J=int(rb.J),
            pi=np.asarray(rb.pi, np.int32), col_to_canonical=ext,
        )
        if not np.array_equal(blocked.canonical_gather(), np.asarray(rb.canonical_gather())):
            raise ValueError("reference canonical_gather is not the inverse of external_gather")
    return LdpcGraph(
        n_checks=M,
        n_vars=N,
        dc_max=dc,
        dv_max=dv,
        n_edges=int(check_mask.sum()),
        check_vars=check_vars,
        check_mask=check_mask,
        var_edge_ids=var_edge_ids,
        var_mask=var_mask,
        edge_perm=np.asarray(ref.edge_perm, np.int32),
        edge_var=check_vars.reshape(-1),
        regular=bool(check_mask.all() and var_mask.all()),
        blocked=blocked,
    )
