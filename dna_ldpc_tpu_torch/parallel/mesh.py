"""Device mesh construction for the decoding framework.

Port of ``dna_ldpc_tpu/parallel/mesh.py``, the replacement for the
reference's (compiled-out) MPI frame parallelism
(``LDPC_dec/ldpc/DNA_main.cpp:1187-1193``, ``Set_FrameNum`` per-rank
splitting at ``:629-651``): a 2-D ``DeviceMesh`` over the ranks of the
default process group, one rank per device, with

- axis ``cw``    — codeword/trial batch data parallelism (the domain's DP;
  replaces the 272-sequential-process loop, decoder.py:553-558), meant to
  span hosts;
- axis ``graph`` — Tanner-graph parallelism: checks partitioned across
  ranks (cosets of the RS-LDPC construction give perfectly balanced
  shards), message sums all-reduced over the axis's process group.

Ranks lie row-major on the mesh, so a ``graph`` group is consecutive
ranks. Where the JAX package gives an array a ``NamedSharding``, a rank
here takes its own slice of the rows (``llr_sharding`` /
``check_sharding``).
"""

from __future__ import annotations

import torch

from ..utils.device import DEFAULT_DEVICE, require_device

CW_AXIS = "cw"
GRAPH_AXIS = "graph"


def mesh_shape(n_devices: int, n_graph: int | None = None, max_graph: int = 8) -> tuple[int, int]:
    """The (cw, graph) shape of a mesh over ``n_devices``: ``n_graph``
    defaults to the largest power-of-two divisor of the device count that
    is <= max_graph (gamma=8 cosets for the deployed code)."""
    if n_graph is None:
        n_graph = 1
        while n_graph * 2 <= max_graph and n_devices % (n_graph * 2) == 0:
            n_graph *= 2
    if n_devices % n_graph:
        raise ValueError(f"{n_devices} devices not divisible by graph axis {n_graph}")
    return n_devices // n_graph, n_graph


def build_mesh(n_graph: int | None = None, max_graph: int = 8, device_type: str = DEFAULT_DEVICE):
    """A (cw, graph) ``DeviceMesh`` over every rank of the default process
    group (initialised first, e.g. by ``distributed.initialize``), shaped
    by ``mesh_shape``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    require_device(device_type)
    shape = mesh_shape(dist.get_world_size(), n_graph, max_graph)
    return init_device_mesh(device_type, shape, mesh_dim_names=(CW_AXIS, GRAPH_AXIS))


def _block(mesh, axis: str, n: int) -> slice:
    """This rank's contiguous share of ``n`` rows split evenly over ``axis``."""
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    if n % size:
        raise ValueError(f"{n} rows do not split evenly over the {axis} axis of size {size}")
    k = mesh.get_local_rank(axis)
    return slice(k * (n // size), (k + 1) * (n // size))


def llr_sharding(mesh, n_rows: int) -> slice:
    """This rank's codeword rows of an [n_rows, N] batch: rows over the
    ``cw`` axis, replicated over ``graph``."""
    return _block(mesh, CW_AXIS, n_rows)


def check_sharding(mesh, n_checks: int) -> slice:
    """This rank's rows of [M, ...] check-side tables: rows over the
    ``graph`` axis."""
    return _block(mesh, GRAPH_AXIS, n_checks)


def mesh_device(mesh) -> torch.device:
    """The device this rank's shard lives on: its current CUDA device, or
    the CPU for a ``cpu`` mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
