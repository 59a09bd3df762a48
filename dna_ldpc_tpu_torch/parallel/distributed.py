"""Multi-process distribution layer.

Port of ``dna_ldpc_tpu/parallel/distributed.py``, the replacement for the
reference's compiled-out MPI backend (``LDPC_dec/ldpc/DNA_main.cpp:12``
mpi.h include, ``:1187-1193`` COLLECT_MPI MPI_Reduce of error counters,
``:629-651`` Set_FrameNum per-rank frame split): ``torch.distributed``
initialisation from torchrun's environment, a mesh over every rank with
the ``graph`` axis inside one node, the per-rank trial split, and the
gather of a sharded result.

One process drives one device. Launch N ranks per node with torchrun,
which sets ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``:

    torchrun --nproc-per-node 8 script.py   # script: initialize(); mesh = global_mesh(); ...

With the global mesh the sharded decoders of ``parallel/sharded_bp.py``
run unchanged across nodes: their per-iteration all-reduce rides the
node's own links for the graph axis, and the codeword axis spans nodes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.bp import BpResult
from ..utils.device import DEFAULT_DEVICE, require_device
from .mesh import CW_AXIS, GRAPH_AXIS, llr_sharding, mesh_device


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Initialise the default process group.

    Arguments default to torchrun's environment (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), so a launcher configures
    ranks purely through the environment — the role argv/mpiexec played
    for the reference's MPI scaffolding. ``coordinator_address`` is
    ``host:port`` or any ``init_method`` URL (``tcp://``, ``file://``).
    ``backend`` defaults to ``nccl`` on the card, whose rank then takes
    device ``LOCAL_RANK``; name ``gloo`` for CPU ranks. No-op when the
    group is already initialised or there is one process."""
    import torch.distributed as dist

    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if dist.is_initialized() or coordinator_address is None or not num_processes or num_processes <= 1:
        return
    backend = backend or "nccl"
    if backend == "nccl":
        require_device("cuda")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id)))
    init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes, rank=process_id)


def global_mesh(max_graph: int = 8, device_type: str = DEFAULT_DEVICE):
    """A (cw, graph) mesh over every rank, the ``graph`` axis (the
    per-iteration all-reduce) inside one node: shape
    [world // g, g] with g the largest power-of-two divisor of the ranks
    per node (``LOCAL_WORLD_SIZE``; all ranks when it is unset) that is
    <= max_graph. The ``cw`` axis therefore spans nodes — codeword batches
    are the distributed dimension, exactly the reference's per-rank frame
    split (Set_FrameNum)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    require_device(device_type)
    world = dist.get_world_size()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    g = 1
    while g * 2 <= max_graph and n_local % (g * 2) == 0:
        g *= 2
    return init_device_mesh(device_type, (world // g, g), mesh_dim_names=(CW_AXIS, GRAPH_AXIS))


def split_trials(n_trials: int, num_processes: int, process_id: int) -> range:
    """Per-rank trial partition (Set_FrameNum, DNA_main.cpp:629-651):
    near-equal contiguous blocks, remainder spread over the first ranks."""
    base, rem = divmod(n_trials, num_processes)
    start = process_id * base + min(process_id, rem)
    return range(start, start + base + (1 if process_id < rem else 0))


def process_local_batch(global_batch: np.ndarray, mesh) -> torch.Tensor:
    """This rank's rows of a [B, ...] host batch on its device. Every
    process passes the FULL batch (or at least its own rows); rows are
    laid out over the ``cw`` axis and replicated over ``graph``."""
    rows = llr_sharding(mesh, global_batch.shape[0])
    return torch.as_tensor(np.ascontiguousarray(global_batch[rows]), device=mesh_device(mesh))


def allgather_result(result: BpResult, mesh) -> BpResult:
    """The whole batch's result on every rank, from each rank's rows: an
    all-gather of every field over the ``cw`` group, in rank order (the
    ``graph`` group already holds one copy of its rows) — the counterpart
    of ``multihost_utils.process_allgather(..., tiled=True)``. Booleans
    travel as uint8."""
    import torch.distributed as dist

    group = mesh.get_group(CW_AXIS)
    size = mesh.size(mesh.mesh_dim_names.index(CW_AXIS))

    def gather(x):
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(wire) for _ in range(size)]
        dist.all_gather(parts, wire, group=group)
        return torch.cat(parts).to(x.dtype)

    return BpResult(bits=gather(result.bits), success=gather(result.success),
                    iterations=gather(result.iterations), unsat=gather(result.unsat))

