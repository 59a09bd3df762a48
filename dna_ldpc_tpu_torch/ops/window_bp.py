"""The BP of an SC-LDPC window: one CUDA kernel launch a window.

``decode`` is the windowed decoders' one entry (``ops/scldpc.py``:
``sliding_window_decode`` and ``pipeline_decode``). The input's device
routes it, with no setting and no fallback:

- a CUDA tensor launches ``csrc/window_bp.cu``: one thread block per
  frame runs every iteration of the window, each frame leaving at its own
  first zero syndrome. The kernel takes float32 LLRs on a graph of check
  degree 6 and variable degrees up to 3 whose whole decoding state fits
  one block's shared memory (``fits``: the messages of every check slot,
  the posteriors and the LLRs, a function of the graph's checks,
  variables and degrees alone), as every window graph the port runs
  does; it raises a ``ValueError`` for anything else, so that the card
  never decodes a window eagerly unseen;
- a CPU tensor takes ``bp.bp_decode_generic``, the eager gather decoder.

The kernel forms the check update as ``bp_decode_generic`` does (the
exclusive product from log-magnitude sums, sign and zero counts, the clip
at 1 - eps(float32), ``log1p(te) - log1p(-te)``) and takes its sums in
torch's order on the card, so ``bp_decode_generic`` is its plain version:
the CPU runs it, and the card tests hold the kernel to it. The results
are a ``BpResult`` with ``bp_decode_generic``'s semantics: bits latched at
the first zero syndrome or at ``max_iter``, iterations, unsat.

Counts on the innermost open span (``utils/profiling.py``): ``kernel`` 1
for a window the kernel decoded. The eager loop (``bp._iterate``) counts
``iterations`` (its loop's) and ``edge_iterations`` (the edges times the
frames live in each iteration) itself; the kernel's side counts the same
two (the frames' largest iteration count; their sum times the edges) from
a copy of the frames' counts that the host reads when the record closes
(``profiling.count_at_close``), after the call's own download: the host
never waits for a window, traced or not.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.ldpc_graph import LdpcGraph
from ..utils.profiling import count, count_at_close
from .bp import BpResult, _tanh_clip, bp_decode_generic

launches = 0  # window kernel launches since import (main-path evidence)

SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100 (227 KB)
DC, MAX_DV = 6, 3  # the check degree and the largest variable degree the kernel is built for
PAD = 0xFFFF  # a pad slot in the kernel's uint16 tables


def smem_bytes(graph: LdpcGraph) -> int:
    """Shared memory of one frame's state: float32 messages of every check
    slot, posteriors and LLRs, and the kernel's unsat counter."""
    return 4 * (graph.n_checks * graph.dc_max + 2 * graph.n_vars) + 16


def fits(graph: LdpcGraph) -> bool:
    """Whether the kernel takes this graph: degrees it is built for, and a
    frame's state within one block's shared memory (then every index fits
    the uint16 tables)."""
    return graph.dc_max == DC and 1 <= graph.dv_max <= MAX_DV and smem_bytes(graph) <= SMEM_LIMIT


def kernel_tables(graph: LdpcGraph) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's uint16 tables: ``check_vars`` [dc, M], the variable of
    each check slot, and ``var_slots`` [dv, N], the message index k * M + c
    of each variable's slot (check c's slot k, in the graph's table order);
    ``PAD`` where a row has no slot."""
    M, dc = graph.n_checks, graph.dc_max
    check_vars = np.where(graph.check_mask, graph.check_vars, PAD).T
    e = graph.var_edge_ids.astype(np.int64)  # check-major edge id c * dc + k
    var_slots = np.where(graph.var_mask, (e % dc) * M + e // dc, PAD).T
    return np.ascontiguousarray(check_vars, np.uint16), np.ascontiguousarray(var_slots, np.uint16)


def _device_tables(graph: LdpcGraph, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``kernel_tables`` on ``device`` (as int16 bits), cached per graph and device."""
    cache = graph.__dict__.setdefault("_window_bp_tables", {})
    if device not in cache:
        cache[device] = tuple(torch.from_numpy(t.view(np.int16)).to(device) for t in kernel_tables(graph))
    return cache[device]


def decode(graph: LdpcGraph, llr: torch.Tensor, max_iter: int = 200, early_stop: bool = True) -> BpResult:
    """BP of the frames ``llr`` [B, N] (rows may be strided) on a window
    graph, on ``llr``'s device: the kernel on the card (a ``ValueError``
    for an input it does not take), ``bp_decode_generic`` on the CPU
    (module docstring)."""
    if llr.device.type == "cuda":
        return _kernel(graph, llr, max_iter, early_stop)
    return bp_decode_generic(graph, llr, max_iter, early_stop=early_stop)


def _kernel(graph: LdpcGraph, llr: torch.Tensor, max_iter: int, early_stop: bool,
            post: torch.Tensor | None = None) -> BpResult:
    """One launch of the window kernel on ``llr`` (float32 [B, N] on the
    card). ``post``, where given (float32 [B, N], contiguous), receives
    each frame's posteriors at its exit."""
    global launches
    from .. import cuda_lib

    if not fits(graph):
        raise ValueError(
            f"the window kernel does not take this graph: check degree {graph.dc_max}, variable degree "
            f"{graph.dv_max}, {smem_bytes(graph)} bytes of state a frame; it takes check degree {DC}, variable "
            f"degrees 1-{MAX_DV} and {SMEM_LIMIT} bytes (227 KB)")
    if llr.dim() != 2 or llr.shape[1] != graph.n_vars or llr.dtype != torch.float32:
        raise ValueError(f"llr must be float32 [B, {graph.n_vars}], got {llr.dtype} {tuple(llr.shape)}")
    if llr.stride(1) != 1:
        llr = llr.contiguous()
    B, N, dev = llr.shape[0], graph.n_vars, llr.device
    if post is not None and (post.shape != (B, N) or post.dtype != torch.float32 or not post.is_contiguous()
                             or post.device != dev):
        raise ValueError(f"post must be contiguous float32 [{B}, {N}] on {dev}")
    check_vars, var_slots = _device_tables(graph, dev)
    bits = torch.empty((B, N), dtype=torch.uint8, device=dev)
    success = torch.empty(B, dtype=torch.bool, device=dev)
    counts = torch.empty((2, B), dtype=torch.int32, device=dev)
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        status = lib.window_bp_launch(
            llr.data_ptr(), llr.stride(0), check_vars.data_ptr(), var_slots.data_ptr(), B, graph.n_checks, N,
            graph.dc_max, graph.dv_max, int(max_iter), int(early_stop), _tanh_clip(torch.float32, None),
            bits.data_ptr(), success.data_ptr(), counts[0].data_ptr(), counts[1].data_ptr(),
            None if post is None else post.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_lib.check(status, "window_bp_launch")
    if B:
        launches += 1
        count("kernel")
        edges = graph.n_edges
        count_at_close(counts[0], lambda its: {"iterations": int(its.max()),
                                               "edge_iterations": int(its.sum()) * edges})
    return BpResult(bits=bits, success=success, iterations=counts[0], unsat=counts[1])
