"""Fused blocked-code BP: the CUDA kernel K1 and its plain torch twin.

``bp_decode_blocked`` replaces the TPU kernel
``dna_ldpc_tpu/ops/bp_pallas.py::_bp_kernel`` (launched by
``_bp_pallas_call``; entry ``bp_decode_blocked_pallas``). On a CUDA
tensor it launches ``csrc/bp_blocked.cu`` (one thread block per codeword,
see the design notes there); on a CPU tensor it runs
``bp_decode_blocked_ref``, the same arithmetic as plain torch ops. There
is no fallback between the two: a CUDA tensor launches the kernel or
raises.

Semantics of the TPU kernel, kept rounding point for rounding point:
NaN LLRs become -1e-30 and values are clipped to the finite range;
messages are bf16 tanh-domain values ``t = bf16(tanh(v / 2))`` with
``v0 = bf16(llr)``; the check update is an exact forward/backward
exclusive product of the bf16 ``t`` in f32, clipped to +-(1 - 1e-5), and
``c2v = bf16(log((1 + te) / (1 - te)))``; the posterior is
``llr + sum_g c2v`` summed in f32 in coset order; decisions are
``!(post > 0)``; parity comes from ``!(bf16(post) > 0)``; results latch at
the first zero syndrome, capped at ``max_iter``. ``early_stop=False`` is
the TPU kernel's fixed-work mode: every codeword runs all ``max_iter``
iterations and its results still latch at the first zero syndrome, so the
outputs equal the early-stopped ones word for word.

What bounds the kernel on the card: the per-check sequential sweeps over
the J column groups, at one 8-warp block per codeword (latency, not
bandwidth: ~0.6 MB of mostly L2-resident traffic per codeword and
iteration).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.blocked import BlockedCode
from .bp import BpResult

# te is clipped so c2v survives bf16 tanh-domain storage (the TPU
# kernel's _TE_CLIP, as the float32 value its clip compares against)
TE_CLIP = float(np.float32(1.0 - 1e-5))
SMEM_LIMIT = 232448  # bytes of shared memory one block can use (sm_90)

launches = 0  # kernel launches since the last reset (main-path evidence)


@dataclasses.dataclass(frozen=True)
class _CodeTensors:
    pi: torch.Tensor      # [G, J, q] int32: variable of check r in block (g, j)
    pinv: torch.Tensor    # [G, J, q] int64: check of variable v in block (g, j)
    canon: torch.Tensor   # [N] int64: llr_canonical = llr_external[:, canon]
    ext: torch.Tensor     # [N] int64: bits_external = bits_canonical[:, ext]


def _tables(code: BlockedCode, device: torch.device) -> _CodeTensors:
    cache = code.__dict__.setdefault("_torch_tables", {})
    if device not in cache:
        pi = np.asarray(code.pi, np.int32)
        cache[device] = _CodeTensors(
            pi=torch.as_tensor(pi, device=device),
            pinv=torch.as_tensor(np.argsort(pi, axis=-1), device=device),
            canon=torch.as_tensor(np.asarray(code.canonical_gather(), np.int64), device=device),
            ext=torch.as_tensor(np.asarray(code.external_gather(), np.int64), device=device),
        )
    return cache[device]


def _sanitize(llr: torch.Tensor) -> torch.Tensor:
    """NaN -> -1e-30 (the reference's NaN -> bit 1 rule), +-inf clipped."""
    llr = llr.to(torch.float32)
    big = float(torch.finfo(torch.float32).max)
    return torch.where(torch.isnan(llr), torch.full_like(llr, -1e-30), llr.clamp(-big, big))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def bp_decode_blocked_ref(
    code: BlockedCode, llr: torch.Tensor, max_iter: int = 200, early_stop: bool = True
) -> BpResult:
    """Plain torch twin of the K1 kernel, on ``llr``'s device. llr: [B, N]
    in the code's external column order."""
    B = llr.shape[0]
    G, J, q = code.G, code.J, code.q
    tabs = _tables(code, llr.device)
    lc = _sanitize(llr)[:, tabs.canon].reshape(B, J, q)
    route_idx = tabs.pi.long().unsqueeze(0).expand(B, G, J, q)
    back_idx = tabs.pinv.unsqueeze(0).expand(B, G, J, q)

    def to_checks(x):  # [B, J, q(v)] -> [B, G, J, q(r)]
        return torch.gather(x.unsqueeze(1).expand(B, G, J, q), 3, route_idx)

    def to_vars(y):  # [B, G, J, q(r)] -> [B, G, J, q(v)]
        return torch.gather(y, 3, back_idx)

    def unsat_of(bits_pc):  # [B, G, J, q] bool decisions at the check side
        return (bits_pc.int().sum(2) % 2).sum((1, 2)).to(torch.int32)

    v0 = to_checks(_bf16(lc))
    t = torch.tanh(v0 * 0.5).to(torch.bfloat16)
    unsat = unsat_of(v0 < 0)
    bits = (lc < 0).to(torch.uint8)
    done = unsat == 0
    iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
    n = 0
    while n < max_iter and not (early_stop and bool(done.all())):
        tf = t.float()
        # exclusive products over the J edges of each check, as the
        # kernel's two sweeps (same f32 multiplication order)
        acc = torch.ones_like(tf[:, :, 0])
        bwd = [acc] * J
        for j in range(J - 2, -1, -1):
            acc = tf[:, :, j + 1] * acc
            bwd[j] = acc
        F = torch.ones_like(acc)
        te = []
        for j in range(J):
            te.append(F * bwd[j])
            F = F * tf[:, :, j]
        te = torch.stack(te, 2).clamp(-TE_CLIP, TE_CLIP)
        c2v = _bf16(torch.log((1.0 + te) / (1.0 - te)))
        cv = to_vars(c2v)
        post = lc
        for g in range(G):  # coset order, as the kernel accumulates
            post = post + cv[:, g]
        bits = torch.where(done[:, None, None], bits, (~(post > 0)).to(torch.uint8))
        postpc = to_checks(_bf16(post))
        t = torch.tanh((postpc - c2v) * 0.5).to(torch.bfloat16)
        new_unsat = unsat_of(~(postpc > 0))
        unsat = torch.where(done, unsat, new_unsat)
        iters = torch.where(done, iters, torch.full_like(iters, n + 1))
        done = done | (new_unsat == 0)
        n += 1
    bits = bits.reshape(B, J * q)[:, tabs.ext]
    return BpResult(bits=bits, success=unsat == 0, iterations=iters, unsat=unsat)


def _bp_decode_blocked_cuda(code: BlockedCode, llr: torch.Tensor, max_iter: int, early_stop: bool) -> BpResult:
    global launches
    from .. import cuda_lib

    G, J, q = code.G, code.J, code.q
    if q > 1024 or 2 * J * q * 4 > SMEM_LIMIT:
        raise ValueError(f"blocked code {G}x{J}x{q} exceeds one block's threads or shared memory")
    B = llr.shape[0]
    tabs = _tables(code, llr.device)
    llr_c = _sanitize(llr)[:, tabs.canon].contiguous()
    msg = torch.empty((B, G, J, q), dtype=torch.bfloat16, device=llr.device)
    bits_c = torch.empty((B, J * q), dtype=torch.uint8, device=llr.device)
    unsat = torch.empty(B, dtype=torch.int32, device=llr.device)
    iters = torch.empty(B, dtype=torch.int32, device=llr.device)
    lib = cuda_lib.load()
    with torch.cuda.device(llr.device):
        status = lib.bp_blocked_launch(
            llr_c.data_ptr(), tabs.pi.data_ptr(), msg.data_ptr(), bits_c.data_ptr(),
            unsat.data_ptr(), iters.data_ptr(), B, G, J, q, int(max_iter), int(early_stop), TE_CLIP,
            torch.cuda.current_stream(llr.device).cuda_stream,
        )
    cuda_lib.check(status, "bp_blocked_launch")
    if B:
        launches += 1
    bits = bits_c[:, tabs.ext]
    return BpResult(bits=bits, success=unsat == 0, iterations=iters, unsat=unsat)


def bp_decode_blocked(
    code: BlockedCode, llr: torch.Tensor, max_iter: int = 200, early_stop: bool = True
) -> BpResult:
    """Decode LLRs [B, N] (external column order) of a blocked code:
    the K1 kernel on a CUDA tensor, the plain twin on a CPU tensor."""
    if llr.dim() != 2 or llr.shape[1] != code.n_vars:
        raise ValueError(f"llr must be [B, {code.n_vars}], got {tuple(llr.shape)}")
    if llr.device.type == "cpu":
        return bp_decode_blocked_ref(code, llr, max_iter, early_stop)
    if llr.device.type != "cuda":
        raise ValueError(f"unsupported device {llr.device}")
    return _bp_decode_blocked_cuda(code, llr, max_iter, early_stop)
