"""Additional batched LDPC decoders: min-sum family, Gallager A/B, BEC
peeling — the rest of the reference's decoder zoo (``LDPC_dec/ldpc/
dec.cpp``).

Port of ``dna_ldpc_tpu/ops/decoders.py`` as plain torch on the input's
device, over the same dense edge tables as the generic BP decoder:

- ``min_sum_decode``: the float min-sum of ``Run_MSA_Decoder_INF``
  (dec.cpp :1357-1436): check message = product of signs x min magnitude
  over the other edges, with optional offset and normalization; decision
  sum > 0 -> 0; zero-LLR init ties broken by seeded random bits;
- ``quantized_min_sum_decode``: the same on integer LLR levels
  (``Cal_MSA_Q``), with the uniform, quasi-uniform and reference-stub
  quantizers;
- ``gallager_decode``: Gallager A/B/majority on +/-1 int8 messages
  (Run_Gallager_Decoder, dec.cpp:699-835), counts in int32;
- ``bec_peel``: erasure-channel peeling (dec.cpp:243-580); its rounds,
  ``peel_values``, are also the step of the windowed BEC decoders
  (``ops/scldpc.py``).

All but peeling run the generic BP decoder's loop (``bp._iterate``, the
reference's control flow: syndrome check before each iteration, stop at
zero syndrome or max_iter, per-codeword result latching across the batch,
one host sync per iteration) with their own check and variable updates.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.ldpc_graph import LdpcGraph
from .bp import BpResult, _gather_checkmajor, _iterate, _posterior_update, _syndrome_unsat
from .channels import ERASE_MARK  # also decoders.ERASE_MARK, as in the JAX package


def sign_min_update(v2c: torch.Tensor, check_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exclusive sign and min magnitude of each check edge over the other
    edges. v2c: [B, M, dc] (padded slots arbitrary); returns (sign, excl_min)
    [B, M, dc]. The minimum is the first one (argmin), its exclusive value
    the second smallest magnitude."""
    dc = v2c.shape[-1]
    inf = torch.tensor(float("inf"), dtype=v2c.dtype, device=v2c.device)
    mag = torch.where(check_mask[None], v2c.abs(), inf)
    neg = check_mask[None] & (v2c < 0)
    min1 = mag.min(-1, keepdim=True).values
    is_min = torch.nn.functional.one_hot(mag.argmin(-1), dc).bool()
    min2 = torch.where(is_min, inf, mag).min(-1, keepdim=True).values
    excl_min = torch.where(is_min, min2, min1)
    excl_neg = neg.sum(-1, keepdim=True) - neg.long()
    sign = 1.0 - 2.0 * (excl_neg % 2).to(v2c.dtype)
    return sign, excl_min


def _min_sum(
    graph: LdpcGraph, llr: torch.Tensor, tie_bits: torch.Tensor, max_iter: int, offset: float, normalize: float
) -> BpResult:
    """Min-sum with the zero-LLR tie bits given (``_min_sum_jit``'s decode)."""
    tabs = graph.to(llr.device)
    bits = torch.where(llr == 0, tie_bits.to(torch.uint8), (llr < 0).to(torch.uint8))

    def check_update(v):
        sign, excl_min = sign_min_update(v, tabs.check_mask)
        return sign * (torch.clamp(excl_min - offset, min=0.0) * normalize)

    # decision sum > 0 -> 0, as BP's
    return _iterate(graph, bits, _gather_checkmajor(llr, tabs.check_vars), max_iter, check_update,
                    _posterior_update(llr))


def _tie_bits(shape, tie_seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(tie_seed)
    return (torch.rand(shape, generator=gen, device=device) < 0.5).to(torch.uint8)


def min_sum_decode(
    graph: LdpcGraph,
    llr: torch.Tensor,
    max_iter: int = 200,
    offset: float = 0.0,
    normalize: float = 1.0,
    tie_seed: int = 0,
) -> BpResult:
    """Float min-sum with optional offset/normalization. llr: [B, N] on
    the device the decode runs on."""
    llr = torch.atleast_2d(llr)
    tie = _tie_bits(llr.shape, tie_seed, llr.device)
    return _min_sum(graph, llr, tie, max_iter, float(offset), float(normalize))


def quantize_llr(llr: torch.Tensor, precision: int, step: float) -> torch.Tensor:
    """Uniform LLR quantizer of the reference (Cal_MSA_Q, dec.cpp:
    1708-1765 / Set_MSA): integer levels round(LLR/step) (half to even)
    clipped to +/-(2^(precision-1) - 1)."""
    lim = float((1 << (precision - 1)) - 1)
    return torch.round(llr / step).clamp(-lim, lim)


def quantize_llr_quasi_uniform(
    llr: torch.Tensor,
    precision: int,
    step: float,
    uniform_levels: int | None = None,
    growth: float = 2.0,
) -> torch.Tensor:
    """Quasi-uniform LLR quantizer: uniform spacing ``step`` for the inner
    ``uniform_levels`` levels (default: half the level range), geometrically
    growing decision thresholds (factor ``growth``) for the outer levels.
    The reference's DECODER_MSA_QUASI_UNIFORM branch is an empty stub
    (dec.cpp:1737-1740); ``quantize_llr_reference_stub`` keeps that literal
    behavior."""
    lim = (1 << (precision - 1)) - 1
    nu = uniform_levels if uniform_levels is not None else max(1, lim // 2)
    nu = min(nu, lim)
    # decision thresholds t_k, k = 1..lim: level k chosen when |x| >= t_k
    t = np.empty(lim, np.float64)
    for k in range(1, nu + 1):
        t[k - 1] = (k - 0.5) * step          # reference uniform rounding
    for k in range(nu + 1, lim + 1):
        t[k - 1] = t[nu - 1] * growth ** (k - nu)
    thr = torch.as_tensor(t, device=llr.device).to(llr.dtype)
    k = (llr.abs()[..., None] >= thr).sum(-1)
    return torch.sign(llr) * k.to(llr.dtype)


def quantize_llr_reference_stub(llr: torch.Tensor) -> torch.Tensor:
    """The literal behavior of the reference's quasi-uniform branch
    (``Cal_MSA_Q(x, 1)``, dec.cpp:1737-1740): every LLR maps to level 0."""
    return torch.zeros_like(llr)


def quantized_min_sum_decode(
    graph: LdpcGraph,
    llr: torch.Tensor,
    precision: int = 5,
    step: float = 0.5,
    max_iter: int = 200,
    offset: float = 0.0,
    tie_seed: int = 0,
    quantizer: str = "uniform",
) -> BpResult:
    """Quantized offset min-sum (Run_MSA_Decoder, dec.cpp:1174-1436):
    channel LLRs quantized to ``precision``-bit integer levels of step
    ``step``; the integer ``offset`` is subtracted in the check update.
    Message arithmetic runs on the integer levels carried in f32 (exact
    for these magnitudes). ``quantizer``: "uniform", "quasi-uniform" or
    "reference-quasi-stub"."""
    llr = torch.atleast_2d(llr.to(torch.float32))
    if quantizer == "uniform":
        q = quantize_llr(llr, precision, step)
    elif quantizer == "quasi-uniform":
        q = quantize_llr_quasi_uniform(llr, precision, step)
    elif quantizer == "reference-quasi-stub":
        q = quantize_llr_reference_stub(llr)
    else:
        raise ValueError(f"unknown quantizer {quantizer!r}")
    return _min_sum(graph, q, _tie_bits(q.shape, tie_seed, q.device), max_iter, float(offset), 1.0)


def _gallager_thresholds(dv: int, variant: int) -> tuple[int, int]:
    """(b_var, b_dec) of Variable_Update_Gallager / Decision_Gallager."""
    if variant == 0:      # Gallager A
        return dv - 1, dv
    if variant == 1:      # Gallager B (strength 1)
        return dv - 2, dv - 1
    return dv // 2 + dv % 2, dv // 2 + 1  # majority variant


def gallager_decode(graph: LdpcGraph, hard_bits: torch.Tensor, max_iter: int = 200, variant: int = 0) -> BpResult:
    """Gallager A (variant 0) / B (1) / majority (2). hard_bits: [B, N]
    0/1 channel hard decisions."""
    recv = (1 - 2 * torch.atleast_2d(hard_bits).to(torch.int8)).to(torch.int8)
    tabs = graph.to(recv.device)
    b_var, b_dec = _gallager_thresholds(graph.dv_max, variant)
    one = torch.ones((), dtype=torch.int8, device=recv.device)

    def check_update(v):
        neg = torch.where(tabs.check_mask[None], v, one) < 0
        excl_neg = neg.sum(-1, keepdim=True, dtype=torch.int32) - neg.int()
        return (1 - 2 * (excl_neg % 2)).to(torch.int8)

    def var_update(cv):
        flipped = cv == -recv[:, :, None]  # message == -m0
        agree = flipped.sum(-1, dtype=torch.int32)  # [B, N]
        excl = agree[:, :, None] - flipped.int()  # per-edge exclusive count
        v2c_vm = torch.where(excl >= b_var, -recv[:, :, None], recv[:, :, None]).to(torch.int8)
        return v2c_vm, (torch.where(agree >= b_dec, -recv, recv) < 0).to(torch.uint8)

    return _iterate(graph, (recv < 0).to(torch.uint8), _gather_checkmajor(recv, tabs.check_vars), max_iter,
                    check_update, var_update)


def _peel(graph: LdpcGraph, vals: torch.Tensor, max_iter: int) -> tuple[torch.Tensor, int]:
    """Peeling rounds on int8 values [B, N] (0/1 known, 2 erased) until
    ``max_iter`` rounds or a round that changes nothing; returns the
    values and the rounds run. Each round solves every check with exactly
    one erased variable; checks that cannot solve write to a dummy slot N.
    Two checks solving one variable write the same value on the BEC, so
    the order of the scatter never shows. One host sync per round."""
    tabs = graph.to(vals.device)
    B = vals.shape[0]
    M, N, dc = graph.n_checks, graph.n_vars, graph.dc_max
    cv_idx = tabs.check_vars.clamp(min=0)
    zero = torch.zeros((), dtype=torch.int8, device=vals.device)
    n, changed = 0, True
    while n < max_iter and changed:
        g = torch.where(tabs.check_mask[None], _gather_checkmajor(vals, tabs.check_vars).reshape(B, M, dc), zero)
        erased = g == ERASE_MARK
        n_erased = erased.sum(-1)  # [B, M]
        known_parity = torch.where(erased, zero, g).sum(-1, dtype=torch.int32) % 2
        var_of = torch.where(erased, cv_idx[None], 0).sum(-1)
        target = torch.where(n_erased == 1, var_of, N)  # dummy slot N
        upd = torch.full((B, N + 1), ERASE_MARK, dtype=torch.int8, device=vals.device)
        upd.scatter_(1, target, known_parity.to(torch.int8))
        upd = upd[:, :N]
        new_vals = torch.where((vals == ERASE_MARK) & (upd != ERASE_MARK), upd, vals)
        changed = bool((new_vals != vals).any())
        vals = new_vals
        n += 1
    return vals, n


def peel_values(graph: LdpcGraph, values: torch.Tensor, max_iter: int) -> torch.Tensor:
    """BEC peeling on ``values``' device, returning the values themselves
    (int8 [B, N]: bits where resolved, 2 where still erased) — the step
    the windowed BEC decoders of ``ops/scldpc.py`` share with
    ``bec_peel`` (the JAX package's ``scldpc._peel_values``)."""
    return _peel(graph, torch.atleast_2d(values).to(torch.int8), max_iter)[0]


def bec_peel(graph: LdpcGraph, values: torch.Tensor, max_iter: int = 200) -> BpResult:
    """Peeling decoder for the binary erasure channel. values: [B, N] with
    0/1 known bits and 2 marking erasures (``peel_values``' rounds)."""
    vals, n = _peel(graph, torch.atleast_2d(values).to(torch.int8), max_iter)
    B = vals.shape[0]
    tabs = graph.to(vals.device)
    bits = vals.masked_fill(vals == ERASE_MARK, 0).to(torch.uint8)
    unsat = _syndrome_unsat(bits.long(), tabs.check_vars, tabs.check_mask)
    resolved = ~(vals == ERASE_MARK).any(1)
    return BpResult(
        bits=bits,
        success=resolved & (unsat == 0),
        iterations=torch.full((B,), n, dtype=torch.int32, device=vals.device),
        unsat=unsat,
    )
