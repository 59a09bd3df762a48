"""Finite-alphabet iterative decoders (FAID).

Port of ``dna_ldpc_tpu/ops/faid.py`` (the reference's LUT-driven FAID
family, ``LDPC_dec/ldpc/dec.cpp:837-1171``) as plain torch on the input's
device: messages live on a small symmetric level alphabet
{-L_s..-L_1, 0, L_1..L_s}; the check node is the usual sign x min rule;
the variable node is either a threshold-symmetric rule (:class:`FaidRule`,
any column weight: a quantizer over the weighted channel value plus the
exclusive message sum) or an arbitrary 2-input lookup table
(:class:`LutRule`, column weight exactly 3, the reference's own tables).
LUT indices and weight lookups are small integers carried in f32 and
converted to integer indices exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.ldpc_graph import LdpcGraph
from .bp import BpResult, _gather_checkmajor, _iterate
from .decoders import sign_min_update


@dataclasses.dataclass(frozen=True)
class FaidRule:
    """A threshold-symmetric FAID variable-node rule.

    new_level = sign(s) * levels[ #thresholds below |s| ]   with
    s = channel_weight * y + sum(incoming c2v), y = +/-C channel value.
    """

    levels: tuple          # (L1, L2, ..., Ls), positive ascending
    thresholds: tuple      # (T1, ..., Ts): |s| >= T_k -> at least level k
    channel_value: float   # C, the +/-channel magnitude
    channel_weight: float  # w applied to the channel term


def default_faid_rule() -> FaidRule:
    """7-level (3-bit) FAID for column-weight-3 codes: levels {1, 2, 3},
    channel +/-1.5 weighted 1, thresholds placed between level sums."""
    return FaidRule(
        levels=(1.0, 2.0, 3.0),
        thresholds=(0.5, 2.5, 4.5),
        channel_value=1.5,
        channel_weight=1.0,
    )


@dataclasses.dataclass(frozen=True)
class LutRule:
    """An arbitrary 2-input FAID variable-node lookup table for dv=3
    codes (``Variable_FAID_LUT``, dec.cpp:1135-1171; tables
    dec.cpp:1026-1126).

    ``table[m1+s][m2+s]`` gives the outgoing level for incoming
    check-to-variable messages (m1, m2) when the channel value is
    NEGATIVE; the y >= 0 case is the odd-symmetric image (dec.cpp:
    1148-1168). m1/m2 follow the variable node's edge order.

    Decision rule (Decision_FAID, dec.cpp:965-998):
    ``sum = C * recv + sum_k weights[|m_k|] * sign(m_k)`` with
    sign(0) = +1; sum > 0 -> bit 0, sum < 0 -> bit 1, and a tie decodes
    as bit 1 (the reference stores recv's +/-1, which its ``check()``
    reads as a set bit either way).
    """

    table: tuple            # (2s+1) rows of (2s+1) ints, y < 0 convention
    channel_value: float    # C: 0.5 (type_FAID_weight == 0) or 1.5
    weights: tuple | None = None  # weights[mag], mag 0..s; default all 1

    @property
    def s(self) -> int:
        return (len(self.table) - 1) // 2


# Published LUTs shipped by the reference (dec.cpp FAID_LUT_2 / FAID_LUT_3,
# active — i.e. non-commented — entries, in type_FAID order):
FAID_TABLES: dict[str, tuple] = {
    # "Finite alphabet iterative decoders for LDPC codes surpassing
    # floating-point iterative decoders", Table 1 (5-level)
    "planjery5_t1": (
        (-2, -2, -2, -2, 0),
        (-2, -2, -2, -1, 0),
        (-2, -2, -1, 0, 1),
        (-2, -1, 0, 0, 1),
        (0, 0, 1, 1, 2),
    ),
    # "Finite Alphabet Iterative Decoding of the (155,64,20) Tanner
    # Code", Table V (5-level)
    "tanner5_t5": (
        (-2, -2, -2, -2, 0),
        (-2, -2, -1, -1, 1),
        (-2, -1, -1, 0, 1),
        (-2, -1, 0, 1, 2),
        (0, 1, 1, 2, 2),
    ),
    # "surpassing floating-point", Table 2 (7-level) — NOT expressible as
    # a threshold rule: e.g. rows are not translates of each other
    "planjery7_t2": (
        (-3, -3, -3, -3, -3, -3, -1),
        (-3, -3, -3, -3, -2, -1, 1),
        (-3, -3, -2, -2, -1, -1, 1),
        (-3, -3, -2, -1, 0, 0, 1),
        (-3, -2, -1, 0, 0, 1, 2),
        (-3, -1, -1, 0, 1, 1, 3),
        (-1, 1, 1, 1, 2, 3, 3),
    ),
    # "(155,64,20) Tanner Code", Table VIII (7-level)
    "tanner7_t8": (
        (-3, -3, -3, -3, -3, -3, -1),
        (-3, -3, -3, -3, -2, -1, 1),
        (-3, -3, -2, -2, -1, 0, 1),
        (-3, -3, -2, -1, -1, 1, 2),
        (-3, -2, -1, -1, 0, 1, 2),
        (-3, -1, 0, 1, 1, 1, 2),
        (-1, 1, 1, 2, 2, 2, 3),
    ),
    # third active 7-level entry of FAID_LUT_3 (unattributed in the
    # reference source)
    "faid7_3": (
        (-3, -3, -3, -3, -3, -3, -1),
        (-3, -3, -2, -2, -1, -1, 1),
        (-3, -2, -2, -1, -1, 1, 1),
        (-3, -2, -1, -1, -1, 1, 2),
        (-3, -1, -1, -1, 0, 1, 2),
        (-3, -1, 1, 1, 1, 2, 2),
        (-1, 1, 1, 2, 2, 2, 3),
    ),
}


def lut_rule(name: str = "planjery7_t2", channel_weight_type: int = 1) -> LutRule:
    """A published LUT by name; ``channel_weight_type`` selects C as the
    reference does (0 -> 0.5, else 1.5; dec.cpp:973-980)."""
    return LutRule(
        table=FAID_TABLES[name],
        channel_value=0.5 if channel_weight_type == 0 else 1.5,
    )


def faid_decode(
    graph: LdpcGraph,
    hard_bits: torch.Tensor,
    max_iter: int = 200,
    rule: "FaidRule | LutRule | None" = None,
) -> BpResult:
    """Decode hard-decision input (BSC) with a finite-alphabet decoder on
    ``hard_bits``' device. hard_bits: [B, N] 0/1 channel hard decisions.

    ``rule`` may be a threshold-symmetric :class:`FaidRule` (any dv) or
    an arbitrary-table :class:`LutRule` (dv=3 codes)."""
    rule = rule or default_faid_rule()
    bits = torch.atleast_2d(hard_bits)
    if isinstance(rule, LutRule):
        # every variable node must have degree exactly 3: a padded edge
        # would feed m=0 into the LUT and add +weights[0] to the decision
        # sum, diverging from the reference's real-edge-only loops
        if graph.dv_max != 3 or not graph.var_mask.all():
            raise ValueError("LutRule FAID requires a code whose every column has weight exactly 3")
        recv = torch.where(bits == 0, 1.0, -1.0).to(torch.float32)
        return _faid_lut(graph, recv, max_iter, rule)
    y = torch.where(bits == 0, rule.channel_value, -rule.channel_value).to(torch.float32)
    return _faid_threshold(graph, y, max_iter, rule)


def _sign_min(tabs):
    """The FAID check node: exclusive sign x min, sign(0) = +1."""
    return lambda v: torch.mul(*sign_min_update(v, tabs.check_mask))


def _faid_lut(graph: LdpcGraph, recv: torch.Tensor, max_iter: int, rule: LutRule) -> BpResult:
    """recv: [B, N] +/-1 channel hard values."""
    s = rule.s
    width = 2 * s + 1
    lut = np.asarray(rule.table, np.float32)
    if lut.shape != (width, width):
        raise ValueError("LUT must be square (2s+1) x (2s+1)")
    dev = recv.device
    flat_lut = torch.as_tensor(lut.ravel(), device=dev)
    weights = torch.as_tensor(
        np.asarray(rule.weights if rule.weights is not None else np.ones(s + 1), np.float32), device=dev
    )
    # for edge k of a dv=3 variable node, the other two incoming edges in
    # column order (the reference's inner traversal, dec.cpp:955-963)
    other_a = torch.tensor([1, 0, 0], device=dev)
    other_b = torch.tensor([2, 2, 1], device=dev)

    def var_update(cv):
        # Phi(m1, m2 | y) with odd symmetry for y >= 0 (dec.cpp:1148-1168)
        flip = torch.where(recv >= 0, -1.0, 1.0)[:, :, None]
        m1 = cv[:, :, other_a] * flip
        m2 = cv[:, :, other_b] * flip
        idx = ((m1 + s) * width + (m2 + s)).to(torch.int64)
        v2c_vm = flat_lut[idx] * flip
        # Decision_FAID: weighted sign sum with sign(0) = +1; a tie
        # decodes as bit 1
        dsign = torch.where(cv >= 0, 1.0, -1.0)
        wmag = weights[cv.abs().to(torch.int64)]
        total = rule.channel_value * recv + (dsign * wmag).sum(-1)
        return v2c_vm, (~(total > 0)).to(torch.uint8)

    tabs = graph.to(dev)
    # Init_FAID: v2c = +/-1 per edge (dec.cpp:873-884)
    v0 = _gather_checkmajor(recv, tabs.check_vars)
    return _iterate(graph, (recv < 0).to(torch.uint8), v0, max_iter, _sign_min(tabs), var_update)


def _faid_threshold(graph: LdpcGraph, y: torch.Tensor, max_iter: int, rule: FaidRule) -> BpResult:
    """y: [B, N] +/-C channel values."""
    dev = y.device
    thresholds = torch.as_tensor(np.asarray(rule.thresholds, np.float32), device=dev)
    lv = torch.as_tensor(np.concatenate([[0.0], np.asarray(rule.levels)]).astype(np.float32), device=dev)

    def quantize(x):
        """sign(x) * levels[#thresholds <= |x|], 0 below T1."""
        k = (x.abs()[..., None] >= thresholds).sum(-1)
        return torch.sign(x) * lv[k]

    def var_update(cv):
        total = rule.channel_weight * y + cv.sum(-1)  # [B, N]
        # variable update: LUT over channel + exclusive message sum
        return quantize(total[:, :, None] - cv), (~(total > 0)).to(torch.uint8)

    tabs = graph.to(dev)
    v0 = quantize(_gather_checkmajor(y, tabs.check_vars))
    return _iterate(graph, (y < 0).to(torch.uint8), v0, max_iter, _sign_min(tabs), var_update)
