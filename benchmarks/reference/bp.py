"""Plain flooding sum-product decoding of a binary LDPC code in torch.

The semantics of the reference decoder (``LDPC_dec/ldpc/dec.cpp``) that
the deployed pipeline and its simulator run: the initial decision is
bit = (LLR < 0); before every iteration the syndrome of the current
decision is taken, and a word stops, its results latched, when it is zero
or after ``max_iter`` iterations; an iteration sends every check its
variables' extrinsic messages in the tanh domain, each check returns the
product of the others' (2 atanh of it), and a variable's posterior is its
channel LLR plus all its checks' messages; the decision is
bit = (posterior <= 0). ``iterations`` counts the iterations a word ran.

Messages are stored in ``msg_dtype`` and computed in float32: the
deployed decoder's precision is bfloat16 messages (``K1``); the control
of ``correct`` runs this decoder with float8 (e4m3) messages. Nothing of
the program is imported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

TE_CLIP = 1.0 - 1e-5   # |tanh product| < 1, so 2 atanh stays finite


@dataclass
class Decoded:
    bits: torch.Tensor        # [B, N] uint8
    success: torch.Tensor     # [B] bool
    iterations: torch.Tensor  # [B] int32


def _q(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).float()


def _exclusive_product(t: torch.Tensor) -> torch.Tensor:
    """[..., d] -> product over the other d - 1 entries of each position."""
    ones = torch.ones_like(t[..., :1])
    left = torch.cumprod(torch.cat([ones, t[..., :-1]], -1), -1)
    right = torch.flip(torch.cumprod(torch.cat([ones, torch.flip(t[..., 1:], [-1])], -1), -1), [-1])
    return left * right


def decode(checks: torch.Tensor, llr: torch.Tensor, max_iter: int, msg_dtype=torch.bfloat16) -> Decoded:
    """checks: [M, dc] long variable index of each check's edges (regular
    row weight); llr: [B, N] float32 channel LLRs on the same device."""
    B, N = llr.shape
    flat = checks.reshape(-1)
    lc = torch.nan_to_num(llr.float())

    def unsat(bits):
        return (bits[:, checks].sum(-1) % 2).sum(-1)

    bits = (lc < 0).to(torch.uint8)
    done = unsat(bits) == 0
    iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
    t = _q(torch.tanh(_q(lc, msg_dtype)[:, checks] * 0.5), msg_dtype)
    for n in range(max_iter):
        if bool(done.all()):
            break
        te = _exclusive_product(t).clamp(-TE_CLIP, TE_CLIP)
        c2v = _q(torch.log((1.0 + te) / (1.0 - te)), msg_dtype)
        post = lc.clone()
        post.index_add_(1, flat, c2v.reshape(B, -1))
        new_bits = (~(post > 0)).to(torch.uint8)
        new_unsat = unsat(new_bits)
        live = ~done
        bits = torch.where(live[:, None], new_bits, bits)
        iters = torch.where(live, torch.full_like(iters, n + 1), iters)
        done = done | (new_unsat == 0)
        t = _q(torch.tanh((_q(post, msg_dtype)[:, checks] - c2v) * 0.5), msg_dtype)
    return Decoded(bits=bits, success=unsat(bits) == 0, iterations=iters)


def decode_blocks(checks, llr, max_iter: int, msg_dtype=torch.bfloat16, rows: int = 256) -> Decoded:
    """``decode`` over blocks of ``rows`` words (rows are independent), so
    that a large batch fits beside what the program left on the card."""
    parts = [decode(checks, llr[k : k + rows], max_iter, msg_dtype) for k in range(0, len(llr), rows)]
    return Decoded(*(torch.cat([getattr(p, f) for p in parts]) for f in ("bits", "success", "iterations")))
