"""Simulation channels: AWGN / BSC / BEC LLR generation and fault
injection (puncturing/shortening erasures).

Port of ``dna_ldpc_tpu/ops/channels.py`` (the reference's channel layer,
``LDPC_dec/ldpc/channel.cpp``: EbNo->sigma at :9-16, BPSK AWGN LLR =
2r/sigma^2 at :23-35, BSC :37-89, BEC with ERASE_MARK=2 :95-120), on
torch tensors on the codewords' device. The three draws take an explicit
``torch.Generator`` on that device; each draws its noise with the batch's
shape and independent of the bit values, so one codeword broadcast over a
batch sees, slot for slot, the noise the batch saw (the simulator's
error-case replay relies on it). The draws cannot equal the JAX package's
threefry bits: tests feed both packages the same channel outputs.
"""

from __future__ import annotations

import math

import torch

ERASE_MARK = 2
SHORTEN_LLR = 1e9


def ebno_to_sigma(ebno_db: float, rate: float) -> float:
    """Noise std-dev for BPSK at the given Eb/No (getStd_dev)."""
    return math.sqrt(1.0 / (2.0 * rate * 10.0 ** (ebno_db / 10.0)))


def _uniform(gen: torch.Generator, codewords: torch.Tensor) -> torch.Tensor:
    return torch.rand(codewords.shape, generator=gen, device=codewords.device)


def awgn_llr(gen: torch.Generator, codewords: torch.Tensor, sigma: float) -> torch.Tensor:
    """BPSK-modulate bits (0 -> +1, 1 -> -1), add N(0, sigma^2), return
    LLR = 2r/sigma^2 (channel.cpp:23-35; LLR >= 0 <=> bit 0)."""
    x = 1.0 - 2.0 * codewords.to(torch.float32)
    r = x + sigma * torch.randn(codewords.shape, generator=gen, device=codewords.device)
    return 2.0 * r / (sigma * sigma)


def bsc_flips(gen: torch.Generator, codewords: torch.Tensor, p: float) -> torch.Tensor:
    """The BSC's received hard bits: each bit flipped w.p. p, uint8."""
    return (codewords.bool() ^ (_uniform(gen, codewords) < p)).to(torch.uint8)


def bsc_llr(gen: torch.Generator, codewords: torch.Tensor, p: float) -> torch.Tensor:
    """Flip each bit w.p. p; LLR = +/- log((1-p)/p)."""
    mag = math.log((1 - p) / p)
    rx = bsc_flips(gen, codewords, p).bool()
    return torch.where(rx, -mag, mag).to(torch.float32)


def bec_values(gen: torch.Generator, codewords: torch.Tensor, p: float) -> torch.Tensor:
    """Erase each bit w.p. p -> int8 values {0, 1, ERASE_MARK}."""
    erase = _uniform(gen, codewords) < p
    return torch.where(erase, ERASE_MARK, codewords.to(torch.int8)).to(torch.int8)


def inject_erasures(llr: torch.Tensor, positions) -> torch.Tensor:
    """Zero the LLRs at the given positions (puncturing fault injection,
    DNA_main.cpp:1440-1470 analog in the soft domain). Returns a copy."""
    out = llr.clone()
    out[..., torch.as_tensor(positions, dtype=torch.long, device=llr.device)] = 0.0
    return out


def puncture(llr: torch.Tensor, positions) -> torch.Tensor:
    """Puncturing: the transmitter skips these code bits, so the receiver
    has no observation — LLR 0 (DNA_main.cpp puncture path, :1440-1470)."""
    return inject_erasures(llr, positions)


def shorten(llr: torch.Tensor, positions) -> torch.Tensor:
    """Shortening: these code bits are known zero a priori — saturated
    positive LLR (DNA_main.cpp shortening path, :1472-1520). Returns a
    copy."""
    out = llr.clone()
    out[..., torch.as_tensor(positions, dtype=torch.long, device=llr.device)] = SHORTEN_LLR
    return out
