"""Reads drawn with uneven coverage: a pool sequenced deep after
synthesis and PCR gives each stored sequence a share of the reads far
wider than a uniform draw's Poisson (Heckel, Mikutis and Grass, "A
characterization of the DNA data storage channel", Sci. Rep. 9:9663,
2019). The usual model of that over-dispersion is a negative binomial:
each oligo's abundance is drawn from a gamma distribution of mean 1 and
shape ``k`` (coefficient of variation 1 / sqrt(k)), then the reads are
drawn from the abundances.

``negative_binomial_picks`` draws exactly ``n_reads`` oligo indices,
multinomial over the abundances, in a random order; ``channel_reads``
sends the picked oligos through the read channel of ``recipe.py`` (a copy
of the channel step of ``recipe.simulate_reads``, which draws its picks
uniformly inside). Nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np

from benchlib.recipe import _HI, _LO, BASES, ChannelModel


def negative_binomial_picks(n_oligos: int, n_reads: int, gamma_shape: float, rng: np.random.Generator) -> np.ndarray:
    """``n_reads`` oligo indices in random order: abundances from a gamma
    of shape ``gamma_shape`` and mean 1, then a multinomial over them. An
    oligo's read count is negative binomial of mean m = n_reads / n_oligos
    and variance m + m^2 / gamma_shape, less the little that fixing the
    total takes away."""
    abundance = rng.gamma(gamma_shape, 1.0 / gamma_shape, n_oligos)
    counts = rng.multinomial(n_reads, abundance / abundance.sum())
    return rng.permutation(np.repeat(np.arange(n_oligos), counts))


def channel_reads(pool: np.ndarray, picks: np.ndarray, channel: ChannelModel, rng: np.random.Generator):
    """The reads of oligos ``picks`` of the [n_oligos, L] base matrix
    ``pool`` through the channel: a substitution to one of the three other
    bases, a deletion of a base, an insertion slot before every base and at
    the end, one quality character a read. Returns (reads, quality
    characters) as lists of str."""
    n_reads = len(picks)
    L = pool.shape[1]
    seqs = pool[picks].copy()
    sub = rng.random(seqs.shape) < channel.substitution
    if sub.any():
        r, c = np.nonzero(sub)
        sym = (_HI[seqs[r, c]] << 1) | _LO[seqs[r, c]]
        seqs[r, c] = BASES[(sym + rng.integers(1, 4, size=len(r))) % 4]
    dele = rng.random(seqs.shape) < channel.deletion
    ins = rng.random((n_reads, L + 1)) < channel.insertion
    ins_base = BASES[rng.integers(0, 4, size=(n_reads, L + 1))]
    indel = np.nonzero(dele.any(axis=1) | ins.any(axis=1))[0]
    reads = [row.tobytes().decode("ascii") for row in seqs]
    if len(indel):
        # slot k of a read: the base inserted before base k, then base k (slot L: an insertion at the end)
        vals = np.stack([ins_base[indel], np.pad(seqs[indel], ((0, 0), (0, 1)))], axis=2).reshape(len(indel), -1)
        keep = np.stack([ins[indel], np.pad(~dele[indel], ((0, 0), (0, 1)))], axis=2).reshape(len(indel), -1)
        flat = vals[keep].tobytes().decode("ascii")
        ends = np.cumsum(keep.sum(axis=1))
        for i, a, b in zip(indel, ends - keep.sum(axis=1), ends):
            reads[i] = flat[a:b]
    q = np.where(rng.random(n_reads) < channel.p_low_quality, channel.q_low, channel.q_high)
    return reads, [chr(c) for c in q]
