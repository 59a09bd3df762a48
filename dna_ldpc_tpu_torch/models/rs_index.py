"""Carried from ``dna_ldpc_tpu/models/rs_index.py`` as numpy code: the
JAX package cannot be imported without ``jax``. tests/test_torch_models.py
holds it equal to the original.

Batched RS(8,4) over GF(16) index code: encoder + bounded-distance decoder.

Replaces the compiled-MATLAB ``rs_dec.exe`` of the reference
(``ex_decoder/rs_dec_init.m``: ``rsdec(gf(code,4), 8, 4)`` with the default
narrow-sense generator, roots alpha^1..alpha^4, primitive poly D^4+D+1).
The code is the (15,11) RS code shortened to (8,4); minimum distance 5,
corrects t=2 symbol errors.

Decoding strategy: the syndrome space has only 16^4 = 65536 values and
23,851 of them correspond to a unique error pattern of weight <= 2 in the
full 15-symbol space, so the decoder is a precomputed syndrome-indexed
lookup table — one gather per read instead of Berlekamp iterations, exact
bounded-distance semantics by construction (decode succeeds iff the
received word is within Hamming distance 2 of a codeword; by d=5 that
codeword is unique, so results match ANY correct BD decoder including
MATLAB's). Per MATLAB's shorten-by-zero-prepending semantics, corrections
falling in the 7 prepended positions are counted in ``cnumerr`` but cannot
affect the returned (stripped) message.

All operations vectorize over the full read batch (~70k reads/trial) in
numpy; this is host-side ingest preprocessing feeding the TPU LLR stage.
"""

from __future__ import annotations

import functools

import numpy as np

from ..utils.gf import get_field

N_FULL = 15      # native RS length over GF(16)
N_SHORT = 8      # transmitted symbols
K_SHORT = 4      # message symbols
N_PARITY = 4     # n - k = 2t
T = 2


@functools.lru_cache(maxsize=None)
def _gen_poly() -> np.ndarray:
    """Generator polynomial with roots alpha^1..alpha^4 (narrow-sense,
    MATLAB default b=1), coefficients low->high degree, monic degree 4."""
    f = get_field(4)
    g = np.array([1], dtype=np.int64)
    for j in range(1, 2 * T + 1):
        root = f.exp_table[j]
        new = np.zeros(len(g) + 1, dtype=np.int64)
        new[1:] = g                      # x * g
        new[:-1] ^= f.mul(g, root)       # + root * g
        g = new
    return g


def rs_encode(msgs: np.ndarray) -> np.ndarray:
    """Systematic encode: [..., 4] GF(16) messages -> [..., 8] codewords
    [msg, parity]. Parity = remainder of msg(x) * x^4 mod g(x), evaluated
    with MATLAB's coefficient order (first symbol = highest degree)."""
    f = get_field(4)
    g = _gen_poly()
    msgs = np.asarray(msgs, dtype=np.int64)
    # long division: work on msg followed by 4 zeros, high degree first
    rem = np.concatenate([msgs, np.zeros(msgs.shape[:-1] + (N_PARITY,), np.int64)], axis=-1)
    ghi = g[::-1]  # high -> low degree, ghi[0] == 1 (monic)
    for i in range(K_SHORT):
        q = rem[..., i].copy()
        rem[..., i : i + N_PARITY + 1] ^= f.mul(q[..., None], ghi[None, :])
    return np.concatenate([msgs, rem[..., K_SHORT:]], axis=-1)


@functools.lru_cache(maxsize=None)
def _syndrome_tables():
    """Precompute the syndrome->error-pattern lookup.

    Syndromes S_j = C(alpha^j), j=1..4, of the full 15-symbol word C with
    C(x) = sum_k c[k] x^(14-k) (MATLAB gf row convention). The packed key
    is S1<<12 | S2<<8 | S3<<4 | S4.

    Returns (nerr[65536] int8 with -1 = uncorrectable, epos[65536, 2] int8
    full-word positions with -1 padding, eval[65536, 2] int8 magnitudes).
    """
    f = get_field(4)
    # power table: x_pow[j, k] = (alpha^j)^(14-k) for j=1..4, k=0..14
    degs = 14 - np.arange(N_FULL)
    x_pow = np.stack([f.pow(np.full(N_FULL, f.exp_table[j]), degs) for j in range(1, 5)])

    nerr = np.full(1 << 16, -1, dtype=np.int8)
    epos = np.full((1 << 16, 2), -1, dtype=np.int8)
    evals = np.zeros((1 << 16, 2), dtype=np.int8)

    def key(S):
        return (int(S[0]) << 12) | (int(S[1]) << 8) | (int(S[2]) << 4) | int(S[3])

    nerr[0] = 0  # zero syndrome: no errors

    # single errors: 15 positions x 15 magnitudes
    for p in range(N_FULL):
        for v in range(1, 16):
            S = f.mul(x_pow[:, p], v)
            k = key(S)
            nerr[k] = 1
            epos[k, 0] = p
            evals[k, 0] = v

    # double errors (vectorized over the 225 magnitude pairs per position pair)
    vv = np.arange(1, 16)
    v1, v2 = np.meshgrid(vv, vv, indexing="ij")
    v1, v2 = v1.ravel(), v2.ravel()
    for p1 in range(N_FULL):
        for p2 in range(p1 + 1, N_FULL):
            S = f.mul(x_pow[:, p1][:, None], v1[None, :]) ^ f.mul(
                x_pow[:, p2][:, None], v2[None, :]
            )  # [4, 225]
            keys = (S[0] << 12) | (S[1] << 8) | (S[2] << 4) | S[3]
            nerr[keys] = 2
            epos[keys, 0] = p1
            epos[keys, 1] = p2
            evals[keys, 0] = v1
            evals[keys, 1] = v2
    return nerr, epos, evals


def rs_decode(received: np.ndarray, return_full: bool = False):
    """Bounded-distance decode. received: [..., 8] GF(16) symbols.

    Returns (messages [..., 4] corrected message symbols, cnumerr [...]
    int32: number of symbol errors corrected, or -1 on decoding failure) —
    the exact outputs the pipeline consumes from ``rs_dec.exe``
    (decoder.py:76-92 keeps reads with cnumerr in {0, 1, 2}).

    ``return_full=True`` additionally returns the corrected full 15-symbol
    word (zero-padded positions included), used by tests to validate the
    bounded-distance property when corrections land in the padding.
    """
    f = get_field(4)
    received = np.asarray(received, dtype=np.int64)
    batch_shape = received.shape[:-1]
    r = received.reshape(-1, N_SHORT)

    degs = 14 - np.arange(7, 15)  # degrees of the 8 transmitted positions
    S = np.stack(
        [
            np.bitwise_xor.reduce(
                f.mul(r, f.pow(np.full(N_SHORT, f.exp_table[j]), degs)[None, :]), axis=1
            )
            for j in range(1, 5)
        ],
        axis=1,
    )  # [B, 4]
    keys = (S[:, 0] << 12) | (S[:, 1] << 8) | (S[:, 2] << 4) | S[:, 3]

    nerr_t, epos_t, eval_t = _syndrome_tables()
    cnumerr = nerr_t[keys].astype(np.int32)

    full = np.concatenate([np.zeros((len(r), 7), np.int64), r], axis=1)
    flat = np.arange(len(r))
    for e in range(2):
        pos = epos_t[keys, e].astype(np.int64)   # full-word position, -1 pad
        val = eval_t[keys, e].astype(np.int64)
        idx = np.where(pos >= 0, pos, 0)
        upd = np.where((cnumerr > 0) & (pos >= 0), val, 0)
        full[flat, idx] ^= upd

    messages = full[:, 7 : 7 + K_SHORT]
    out = (
        messages.reshape(batch_shape + (K_SHORT,)),
        cnumerr.reshape(batch_shape),
    )
    if return_full:
        out = out + (full.reshape(batch_shape + (N_FULL,)),)
    return out


def decode_index_bits(index_bits: np.ndarray):
    """Decode 32-bit read indices. index_bits: [B, 32] with values in
    {0,1,2} (2 = non-ACGT base, def_func.py DNA2binary); any read containing
    a non-binary symbol cannot form GF(16) symbols and is marked failed.

    Returns (decoded 16-bit messages as [B, 16] bits, cnumerr [B]) matching
    rs_dec_init.m's bit packing: 8 symbols of 4 MSB-first bits each in, 4
    symbols of 4 MSB-first bits each out.
    """
    bits = np.asarray(index_bits, dtype=np.int64)
    bad = np.any(bits > 1, axis=1)
    b = np.where(bits > 1, 0, bits)
    syms = b.reshape(-1, 8, 4) @ (1 << np.arange(3, -1, -1, dtype=np.int64))
    messages, cnumerr = rs_decode(syms)
    cnumerr = np.where(bad, -1, cnumerr)
    out_bits = ((messages[..., None] >> np.arange(3, -1, -1)) & 1).reshape(-1, 16)
    return out_bits.astype(np.uint8), cnumerr
