"""Carried from ``dna_ldpc_tpu/utils/gf.py`` as numpy code: the
JAX package cannot be imported without ``jax``. tests/test_torch_models.py
holds it equal to the original.

Vectorized GF(2^s) arithmetic over numpy integer arrays.

TPU-native replacement for the scalar GF helpers in the reference encoder
(``RS LDPC encode/RS_LDPC/RS_LDPC.c:14-199``): the reference builds the
antilog table one element at a time and resolves additions by linear search
through the table; here the same fields are built once as flat log/antilog
numpy tables so that every downstream operation (RS-LDPC matrix
construction, RS(8,4) index decoding) is a whole-array table lookup.

Field elements are represented in *polynomial* (integer bit-vector) form:
addition is XOR, multiplication goes through log/antilog tables. The
reference instead carries elements as exponents with -1 denoting the zero
element; conversion helpers are provided because the RS-LDPC construction
is specified in exponent form.
"""

from __future__ import annotations

import functools

import numpy as np

# Primitive polynomials per field size, identical to the table in the
# reference construction (RS_LDPC.c:14-105, switch on s). Encoded as the
# integer whose bit i is the coefficient of x^i (including the leading x^s
# term). GF(16) (s=4) additionally matches MATLAB's default primitive
# polynomial D^4+D+1 used by ``rsdec`` (rs_dec_init.m:31-32).
PRIMITIVE_POLYS = {
    2: 0b111,            # 1+x+x^2
    3: 0b1011,           # 1+x+x^3
    4: 0b10011,          # 1+x+x^4
    5: 0b100101,         # 1+x^2+x^5
    6: 0b1000011,        # 1+x+x^6
    7: 0b10001001,       # 1+x^3+x^7
    8: 0b100011101,      # 1+x^2+x^3+x^4+x^8
    9: 0b1000010001,     # 1+x^4+x^9
    10: 0b10000001001,   # 1+x^3+x^10
}


class GF:
    """A binary extension field GF(2^s) with vectorized numpy ops."""

    def __init__(self, s: int, primitive_poly: int | None = None):
        if primitive_poly is None:
            primitive_poly = PRIMITIVE_POLYS[s]
        self.s = s
        self.q = 1 << s
        self.poly = primitive_poly

        # exp_table[i] = alpha^i in polynomial form, i in [0, q-2];
        # extended to 2(q-1) entries so products of logs never need a mod.
        exp = np.zeros(2 * (self.q - 1), dtype=np.int64)
        x = 1
        for i in range(self.q - 1):
            exp[i] = x
            x <<= 1
            if x & self.q:
                x ^= primitive_poly
        exp[self.q - 1 :] = exp[: self.q - 1]
        # log_table[v] = i such that alpha^i == v; log of 0 is a sentinel.
        log = np.full(self.q, -1, dtype=np.int64)
        log[exp[: self.q - 1]] = np.arange(self.q - 1)
        self.exp_table = exp
        self.log_table = log

    # -- polynomial-form ops (arrays of ints in [0, q)) --------------------

    def add(self, a, b):
        return np.bitwise_xor(a, b)

    def mul(self, a, b):
        a = np.asarray(a)
        b = np.asarray(b)
        out = self.exp_table[self.log_table[a] + self.log_table[b]]
        return np.where((a == 0) | (b == 0), 0, out)

    def inv(self, a):
        a = np.asarray(a)
        if np.any(a == 0):
            raise ZeroDivisionError("inverse of 0 in GF(2^s)")
        return self.exp_table[(self.q - 1) - self.log_table[a]]

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def pow(self, a, n):
        """a ** n elementwise; 0 ** 0 == 1 by convention."""
        a = np.asarray(a)
        n = np.asarray(n)
        loga = self.log_table[a]
        out = self.exp_table[(loga * n) % (self.q - 1)]
        out = np.where(a == 0, np.where(n == 0, 1, 0), out)
        return out

    # -- exponent-form helpers (reference representation) ------------------
    # Exponent form: integer e in [0, q-2] means alpha^e; -1 means zero.

    def exp_to_poly(self, e):
        e = np.asarray(e)
        return np.where(e < 0, 0, self.exp_table[np.maximum(e, 0)])

    def poly_to_exp(self, v):
        return self.log_table[np.asarray(v)]

    def polyval(self, coeffs, x):
        """Evaluate polynomial sum_i coeffs[i] * x**i at each x (Horner).

        ``coeffs`` is a 1-D array in polynomial form, lowest degree first;
        ``x`` any-shape array. Returns array shaped like x.
        """
        x = np.asarray(x)
        acc = np.zeros_like(x)
        for c in coeffs[::-1]:
            acc = self.add(self.mul(acc, x), int(c))
        return acc


@functools.lru_cache(maxsize=None)
def get_field(s: int) -> GF:
    return GF(s)
