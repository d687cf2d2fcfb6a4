"""Generic Reed-Solomon / binary-BCH codec: syndromes -> Berlekamp-Massey ->
Chien search -> Forney, over any GF(2^m).

Same algorithm family as the reference's BerlekempMassey.java:25 (the classic
Rockliff structure), written from the textbook algorithm. Shortened codes are
handled by treating the absent leading symbols as zeros.

Conventions: `codeword[0]` is the FIRST symbol on the wire and holds data;
parity occupies the tail. Generator roots are alpha^fcr .. alpha^(fcr+2t-1)
with fcr=1 (P25 / DMR convention).
"""
from __future__ import annotations

import numpy as np

from .galois import GF

__all__ = ["ReedSolomon"]


class ReedSolomon:
    def __init__(self, n: int, k: int, gf: GF, fcr: int = 1):
        if n > gf.size - 1:
            raise ValueError(f"n={n} exceeds field codeword length {gf.size - 1}")
        self.n = n
        self.k = k
        self.gf = gf
        self.fcr = fcr
        self.nroots = n - k
        self.t = (n - k) // 2
        # generator polynomial g(x) = prod (x - alpha^(fcr+i)), ascending coeffs
        g = np.array([1], dtype=np.int64)
        for i in range(self.nroots):
            root = gf.pow_alpha(fcr + i)
            g = gf.poly_mul(g, np.array([root, 1], dtype=np.int64))
        self.genpoly = g  # len nroots+1, g[-1] == 1
        # syndrome exponent matrix: S_i = XOR_j coeff_j * alpha^((fcr+i)*j)
        # with coeff_j = received[n-1-j]; precomputing the log of each
        # alpha power turns the per-word Horner loop into one table-lookup
        # + XOR-reduce (the Python-loop Horner was the host hot spot at
        # 1000-channel framing scale)
        q1 = gf.size - 1
        self._synd_logp = (np.outer(np.arange(self.nroots) + fcr,
                                    np.arange(self.n)) % q1)  # (nroots, n)
        # Chien inverse points: alpha^{-(n-1-p)} for wire position p
        self._chien_x = gf.exp[(-(self.n - 1 - np.arange(self.n))) % q1]

    # ---------------- encode ----------------

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data (k,) -> codeword (n,) = data ++ parity (systematic)."""
        data = np.asarray(data, np.int64)
        if len(data) != self.k:
            raise ValueError(f"expected {self.k} data symbols, got {len(data)}")
        gf = self.gf
        # polynomial division: x^(n-k) * d(x) mod g(x)
        rem = np.zeros(self.nroots, dtype=np.int64)  # ascending coeffs
        for d in data:  # feed highest-order symbol first
            feedback = int(rem[-1]) ^ int(d)
            rem[1:] = rem[:-1]
            rem[0] = 0
            if feedback:
                rem ^= gf.mul(feedback, self.genpoly[:-1])
        # rem holds parity, highest order at tail; wire order = descending
        parity = rem[::-1]
        return np.concatenate([data, parity])

    # systematic-encoding matrix (lazy): row i = parity of the unit
    # info vector e_i; encoding is GF-linear so batch parity is one
    # log/exp lookup + XOR-reduce, like syndromes()
    _enc_P = None

    def encode_parity(self, data: np.ndarray) -> np.ndarray:
        """Batched systematic parity: data (..., k) -> (..., nroots).

        The fast path for punctured codes (P25P2 FACCH/SACCH): the 9
        punctured parity symbols are substituted with zeros at decode,
        so EVERY word — clean or not — carries >= 9 'errors' and the
        syndrome screen never short-circuits; re-encoding the received
        info and comparing only the TRANSMITTED parity detects clean
        words in one vectorized pass (the per-word Berlekamp-Massey on
        clean streams was a measured 20 s/chunk at 1023-slot P25P2
        scale)."""
        gf = self.gf
        if self._enc_P is None:
            P = np.zeros((self.k, self.nroots), np.int64)
            e = np.zeros(self.k, np.int64)
            for i in range(self.k):
                e[:] = 0
                e[i] = 1
                P[i] = self.encode(e)[self.k:]
            self._enc_P = P
            self._enc_logP = gf.log[P]
        d = np.asarray(data, np.int64)
        logs = gf.log[d][..., :, None] + self._enc_logP  # (..., k, nr)
        vals = gf.exp[logs]
        vals = np.where((d[..., :, None] != 0)
                        & (self._enc_P != 0), vals, 0)
        return np.bitwise_xor.reduce(vals, axis=-2)

    # ---------------- decode ----------------

    def syndromes(self, received: np.ndarray) -> np.ndarray:
        """Syndromes S_i = R(alpha^(fcr+i)) for wire-order word(s).

        received: (..., n) -> (..., nroots); fully vectorized over any
        leading batch axes (the bank framer checks every NID candidate of
        every channel in one call)."""
        gf = self.gf
        r = np.asarray(received, np.int64)
        coeffs = r[..., ::-1]                      # index j -> coeff of x^j
        logc = gf.log[coeffs]                      # -1 sentinel at 0
        # the exp table is doubled, so the exponent sum (<= 2q-4, >= -1
        # only when coeff==0, which is masked) indexes it without a
        # modulo — the % was a measured hot spot on large batches
        e = gf.exp[logc[..., None, :] + self._synd_logp]
        e = np.where(coeffs[..., None, :] != 0, e, 0)
        return np.bitwise_xor.reduce(e, axis=-1)

    def decode(self, received: np.ndarray):
        """received (n,) -> (corrected (n,), n_corrected | None).

        Returns None for n_corrected when the word is uncorrectable.
        """
        r = np.asarray(received, np.int64).copy()
        if len(r) != self.n:
            raise ValueError(f"expected {self.n} symbols, got {len(r)}")
        gf = self.gf
        synd = self.syndromes(r)
        if not np.any(synd):
            return r, 0

        # Berlekamp-Massey for error locator sigma(x), ascending coeffs
        # (discrepancy computed as one vectorized GF mul + XOR-reduce per
        # iteration — the scalar inner loop was a measured hot spot on
        # error-bearing frames at 1000-channel scale)
        sigma = np.zeros(self.nroots + 1, dtype=np.int64)
        prev = np.zeros(self.nroots + 1, dtype=np.int64)
        sigma[0] = 1
        prev[0] = 1
        L = 0
        mshift = 1
        b = 1
        for i in range(self.nroots):
            d = int(synd[i])
            if L:
                terms = gf.mul(sigma[1:L + 1], synd[i - L:i][::-1])
                d ^= int(np.bitwise_xor.reduce(terms))
            if d == 0:
                mshift += 1
            elif 2 * L <= i:
                temp = sigma.copy()
                coef = gf.mul(d, gf.inv(b))
                shifted = np.zeros_like(prev)
                shifted[mshift:] = prev[:-mshift] if mshift else prev
                sigma = sigma ^ gf.mul(int(coef), shifted)
                L = i + 1 - L
                prev = temp
                b = d
                mshift = 1
            else:
                coef = gf.mul(d, gf.inv(b))
                shifted = np.zeros_like(prev)
                shifted[mshift:] = prev[:-mshift] if mshift else prev
                sigma = sigma ^ gf.mul(int(coef), shifted)
                mshift += 1
        if L > self.t:
            return r, None

        # Chien search over valid positions of the (possibly shortened)
        # code: error position p (0-based from wire start) corresponds to
        # coefficient x^(n-1-p); locator root test:
        # sigma(alpha^{-(n-1-p)}) == 0 — evaluated at all n inverse
        # points in one vectorized poly_eval
        positions = np.nonzero(
            gf.poly_eval(sigma[: L + 1], self._chien_x) == 0)[0].tolist()
        if len(positions) != L:
            return r, None

        # Forney: error values. Omega(x) = [S(x) * sigma(x)] mod x^nroots
        # — each coefficient one vectorized GF mul + XOR-reduce
        omega = np.zeros(self.nroots, dtype=np.int64)
        for i in range(self.nroots):
            lo = min(i, L) + 1
            terms = gf.mul(sigma[:lo], synd[i - lo + 1:i + 1][::-1])
            omega[i] = int(np.bitwise_xor.reduce(terms))

        jj_odd = np.arange(1, L + 1, 2)
        for p in positions:
            j = self.n - 1 - p            # power of x for this position
            xinv = int(gf.pow_alpha(-j))  # X_l^{-1}
            num = int(gf.poly_eval(omega, xinv))
            # sigma'(x): formal derivative = odd-power coeffs
            den_terms = gf.mul(sigma[jj_odd],
                               gf.pow_alpha(-j * (jj_odd - 1)))
            den = int(np.bitwise_xor.reduce(den_terms)) if len(jj_odd) \
                else 0
            if den == 0:
                return r, None
            mag = int(gf.mul(num, self.gf.inv(den)))
            # e_l = X_l^{1-fcr} * Omega(X_l^{-1}) / sigma'(X_l^{-1})
            if self.fcr != 1:
                mag = int(gf.mul(mag, int(gf.pow_alpha(j * (1 - self.fcr)))))
            r[p] ^= mag
        # verify: recompute syndromes
        if np.any(self.syndromes(r)):
            return np.asarray(received, np.int64), None
        return r, L
