"""The AV1 symbol decoder (the AV1 specification, section 8.2), as libaom's
``od_ec_decode_cdf_q15`` runs it.

A CDF here is a Python list in the specification's form: ``N`` increasing
values ending at 32768 (the probability that the symbol is at most ``i``,
out of 32768), then the adaptation counter.  :class:`SymbolDecoder` keeps
the specification's ``SymbolValue`` in a window over the tile's bits,
inverted, with ones past the end of the data, so that one comparison
decides each symbol.  It counts the bits it has read as libaom's
``aom_reader_tell`` does, for libaom's checks that a tile neither overruns
its data nor ends without its trailing bits (a corrupt frame).
"""

from __future__ import annotations

from typing import List


class SymbolDecoder:
    """``init_symbol``/``read_symbol``/``read_bool``/``read_literal`` over
    one tile's bytes; ``adapt`` is ``not disable_cdf_update``."""

    __slots__ = ("data", "start", "pos", "end", "rng", "dif", "cnt", "adapt", "bits")

    def __init__(self, data: bytes, start: int, size: int, adapt: bool = True):
        if size < 1:
            raise ValueError("AV1: empty tile")
        self.data, self.start, self.pos, self.end = data, start, start, start + size
        self.bits = 1  # libaom's aom_reader_tell: 1, plus every renormalisation shift
        self.adapt = adapt
        self.rng = 1 << 15
        # dif holds SymbolValue << cnt, then cnt more (inverted) bits
        self.dif, self.cnt = 0, -15
        self._refill()

    def _refill(self) -> None:
        data, pos, end, dif, cnt = self.data, self.pos, self.end, self.dif, self.cnt
        while cnt < 24:
            dif = (dif << 8) | ((data[pos] ^ 0xFF) if pos < end else 0xFF)
            pos += 1
            cnt += 8
        self.dif, self.cnt, self.pos = dif, cnt, pos

    def symbol(self, cdf: List[int]) -> int:
        """``read_symbol``: the symbol, then the CDF adapted to it."""
        n = len(cdf) - 1
        r8 = self.rng >> 8
        cnt = self.cnt
        c = self.dif >> cnt
        s = 0
        u = self.rng
        v = ((r8 * ((32768 - cdf[0]) >> 6)) >> 1) + 4 * (n - 1)
        while c < v:
            s += 1
            u = v
            v = ((r8 * ((32768 - cdf[s]) >> 6)) >> 1) + 4 * (n - s - 1) if s < n - 1 else 0
        rng = u - v
        dif = self.dif - (v << cnt)
        bits = 16 - rng.bit_length()
        self.rng = rng << bits
        self.dif, self.cnt = dif, cnt - bits
        self.bits += bits
        if self.cnt < 0:
            self._refill()
        if self.adapt:
            count = cdf[n]
            rate = 3 + (count > 15) + (count > 31) + (2 if n > 3 else (1 if n > 1 else 0))
            for i in range(n - 1):
                if i < s:
                    cdf[i] -= cdf[i] >> rate
                else:
                    cdf[i] += (32768 - cdf[i]) >> rate
            if count < 32:
                cdf[n] = count + 1
        return s

    def bool(self) -> int:
        """``read_bool``: a symbol of a fixed even CDF."""
        r8 = self.rng >> 8
        cnt = self.cnt
        v = ((r8 * (16384 >> 6)) >> 1) + 4
        if (self.dif >> cnt) < v:  # symbol 1: the lower part of the range
            rng, bit, dif = v, 1, self.dif
        else:
            rng, bit, dif = self.rng - v, 0, self.dif - (v << cnt)
        bits = 16 - rng.bit_length()
        self.rng = rng << bits
        self.dif, self.cnt = dif, cnt - bits
        self.bits += bits
        if self.cnt < 0:
            self._refill()
        return bit

    def overflowed(self) -> bool:
        """``aom_reader_has_overflowed``: more bits read than the tile has."""
        return (self.bits + 7) >> 3 > self.end - self.start

    def trailing_ok(self) -> bool:
        """``check_trailing_bits_after_symbol_coder``: a one bit after the
        last bit read, zeros to the end of its byte, zero bytes after."""
        if self.overflowed():
            return False
        nbytes = (self.bits + 7) >> 3
        pattern = 128 >> ((self.bits - 1) & 7)
        if self.data[self.start + nbytes - 1] & (2 * pattern - 1) != pattern:
            return False
        return not any(self.data[self.start + nbytes : self.end])

    def literal(self, n: int) -> int:
        """``read_literal``: ``n`` bools, most significant first."""
        x = 0
        read = self.bool
        for _ in range(n):
            x = (x << 1) | read()
        return x

    def ns(self, n: int) -> int:
        """``NS(n)``: a non-symmetric unsigned value below ``n``."""
        w = n.bit_length()
        m = (1 << w) - n
        v = self.literal(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.literal(1)

