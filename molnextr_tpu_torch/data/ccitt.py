"""CCITT bilevel decoding for TIFF (compressions 2, 3 and 4), as libtiff's
``tif_fax3.c`` decodes it.

* Modified Huffman (compression 2): each row one-dimensional, starting on
  a byte boundary, no EOL codes.
* T.4 (compression 3): every row follows an EOL (libtiff's ``SYNC_EOL``:
  eleven zero bits or more, then a one); with ``T4Options`` bit 0 a tag
  bit after the EOL says whether the row is coded in 1-D or 2-D.
* T.6 / Group 4 (compression 4): every row 2-D, no EOLs; each strip starts
  from an all-white reference row.

A decoded row is a list of changing elements (the positions where the
colour flips, white first); :func:`rows_to_bits` turns rows into pixels, 1
for a black run, as libtiff fills them.  A bad code raises ``ValueError``.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List

import numpy as np

_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 "
    "000011 110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 "
    "0000100 0101000 0101011 0010011 0100100 0011000 00000010 00000011 00011010 "
    "00011011 00010010 00010011 00010100 00010101 00010110 00010111 00101000 "
    "00101001 00101010 00101011 00101100 00101101 00000100 00000101 00001010 "
    "00001011 01010010 01010011 01010100 01010101 00100100 00100101 01011000 "
    "01011001 01011010 01011011 01001010 01001011 00110010 00110011 00110100")
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011")
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 "
    "00001101000 00001101100 00000110111 00000101000 00000010111 00000011000 "
    "000011001010 000011001011 000011001100 000011001101 000001101000 000001101001 "
    "000001101010 000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 000011011011 "
    "000001010100 000001010101 000001010110 000001010111 000001100100 000001100101 "
    "000001010010 000001010011 000000100100 000000110111 000000111000 000000100111 "
    "000000101000 000001011000 000001011001 000000101011 000000101100 000001011010 "
    "000001100110 000001100111")
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 "
    "0000001001100 0000001001101 0000001110010 0000001110011 0000001110100 "
    "0000001110101 0000001110110 0000001110111 0000001010010 0000001010011 "
    "0000001010100 0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101")
_EXT_MAKEUP = (  # 1792-2560, both colours
    "00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
    "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
    "000000011111")
# 2-D mode codes -> (mode, vertical offset); P pass, H horizontal, V vertical
_MODES = {"1": ("V", 0), "011": ("V", 1), "000011": ("V", 2), "0000011": ("V", 3),
          "010": ("V", -1), "000010": ("V", -2), "0000010": ("V", -3),
          "001": ("H", 0), "0001": ("P", 0), "0000001": ("X", 0)}
PEEK = 13  # longest run code (black make-up) in bits


def _table(codes: Dict[str, int], bits: int) -> List[int]:
    """Look-ahead table over ``bits`` bits: entry = value << 5 | code length,
    0 for no code."""
    table = [0] * (1 << bits)
    for code, value in codes.items():
        n = len(code)
        lo = int(code, 2) << (bits - n)
        for k in range(lo, lo + (1 << (bits - n))):
            table[k] = (value << 5) | n
    return table


def _run_codes(term: str, makeup: str) -> Dict[str, int]:
    codes = {c: i for i, c in enumerate(term.split())}
    codes.update({c: 64 * (i + 1) for i, c in enumerate(makeup.split())})
    codes.update({c: 1792 + 64 * i for i, c in enumerate(_EXT_MAKEUP.split())})
    return codes


_TABLES: Dict[str, List[int]] = {}


def _tables():
    if not _TABLES:
        _TABLES["white"] = _table(_run_codes(_WHITE_TERM, _WHITE_MAKEUP), PEEK)
        _TABLES["black"] = _table(_run_codes(_BLACK_TERM, _BLACK_MAKEUP), PEEK)
        _TABLES["mode"] = _table({c: i for i, c in enumerate(_MODES)}, 7)
    return _TABLES["white"], _TABLES["black"], _TABLES["mode"]


_MODE_LIST = list(_MODES.values())
_TAIL = [0] * 64


class _Reader:
    """MSB-first bits through a 32-bit window per byte; zero bits past the end."""

    def __init__(self, data: bytes):
        b = np.frombuffer(data + bytes(3), np.uint8).astype(np.int64)
        self.win = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
        self.win.extend(_TAIL)
        self.nbits = len(data) * 8
        self.pos = 0

    def peek(self, n: int) -> int:
        pos = self.pos
        if pos >= self.nbits + 64:
            raise ValueError("CCITT: data ended before the image")
        return (self.win[pos >> 3] >> (32 - (pos & 7) - n)) & ((1 << n) - 1)

    def sync_eol(self) -> None:
        """libtiff's ``SYNC_EOL``: find eleven zero bits, then consume up to
        and including the next one bit."""
        while self.peek(11):
            self.pos += 1
        while not self.peek(1):
            self.pos += 1
        self.pos += 1


def _run(reader: _Reader, table: List[int]) -> int:
    """One run: make-up codes then a terminating code."""
    total = 0
    while True:
        entry = table[reader.peek(PEEK)]
        if not entry:
            raise ValueError("CCITT: bad run code")
        reader.pos += entry & 31
        value = entry >> 5
        total += value
        if value < 64:
            return total


def _row_1d(reader: _Reader, width: int, white: List[int], black: List[int]) -> List[int]:
    changes, a0, colour = [], 0, 0
    while a0 < width:
        a0 += _run(reader, black if colour else white)
        changes.append(min(a0, width))
        colour ^= 1
    return changes


def _row_2d(reader: _Reader, width: int, ref: List[int], white: List[int],
            black: List[int], modes: List[int]) -> List[int]:
    """One 2-D row against the reference row's changing elements ``ref``."""
    changes: List[int] = []
    a0, colour = -1, 0
    refs = ref + [width, width]
    while a0 < width:
        entry = modes[reader.peek(7)]
        if not entry:
            raise ValueError("CCITT: bad mode code")
        reader.pos += entry & 31
        mode, offset = _MODE_LIST[entry >> 5]
        i = bisect_right(refs, a0)
        if i % 2 != colour:
            i += 1
        b1 = refs[i] if i < len(refs) else width
        if mode == "P":
            a0 = refs[i + 1] if i + 1 < len(refs) else width
        elif mode == "H":
            start = max(a0, 0)
            a1 = start + _run(reader, black if colour else white)
            a2 = a1 + _run(reader, white if colour else black)
            changes += [min(a1, width), min(a2, width)]
            a0 = a2
        elif mode == "V":
            a1 = b1 + offset
            if a1 < max(a0, 0) or a1 > width:
                raise ValueError("CCITT: vertical mode out of the row")
            changes.append(a1)
            a0 = a1
            colour ^= 1
        else:
            raise ValueError("CCITT: uncompressed mode is not supported (libtiff refuses it)")
    return changes


def decode(data: bytes, width: int, rows: int, compression: int, t4_options: int = 0
           ) -> List[List[int]]:
    """The changing elements of ``rows`` rows of one strip or tile."""
    white, black, modes = _tables()
    reader = _Reader(data)
    out: List[List[int]] = []
    ref: List[int] = []
    for _ in range(rows):
        if compression == 2:
            row = _row_1d(reader, width, white, black)
            reader.pos = (reader.pos + 7) & ~7
        elif compression == 3:
            reader.sync_eol()
            two_d = False
            if t4_options & 1:
                two_d = not reader.peek(1)
                reader.pos += 1
            row = (_row_2d(reader, width, ref, white, black, modes) if two_d
                   else _row_1d(reader, width, white, black))
        else:
            row = _row_2d(reader, width, ref, white, black, modes)
        out.append(row)
        ref = row
    return out


def rows_to_bits(rows: List[List[int]], width: int) -> np.ndarray:
    """Changing elements -> (rows, width) uint8, 1 where a run is black."""
    flips = np.zeros((len(rows), width + 1), np.int64)
    for y, changes in enumerate(rows):
        if changes:
            np.add.at(flips[y], np.minimum(changes, width), 1)
    return (np.cumsum(flips, axis=1)[:, :width] & 1).astype(np.uint8)

