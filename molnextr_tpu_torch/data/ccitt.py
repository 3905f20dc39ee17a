"""CCITT bilevel decoding for TIFF (compressions 2, 3, 4 and 32771), as
libtiff's ``tif_fax3.c`` decodes it.

:func:`decode_strip` is libtiff's own state machine (``Fax3DecodeRLE``,
``Fax3Decode1D``, ``Fax3Decode2D``, ``Fax4Decode`` over the ``tif_fax3.h``
macros and ``mkg3states``' tables), run-length arrays and all, so that a
damaged strip reads as libtiff reads it:

* Modified Huffman (compression 2): each row one-dimensional, starting on
  a byte boundary, no EOL codes.
* RLE/W (compression 32771): Modified Huffman under ``FAXMODE_WORDALIGN``.
  At the end of a row libtiff drops the bits of its accumulator past a
  multiple of 16; when none are left and its byte pointer ``cp`` is odd,
  it skips a byte.  ``cp`` points into the file libtiff maps (the fax codecs
  take the data as it lies), so the parity is that of the byte's offset in
  the file: the strip's offset counts.
* T.4 (compression 3): every row follows an EOL (``SYNC_EOL``: eleven zero
  bits or more, then a one); with ``T4Options`` bit 0 a tag bit after the
  EOL says whether the row is coded in 1-D or 2-D.
* T.6 / Group 4 (compression 4): every row 2-D, no EOLs; each strip starts
  from an all-white reference row; an EOL ends the strip.
* A bad code ends its row (``unexpected``), a row of the wrong length is
  cut or padded (``CLEANUP_RUNS``), runs past the row are clipped in the
  run array the next row refers to (``_TIFFFax3fillruns``), the data's end
  pads the last code with zeros, and the run arrays (zeroed once) carry
  over from strip to strip (:class:`FaxState`).

The code tables and :class:`_Reader` / :func:`_row_1d` also serve the test
writers (``tests/torch_image_writers.py``).
"""

from __future__ import annotations

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


# ----- libtiff's state machine (tif_fax3.c, tif_fax3.h), error recovery and all

S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB, S_MAKEUPW, S_MAKEUPB, \
    S_MAKEUP, S_EOL = range(13)
_REV = [int(f"{i:08b}"[::-1], 2) for i in range(256)]
_FAX: Dict[str, list] = {}


def _fax_table(bits: int, protos) -> list:
    """A ``mkg3states`` table: indexed by the next ``bits`` bits, first bit
    lowest (libtiff's accumulator); entry (state, width, param); an index
    no code starts with stays (S_NULL, 0, 0)."""
    table = [(S_NULL, 0, 0)] * (1 << bits)
    for code, state, param in protos:
        n = len(code)
        rev = int(code[::-1], 2) if n else 0
        for x in range(1 << (bits - n)):
            table[rev | (x << n)] = (state, n, param)
    return table


def _fax_tables():
    if not _FAX:
        main = [("0001", S_PASS, 0), ("001", S_HORIZ, 0), ("1", S_V0, 0),
                ("011", S_VR, 1), ("000011", S_VR, 2), ("0000011", S_VR, 3),
                ("010", S_VL, 1), ("000010", S_VL, 2), ("0000010", S_VL, 3),
                ("0000001", S_EXT, 0), ("0000000", S_EOL, 0)]
        ext = [(c, S_MAKEUP, 1792 + 64 * i) for i, c in enumerate(_EXT_MAKEUP.split())]
        white = [(c, S_MAKEUPW, 64 * (i + 1)) for i, c in enumerate(_WHITE_MAKEUP.split())]
        white += ext + [(c, S_TERMW, i) for i, c in enumerate(_WHITE_TERM.split())]
        white += [("0" * 11, S_EOL, 0)]
        black = [(c, S_MAKEUPB, 64 * (i + 1)) for i, c in enumerate(_BLACK_MAKEUP.split())]
        black += ext + [(c, S_TERMB, i) for i, c in enumerate(_BLACK_TERM.split())]
        black += [("0" * 11, S_EOL, 0)]
        _FAX["main"] = _fax_table(7, main)
        _FAX["white"] = _fax_table(12, white)
        _FAX["black"] = _fax_table(13, black)
    return _FAX["main"], _FAX["white"], _FAX["black"]


class FaxState:
    """What libtiff's fax decoder keeps from one strip to the next of an
    image: the run arrays (``2 * nruns`` words, zeroed once) and which half
    is the current row's."""

    def __init__(self, width: int, two_d: bool):
        nruns = ((width + 1 + 31) // 32) * 32
        self.nruns = nruns * 2 if two_d else nruns
        self.runs = [0] * (2 * self.nruns)
        self.cur, self.ref = 0, (self.nruns if two_d else None)


class _Overflow(Exception):
    """libtiff's "Buffer overflow": the strip's decoding stops (-1)."""


class _Eof(Exception):
    """No bits left where a code was needed."""


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


def decode_strip(data: bytes, width: int, rows: int, compression: int, t4_options: int,
                 state: FaxState, odd_offset: bool = False) -> "tuple":
    """One strip or tile as libtiff's ``Fax3DecodeRLE`` (2 and 32771),
    ``Fax3Decode1D`` / ``Fax3Decode2D`` (3) or ``Fax4Decode`` (4) decode it,
    bad codes and lengths repaired as ``tif_fax3.h`` repairs them
    (``CLEANUP_RUNS``, runs clipped by ``_TIFFFax3fillruns``); ``odd_offset``
    is the parity of the data's offset in the file, which RLE/W's word
    alignment reads.  Returns the rows' pixels (rows, width) uint8, 1 black,
    and whether the decoder reported success; rows it never reached stay
    0."""
    main, white_t, black_t = _fax_tables()
    out = np.zeros((rows, width), np.uint8)
    runs, nruns = state.runs, state.nruns
    lastx = width
    if state.ref is not None:
        runs[state.ref] = width
        runs[state.ref + 1] = 0
    acc = [0, 0, 0]  # BitAcc, BitsAvail, cp
    end = len(data)

    def need(n: int) -> bool:
        """NeedBits8/16: False at the end of the data with no bits left."""
        while acc[1] < n:
            if acc[2] >= end:
                if acc[1] == 0:
                    return False
                acc[1] = n  # pad with zeros
                return True
            acc[0] |= _REV[data[acc[2]]] << acc[1]
            acc[2] += 1
            acc[1] += 8
        return True

    def clr(n: int) -> None:
        acc[1] -= n
        acc[0] >>= n

    def lookup(table, n: int):
        if not need(n):
            raise _Eof
        ent = table[acc[0] & ((1 << n) - 1)]
        clr(ent[1])
        return ent

    eol = [0]

    def sync_eol() -> None:
        if eol[0] == 0:
            while True:
                if not need(11):
                    raise _Eof
                if acc[0] & 0x7FF == 0:
                    break
                clr(1)
        while True:
            if not need(8):
                raise _Eof
            if acc[0] & 0xFF:
                break
            clr(8)
        while not acc[0] & 1:
            clr(1)
        clr(1)
        eol[0] = 0

    def fill(row: int, this: int, pa: int) -> None:
        """``_TIFFFax3fillruns``: white and black runs, each clipped to
        the row (in the run array too)."""
        if (pa - this) & 1:
            runs[pa] = 0
            pa += 1
        x, bits = 0, out[row]
        for k in range(this, pa, 2):
            run = runs[k]
            if x + run > lastx or run > lastx:
                run = runs[k] = (lastx - x) & 0xFFFFFFFF
            x += run
            run = runs[k + 1]
            if x + run > lastx or run > lastx:
                run = runs[k + 1] = (lastx - x) & 0xFFFFFFFF
            if run:
                bits[x : x + run] = 1
            x += run

    ok = True
    row = 0
    try:
        while row < rows:
            this = state.cur
            st = {"pa": this, "a0": 0, "rl": 0}

            def setvalue(x: int) -> None:
                if st["pa"] >= this + nruns:
                    raise _Overflow
                runs[st["pa"]] = (st["rl"] + x) & 0xFFFFFFFF
                st["pa"] += 1
                st["a0"] = _i32(st["a0"] + x)
                st["rl"] = 0

            def cleanup() -> None:
                if st["rl"]:
                    setvalue(0)
                if st["a0"] != lastx:
                    while st["a0"] > lastx and st["pa"] > this:
                        st["pa"] -= 1
                        st["a0"] = _i32(st["a0"] - runs[st["pa"]])
                    if st["a0"] < lastx:
                        if st["a0"] < 0:
                            st["a0"] = 0
                        if (st["pa"] - this) & 1:
                            setvalue(0)
                        setvalue(lastx - st["a0"])
                    elif st["a0"] > lastx:
                        setvalue(lastx)
                        setvalue(0)

            def expand_1d() -> None:
                """EXPAND1D; raises _Eof where it jumps to eof1d (after its
                cleanup)."""
                try:
                    while True:
                        while True:
                            s_, _w, p = lookup(white_t, 12)
                            if s_ == S_EOL:
                                eol[0] = 1
                                return cleanup()
                            if s_ == S_TERMW:
                                setvalue(p)
                                break
                            if s_ in (S_MAKEUPW, S_MAKEUP):
                                st["a0"] = _i32(st["a0"] + p)
                                st["rl"] += p
                                continue
                            return cleanup()  # unexpected("WhiteTable")
                        if st["a0"] >= lastx:
                            return cleanup()
                        while True:
                            s_, _w, p = lookup(black_t, 13)
                            if s_ == S_EOL:
                                eol[0] = 1
                                return cleanup()
                            if s_ == S_TERMB:
                                setvalue(p)
                                break
                            if s_ in (S_MAKEUPB, S_MAKEUP):
                                st["a0"] = _i32(st["a0"] + p)
                                st["rl"] += p
                                continue
                            return cleanup()  # unexpected("BlackTable")
                        if st["a0"] >= lastx:
                            return cleanup()
                        if runs[st["pa"] - 1] == 0 and runs[st["pa"] - 2] == 0:
                            st["pa"] -= 2
                except _Eof:
                    cleanup()
                    raise

            def expand_2d() -> None:
                """EXPAND2D; raises _Eof where it jumps to eof2d."""
                pb = [state.ref]
                b1 = [runs[pb[0]]]
                pb[0] += 1

                def check_b1() -> None:
                    if st["pa"] != this:
                        while b1[0] <= st["a0"] and b1[0] < lastx:
                            if pb[0] + 1 >= state.ref + nruns:
                                raise _Overflow
                            b1[0] = _i32(b1[0] + runs[pb[0]] + runs[pb[0] + 1])
                            pb[0] += 2

                def next_b1() -> None:
                    if pb[0] >= state.ref + nruns:
                        raise _Overflow
                    b1[0] = _i32(b1[0] + runs[pb[0]])
                    pb[0] += 1

                try:
                    while st["a0"] < lastx:
                        if st["pa"] >= this + nruns:
                            raise _Overflow
                        s_, _w, p = lookup(main, 7)
                        if s_ == S_PASS:
                            check_b1()
                            next_b1()
                            st["rl"] += b1[0] - st["a0"]
                            st["a0"] = b1[0]
                            b1[0] = _i32(b1[0] + runs[pb[0]])
                            pb[0] += 1
                        elif s_ == S_HORIZ:
                            order = ((black_t, 13, S_TERMB, S_MAKEUPB),
                                     (white_t, 12, S_TERMW, S_MAKEUPW))
                            if not (st["pa"] - this) & 1:
                                order = order[::-1]
                            for table, n, term, makeup in order:
                                while True:
                                    s2, _w2, p2 = lookup(table, n)
                                    if s2 == term:
                                        setvalue(p2)
                                        break
                                    if s2 in (makeup, S_MAKEUP):
                                        st["a0"] = _i32(st["a0"] + p2)
                                        st["rl"] += p2
                                        continue
                                    return cleanup()  # unexpected("Black/WhiteTable")
                            check_b1()
                        elif s_ == S_V0:
                            check_b1()
                            setvalue(b1[0] - st["a0"])
                            next_b1()
                        elif s_ == S_VR:
                            check_b1()
                            setvalue(b1[0] - st["a0"] + p)
                            next_b1()
                        elif s_ == S_VL:
                            check_b1()
                            if b1[0] < _i32(st["a0"] + p):
                                return cleanup()  # unexpected("VL")
                            setvalue(b1[0] - st["a0"] - p)
                            pb[0] -= 1
                            b1[0] = _i32(b1[0] - runs[pb[0]])
                        elif s_ == S_EXT:
                            runs[st["pa"]] = (lastx - st["a0"]) & 0xFFFFFFFF
                            st["pa"] += 1
                            return cleanup()
                        elif s_ == S_EOL:
                            runs[st["pa"]] = (lastx - st["a0"]) & 0xFFFFFFFF
                            st["pa"] += 1
                            if not need(4):
                                raise _Eof
                            clr(4)
                            eol[0] = 1
                            return cleanup()
                        else:
                            return cleanup()  # unexpected("MainTable")
                    if st["rl"]:
                        if st["rl"] + st["a0"] < lastx:
                            if not need(1):
                                raise _Eof
                            if not acc[0] & 1:
                                return cleanup()  # badMain2D
                            clr(1)
                        setvalue(0)
                    return cleanup()
                except _Eof:
                    cleanup()
                    raise

            try:
                if compression in (2, 32771):
                    expand_1d()
                elif compression == 3:
                    sync_eol()
                    two_d = False
                    if t4_options & 1:
                        if not need(1):
                            raise _Eof
                        two_d = not acc[0] & 1
                        clr(1)
                    if two_d:
                        expand_2d()
                    else:
                        expand_1d()
                else:
                    expand_2d()
                    if eol[0]:
                        raise _Eof  # Fax4Decode: an EOL ends the strip (EOFG4)
            except _Eof:
                fill(row, this, st["pa"])
                if compression == 4:
                    ok = row > 0  # "don't error on badly-terminated strips"
                else:
                    ok = False
                break
            fill(row, this, st["pa"])
            if compression == 2:
                clr(acc[1] & 7)  # FAXMODE_BYTEALIGN: the rest of the byte
            elif compression == 32771:  # FAXMODE_WORDALIGN
                clr(acc[1] & 15)
                if acc[1] == 0 and (odd_offset + acc[2]) & 1:
                    acc[2] += 1
            elif compression == 4 or st["pa"] < this + nruns:
                setvalue(0)  # the reference's imaginary change
            if state.ref is not None:
                state.cur, state.ref = state.ref, state.cur
            row += 1
    except _Overflow:
        ok = False
    return out, ok
