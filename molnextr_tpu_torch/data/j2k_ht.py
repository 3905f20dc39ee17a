"""HTJ2K code-blocks (ISO/IEC 15444-15, ITU-T T.814) as OpenJPEG 2.5.3
decodes them (``ht_dec.c``'s ``opj_t1_ht_decode_cblk``), in Python and numpy.

:func:`decode_ht_cblk` turns one HT code-block's bytes into coefficients in
the scale and layout of :func:`data.j2k_t1.decode_cblk` (twice the magnitude
and the half of the last decoded bit-plane, with the sign), so that
``data/j2k_dwt.py``'s dequantisation and inverse wavelets serve both.

* The cleanup pass (one segment, ``Lcup`` bytes): ``Scup`` from its last two
  bytes; the MEL stream of run-length events (MSB first, forward from
  ``Lcup - Scup``, its last byte's low nibble read as ones); the VLC stream
  (LSB first, backward from the upper nibble of byte ``Lcup - 2``) with the
  two context tables (the first line pair of quads has its own) and the
  u-VLC, whose first line pair codes two quads that both have ``u_off`` 1
  with a MEL event; the MagSgn stream (LSB first, forward from the start).
  Quads are worked a pair at a time in Python, as the streams force it.
* The SigProp pass (a raw stream forward from the refinement segment's
  start) and the MagRef pass (backward from its end) of the plane below;
  SigProp sees no sample of the stripe below under ``VSC``.
* Bit unstuffing as OpenJPEG reads each stream: MagSgn, MEL and SigProp
  read seven bits of the byte after an ``0xFF``; VLC and MagRef read seven
  of a byte whose low seven bits are ``0x7F`` after a byte above ``0x8F``,
  and a dropped MSB that is set is ORed into the next byte's first bit.
  Past its bytes MagSgn reads ones, VLC, SigProp and MagRef zeros, MEL
  ones.  OpenJPEG reads the first MEL bytes singly up to an address that
  is a multiple of four, and refuses an ``0xFF`` followed by a byte above
  ``0x8F`` among them (``align``: the segment's address modulo 4).
* What OpenJPEG refuses (:class:`data.j2k_t1.T1Error`, which fails the
  tile): a region of interest, more than 3 passes, more than 30 bit-planes,
  more zero bit-planes than bit-planes, lengths out of bounds, ``Scup``
  outside ``2..min(Lcup, 4079)``, the MEL sequence above, a ``U_q`` past
  the zero bit-planes + 1, and significance outside the block.  Where it
  warns and goes on (a second pass of no bytes; passes past the cleanup
  when the zero bit-planes fill every plane) only the cleanup is decoded.
  The u-VLC's 4-bit extension is never read, as in OpenJPEG: a ``u_q``
  that needs it is past 30 bit-planes and refused.

The context tables (``j2k_ht.npz``: entries ``e_k << 12 | e_1 << 8 |
rho << 4 | u_off << 3 | length`` indexed by the context and the next 7 VLC
bits) were read out of the OpenJPEG 2.5.3 linked into cv2 5.0.0
(``tests/test_torch_fixtures.py::build_ht_tables``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from molnextr_tpu_torch.data.j2k_t1 import VSC, T1Error

with np.load(Path(__file__).with_name("j2k_ht.npz")) as _z:
    VLC_INITIAL = _z["vlc_initial"].tolist()
    VLC_LATER = _z["vlc_later"].tolist()

# T.814 table 3: the u-VLC prefix codewords (first bit first), u_pfx and the
# suffix length; u = u_pfx + suffix
U_PREFIXES = (("1", 1, 0), ("01", 2, 0), ("001", 3, 1), ("000", 5, 5))


def _uvlc_table() -> List[Tuple[int, int, int]]:
    """(prefix length, suffix length, u_pfx) by the next three VLC bits
    (the first bit read the least significant)."""
    table = []
    for v in range(8):
        for code, pfx, sfx in U_PREFIXES:
            if all((v >> i) & 1 == int(c) for i, c in enumerate(code)):
                table.append((len(code), sfx, pfx))
                break
    return table


UVLC = _uvlc_table()
MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)


def _pack(vals: np.ndarray, counts: np.ndarray, fill: int, extra: int) -> np.ndarray:
    """The unstuffed bits (0/1, LSB first) of bytes ``vals`` that give
    ``counts`` bits each, every byte's eight bits ORed in at the running sum
    of the counts, then ``extra`` bits of ``fill``."""
    pos = np.concatenate(([0], np.cumsum(counts)))
    total = int(pos[-1])
    bits = np.zeros(total + 8 + extra, np.uint8)
    if len(vals):
        b = np.unpackbits(vals.astype(np.uint8)[:, None], axis=1, bitorder="little")
        idx = pos[:-1, None] + np.arange(8)
        bits[idx[b == 1]] = 1
    if fill:
        bits[total:] = 1
    return bits


def _forward(data: bytes, start: int, size: int, fill: int, extra: int) -> np.ndarray:
    """MagSgn and SigProp: seven bits of the byte after an ``0xFF``."""
    vals = np.frombuffer(data, np.uint8, max(size, 0), start)
    counts = np.full(len(vals), 8, np.int64)
    counts[1:] -= vals[:-1] == 0xFF
    return _pack(vals, counts, fill, extra)


def _backward_counts(vals: np.ndarray, gt_first: bool) -> np.ndarray:
    """VLC and MagRef, bytes in reading order: seven bits of a byte whose
    low seven bits are ``0x7F`` after one above ``0x8F`` (``gt_first``: the
    one before the first)."""
    gt = np.concatenate(([gt_first], vals[:-1] > 0x8F))[: len(vals)]
    return 8 - (gt & ((vals & 0x7F) == 0x7F)).astype(np.int64)


def _vlc_bits(data: bytes, lcup: int, scup: int, extra: int) -> np.ndarray:
    """The VLC stream: the upper nibble of byte ``Lcup - 2`` (three bits
    of it if its low three are ones), then bytes ``Lcup - 3`` down to
    ``Lcup - Scup``, then zeros."""
    d = data[lcup - 2]
    rest = np.frombuffer(data, np.uint8, scup - 2, lcup - scup)[::-1]
    counts = np.concatenate(([4 - ((d >> 4) & 7 == 7)], _backward_counts(rest, (d | 0xF) > 0x8F)))
    return _pack(np.concatenate(([d >> 4], rest)).astype(np.uint8), counts, 0, extra)


def _packed(bits: np.ndarray) -> bytes:
    return np.packbits(bits, bitorder="little").tobytes() + bytes(8)


def _mel_refused(data: bytes, start: int, size: int, align: int) -> bool:
    """``mel_init``: an ``0xFF`` then a byte above ``0x8F`` among the bytes
    read singly (up to an address that is a multiple of four)."""
    unstuff = False
    for i in range(4 - (align + start) % 4):
        at = start + min(i, size)
        if unstuff and data[at] > 0x8F:
            return True
        d = data[at] if size - i > 0 else 0xFF
        if size - i == 1:
            d |= 0xF
        unstuff = d == 0xFF
    return False


def _mel_events(data: bytes, start: int, size: int) -> Iterator[int]:
    """The MEL decoder's events: MSB first, seven bits of the byte after an
    ``0xFF``, the last byte's low nibble ones, then ones."""
    def bits():
        prev = 0
        for i in range(size):
            d = data[start + i] | (0xF if i == size - 1 else 0)
            for k in range(6 if prev == 0xFF else 7, -1, -1):
                yield (d >> k) & 1
            prev = d
        while True:
            yield 1

    stream = bits()
    k = 0
    while True:
        e = MEL_EXP[k]
        if next(stream):
            for _ in range(1 << e):
                yield 0
            k = min(k + 1, 12)
        else:
            run = 0
            for _ in range(e):
                run = (run << 1) | next(stream)
            for _ in range(run):
                yield 0
            yield 1
            k = max(k - 1, 0)


def _cleanup(data: bytes, lcup: int, scup: int, w: int, h: int, p: int, zbp1: int,
             out: np.ndarray, sig: np.ndarray) -> None:
    """The HT cleanup pass into ``out`` (uint32 samples: bit 31 the sign,
    the magnitude (2 mu + 1) << (p - 1), which may wrap) and ``sig``."""
    qh, qw = (h + 1) // 2, (w + 1) // 2
    mel = _mel_events(data, lcup - scup, scup - 1)
    vbuf = _packed(_vlc_bits(data, lcup, scup, 16 * qh * qw + 64))
    ms = _forward(data, 0, lcup - scup, 1, 32 * (4 * qh * qw) + 64)
    mbuf = _packed(ms)
    vpos = mpos = 0
    width_e = 2 * qw + 3
    e_up = [0] * width_e  # E of the row above, by column + 1
    mask32 = 0xFFFFFFFF
    shift = p - 1
    for qy in range(qh):
        first = qy == 0
        table = VLC_INITIAL if first else VLC_LATER
        e_cur = [0] * width_e
        y = 2 * qy
        tall = y + 2 <= h
        qinf_prev = 0
        for x in range(0, w, 4):
            qx = x >> 1
            qinf = [0, 0]
            for k in (0, 1):
                if k and x + 2 >= w:
                    break
                c = qx + k
                if first:
                    c_q = ((qinf_prev & 0x10) >> 4) | ((qinf_prev & 0xE0) >> 5)
                else:
                    c_q = (((qinf_prev & 0x40) >> 5) | ((qinf_prev & 0x80) >> 6)
                           | int(e_up[2 * c] > 0 or e_up[2 * c + 1] > 0)
                           | (4 if e_up[2 * c + 2] > 0 or e_up[2 * c + 3] > 0 else 0))
                v = int.from_bytes(vbuf[vpos >> 3 : (vpos >> 3) + 2], "little") >> (vpos & 7)
                q = table[(c_q << 7) | (v & 0x7F)]
                if c_q == 0 and not next(mel):
                    q = 0
                vpos += q & 7
                qinf[k] = q
                qinf_prev = q
            mode = ((qinf[0] & 8) >> 3) | ((qinf[1] & 8) >> 2)
            v = int.from_bytes(vbuf[vpos >> 3 : (vpos >> 3) + 4], "little") >> (vpos & 7)
            u = [1, 1]
            used = 0
            if mode == 3 and first and next(mel):
                mode = 4
            if mode in (1, 2):
                plen, slen, pfx = UVLC[v & 7]
                d = pfx + ((v >> plen) & ((1 << slen) - 1))
                used = plen + slen
                u[mode - 1] = d + 1
            elif mode == 3 and first and UVLC[v & 7][0] > 2:
                plen, slen, pfx = UVLC[v & 7]
                v >>= plen
                u[1] = (v & 1) + 2
                v >>= 1
                u[0] = pfx + (v & ((1 << slen) - 1)) + 1
                used = plen + 1 + slen
            elif mode >= 3:
                plen1, slen1, pfx1 = UVLC[v & 7]
                v >>= plen1
                plen2, slen2, pfx2 = UVLC[v & 7]
                v >>= plen2
                u[0] = pfx1 + (v & ((1 << slen1) - 1)) + (3 if mode == 4 else 1)
                v >>= slen1
                u[1] = pfx2 + (v & ((1 << slen2) - 1)) + (3 if mode == 4 else 1)
                used = plen1 + plen2 + slen1 + slen2
            vpos += used
            if not first:
                for k in (0, 1):
                    rho = qinf[k] & 0xF0
                    if rho & (rho - 1):
                        c = qx + k
                        e = max(e_up[2 * c], e_up[2 * c + 1], e_up[2 * c + 2], e_up[2 * c + 3])
                        if e > 2:
                            u[k] += e - 2
            if u[0] > zbp1 or u[1] > zbp1:
                raise T1Error("Malformed HT codeblock. Decoding this codeblock is stopped. "
                              "U_q is larger than zero bitplanes + 1")
            locs = 0xFF
            if x + 4 > w:
                locs >>= (x + 4 - w) << 1
            if not tall:
                locs &= 0x55
            if (((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs:
                raise T1Error("Malformed HT codeblock. VLC code produces significant samples "
                              "outside the codeblock area.")
            for k in (0, 1):
                q = qinf[k]
                if not q & 0xF0:
                    continue
                c = qx + k
                for n in range(4):
                    if not (q >> (4 + n)) & 1:
                        continue
                    ms_val = int.from_bytes(mbuf[mpos >> 3 : (mpos >> 3) + 5], "little") \
                        >> (mpos & 7)
                    m_n = u[k] - ((q >> (12 + n)) & 1)
                    mpos += m_n
                    vn = (ms_val & ((1 << m_n) - 1)) | (((q >> (8 + n)) & 1) << m_n) | 1
                    vn &= mask32
                    sy, sx = y + (n & 1), 2 * c + (n >> 1)
                    out[sy, sx] = ((ms_val & 1) << 31) | ((((vn + 2) & mask32) << shift) & mask32)
                    sig[sy, sx] = True
                    if n & 1:
                        e_cur[sx + 1] = vn.bit_length()
        e_up = e_cur


def _sigprop(bits: List[int], out: np.ndarray, sig: np.ndarray, p: int, vsc: bool) -> None:
    """The HT SigProp pass: stripes of four rows, each in groups of four
    columns; a bit for each sample not significant in the cleanup that has
    a significant neighbour (the cleanup's anywhere but, under ``vsc``, in
    the stripe below; this pass's before it), then a sign bit for each
    sample of the group that became significant."""
    h, w = sig.shape
    near = np.zeros((h + 2, w + 2), bool)  # next to (or at) a cleanup significance
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            near[dy : h + dy, dx : w + dx] |= sig
    now = np.pad(sig, 1).tolist()  # significance so far, padded by one
    val = 3 << (p - 2)
    pos = 0
    for y0 in range(0, h, 4):
        y1 = min(y0 + 4, h)
        for x0 in range(0, w, 4):
            x1 = min(x0 + 4, w)
            if not (near[y0 + 1 : y1 + 1, x0 + 1 : x1 + 1].any()
                    or any(now[y][x0] for y in range(y0, y1 + 2))
                    or any(now[y0][x0 : x1 + 2])):
                continue
            found = []
            for x in range(x0, x1):
                for y in range(y0, y1):
                    r1 = now[y + 1]
                    if r1[x + 1]:
                        continue
                    r0 = now[y]
                    hit = r0[x] or r0[x + 1] or r0[x + 2] or r1[x] or r1[x + 2]
                    if not hit and (y + 1 < y0 + 4 or not vsc):
                        r2 = now[y + 2]
                        hit = r2[x] or r2[x + 1] or r2[x + 2]
                    if not hit:
                        continue
                    if bits[pos]:
                        found.append((y, x))
                        r1[x + 1] = True
                    pos += 1
            for y, x in found:
                out[y, x] = (bits[pos] << 31) | val
                pos += 1


def _magref(bits: List[int], out: np.ndarray, sig: np.ndarray, p: int) -> None:
    """The HT MagRef pass: a bit for each sample significant in the
    cleanup, stripe by stripe and column by column; a 0 takes off the half
    the cleanup put in, then half of what remains goes in."""
    h, w = sig.shape
    order = np.arange(h * w).reshape(h, w)
    stripes = [order[y0 : y0 + 4].T.ravel() for y0 in range(0, h, 4)]
    scan = np.concatenate(stripes)
    flat = out.reshape(-1)
    where = scan[sig.reshape(-1)[scan]]
    sym = np.asarray(bits[: len(where)], np.int64)
    flat[where] = (flat[where] ^ ((1 - sym) << (p - 1))) | (1 << (p - 2))


def decode_ht_cblk(w: int, h: int, cblksty: int, numbps: int, mb: int, roishift: int,
                   data: bytes, segs: Sequence[Tuple[int, int]], numsegs: int,
                   align: int) -> np.ndarray:
    """Coefficients (int64, ``(h, w)``, module doc) of a ``w`` x ``h`` HT
    code-block of ``mb`` bit-planes (the band's, 0 if the block was never
    included) and ``numbps`` decoded ones (OpenJPEG's ``cblk->numbps``),
    from its bytes ``data`` (every chunk joined), the (length, passes) of
    its first two segments ``segs`` (those it has, used or not: OpenJPEG
    reads the second's length when the first alone has two passes) of which
    ``numsegs`` are in use, and ``align``: the address of ``data`` modulo 4
    in OpenJPEG's buffers (module doc)."""
    if roishift:
        raise T1Error("We do not support ROI in decoding HT codeblocks")
    out = np.zeros((h, w), np.int64)
    if mb == 0 or not numsegs:
        return out
    zero_bplanes = (mb + 1 - numbps) & 0xFFFFFFFF
    segs = list(segs[:2]) + [(0, 0)] * (2 - len(segs[:2]))
    num_passes = sum(n for _, n in segs[:numsegs])
    lengths1 = segs[0][0] if num_passes > 0 else 0
    lengths2 = segs[1][0] if num_passes > 1 else 0
    if num_passes > 1 and lengths2 == 0:
        num_passes = 1  # OpenJPEG warns: a second pass of no bytes
    if num_passes > 3:
        raise T1Error(f"We do not support more than 3 coding passes in an HT codeblock; "
                      f"This codeblocks has {num_passes} passes.")
    if mb > 30:
        raise T1Error(f"32 bits are not enough to decode this codeblock, since the number of "
                      f"bitplane, {mb}, is larger than 30.")
    if zero_bplanes > mb:
        raise T1Error("Malformed HT codeblock. Decoding this codeblock is stopped. There are "
                      f"{zero_bplanes} zero bitplanes in {mb} bitplanes.")
    if zero_bplanes == mb:
        num_passes = min(num_passes, 1)  # OpenJPEG warns: the cleanup alone makes sense
    p = numbps
    if lengths1 < 2 or lengths1 > len(data) or lengths1 + lengths2 > len(data):
        raise T1Error("Malformed HT codeblock. Invalid codeblock length values.")
    lcup = lengths1
    scup = (data[lcup - 1] << 4) + (data[lcup - 2] & 0xF)
    if scup < 2 or scup > lcup or scup > 4079:
        raise T1Error("Malformed HT codeblock. One of the following condition is not met: "
                      "2 <= Scup <= min(Lcup, 4079)")
    if _mel_refused(data, lcup - scup, scup - 1, align):
        raise T1Error("Malformed HT codeblock. Incorrect MEL segment sequence.")
    sig = np.zeros((h, w), bool)
    _cleanup(data, lcup, scup, w, h, p, zero_bplanes + 1, out, sig)
    if num_passes > 1:
        if num_passes > 2:
            vals = np.frombuffer(data, np.uint8, lengths2, lcup)[::-1]
            mr = _pack(vals, _backward_counts(vals, True), 0, h * w + 64)
            _magref(mr.tolist(), out, sig, p)
        sp = _forward(data, lcup, lengths2, 0, 2 * h * w + 64).tolist()
        _sigprop(sp, out, sig, p, bool(cblksty & VSC))
    mag = out & 0x7FFFFFFF
    return np.where(out >> 31, -mag, mag)
