"""JPEG 2000 tier 2: packets, as OpenJPEG 2.5 reads them (``t2.c``, ``pi.c``,
``tgt.c``, ``bio.c``).

* :class:`BitReader` reads packet headers MSB first with bit stuffing after
  ``0xFF``, and zeros past its end.
* :class:`TagTree` is the quad-tree of inclusion and zero bit-planes, its
  nodes starting at OpenJPEG's 999.
* :func:`packet_order` walks a tile's packets in each of the five
  progressions (LRCP, RLCP, RPCL, PCRL, CPRL), one walk per ``POC`` entry,
  each packet at most once over all of them.
* :func:`decode_packets` reads every packet: ``SOP`` (skipped where it is,
  as OpenJPEG treats it) and ``EPH`` (required where ``COD`` announces
  it), the zero-length bit, inclusion, zero
  bit-planes, the number of passes, ``Lblock`` increments and segment
  lengths (with the segment rules of the code-block style; HTJ2K's, as
  OpenJPEG 2.5.3 reads them: the cleanup segment's first pass alone, the
  next segment every other pass of the packet, with no segment limit of
  HT's own, so a later layer's first pass joins the cleanup), headers taken
  from ``PPM``/``PPT`` where the tile has them, and attaches each
  segment's bytes to its code-block.  A segment that runs past the tile's
  data fails the tile (OpenJPEG's strict mode).
"""

from __future__ import annotations

from typing import Iterator, Tuple

from molnextr_tpu_torch.data.j2k_t1 import HT, LAZY, TERMALL


class T2Error(ValueError):
    """A packet OpenJPEG refuses to read."""


class BitReader:
    """``opj_bio`` over ``data[start:end]``."""

    __slots__ = ("data", "start", "bp", "end", "buf", "ct")

    def __init__(self, data, start: int, end: int):
        self.data, self.start, self.bp, self.end = data, start, start, end
        self.buf, self.ct = 0, 0

    def _bytein(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.bp < self.end:
            self.buf |= self.data[self.bp]
            self.bp += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def inalign(self) -> None:
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0

    def numbytes(self) -> int:
        return self.bp - self.start


class TagTree:
    """``opj_tgt`` over ``w`` x ``h`` leaves."""

    __slots__ = ("parent", "value", "low")

    def __init__(self, w: int, h: int):
        parent = []
        level_w, level_h, first = w, h, 0
        while True:
            n = level_w * level_h
            up_w, up_h = (level_w + 1) // 2, (level_h + 1) // 2
            nxt = first + n
            if n <= 1:
                parent.extend([-1] * n)
                break
            for j in range(level_h):
                for i in range(level_w):
                    parent.append(nxt + (j // 2) * up_w + i // 2)
            first, level_w, level_h = nxt, up_w, up_h
        self.parent = parent
        self.value = [999] * len(parent)
        self.low = [0] * len(parent)

    def reset(self) -> None:
        n = len(self.parent)
        self.value = [999] * n
        self.low = [0] * n

    def decode(self, bio: BitReader, leaf: int, threshold: int) -> int:
        parent, value, lows = self.parent, self.value, self.low
        stack = []
        node = leaf
        while parent[node] >= 0:
            stack.append(node)
            node = parent[node]
        low = 0
        while True:
            if low > lows[node]:
                lows[node] = low
            else:
                low = lows[node]
            while low < threshold and low < value[node]:
                if bio.bit():
                    value[node] = low
                else:
                    low += 1
            lows[node] = low
            if not stack:
                break
            node = stack.pop()
        return 1 if value[node] < threshold else 0


def _min_steps(comps, only=None):
    """RPCL/PCRL/CPRL's ``pi->dx``/``pi->dy``: the smallest precinct step
    on the reference grid over the components (or the one ``only``)."""
    dx = dy = 0
    for compno, comp in enumerate(comps):
        if only is not None and compno != only:
            continue
        nres = len(comp.res)
        for resno, res in enumerate(comp.res):
            sx = res.pdx + nres - 1 - resno
            if sx < 32 and comp.dx <= 0xFFFFFFFF // (1 << sx):
                v = comp.dx * (1 << sx)
                dx = v if not dx else min(dx, v)
            sy = res.pdy + nres - 1 - resno
            if sy < 32 and comp.dy <= 0xFFFFFFFF // (1 << sy):
                v = comp.dy * (1 << sy)
                dy = v if not dy else min(dy, v)
    return dx, dy


def _position_precinct(tile, comp, resno: int, x: int, y: int):
    """The precinct of ``comp``'s resolution ``resno`` that starts at the
    reference-grid position (x, y), or None (``opj_pi_next_rpcl``'s body)."""
    res = comp.res[resno]
    levelno = len(comp.res) - 1 - resno
    if levelno >= 32 or (comp.dx << levelno) > 0x7FFFFFFF or (comp.dy << levelno) > 0x7FFFFFFF:
        return None
    sx, sy = comp.dx << levelno, comp.dy << levelno
    trx0, try0 = -(-tile.x0 // sx), -(-tile.y0 // sy)
    trx1, try1 = -(-tile.x1 // sx), -(-tile.y1 // sy)
    rpx, rpy = res.pdx + levelno, res.pdy + levelno
    if rpx >= 31 or rpy >= 31 or (comp.dx << rpx) > 0xFFFFFFFF or (comp.dy << rpy) > 0xFFFFFFFF:
        return None
    if not (y % (comp.dy << rpy) == 0 or (y == tile.y0 and ((try0 << levelno) % (1 << rpy)))):
        return None
    if not (x % (comp.dx << rpx) == 0 or (x == tile.x0 and ((trx0 << levelno) % (1 << rpx)))):
        return None
    if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
        return None
    prci = ((-(-x // sx)) >> res.pdx) - (trx0 >> res.pdx)
    prcj = ((-(-y // sy)) >> res.pdy) - (try0 >> res.pdy)
    return prci + prcj * res.pw


def _positions(lo: int, hi: int, step: int) -> Iterator[int]:
    v = lo
    while v < hi:
        yield v
        v += step - (v % step)


def packet_order(tile, tcp) -> Iterator[Tuple[int, Tuple[int, int, int, int]]]:
    """(walk, (layer, resolution, component, precinct)) of each packet of
    ``tile`` in the order of ``opj_pi_next`` over every progression (walk)
    of ``tcp``."""
    comps = tile.comps
    ncomp = len(comps)
    max_res = max(len(c.res) for c in comps)
    max_prec = max(r.pw * r.ph for c in comps for r in c.res)
    step_c = max_prec
    step_r = ncomp * step_c
    step_l = max_res * step_r
    if not step_l:
        raise T2Error("no precincts")
    include_size = (tcp.numlayers + 1) * step_l
    include = bytearray(include_size)
    if tcp.poc:
        walks = [(p.prg, p.resno0, p.compno0, min(p.layno1, tcp.numlayers), p.resno1,
                  p.compno1) for p in tcp.pocs]
    else:
        walks = [(tcp.prg, 0, 0, tcp.numlayers, max_res, ncomp)] * (tcp.numpocs + 1)
    for walk, (prg, r0, c0, l1, r1, c1) in enumerate(walks):
        if prg < 0:
            raise T2Error("unknown progression order")
        if prg > 4 or c0 >= ncomp or c1 >= ncomp + 1:
            continue  # opj_pi_next ends the walk
        for packet in _walk(tile, prg, r0, c0, l1, r1, c1):
            index = (packet[0] * step_l + packet[1] * step_r + packet[2] * step_c + packet[3])
            if index >= include_size:
                break  # "Invalid access to pi->include": the walk ends
            if not include[index]:
                include[index] = 1
                yield walk, packet


def _walk(tile, prg: int, r0: int, c0: int, l1: int, r1: int, c1: int):
    comps = tile.comps
    if prg in (0, 1):  # LRCP, RLCP
        outer = ((l, r) for l in range(l1) for r in range(r0, r1)) if prg == 0 else \
            ((l, r) for r in range(r0, r1) for l in range(l1))
        for l, r in outer:
            for c in range(c0, c1):
                comp = comps[c]
                if r >= len(comp.res):
                    continue
                res = comp.res[r]
                for p in range(res.pw * res.ph):
                    yield l, r, c, p
        return
    if prg == 4:  # CPRL
        for c in range(c0, c1):
            comp = comps[c]
            dx, dy = _min_steps(comps, c)
            if not dx or not dy:
                return
            for y in _positions(tile.y0, tile.y1, dy):
                for x in _positions(tile.x0, tile.x1, dx):
                    for r in range(r0, min(r1, len(comp.res))):
                        p = _position_precinct(tile, comp, r, x, y)
                        if p is not None:
                            for l in range(l1):
                                yield l, r, c, p
        return
    dx, dy = _min_steps(comps)
    if not dx or not dy:
        return
    if prg == 2:  # RPCL
        for r in range(r0, r1):
            for y in _positions(tile.y0, tile.y1, dy):
                for x in _positions(tile.x0, tile.x1, dx):
                    for c in range(c0, c1):
                        comp = comps[c]
                        if r >= len(comp.res):
                            continue
                        p = _position_precinct(tile, comp, r, x, y)
                        if p is not None:
                            for l in range(l1):
                                yield l, r, c, p
        return
    for y in _positions(tile.y0, tile.y1, dy):  # PCRL
        for x in _positions(tile.x0, tile.x1, dx):
            for c in range(c0, c1):
                comp = comps[c]
                for r in range(r0, min(r1, len(comp.res))):
                    p = _position_precinct(tile, comp, r, x, y)
                    if p is not None:
                        for l in range(l1):
                            yield l, r, c, p


class Segment:
    __slots__ = ("len", "numpasses", "real_num_passes", "maxpasses", "numnewpasses", "newlen")

    def __init__(self):
        self.len = self.numpasses = self.real_num_passes = 0
        self.maxpasses = self.numnewpasses = self.newlen = 0


def _init_seg(cblk, index: int, cblksty: int, first: bool) -> Segment:
    while len(cblk.segs) <= index:
        cblk.segs.append(Segment())
    seg = Segment()
    cblk.segs[index] = seg
    if cblksty & TERMALL:
        seg.maxpasses = 1
    elif cblksty & LAZY:
        if first:
            seg.maxpasses = 10
        else:
            seg.maxpasses = 2 if cblk.segs[index - 1].maxpasses in (1, 10) else 1
    else:
        seg.maxpasses = 109
    return seg


def _numpasses(bio: BitReader) -> int:
    if not bio.bit():
        return 1
    if not bio.bit():
        return 2
    n = bio.bits(2)
    if n != 3:
        return 3 + n
    n = bio.bits(5)
    if n != 31:
        return 6 + n
    return 37 + bio.bits(7)


class HeaderSource:
    """Where packet headers are read from: the packet data itself, or the
    bytes of ``PPM`` / ``PPT`` (``data``, position ``pos``, ``end``)."""

    __slots__ = ("data", "pos", "end")

    def __init__(self, data, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end


def _read_header(tile, tcp, packet, data, pos: int, end: int, headers):
    """``opj_t2_read_packet_header``: returns (data present, new pos)."""
    layno, resno, compno, precno = packet
    comp = tile.comps[compno]
    res = comp.res[resno]
    if layno == 0:
        for band in res.bands:
            if band.empty:
                continue
            if precno >= len(band.precincts):
                raise T2Error("Invalid precinct")
            prc = band.precincts[precno]
            if prc.incl is not None:
                prc.incl.reset()
                prc.imsb.reset()
            for cblk in prc.cblks:
                cblk.numsegs = 0
                cblk.real_num_segs = 0
    if tcp.csty & 0x02:  # SOP
        if end - pos >= 6 and data[pos] == 0xFF and data[pos + 1] == 0x91:
            pos += 6
    if headers is None:
        src = HeaderSource(data, pos, end)
    else:
        src = headers
    bio = BitReader(src.data, src.pos, src.end)
    present = bio.bit()
    cblksty = tcp.tccps[compno].cblksty
    if present:
        for band in res.bands:
            if band.empty:
                continue
            prc = band.precincts[precno]
            for cblkno, cblk in enumerate(prc.cblks):
                if not cblk.numsegs:
                    included = prc.incl.decode(bio, cblkno, layno + 1)
                else:
                    included = bio.bit()
                if not included:
                    cblk.numnewpasses = 0
                    continue
                if not cblk.numsegs:
                    i = 0
                    while not prc.imsb.decode(bio, cblkno, i):
                        i += 1
                    cblk.numbps = (band.numbps + 1 - i) & 0xFFFFFFFF
                    cblk.mb = band.numbps
                    cblk.numlenbits = 3
                cblk.numnewpasses = _numpasses(bio)
                increment = 0
                while bio.bit():
                    increment += 1
                cblk.numlenbits += increment
                if not cblk.numsegs:
                    segno = 0
                    seg = _init_seg(cblk, 0, cblksty, True)
                else:
                    segno = cblk.numsegs - 1
                    seg = cblk.segs[segno]
                    if seg.numpasses == seg.maxpasses:
                        segno += 1
                        seg = _init_seg(cblk, segno, cblksty, False)
                n = cblk.numnewpasses
                while True:
                    if cblksty & HT:  # the cleanup segment 1 pass, the next all the rest
                        seg.numnewpasses = 1 if segno == 0 else n
                    else:
                        seg.numnewpasses = min(seg.maxpasses - seg.numpasses, n)
                    bit_number = cblk.numlenbits + (seg.numnewpasses.bit_length() - 1
                                                    if seg.numnewpasses > 0 else 0)
                    if bit_number > 32:
                        raise T2Error(f"Invalid bit number {bit_number}")
                    seg.newlen = bio.bits(bit_number)
                    n -= seg.numnewpasses
                    if n <= 0:
                        break
                    segno += 1
                    seg = _init_seg(cblk, segno, cblksty, False)
    bio.inalign()
    hpos = src.pos + bio.numbytes()
    if tcp.csty & 0x04:  # EPH: required where COD announces it
        if src.end - hpos < 2 or src.data[hpos] != 0xFF or src.data[hpos + 1] != 0x92:
            raise T2Error("Expected EPH marker")
        hpos += 2
    if headers is None:
        pos = hpos
    else:
        headers.pos = hpos
    return bool(present), pos


def _read_data(res, precno: int, data, pos: int, end: int, keep: bool) -> int:
    """``opj_t2_read_packet_data`` (``keep``) / ``opj_t2_skip_packet_data``."""
    for band in res.bands:
        if band.empty:
            continue
        prc = band.precincts[precno]
        for cblk in prc.cblks:
            if not cblk.numnewpasses:
                continue
            if not cblk.numsegs:
                segno = 0
                cblk.numsegs = 1
            else:
                segno = cblk.numsegs - 1
                if cblk.segs[segno].numpasses == cblk.segs[segno].maxpasses:
                    segno += 1
                    cblk.numsegs += 1
            while True:
                seg = cblk.segs[segno]
                if pos + seg.newlen > end:
                    raise T2Error(f"segment too long ({seg.newlen}) with max ({end - pos})")
                if keep:
                    cblk.chunks.append(bytes(data[pos : pos + seg.newlen]))
                    cblk.offsets.append(pos)
                    seg.len += seg.newlen
                pos += seg.newlen
                seg.numpasses += seg.numnewpasses
                cblk.numnewpasses -= seg.numnewpasses
                if keep:
                    seg.real_num_passes = seg.numpasses
                if cblk.numnewpasses > 0:
                    segno += 1
                    cblk.numsegs += 1
                else:
                    break
            if keep:
                cblk.real_num_segs = cblk.numsegs
    return pos


def decode_packets(tile, tcp, data, headers, resno_decoded) -> None:
    """``opj_t2_decode_packets`` over a tile's bytes: every code-block gets
    its segments and chunks; ``resno_decoded`` (per component, the image's)
    is updated as OpenJPEG updates it."""
    pos, end = 0, len(data)
    current, failed = -1, []
    for walk, packet in packet_order(tile, tcp):
        if walk != current:
            current, failed = walk, [True] * len(tile.comps)
        layno, resno, compno, precno = packet
        comp = tile.comps[compno]
        res = comp.res[resno]
        skip = layno >= tcp.numlayers or not any(
            precno < len(b.precincts) and b.precincts[precno].area for b in res.bands)
        present, pos = _read_header(tile, tcp, packet, data, pos, end, headers)
        if present:
            pos = _read_data(res, precno, data, pos, end, not skip)
        if not skip:
            failed[compno] = False
            resno_decoded[compno] = max(resno_decoded[compno], resno)
        elif failed[compno] and resno_decoded[compno] == 0:
            resno_decoded[compno] = len(comp.res) - 1
