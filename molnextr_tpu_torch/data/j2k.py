"""The JPEG 2000 codestream (ISO/IEC 15444-1 annex A) as OpenJPEG 2.5 reads
it, in Python and numpy: :class:`Decoder` (``read_header``, then ``decode``).

The reader follows ``j2k.c`` step by step, because what ``cv2.imread``
returns for a damaged or unusual file is what that code does with it:

* the main header: ``SOC``, then ``SIZ`` first, then ``COD``, ``COC``,
  ``QCD``, ``QCC``, ``RGN``, ``POC``, ``PPM``, ``TLM``, ``PLM``, ``CRG``,
  ``COM`` (and Part 15's ``CAP`` and ``CPF``, read and not used: HT
  code-blocks are told by the code-block style alone, as OpenJPEG tells
  them) in any order up to the first ``SOT``; an unknown
  marker is skipped two bytes at a time up to the next known one.
  ``COD``/``QCD`` set every component, ``COC``/``QCC`` one; scalar-derived
  steps are expanded per band; each tile starts with a copy of the main
  header's parameters.
* tile-parts in any order of tiles, each tile's parts in order (``TPsot``),
  with their headers (``COD``, ``COC``, ``QCD``, ``QCC``, ``RGN``, ``POC``,
  ``PPT``, ``PLT``, ``COM``) and data; a tile is decoded once its last part
  (``TNsot``) is read, or at ``EOC``.  OpenJPEG's strict mode: a tile-part
  longer than the data left, or a stream that ends without ``EOC``, fails.
* tile geometry from ``SIZ`` down: tile, tile-component (``XRsiz``/``YRsiz``),
  resolution, band, precinct (``PPx``/``PPy``) and code-block, by the
  standard's ceil-division rules (``opj_tcd_init_tile``).
* each tile: packets (``data/j2k_t2.py``), code-blocks (``data/j2k_t1.py``,
  or ``data/j2k_ht.py`` for HTJ2K's, Part 15, each chunk's place in the
  tile's data kept for OpenJPEG's MEL check), dequantisation, inverse
  wavelet, inverse RCT/ICT, DC level shift and clamp
  (``data/j2k_dwt.py``), then copied into the image's components.

* Part 2's ``CBD`` (main header: each component's precision and sign,
  which the clamp after the level shift and OpenCV's depth then use),
  ``MCT``, ``MCC`` and ``MCO`` (main and tile-part headers), validated as
  ``opj_j2k_read_*`` validates them.  ``MCO`` sets every level shift to 0,
  then to the offsets of the first ``MCC`` collection when the stage names
  it (OpenJPEG's ``opj_j2k_add_mct`` looks at no other); its decorrelation
  matrix is only checked for its size: ``COD`` refuses the custom
  transform (``mct`` 2) that would apply it.

Failures raise :class:`J2KError` (a ``ValueError``, which ``data/image.py``
turns into None as cv2 gives None).  ``SPcod``'s mixed HT style (``0x80``)
is refused, as OpenJPEG refuses it.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np

from molnextr_tpu_torch.data.j2k_dwt import (band_stepsize, dc_shift, dequantise, idwt53,
                                             idwt97, inverse_ict, inverse_rct)
from molnextr_tpu_torch.data.j2k_ht import decode_ht_cblk
from molnextr_tpu_torch.data.j2k_t1 import HT, T1Error, decode_cblk
from molnextr_tpu_torch.data.j2k_t2 import HeaderSource, T2Error, TagTree, decode_packets

SOC, SOT, SOD, EOC = 0xFF4F, 0xFF90, 0xFF93, 0xFFD9
SIZ, COD, COC, RGN, QCD, QCC, POC = 0xFF51, 0xFF52, 0xFF53, 0xFF5E, 0xFF5C, 0xFF5D, 0xFF5F
TLM, PLM, PLT, PPM, PPT, SOP, CRG, COM = (0xFF55, 0xFF57, 0xFF58, 0xFF60, 0xFF61, 0xFF91,
                                         0xFF63, 0xFF64)
CAP, CPF, CBD, MCT, MCC, MCO = 0xFF50, 0xFF59, 0xFF78, 0xFF74, 0xFF75, 0xFF77

# decoder states (J2K_STATE_*)
ST_MHSIZ, ST_MH, ST_TPHSOT, ST_TPH, ST_NEOC, ST_EOC = 2, 4, 8, 16, 64, 256
# the states each marker may appear in; others are "unknown" (UNK: MH | TPH)
_STATES = {SOT: ST_MH | ST_TPHSOT, COD: ST_MH | ST_TPH, COC: ST_MH | ST_TPH,
           RGN: ST_MH | ST_TPH, QCD: ST_MH | ST_TPH, QCC: ST_MH | ST_TPH, POC: ST_MH | ST_TPH,
           SIZ: ST_MHSIZ, TLM: ST_MH, PLM: ST_MH, PLT: ST_TPH, PPM: ST_MH, PPT: ST_TPH,
           SOP: 0, CRG: ST_MH, COM: ST_MH | ST_TPH, MCT: ST_MH | ST_TPH, CBD: ST_MH,
           CAP: ST_MH, CPF: ST_MH, MCC: ST_MH | ST_TPH, MCO: ST_MH | ST_TPH}
_UNK_STATES = ST_MH | ST_TPH
MAXRLVLS, MAXBANDS, MAX_POCS = 33, 3 * 33 - 2, 32


class J2KError(ValueError):
    """A codestream OpenJPEG refuses."""


def _be(data, pos: int, n: int) -> int:
    return int.from_bytes(bytes(data[pos : pos + n]), "big")


def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def _ceildivpow2(a: int, b: int) -> int:
    return -(-a >> b)


class Stream:
    """``opj_stream`` over bytes: reads that may come short."""

    def __init__(self, data, pos: int = 0):
        self.data, self.pos = data, pos

    def left(self) -> int:
        return len(self.data) - self.pos

    def read(self, n: int) -> bytes:
        out = bytes(self.data[self.pos : self.pos + n])
        self.pos += len(out)
        return out


class Component:
    """A ``SIZ`` component (``opj_image_comp_t``)."""

    def __init__(self, prec, sgnd, dx, dy):
        self.prec, self.sgnd, self.dx, self.dy = prec, sgnd, dx, dy
        self.x0 = self.y0 = self.w = self.h = 0
        self.data: Optional[np.ndarray] = None


class TCCP:
    """Per-component coding parameters (``opj_tccp_t``)."""

    def __init__(self):
        self.csty = 0
        self.numres = 0
        self.cblkw = self.cblkh = self.cblksty = self.qmfbid = 0
        self.prcw = [0] * MAXRLVLS
        self.prch = [0] * MAXRLVLS
        self.qntsty = self.numgbits = 0
        self.steps = [(0, 0)] * MAXBANDS
        self.roishift = 0
        self.dc_shift = 0


class POCEntry:
    def __init__(self, resno0, compno0, layno1, resno1, compno1, prg):
        self.resno0, self.compno0, self.layno1 = resno0, compno0, layno1
        self.resno1, self.compno1, self.prg = resno1, compno1, prg


class TCP:
    """Per-tile coding parameters and data (``opj_tcp_t``)."""

    def __init__(self, ncomp: int):
        self.csty = self.prg = self.numlayers = self.mct = 0
        self.tccps = [TCCP() for _ in range(ncomp)]
        self.poc = False
        self.pocs: List[POCEntry] = []
        self.numpocs = 0
        self.ppt = False
        self.ppt_markers: Dict[int, bytes] = {}
        self.data: Optional[bytearray] = None
        self.current_part = -1
        self.nb_parts = 0
        self.mct_records: List[MCTRecord] = []
        self.mcc_slots: List[MCCRecord] = []  # records, then slots a new one reuses
        self.nb_mcc = 0


class MCTRecord:
    """An ``MCT`` array (``opj_mct_data_t``): index, array and element
    types, its bytes (None where a second ``Ymct`` left it without)."""

    def __init__(self, index: int):
        self.index = index
        self.array_type = self.element_type = 0
        self.data: Optional[bytes] = None


class MCCRecord:
    """An ``MCC`` collection (``opj_simple_mcc_decorrelation_data_t``)."""

    def __init__(self):
        self.index = self.nb_comps = 0
        self.irreversible = False
        self.decorrelation: Optional[MCTRecord] = None
        self.offset: Optional[MCTRecord] = None


# ----- marker segments -----------------------------------------------------

def _read_siz(d, seg: bytes) -> None:
    if len(seg) < 36:
        raise J2KError("Error with SIZ marker size")
    ncomp, rem = divmod(len(seg) - 36, 3)
    if ncomp > 16384 or rem:
        raise J2KError("Error with SIZ marker size")
    (x1, y1, x0, y0, tdx, tdy, tx0, ty0) = (_be(seg, 2 + 4 * i, 4) for i in range(8))
    csiz = _be(seg, 34, 2)
    if csiz >= 16385:
        raise J2KError("Error with SIZ marker: number of component is illegal")
    if csiz != ncomp:
        raise J2KError("Error with SIZ marker: number of component is not compatible")
    if x0 >= x1 or y0 >= y1:
        raise J2KError("Error with SIZ marker: negative or zero image size")
    if tdx == 0 or tdy == 0:
        raise J2KError("Error with SIZ marker: invalid tile size")
    tx1 = min(tx0 + tdx, 0xFFFFFFFF)
    ty1 = min(ty0 + tdy, 0xFFFFFFFF)
    if tx0 > x0 or ty0 > y0 or tx1 <= x0 or ty1 <= y0:
        raise J2KError("Error with SIZ marker: illegal tile offset")
    if d.ihdr and d.ihdr != (x1 - x0, y1 - y0):
        raise J2KError("Error with SIZ marker: IHDR size vs. SIZ size")
    comps = []
    for i in range(ncomp):
        s, dx, dy = seg[36 + 3 * i], seg[37 + 3 * i], seg[38 + 3 * i]
        comp = Component((s & 0x7F) + 1, s >> 7, dx, dy)
        if not (1 <= dx <= 255 and 1 <= dy <= 255):
            raise J2KError(f"Invalid values for comp = {i} : dx={dx} dy={dy}")
        if comp.prec > 31:
            raise J2KError(f"Invalid values for comp = {i} : prec={comp.prec}")
        comps.append(comp)
    tw, th = _ceildiv(x1 - tx0, tdx), _ceildiv(y1 - ty0, tdy)
    if tw == 0 or th == 0 or tw > 65535 // th:
        raise J2KError(f"Invalid number of tiles : {tw} x {th}")
    d.x0, d.y0, d.x1, d.y1 = x0, y0, x1, y1
    d.tdx, d.tdy, d.tx0, d.ty0, d.tw, d.th = tdx, tdy, tx0, ty0, tw, th
    d.comps = comps
    for comp in comps:
        comp.x0, comp.y0 = _ceildiv(x0, comp.dx), _ceildiv(y0, comp.dy)
        comp.w = _ceildiv(x1, comp.dx) - comp.x0
        comp.h = _ceildiv(y1, comp.dy) - comp.y0
    d.default = TCP(ncomp)
    for comp, tccp in zip(comps, d.default.tccps):
        if not comp.sgnd:
            tccp.dc_shift = 1 << (comp.prec - 1)
    d.state = ST_MH


def _spcod(d, tccp: TCCP, seg: bytes, pos: int) -> int:
    """``opj_j2k_read_SPCod_SPCoc`` from ``pos``; returns the bytes left."""
    if len(seg) - pos < 5:
        raise J2KError("Error reading SPCod SPCoc element")
    tccp.numres = seg[pos] + 1
    if tccp.numres > MAXRLVLS:
        raise J2KError(f"Invalid value for numresolutions : {tccp.numres}")
    tccp.cblkw, tccp.cblkh = seg[pos + 1] + 2, seg[pos + 2] + 2
    if tccp.cblkw > 10 or tccp.cblkh > 10 or tccp.cblkw + tccp.cblkh > 12:
        raise J2KError("Invalid cblkw/cblkh combination")
    tccp.cblksty = seg[pos + 3]
    if tccp.cblksty & 0x80:
        raise J2KError("Unsupported Mixed HT code-block style found")
    tccp.qmfbid = seg[pos + 4]
    if tccp.qmfbid > 1:
        raise J2KError("Invalid transformation found")
    pos += 5
    if tccp.csty & 0x01:
        if len(seg) - pos < tccp.numres:
            raise J2KError("Error reading SPCod SPCoc element")
        for i in range(tccp.numres):
            v = seg[pos + i]
            if i != 0 and ((v & 0xF) == 0 or (v >> 4) == 0):
                raise J2KError("Invalid precinct size")
            tccp.prcw[i], tccp.prch[i] = v & 0xF, v >> 4
        pos += tccp.numres
    else:
        for i in range(tccp.numres):
            tccp.prcw[i] = tccp.prch[i] = 15
    return len(seg) - pos


def _tcp(d):
    return d.tcps[d.tile] if d.state == ST_TPH else d.default


def _read_cod(d, seg: bytes) -> None:
    tcp = _tcp(d)
    if len(seg) < 5:
        raise J2KError("Error reading COD marker")
    tcp.csty = seg[0]
    if tcp.csty & ~0x07:
        raise J2KError("Unknown Scod value in COD marker")
    tcp.prg = seg[1] if seg[1] <= 4 else -1
    tcp.numlayers = _be(seg, 2, 2)
    if tcp.numlayers < 1:
        raise J2KError("Invalid number of layers in COD marker")
    tcp.mct = seg[4]
    if tcp.mct > 1:
        raise J2KError("Invalid multiple component transformation")
    for tccp in tcp.tccps:
        tccp.csty = tcp.csty & 0x01
    if _spcod(d, tcp.tccps[0], seg, 5) != 0:
        raise J2KError("Error reading COD marker")
    ref = tcp.tccps[0]
    for tccp in tcp.tccps[1:]:
        tccp.numres, tccp.cblkw, tccp.cblkh = ref.numres, ref.cblkw, ref.cblkh
        tccp.cblksty, tccp.qmfbid = ref.cblksty, ref.qmfbid
        tccp.prcw[: ref.numres] = ref.prcw[: ref.numres]
        tccp.prch[: ref.numres] = ref.prch[: ref.numres]


def _comp_room(d) -> int:
    return 1 if len(d.comps) <= 256 else 2


def _read_coc(d, seg: bytes) -> None:
    tcp = _tcp(d)
    room = _comp_room(d)
    if len(seg) < room + 1:
        raise J2KError("Error reading COC marker")
    compno = _be(seg, 0, room)
    if compno >= len(d.comps):
        raise J2KError("Error reading COC marker (bad number of components)")
    tcp.tccps[compno].csty = seg[room]
    if _spcod(d, tcp.tccps[compno], seg, room + 1) != 0:
        raise J2KError("Error reading COC marker")


def _sqcd(tccp: TCCP, seg: bytes, pos: int) -> int:
    """``opj_j2k_read_SQcd_SQcc``; returns the bytes left."""
    size = len(seg) - pos
    if size < 1:
        raise J2KError("Error reading SQcd or SQcc element")
    size -= 1
    v = seg[pos]
    pos += 1
    tccp.qntsty, tccp.numgbits = v & 0x1F, v >> 5
    steps = list(tccp.steps)
    if tccp.qntsty == 1:
        nband = 1
    else:
        nband = size if tccp.qntsty == 0 else size // 2
    if tccp.qntsty == 0:
        for b in range(nband):
            if b < MAXBANDS:
                steps[b] = (seg[pos + b] >> 3, 0)
        size -= nband
    else:
        if size < 2 * nband:
            raise J2KError("Error reading SQcd or SQcc element")
        for b in range(nband):
            v = _be(seg, pos + 2 * b, 2)
            if b < MAXBANDS:
                steps[b] = (v >> 11, v & 0x7FF)
        size -= 2 * nband
    if tccp.qntsty == 1:
        e0, m0 = steps[0]
        for b in range(1, MAXBANDS):
            steps[b] = (max(e0 - (b - 1) // 3, 0), m0)
    tccp.steps = steps
    return size


def _read_qcd(d, seg: bytes) -> None:
    tcp = _tcp(d)
    if _sqcd(tcp.tccps[0], seg, 0) != 0:
        raise J2KError("Error reading QCD marker")
    ref = tcp.tccps[0]
    for tccp in tcp.tccps[1:]:
        tccp.qntsty, tccp.numgbits, tccp.steps = ref.qntsty, ref.numgbits, list(ref.steps)


def _read_qcc(d, seg: bytes) -> None:
    tcp = _tcp(d)
    room = _comp_room(d)
    if len(seg) < room:
        raise J2KError("Error reading QCC marker")
    compno = _be(seg, 0, room)
    if compno >= len(d.comps):
        raise J2KError("Invalid component number")
    if _sqcd(tcp.tccps[compno], seg, room) != 0:
        raise J2KError("Error reading QCC marker")


def _read_rgn(d, seg: bytes) -> None:
    room = _comp_room(d)
    if len(seg) != 2 + room:
        raise J2KError("Error reading RGN marker")
    tcp = _tcp(d)
    compno = _be(seg, 0, room)
    if compno >= len(d.comps):
        raise J2KError("bad component number in RGN")
    tcp.tccps[compno].roishift = seg[room + 1]


def _read_poc(d, seg: bytes) -> None:
    room = _comp_room(d)
    chunk = 5 + 2 * room
    count, rem = divmod(len(seg), chunk)
    if count <= 0 or rem:
        raise J2KError("Error reading POC marker")
    tcp = _tcp(d)
    old = tcp.numpocs + 1 if tcp.poc else 0
    if count + old >= MAX_POCS:
        raise J2KError("Too many POCs")
    tcp.poc = True
    del tcp.pocs[old:]
    for i in range(count):
        p = i * chunk
        resno0 = seg[p]
        compno0 = _be(seg, p + 1, room)
        layno1 = min(_be(seg, p + 1 + room, 2), tcp.numlayers)
        resno1 = seg[p + 3 + room]
        compno1 = min(_be(seg, p + 4 + room, room), len(d.comps))
        prg = seg[p + 4 + 2 * room]
        tcp.pocs.append(POCEntry(resno0, compno0, layno1, resno1, compno1, prg))
    tcp.numpocs = count + old - 1


def _read_ppm(d, seg: bytes) -> None:
    if len(seg) < 2:
        raise J2KError("Error reading PPM marker")
    d.ppm = True
    if seg[0] in d.ppm_markers:
        raise J2KError(f"Zppm {seg[0]} already read")
    d.ppm_markers[seg[0]] = bytes(seg[1:])


def _read_ppt(d, seg: bytes) -> None:
    if len(seg) < 2:
        raise J2KError("Error reading PPT marker")
    if d.ppm:
        raise J2KError("Error reading PPT marker: packet headers in PPM")
    tcp = d.tcps[d.tile]
    tcp.ppt = True
    if seg[0] in tcp.ppt_markers:
        raise J2KError(f"Zppt {seg[0]} already read")
    tcp.ppt_markers[seg[0]] = bytes(seg[1:])


def _read_tlm(d, seg: bytes) -> None:
    """Only its size is checked: a bad ``ST`` or entry size marks the index
    invalid in OpenJPEG, which does not use it for a whole image."""
    if len(seg) < 2:
        raise J2KError("Error reading TLM marker")


def _read_plm(d, seg: bytes) -> None:
    if len(seg) < 1:
        raise J2KError("Error reading PLM marker")


def _read_plt(d, seg: bytes) -> None:
    if len(seg) < 1:
        raise J2KError("Error reading PLT marker")
    length = 0
    for v in seg[1:]:
        length |= v & 0x7F
        length = (length << 7) if v & 0x80 else 0
    if length:
        raise J2KError("Error reading PLT marker")


def _read_crg(d, seg: bytes) -> None:
    if len(seg) != 4 * len(d.comps):
        raise J2KError("Error reading CRG marker")


def _read_cap(d, seg: bytes) -> None:
    if len(seg) < 4:
        raise J2KError("Error reading CAP marker")


# ----- Part 2: component bit depths and component transforms -----------------

_MCT_ELEMENT = (2, 4, 4, 8)  # int16, int32, float32, float64


def _read_cbd(d, seg: bytes) -> None:
    """``opj_j2k_read_cbd``: ``Ncbd`` (the component count) and each
    component's depth and sign byte, in place of ``SIZ``'s."""
    n = len(d.comps)
    if len(seg) != n + 2 or _be(seg, 0, 2) != n:
        raise J2KError("Error reading CBD marker")
    for comp, v in zip(d.comps, seg[2:]):
        comp.sgnd, comp.prec = v >> 7, (v & 0x7F) + 1
        if comp.prec > 31:
            raise J2KError(f"Invalid values for comp : prec={comp.prec}")


def _read_mct(d, seg: bytes) -> None:
    """``opj_j2k_read_mct``: a record of ``Zmct`` 0 and ``Ymct`` 0 keeps its
    array (a second ``Zmct`` or ``Ymct`` is ignored)."""
    tcp = _tcp(d)
    if len(seg) < 2:
        raise J2KError("Error reading MCT marker")
    if _be(seg, 0, 2) != 0:
        return  # "Cannot take in charge mct data within multiple MCT records"
    if len(seg) <= 6:
        raise J2KError("Error reading MCT marker")
    imct = _be(seg, 2, 2)
    rec = next((r for r in tcp.mct_records if r.index == imct & 0xFF), None)
    if rec is None:
        rec = MCTRecord(imct & 0xFF)
        tcp.mct_records.append(rec)
    rec.data = None
    rec.array_type, rec.element_type = (imct >> 8) & 3, (imct >> 10) & 3
    if _be(seg, 4, 2) != 0:
        return  # "Cannot take in charge multiple MCT markers"
    rec.data = bytes(seg[6:])


def _read_mcc(d, seg: bytes) -> None:
    """``opj_j2k_read_mcc``: one collection of array decorrelation over
    components 0, 1, ... in order, naming its ``MCT`` arrays by index.
    What OpenJPEG does not take in charge is ignored, after the fields it
    has set by then."""
    tcp = _tcp(d)
    if len(seg) < 2:
        raise J2KError("Error reading MCC marker")
    if _be(seg, 0, 2) != 0:
        return  # "Cannot take in charge multiple data spanning"
    if len(seg) < 7:
        raise J2KError("Error reading MCC marker")
    index = seg[2]
    new = False
    rec = next((r for r in tcp.mcc_slots[: tcp.nb_mcc] if r.index == index), None)
    if rec is None:
        if len(tcp.mcc_slots) == tcp.nb_mcc:
            tcp.mcc_slots.append(MCCRecord())
        rec, new = tcp.mcc_slots[tcp.nb_mcc], True
    rec.index = index
    if _be(seg, 3, 2) != 0 or _be(seg, 5, 2) > 1:
        return  # Ymcc: "multiple data spanning"; Qmcc: "multiple collections"
    collections = _be(seg, 5, 2)
    pos, size = 7, len(seg) - 7
    for _ in range(collections):
        if size < 3:
            raise J2KError("Error reading MCC marker")
        if seg[pos] != 1:
            return  # "collections other than array decorrelation"
        n = _be(seg, pos + 1, 2)
        pos, size = pos + 3, size - 3
        width = 1 + (n >> 15)
        rec.nb_comps = n & 0x7FFF
        if size < width * rec.nb_comps + 2:
            raise J2KError("Error reading MCC marker")
        size -= width * rec.nb_comps + 2
        for j in range(rec.nb_comps):
            if _be(seg, pos, width) != j:
                return  # "collections with indix shuffle"
            pos += width
        m = _be(seg, pos, 2)
        pos += 2
        width = 1 + (m >> 15)
        if m & 0x7FFF != rec.nb_comps:
            return  # "collections without same number of indixes"
        if size < width * rec.nb_comps + 3:
            raise J2KError("Error reading MCC marker")
        size -= width * rec.nb_comps + 3
        for j in range(rec.nb_comps):
            if _be(seg, pos, width) != j:
                return
            pos += width
        t = _be(seg, pos, 3)
        pos += 3
        rec.irreversible = not (t >> 16) & 1
        rec.decorrelation = rec.offset = None
        for attr, i in (("decorrelation", t & 0xFF), ("offset", (t >> 8) & 0xFF)):
            if i:
                found = next((r for r in tcp.mct_records if r.index == i), None)
                if found is None:
                    raise J2KError("Error reading MCC marker")
                setattr(rec, attr, found)
    if size != 0:
        raise J2KError("Error reading MCC marker")
    if new:
        tcp.nb_mcc += 1


def _read_mco(d, seg: bytes) -> None:
    """``opj_j2k_read_mco``: one stage at most; every level shift to 0, then
    the stage's collection applied (``opj_j2k_add_mct``)."""
    tcp = _tcp(d)
    if len(seg) < 1:
        raise J2KError("Error reading MCO marker")
    stages = seg[0]
    if stages > 1:
        return  # "Cannot take in charge multiple transformation stages"
    if len(seg) != stages + 1:
        raise J2KError("Error reading MCO marker")
    for tccp in tcp.tccps:
        tccp.dc_shift = 0
    for k in range(stages):
        _add_mct(tcp, len(d.comps), seg[1 + k])


def _add_mct(tcp: TCP, ncomp: int, index: int) -> None:
    """``opj_j2k_add_mct``.  Its search for the collection never moves past
    the first record, so only a first collection of this index counts; one
    of another component count is discarded.  Arrays of the wrong size
    fail (the matrix is never applied); the offsets become the level
    shifts."""
    if not tcp.nb_mcc or tcp.mcc_slots[0].index != index:
        return  # "element discarded"
    rec = tcp.mcc_slots[0]
    if rec.nb_comps != ncomp:
        return
    deco = rec.decorrelation
    if deco is not None and \
            len(deco.data or b"") != _MCT_ELEMENT[deco.element_type] * ncomp * ncomp:
        raise J2KError("MCT decorrelation array of the wrong size")
    off = rec.offset
    if off is not None:
        if len(off.data or b"") != _MCT_ELEMENT[off.element_type] * ncomp:
            raise J2KError("MCT offset array of the wrong size")
        for tccp, v in zip(tcp.tccps, _mct_offsets(off)):
            tccp.dc_shift = int(v)


def _mct_offsets(rec: MCTRecord) -> np.ndarray:
    """An array's elements as ``j2k_mct_read_functions_to_int32`` reads
    them: int16 and int32 big-endian read as unsigned bytes, then cast to
    int32; floats cast to int32 by truncation (x86's 0x80000000 where out
    of range)."""
    v = np.frombuffer(rec.data, (">u2", ">u4", ">f4", ">f8")[rec.element_type])
    if rec.element_type < 2:
        return v.astype(np.int64).astype(np.uint32).view(np.int32).astype(np.int64)
    f = v.astype(np.float64)
    ok = np.isfinite(f) & (f > -2.0 ** 31 - 1) & (f < 2.0 ** 31)
    return np.where(ok, np.trunc(np.where(ok, f, 0)), -2 ** 31).astype(np.int64)


_HANDLERS = {SIZ: _read_siz, COD: _read_cod, COC: _read_coc, QCD: _read_qcd, QCC: _read_qcc,
             RGN: _read_rgn, POC: _read_poc, PPM: _read_ppm, PPT: _read_ppt, TLM: _read_tlm,
             PLM: _read_plm, PLT: _read_plt, CRG: _read_crg, COM: lambda d, seg: None,
             CAP: _read_cap, CPF: lambda d, seg: None, CBD: _read_cbd, MCT: _read_mct,
             MCC: _read_mcc, MCO: _read_mco}


# ----- the decoder ---------------------------------------------------------

class Decoder:
    """OpenJPEG's j2k decoder state over the codestream at ``data[pos:]``
    (``ihdr``: the JP2 header's (width, height), which ``SIZ`` must match)."""

    def __init__(self, data, pos: int = 0, ihdr=None):
        self.s = Stream(data, pos)
        self.ihdr = ihdr
        self.state = 0
        self.comps: List[Component] = []
        self.ppm = False
        self.ppm_markers: Dict[int, bytes] = {}
        self.ppm_headers: Optional[HeaderSource] = None
        self.tile = 0
        self.marker = 0

    def _marker(self) -> int:
        two = self.s.read(2)
        if len(two) != 2:
            raise J2KError("Stream too short")
        return _be(two, 0, 2)

    def _segment(self, marker: int) -> None:
        """Read the length and body of ``marker`` and run its handler."""
        if not self.state & _STATES.get(marker, _UNK_STATES):
            raise J2KError("Marker is not compliant with its position")
        two = self.s.read(2)
        if len(two) != 2:
            raise J2KError("Stream too short")
        size = _be(two, 0, 2)
        if size < 2:
            raise J2KError("Invalid marker size")
        body = self.s.read(size - 2)
        if len(body) != size - 2:
            raise J2KError("Stream too short")
        self.marker = marker
        _HANDLERS[marker](self, body)

    def _skip_unknown(self) -> int:
        """``opj_j2k_read_unk``: the next known, well placed marker."""
        while True:
            m = self._marker()
            if m >= 0xFF00:
                if not self.state & _STATES.get(m, _UNK_STATES):
                    raise J2KError("Marker is not compliant with its position")
                if m in _STATES:
                    return m

    def read_header(self) -> None:
        """``opj_j2k_read_header_procedure``."""
        if self._marker() != SOC:
            raise J2KError("Expected a SOC marker")
        self.state = ST_MHSIZ
        marker = self._marker()
        found = set()
        while marker != SOT:
            if marker < 0xFF00:
                raise J2KError(f"A marker ID was expected (0xff--) instead of {marker:#x}")
            if marker not in _STATES:
                marker = self._skip_unknown()
                if marker == SOT:
                    break
            found.add(marker)
            self._segment(marker)
            marker = self._marker()
        for need, name in ((SIZ, "SIZ"), (COD, "COD"), (QCD, "QCD")):
            if need not in found:
                raise J2KError(f"required {name} marker not found in main header")
        self._merge_ppm()
        self.tcps = []
        for _ in range(self.tw * self.th):
            tcp = copy.deepcopy(self.default)
            tcp.ppt, tcp.ppt_markers, tcp.current_part = False, {}, -1
            self.tcps.append(tcp)
        self.state = ST_TPHSOT

    def _merge_ppm(self) -> None:
        """``opj_j2k_merge_ppm``: the packet headers of every ``PPM``, in
        ``Zppm`` order, without their ``Nppm`` lengths."""
        if not self.ppm:
            return
        out = bytearray()
        remaining = 0
        for z in sorted(self.ppm_markers):
            data = self.ppm_markers[z]
            pos = 0
            if remaining >= len(data):
                remaining -= len(data)
                out += data
                continue
            out += data[:remaining]
            pos, remaining = remaining, 0
            while pos < len(data):
                if len(data) - pos < 4:
                    raise J2KError("Not enough bytes to read Nppm")
                n = _be(data, pos, 4)
                pos += 4
                take = min(n, len(data) - pos)
                out += data[pos : pos + take]
                pos += take
                remaining = n - take
        if remaining:
            raise J2KError("Corrupted PPM markers")
        self.ppm_headers = HeaderSource(bytes(out), 0, len(out))

    # -- tile-parts (opj_j2k_read_tile_header, opj_j2k_decode_tiles) --

    def _read_sot(self, seg: bytes) -> None:
        if len(seg) != 8:
            raise J2KError("Error reading SOT marker")
        tileno, tot_len, part, nparts = _be(seg, 0, 2), _be(seg, 2, 4), seg[6], seg[7]
        if tileno >= self.tw * self.th:
            raise J2KError(f"Invalid tile number {tileno}")
        self.tile = tileno
        tcp = self.tcps[tileno]
        if tcp.current_part + 1 != part:
            raise J2KError("Invalid tile part index")
        tcp.current_part = part
        if tot_len != 0 and tot_len < 14 and tot_len != 12:
            raise J2KError(f"Psot value is not correct: {tot_len}")
        if tot_len == 0:
            self.last_part = True
        if tcp.nb_parts and part >= tcp.nb_parts:
            self.last_part = True
            raise J2KError("TPSot is not valid")
        if nparts:
            nparts += self.parts_correction
            if part >= nparts:
                self.last_part = True
                raise J2KError("TPSot is not valid")
            tcp.nb_parts = nparts
        if tcp.nb_parts and tcp.nb_parts == part + 1:
            self.can_decode = True
        self.sot_length = 0 if self.last_part else tot_len - 12
        self.state = ST_TPH

    def _read_sod(self) -> None:
        """``opj_j2k_read_sod``: the tile-part's data (``sot_length`` is
        OpenJPEG's unsigned count)."""
        tcp = self.tcps[self.tile]
        left = self.s.left()
        if self.last_part:
            self.sot_length = (left - 2) & 0xFFFFFFFF
        elif left >= 2:
            self.sot_length = (self.sot_length - 2) & 0xFFFFFFFF
        n, got = self.sot_length, 0
        if n:
            if n > left:
                raise J2KError("Tile part length size inconsistent with stream length")
            chunk = self.s.read(n)
            if tcp.data is None:
                tcp.data = bytearray()
            tcp.data += chunk
            got = len(chunk)
        self.state = ST_TPHSOT if got == n else ST_NEOC

    def _parts_correction_needed(self) -> bool:
        """``opj_j2k_need_nb_tile_parts_correction``: whether a later
        tile-part of this tile follows (peeks, then rewinds; data that runs
        out counts as no)."""
        back = self.s.pos
        try:
            while True:
                head = self.s.read(4)
                if len(head) != 4 or _be(head, 0, 2) != SOT:
                    return False
                if _be(head, 2, 2) != 10:
                    raise J2KError("Inconsistent marker size")
                body = self.s.read(8)
                if len(body) != 8:
                    return False
                tileno, tot_len = _be(body, 0, 2), _be(body, 2, 4)
                if tileno == self.tile:
                    return True
                if tot_len < 14 or self.s.left() < tot_len - 12:
                    return False
                self.s.pos += tot_len - 12
        finally:
            self.s.pos = back

    def read_tile_header(self) -> Optional[int]:
        """The next tile to decode, or None when there is none."""
        ntiles = self.tw * self.th
        if self.state == ST_EOC:
            marker = EOC
        elif self.state != ST_TPHSOT:
            raise J2KError("unexpected decoder state")
        else:
            marker = SOT
        while not self.can_decode and marker != EOC:
            while marker != SOD:
                if self.s.left() == 0:
                    self.state = ST_NEOC
                    break
                two = self.s.read(2)
                if len(two) != 2:
                    raise J2KError("Stream too short")
                size = _be(two, 0, 2)
                if size < 2:
                    raise J2KError("Inconsistent marker size")
                if marker == 0x8080 and self.s.left() == 0:
                    self.state = ST_NEOC
                    break
                if self.state & ST_TPH and self.sot_length != 0:
                    if self.sot_length < size + 2:
                        raise J2KError("Sot length is less than marker size + marker ID")
                    self.sot_length -= size + 2
                if not self.state & _STATES.get(marker, _UNK_STATES):
                    raise J2KError("Marker is not compliant with its position")
                body = self.s.read(size - 2)
                if len(body) != size - 2:
                    raise J2KError("Stream too short")
                if marker == SOT:
                    self._read_sot(body)
                elif marker in _HANDLERS and marker not in (SIZ,):
                    self.marker = marker
                    _HANDLERS[marker](self, body)
                else:
                    raise J2KError("Not sure how that happened.")
                marker = self._marker()
            if self.s.left() == 0 and self.state == ST_NEOC:
                break
            self._read_sod()
            if self.can_decode and not self.correction_checked:
                self.correction_checked = True
                if self._parts_correction_needed():
                    self.can_decode = False
                    self.parts_correction = 1
                    for tcp in self.tcps:
                        if tcp.nb_parts:
                            tcp.nb_parts += 1
            if not self.can_decode:
                two = self.s.read(2)
                if len(two) != 2:
                    if self.tile + 1 == ntiles:
                        lone = [t for t in range(ntiles) if self.tcps[t].current_part == 0
                                and self.tcps[t].nb_parts == 0]
                        if lone:
                            self.tile = lone[0]
                            marker = EOC
                            self.state = ST_EOC
                            break
                    raise J2KError("Stream too short")
                marker = _be(two, 0, 2)
        if marker == EOC and self.state != ST_EOC:
            self.tile = 0
            self.state = ST_EOC
        if not self.can_decode:
            while self.tile < ntiles and self.tcps[self.tile].data is None:
                self.tile += 1
            if self.tile == ntiles:
                return None
        return self.tile

    def after_tile(self) -> None:
        """The end of ``opj_j2k_decode_tile``: the next marker after a tile."""
        self.can_decode = False
        if self.s.left() == 0 and self.state == ST_NEOC:
            return
        if self.state != ST_EOC:
            marker = self._marker()
            if marker == EOC:
                self.tile = 0
                self.state = ST_EOC
            elif marker != SOT:
                if self.s.left() == 0:
                    self.state = ST_NEOC
                    return
                raise J2KError("Stream too short, expected SOT")

    def decode(self) -> List[Component]:
        """``opj_j2k_decode_tiles``: every tile into the image components."""
        self.can_decode = False
        self.last_part = False
        self.sot_length = 0
        self.parts_correction = 0
        self.correction_checked = False
        self.resno_decoded = [0] * len(self.comps)
        ntiles = self.tw * self.th
        done = 0
        while True:
            tileno = self.read_tile_header()
            if tileno is None:
                break
            tcp = self.tcps[tileno]
            if tcp.data is None:
                raise J2KError("tile without data")
            self._decode_tile(tileno, tcp)
            tcp.data = None
            self.after_tile()
            if self.s.left() == 0 and self.state == ST_NEOC:
                break
            done += 1
            if done == ntiles:
                break
        for i, comp in enumerate(self.comps):
            if comp.data is None:
                raise J2KError(f"Failed to decode component {i}")
        return self.comps

    # -- one tile (opj_tcd_init_tile, opj_tcd_decode_tile) --

    def _decode_tile(self, tileno: int, tcp: TCP) -> None:
        headers = None
        if self.ppm:
            headers = self.ppm_headers
        elif tcp.ppt:
            merged = b"".join(tcp.ppt_markers[z] for z in sorted(tcp.ppt_markers))
            headers = HeaderSource(merged, 0, len(merged))
        tile = _tile_geometry(self, tileno, tcp)
        try:
            decode_packets(tile, tcp, tcp.data, headers, self.resno_decoded)
        except T2Error as e:
            raise J2KError(str(e)) from e
        samples = []
        for compno, (tc, tccp, comp) in enumerate(zip(tile.comps, tcp.tccps, self.comps)):
            samples.append(_decode_tilecomp(tc, tccp, comp, self.resno_decoded[compno]))
        if tcp.mct and len(samples) >= 3:
            nres = len(tile.comps[0].res)
            if nres != len(tile.comps[1].res) or nres != len(tile.comps[2].res):
                raise J2KError("Tiles don't all have the same dimension")
            if (self.resno_decoded[0] != self.resno_decoded[1]
                    or self.resno_decoded[0] != self.resno_decoded[2]
                    or not samples[0].shape == samples[1].shape == samples[2].shape):
                raise J2KError("Tiles don't all have the same dimension")
            if tcp.tccps[0].qmfbid == 1:
                planes = [s.view(np.int32) if s.dtype == np.float32 else s for s in samples[:3]]
                inverse_rct(*planes)
            else:
                planes = [s.view(np.float32) if s.dtype == np.int32 else s for s in samples[:3]]
                inverse_ict(*planes)
        for compno, (tc, tccp, comp) in enumerate(zip(tile.comps, tcp.tccps, self.comps)):
            data = samples[compno]
            data = data.view(np.float32 if tccp.qmfbid == 0 else np.int32)
            shifted = dc_shift(data, tccp.dc_shift, comp.prec, bool(comp.sgnd))
            _update_image(comp, tc, shifted, self.resno_decoded[compno])


class TileGeom:
    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.comps = []


class TileComp:
    def __init__(self, x0, y0, x1, y1, dx, dy):
        self.x0, self.y0, self.x1, self.y1, self.dx, self.dy = x0, y0, x1, y1, dx, dy
        self.res = []


class Res:
    def __init__(self, x0, y0, x1, y1, pdx, pdy, pw, ph):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.pdx, self.pdy, self.pw, self.ph = pdx, pdy, pw, ph
        self.bands = []


class Band:
    def __init__(self, bandno, x0, y0, x1, y1, numbps, stepsize):
        self.bandno, self.x0, self.y0, self.x1, self.y1 = bandno, x0, y0, x1, y1
        self.numbps, self.stepsize = numbps, stepsize
        self.empty = x1 - x0 == 0 or y1 - y0 == 0
        self.precincts = []


class Precinct:
    def __init__(self, x0, y0, x1, y1, cw, ch, area):
        self.x0, self.y0, self.x1, self.y1, self.cw, self.ch = x0, y0, x1, y1, cw, ch
        self.area = area
        self.cblks = []
        n = cw * ch
        self.incl = TagTree(cw, ch) if n else None
        self.imsb = TagTree(cw, ch) if n else None


class Cblk:
    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "mb", "numlenbits", "segs", "numsegs",
                 "real_num_segs", "numnewpasses", "chunks", "offsets")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = self.mb = self.numlenbits = self.numsegs = self.real_num_segs = 0
        self.numnewpasses = 0
        self.segs = []
        self.chunks = []  # the bytes of each segment part, and where each was in the tile's data
        self.offsets = []


def _window(tc, resno: int, numres: int, bandno: int, margin: int):
    """``opj_tcd_is_subband_area_of_interest``'s band window for a whole
    tile-component: (x0, y0, x1, y1) widened by the filter margin."""
    nb = numres - 1 if resno == 0 else numres - resno
    out = []
    for lo, hi, b in ((tc.x0, tc.x1, bandno & 1), (tc.y0, tc.y1, bandno >> 1)):
        edges = []
        for v in (lo, hi):
            if nb == 0:
                edges.append(v)
            elif v <= (1 << (nb - 1)) * b:
                edges.append(0)
            else:
                edges.append(_ceildivpow2(v - (1 << (nb - 1)) * b, nb))
        out.append((max(edges[0] - margin, 0), edges[1] + margin))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _tile_geometry(d: Decoder, tileno: int, tcp: TCP) -> TileGeom:
    p, q = tileno % d.tw, tileno // d.tw
    tx0 = d.tx0 + p * d.tdx
    ty0 = d.ty0 + q * d.tdy
    tile = TileGeom(max(tx0, d.x0), max(ty0, d.y0), min(tx0 + d.tdx, d.x1),
                    min(ty0 + d.tdy, d.y1))
    for comp, tccp in zip(d.comps, tcp.tccps):
        tc = TileComp(_ceildiv(tile.x0, comp.dx), _ceildiv(tile.y0, comp.dy),
                      _ceildiv(tile.x1, comp.dx), _ceildiv(tile.y1, comp.dy), comp.dx, comp.dy)
        margin = 2 if tccp.qmfbid == 1 else 3
        numres = tccp.numres
        for resno in range(numres):
            level = numres - 1 - resno
            rx0, ry0 = _ceildivpow2(tc.x0, level), _ceildivpow2(tc.y0, level)
            rx1, ry1 = _ceildivpow2(tc.x1, level), _ceildivpow2(tc.y1, level)
            pdx, pdy = tccp.prcw[resno], tccp.prch[resno]
            px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
            px1, py1 = _ceildivpow2(rx1, pdx) << pdx, _ceildivpow2(ry1, pdy) << pdy
            pw = 0 if rx0 == rx1 else (px1 - px0) >> pdx
            ph = 0 if ry0 == ry1 else (py1 - py0) >> pdy
            if pw and 0xFFFFFFFF // pw < ph:
                raise J2KError("Size of tile data exceeds system limits")
            res = Res(rx0, ry0, rx1, ry1, pdx, pdy, pw, ph)
            if resno == 0:
                cbgx0, cbgy0, cbgw, cbgh = px0, py0, pdx, pdy
                bandnos = (0,)
            else:
                cbgx0, cbgy0 = _ceildivpow2(px0, 1), _ceildivpow2(py0, 1)
                cbgw, cbgh = pdx - 1, pdy - 1
                bandnos = (1, 2, 3)
            cbw, cbh = min(tccp.cblkw, cbgw), min(tccp.cblkh, cbgh)
            for i, bandno in enumerate(bandnos):
                if resno == 0:
                    bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
                    step = tccp.steps[0]
                    gain = 0
                else:
                    xb, yb = bandno & 1, bandno >> 1
                    bx0 = _ceildivpow2(tc.x0 - (xb << level), level + 1)
                    by0 = _ceildivpow2(tc.y0 - (yb << level), level + 1)
                    bx1 = _ceildivpow2(tc.x1 - (xb << level), level + 1)
                    by1 = _ceildivpow2(tc.y1 - (yb << level), level + 1)
                    idx = 3 * resno - 2 + i
                    step = tccp.steps[idx] if idx < MAXBANDS else (0, 0)
                    gain = 0 if tccp.qmfbid == 0 else (2 if bandno == 3 else 1)
                expn, mant = step
                stepsize = band_stepsize(comp.prec + gain, expn, mant)
                band = Band(bandno, bx0, by0, bx1, by1, expn + tccp.numgbits - 1, stepsize)
                wx0, wy0, wx1, wy1 = _window(tc, resno, numres, bandno, margin)
                for precno in range(pw * ph):
                    cx = cbgx0 + (precno % pw) * (1 << cbgw)
                    cy = cbgy0 + (precno // pw) * (1 << cbgh)
                    prx0, pry0 = max(cx, bx0), max(cy, by0)
                    prx1, pry1 = min(cx + (1 << cbgw), bx1), min(cy + (1 << cbgh), by1)
                    tlx, tly = (prx0 >> cbw) << cbw, (pry0 >> cbh) << cbh
                    brx, bry = _ceildivpow2(prx1, cbw) << cbw, _ceildivpow2(pry1, cbh) << cbh
                    cw, ch = max((brx - tlx) >> cbw, 0), max((bry - tly) >> cbh, 0)
                    area = prx0 < wx1 and pry0 < wy1 and prx1 > wx0 and pry1 > wy0
                    prc = Precinct(prx0, pry0, prx1, pry1, cw, ch, area)
                    for cblkno in range(cw * ch):
                        x = tlx + (cblkno % cw) * (1 << cbw)
                        y = tly + (cblkno // cw) * (1 << cbh)
                        prc.cblks.append(Cblk(max(x, prx0), max(y, pry0),
                                              min(x + (1 << cbw), prx1),
                                              min(y + (1 << cbh), pry1)))
                    band.precincts.append(prc)
                res.bands.append(band)
            tc.res.append(res)
        tile.comps.append(tc)
    return tile


def _decode_tilecomp(tc: TileComp, tccp: TCCP, comp: Component, resno_decoded: int):
    """Tier 1, dequantisation and the inverse wavelet of one tile-component:
    its samples in OpenJPEG's tile buffer (int32 for 5/3, float32 for 9/7)."""
    top = tc.res[-1]
    w, h = top.x1 - top.x0, top.y1 - top.y0
    reversible = tccp.qmfbid == 1
    buf = np.zeros((h, w), np.int32 if reversible else np.float32)
    for resno, res in enumerate(tc.res):
        prev = tc.res[resno - 1] if resno else None
        for band in res.bands:
            for prc in band.precincts:
                for cblk in prc.cblks:
                    cw, ch = cblk.x1 - cblk.x0, cblk.y1 - cblk.y0
                    data = b"".join(cblk.chunks)
                    try:
                        if tccp.cblksty & HT:
                            # one chunk is read where it lies in the tile's data, more
                            # from a buffer of their own (aligned)
                            align = cblk.offsets[0] % 4 if len(cblk.chunks) == 1 else 0
                            coeffs = decode_ht_cblk(
                                cw, ch, tccp.cblksty, cblk.numbps, cblk.mb, tccp.roishift, data,
                                [(s.len, s.real_num_passes) for s in cblk.segs[:2]],
                                cblk.numsegs, align)
                        else:
                            segments = []
                            pos = 0
                            for seg in cblk.segs[: cblk.real_num_segs]:
                                segments.append((data[pos : pos + seg.len], seg.real_num_passes))
                                pos += seg.len
                            coeffs = decode_cblk(cw, ch, band.bandno, tccp.cblksty, cblk.numbps,
                                                 tccp.roishift, segments)
                    except T1Error as e:
                        raise J2KError(str(e)) from e
                    x, y = cblk.x0 - band.x0, cblk.y0 - band.y0
                    if band.bandno & 1:
                        x += prev.x1 - prev.x0
                    if band.bandno & 2:
                        y += prev.y1 - prev.y0
                    buf[y : y + ch, x : x + cw] = dequantise(coeffs, tccp.roishift, reversible,
                                                             band.stepsize)
    bounds = [(r.x0, r.y0, r.x1, r.y1) for r in tc.res[: resno_decoded + 1]]
    if w == 0 or h == 0:
        return buf
    return idwt53(buf, bounds) if reversible else idwt97(buf, bounds)


def _update_image(comp: Component, tc: TileComp, data: np.ndarray, resno_decoded: int) -> None:
    """``opj_j2k_update_image_data``: the tile's decoded resolution into the
    component (zeros where no tile was decoded)."""
    res = tc.res[resno_decoded]
    rx0, ry0, rx1, ry1 = res.x0, res.y0, res.x1, res.y1
    wsrc, hsrc = rx1 - rx0, ry1 - ry0
    dx0, dy0 = comp.x0, comp.y0
    dx1, dy1 = dx0 + comp.w, dy0 + comp.h

    def span(d0, d1, r0, r1, wsrc, full):
        if d0 < r0:
            start, off0 = r0 - d0, 0
            width = wsrc if d1 >= r1 else d1 - r0
        else:
            start, off0 = 0, d0 - r0
            width = wsrc - off0 if d1 >= r1 else full
        return start, off0, width

    sx, ox, wdst = span(dx0, dx1, rx0, rx1, wsrc, comp.w)
    sy, oy, hdst = span(dy0, dy1, ry0, ry1, hsrc, comp.h)
    if wdst > wsrc or hdst > hsrc or wdst < 0 or hdst < 0:
        raise J2KError("tile outside the image")
    if comp.data is None:
        comp.data = np.zeros((comp.h, comp.w), np.int32)
    comp.data[sy : sy + hdst, sx : sx + wdst] = data[oy : oy + hdst, ox : ox + wdst]
