"""A JPEG 2000 reader in Python and numpy, exact against ``cv2.imread``.

:func:`decode_jpeg2000` returns RGB uint8 ``(H, W, 3)`` of a JP2 file or a
raw J2K codestream as OpenCV 5.0 gives it under ``IMREAD_COLOR``, on
OpenJPEG 2.5 (``grfmt_jpeg2000_openjpeg.cpp`` over ``jp2.c``; the
codestream itself in ``data/j2k.py``):

* **JP2 boxes** as ``opj_jp2_read_header_procedure`` reads them: the
  signature box first, ``ftyp`` second, ``jp2h`` (``ihdr``, ``colr``,
  ``bpcc``, ``pclr``, ``cmap``, ``cdef``; others such as ``res `` skipped)
  before ``jp2c``, whose length is not used: the codestream runs to the end
  of the file.  Extended (``XLBox``) and "to the end of the file" lengths
  are read; unknown boxes skipped.
* **Colour.** The first ``colr`` box counts: enumerated 16 (sRGB) and 17
  (grey: the first channel) as such, 18 (sYCC) through OpenCV's
  ``COLOR_YUV2BGR``; e-sYCC (24) and CMYK (12) read as None; any other
  enumeration, an ICC profile (restricted or not, never applied), no
  ``colr`` or a raw codestream reads as sRGB, and sRGB or sYCC needs three
  channels: one or two read as None.
  A palette (``pclr`` with ``cmap``) is expanded and channel definitions
  (``cdef``) reorder the channels as OpenJPEG's ``jp2`` layer applies them.
* **Samples to 8 bits** as OpenCV does: every channel shifted right by the
  largest codestream precision less 8, then cut to its low 8 bits; a
  fourth channel (alpha) is dropped.
* **None where cv2 gives None**: signed components, more than four
  components, a largest precision below 8, subsampled components or an
  image offset (``XOsiz``/``YOsiz``; OpenCV reads neither), a size past
  OpenCV's limits (2^20 a side, 2^30 pixels) and every file OpenJPEG
  refuses: a truncated codestream, one without ``EOC``, a missing ``EPH``
  where ``COD`` announces it (OpenJPEG 2.5's strict mode).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from molnextr_tpu_torch.data.j2k import Decoder, Stream

_MAX_SIDE, _MAX_PIXELS = 1 << 20, 1 << 30  # OpenCV's CV_IO_MAX_IMAGE_* defaults
# JP2 reader states (JP2_STATE_*)
_SIG, _FTYP, _HEADER, _CODESTREAM, _UNKNOWN = 0x1, 0x2, 0x4, 0x8, 0x7FFFFFFF + 1
_IMG_BOXES = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")
_SRGB, _GRAY, _SYCC, _EYCC, _CMYK, _UNKNOWN_CS = 1, 2, 3, 4, 5, -1


class JP2Error(ValueError):
    """A JP2 file OpenJPEG or OpenCV refuses."""


def _be(data, pos: int, n: int) -> int:
    return int.from_bytes(bytes(data[pos : pos + n]), "big")


class _JP2:
    """What the JP2 boxes said (``opj_jp2_t``)."""

    def __init__(self):
        self.state = 0
        self.ihdr = None  # (width, height, numcomps)
        self.has_jp2h = False
        self.colr = False
        self.enumcs = 0
        self.pclr = None  # entries (n, channels)
        self.cmap = None  # [(cmp, mtyp, pcol)]
        self.cdef = None  # [(cn, typ, asoc)]


def _read_ihdr(jp2: _JP2, body: bytes) -> None:
    if jp2.ihdr is not None:
        return
    if len(body) != 14:
        raise JP2Error("Bad image header box (bad size)")
    h, w, nc = _be(body, 0, 4), _be(body, 4, 4), _be(body, 8, 2)
    if h < 1 or w < 1 or nc < 1:
        raise JP2Error("Wrong values for w, h, numcomps (ihdr)")
    if nc - 1 >= 16384:
        raise JP2Error("Invalid number of components (ihdr)")
    jp2.ihdr = (w, h, nc)


def _read_colr(jp2: _JP2, body: bytes) -> None:
    if len(body) < 3:
        raise JP2Error("Bad COLR header box (bad size)")
    if jp2.colr:
        return
    meth = body[0]
    if meth == 1:
        if len(body) < 7:
            raise JP2Error("Bad COLR header box (bad size)")
        jp2.enumcs = _be(body, 3, 4)
        jp2.colr = True
    elif meth == 2:
        jp2.colr = True


def _read_bpcc(jp2: _JP2, body: bytes) -> None:
    if len(body) != (jp2.ihdr[2] if jp2.ihdr else 0):
        raise JP2Error("Bad BPCC header box (bad size)")


def _read_pclr(jp2: _JP2, body: bytes) -> None:
    if jp2.pclr is not None or len(body) < 3:
        raise JP2Error("Invalid PCLR box")
    n, nch = _be(body, 0, 2), body[2]
    if n == 0 or n > 1024 or nch == 0:
        raise JP2Error("Invalid PCLR box")
    if len(body) < 3 + nch:
        raise JP2Error("Invalid PCLR box")
    sizes = [(b & 0x7F) + 1 for b in body[3 : 3 + nch]]
    pos = 3 + nch
    entries = np.zeros((n, nch), np.int64)
    for j in range(n):
        for i in range(nch):
            k = min((sizes[i] + 7) >> 3, 4)
            if len(body) < pos + k:
                raise JP2Error("Invalid PCLR box")
            entries[j, i] = _be(body, pos, k)
            pos += k
    jp2.pclr = entries


def _read_cmap(jp2: _JP2, body: bytes) -> None:
    if jp2.pclr is None:
        raise JP2Error("Need to read a PCLR box before the CMAP box")
    if jp2.cmap is not None:
        raise JP2Error("Only one CMAP box is allowed")
    nch = jp2.pclr.shape[1]
    if len(body) < 4 * nch:
        raise JP2Error("Insufficient data for CMAP box")
    jp2.cmap = [(_be(body, 4 * i, 2), body[4 * i + 2], body[4 * i + 3]) for i in range(nch)]


def _read_cdef(jp2: _JP2, body: bytes) -> None:
    if jp2.cdef is not None:
        raise JP2Error("Only one CDEF box is allowed")
    if len(body) < 2:
        raise JP2Error("Insufficient data for CDEF box")
    n = _be(body, 0, 2)
    if n == 0:
        raise JP2Error("Number of channel description is equal to zero in CDEF box")
    if len(body) < 2 + 6 * n:
        raise JP2Error("Insufficient data for CDEF box")
    jp2.cdef = [tuple(_be(body, 2 + 6 * i + 2 * k, 2) for k in range(3)) for i in range(n)]


_IMG_HANDLERS = {b"ihdr": _read_ihdr, b"colr": _read_colr, b"bpcc": _read_bpcc,
                 b"pclr": _read_pclr, b"cmap": _read_cmap, b"cdef": _read_cdef}


def _read_jp2h(jp2: _JP2, body: bytes) -> None:
    if jp2.state & _FTYP != _FTYP:
        raise JP2Error("The jp2h box must follow ftyp")
    pos, size, has_ihdr = 0, len(body), False
    while size > 0:
        if size < 8:
            raise JP2Error("Cannot handle box of less than 8 bytes")
        length, kind, nread = _be(body, pos, 4), bytes(body[pos + 4 : pos + 8]), 8
        if length == 1:
            if size < 16:
                raise JP2Error("Cannot handle XL box of less than 16 bytes")
            if _be(body, pos + 8, 4):
                raise JP2Error("Cannot handle box sizes higher than 2^32")
            length, nread = _be(body, pos + 12, 4), 16
            if length == 0:
                raise JP2Error("Cannot handle box of undefined sizes")
        elif length == 0:
            raise JP2Error("Cannot handle box of undefined sizes")
        if length < nread:
            raise JP2Error("Box length is inconsistent")
        if length > size:
            raise JP2Error("box length is inconsistent")
        if kind in _IMG_HANDLERS:
            _IMG_HANDLERS[kind](jp2, body[pos + nread : pos + length])
        has_ihdr |= kind == b"ihdr"
        pos += length
        size -= length
    if not has_ihdr:
        raise JP2Error("no 'ihdr' box")
    jp2.state |= _HEADER
    jp2.has_jp2h = True


def _read_jp(jp2: _JP2, body: bytes) -> None:
    if jp2.state != 0:
        raise JP2Error("The signature box must be the first box in the file")
    if len(body) != 4 or _be(body, 0, 4) != 0x0D0A870A:
        raise JP2Error("Error with JP Signature")
    jp2.state |= _SIG


def _read_ftyp(jp2: _JP2, body: bytes) -> None:
    if jp2.state != _SIG:
        raise JP2Error("The ftyp box must be the second box in the file")
    if len(body) < 8 or (len(body) - 8) % 4:
        raise JP2Error("Error with FTYP signature Box size")
    jp2.state |= _FTYP


_HANDLERS = {b"jP  ": _read_jp, b"ftyp": _read_ftyp, b"jp2h": _read_jp2h}


def read_boxes(data) -> tuple:
    """``opj_jp2_read_header``: the JP2 header's contents and the position
    of the codestream (just past the ``jp2c`` box header; or where the box
    walk stopped)."""
    jp2 = _JP2()
    s = Stream(data)
    while True:
        head = s.read(8)
        if len(head) != 8:
            break
        length, kind, nread = _be(head, 0, 4), bytes(head[4:8]), 8
        if length == 0:
            length = s.left() + 8
        elif length == 1:
            ext = s.read(8)
            if len(ext) != 8 or _be(ext, 0, 4):
                break
            length, nread = _be(ext, 4, 4), 16
        if kind == b"jp2c":
            if not jp2.state & _HEADER:
                raise JP2Error("bad placed jpeg codestream")
            jp2.state |= _CODESTREAM
            break
        if length == 0:
            raise JP2Error("Cannot handle box of undefined sizes")
        if length < nread:
            raise JP2Error("invalid box size")
        size = length - nread
        handler = _HANDLERS.get(kind)
        if handler is None and kind in _IMG_BOXES:
            if jp2.state & _HEADER:
                handler = _IMG_HANDLERS[kind]
            else:
                jp2.state |= _UNKNOWN
                if s.left() < size:
                    raise JP2Error("Problem with skipping JPEG2000 box")
                s.pos += size
                continue
        if handler is not None:
            if size > s.left():
                raise JP2Error("Invalid box size")
            if size:
                handler(jp2, s.read(size))
            continue
        if not jp2.state & _SIG:
            raise JP2Error("first box must be JPEG 2000 signature box")
        if not jp2.state & _FTYP:
            raise JP2Error("second box must be file type box")
        jp2.state |= _UNKNOWN
        if s.left() < size:
            s.pos = len(data)
            raise JP2Error("Problem with skipping JPEG2000 box")
        s.pos += size
    if not jp2.has_jp2h:
        raise JP2Error("JP2H box missing. Required.")
    if jp2.ihdr is None:
        raise JP2Error("IHDR box missing. Required.")
    return jp2, s.pos


def _check_color(jp2: _JP2, ncomp: int) -> None:
    """``opj_jp2_check_color``."""
    if jp2.cdef is not None:
        nch = jp2.pclr.shape[1] if jp2.pclr is not None and jp2.cmap is not None else ncomp
        for cn, _, asoc in jp2.cdef:
            if cn >= nch:
                raise JP2Error(f"Invalid component index {cn}")
            if asoc != 65535 and asoc > 0 and asoc - 1 >= nch:
                raise JP2Error(f"Invalid component index {asoc - 1}")
        for want in range(nch - 1, -1, -1):
            if not any(cn == want for cn, _, _ in jp2.cdef):
                raise JP2Error("Incomplete channel definitions")
    if jp2.pclr is not None and jp2.cmap is not None:
        nch = jp2.pclr.shape[1]
        sane = all(cmp < ncomp for cmp, _, _ in jp2.cmap)
        used = [False] * nch
        for i, (cmp, mtyp, pcol) in enumerate(jp2.cmap):
            if mtyp not in (0, 1) or pcol >= nch or (used[pcol] and mtyp == 1) \
                    or (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i):
                sane = False
            else:
                used[pcol] = True
        for i in range(nch):
            if not used[i] and jp2.cmap[i][1] != 0:
                sane = False
        if sane and ncomp == 1 and not all(used):
            jp2.cmap = [(cmp, 1, i) for i, (cmp, _, _) in enumerate(jp2.cmap)]
        if not sane:
            raise JP2Error("bad component mapping")


def _apply_color(jp2: _JP2, channels: list) -> list:
    """The palette and channel definitions on the decoded channels, each a
    (samples, geometry) pair (``opj_jp2_apply_pclr`` / ``opj_jp2_apply_cdef``)."""
    if jp2.pclr is not None and jp2.cmap is not None:
        entries = jp2.pclr
        mapped = []
        for cmp, mtyp, pcol in jp2.cmap:
            plane, geometry = channels[cmp]
            if mtyp == 1:
                plane = entries[np.clip(plane.astype(np.int64), 0, entries.shape[0] - 1), pcol]
            mapped.append((plane, geometry))
        channels = mapped
    if jp2.cdef is not None:
        cdef = [list(c) for c in jp2.cdef]
        for i, (cn, typ, asoc) in enumerate(cdef):
            if cn >= len(channels) or asoc in (0, 65535) or asoc - 1 >= len(channels):
                continue
            acn = asoc - 1
            if cn != acn and typ == 0:
                channels[cn], channels[acn] = channels[acn], channels[cn]
                for later in cdef[i + 1 :]:
                    if later[0] == cn:
                        later[0] = acn
                    elif later[0] == acn:
                        later[0] = cn
    return channels


def _yuv_to_rgb(y, u, v) -> np.ndarray:
    """OpenCV's ``COLOR_YUV2RGB`` on uint8 (14-bit fixed point)."""
    y, u, v = (a.astype(np.int64) for a in (y, u, v))
    u, v = u - 128, v - 128

    def descale(x):
        return (x + (1 << 13)) >> 14

    r = y + descale(v * 18678)
    g = y + descale(u * -6472 + v * -9519)
    b = y + descale(u * 33292)
    return np.clip(np.dstack([r, g, b]), 0, 255).astype(np.uint8)


def decode_jpeg2000(data: bytes, path: str = "<bytes>") -> Optional[np.ndarray]:
    """RGB uint8 of a JP2 file or J2K codestream, or None (module doc)."""
    if data[:4] == b"\xffO\xffQ":
        jp2, pos, ihdr = None, 0, None
    else:
        jp2, pos = read_boxes(data)
        ihdr = jp2.ihdr[:2]
    d = Decoder(data, pos, ihdr)
    d.read_header()
    comps = d.comps
    if not 1 <= len(comps) <= 4:
        return None  # "Unsupported number of components"
    if any(c.sgnd for c in comps):
        return None  # "Component is signed"
    max_prec = max(c.prec for c in comps)
    if max_prec < 8:
        return None  # "Precision < 8 not supported"
    width, height = d.x1 - d.x0, d.y1 - d.y0
    if width > _MAX_SIDE or height > _MAX_SIDE or width * height > _MAX_PIXELS:
        return None  # past OpenCV's size limits
    d.decode()
    channels = [(c.data, (c.dx, c.dy, c.x0, c.y0, c.w, c.h)) for c in comps]
    space = _UNKNOWN_CS
    if jp2 is not None:
        _check_color(jp2, len(comps))
        space = {16: _SRGB, 17: _GRAY, 18: _SYCC, 24: _EYCC, 12: _CMYK}.get(jp2.enumcs,
                                                                              _UNKNOWN_CS)
        channels = _apply_color(jp2, channels)
    if space in (_EYCC, _CMYK):
        return None  # "Unsupported color space conversion"
    for _, geometry in channels:
        if geometry != (1, 1, 0, 0, width, height):
            return None  # "tiles are not supported"
    planes = [plane for plane, _ in channels]
    shift = max_prec - 8

    def to8(plane):
        return ((plane.astype(np.int64) >> shift) & 0xFF).astype(np.uint8)

    if space == _GRAY:
        grey = to8(planes[0])
        return np.dstack([grey] * 3)
    if len(planes) < 3:
        return None  # "unsupported conversion from 1 (2) components to 3"
    if space == _SYCC:
        return _yuv_to_rgb(*(to8(p) for p in planes[:3]))
    return np.dstack([to8(p) for p in planes[:3]])


