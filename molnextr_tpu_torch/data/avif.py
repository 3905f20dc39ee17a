"""An AVIF reader in Python and numpy, exact against ``cv2.imread``.

OpenCV 5.0 reads AVIF through libavif 1.4 (``avifDecoderParse``, then
``avifDecoderNextImage`` over libaom, then ``avifImageYUVToRGB`` into
8-bit BGR).  :func:`decode_avif` returns RGB uint8 ``(H, W, 3)`` of the
primary image, or raises ``ValueError`` where ``cv2.imread`` returns None:

* **The container** (ISOBMFF/HEIF, as libavif parses it): ``ftyp`` first,
  with ``avif`` or ``avis`` as its major or a compatible brand (``avif``
  needs a ``meta`` box, ``avis`` a ``moov``); ``meta`` with ``hdlr``
  ``pict`` first, ``pitm``, ``iloc`` (versions 0-2, construction methods 0
  and 1 with ``idat``), ``iinf``/``infe`` (versions 2 and 3), ``iref``
  (``auxl``, ``dimg``, ``thmb``, ``cdsc``, ``prem``) and
  ``iprp``/``ipco``/``ipma`` with essential flags; properties ``ispe``,
  ``pixi``, ``av1C``, ``colr`` (nclx and ICC), ``irot``, ``imir``,
  ``clap``, ``auxC``, ``a1op``, ``lsel``.  A box cut short, a duplicate
  unique box, a missing primary item or a missing mandatory property read
  as None.  The alpha item (``auxl``, an ``av01`` item or a grid) is
  decoded and its planes dropped, as libavif decodes it and OpenCV drops
  alpha: a stream libaom refuses, an alpha grid libavif refuses, or an
  alpha of another ``ispe`` size or decoded depth than the colour image
  reads as None (an alpha frame of another size than its own ``ispe`` is
  one libavif rescales, and reads).  ``irot``, ``imir`` and ``clap`` are
  parsed and, as in OpenCV 5.0, not applied.
* **The primary image**, chosen as libavif's ``AVIF_DECODER_SOURCE_AUTO``
  chooses: the first sample of the colour track of an image sequence
  (``moov``/``trak``: ``tkhd``, ``stsd``'s ``av01`` entry, ``stsc``,
  ``stsz``, ``stco``/``co64``) when the major brand is ``avis``, or when it
  is not ``avif`` and there is a track; otherwise the primary item, an
  ``av01`` item or a ``grid`` of them (the ``ImageGrid`` box, the ``dimg``
  tiles placed row-major and cut to the output size, with libavif's rules
  on tile count, sizes and formats).
* **The image**: the first shown frame of the AV1 OBUs (``data/av1_obu.py``
  and ``data/av1_refs.py``: every frame up to it decoded against the
  reference slots, a key frame hidden and shown by ``show_existing_frame``,
  or a hidden key frame and an inter frame, as libaom's key frame
  filtering writes them; inter prediction by ``data/av1_mvpred.py`` and
  ``data/av1_inter.py``), decoded lossless or lossy
  (``data/av1_block.py``, ``data/av1_recon.py``, ``data/av1_quant.py``,
  ``data/av1_transform.py``), then deblocked (``data/av1_loopfilter.py``),
  CDEF-filtered (``data/av1_cdef.py``), upscaled under superres
  (``data/av1_superres.py``) and loop-restored
  (``data/av1_restoration.py``), with libaom's checks of a corrupt frame
  (a tile that overruns its data or lacks its trailing bits, an intra
  block copy vector outside the decoded area, a segment id past the
  last); then film grain added (``data/av1_grain.py``).
* **Colour** as ``avifImageYUVToRGB`` gives 8-bit BGR: matrix 0 (GBR) as
  the planes are, monochrome (the sequence header's or ``av1C``'s flag) as
  grey, BT.601 and BT.709 at full or limited range through libyuv's
  fixed-point conversion, 4:2:0 and 4:2:2 chroma upsampled as libavif's
  ``AUTOMATIC`` choice does (libyuv's bilinear filter); 10- and 12-bit
  YCbCr shifted down to 8 bits first (chroma before it is upsampled;
  with alpha, where OpenCV asks for BGRA, libyuv's 10-bit conversion and
  its unfiltered 12-bit 4:2:0 one), GBR, FCC, SMPTE 240, YCgCo, YCgCo-Re,
  matrix 15 and chroma-derived NCL on other primaries through libavif's
  float path, grey above 8 bits rounded half to even as OpenCV's
  ``convertTo`` does; a matrix libavif refuses, and grey with alpha,
  read as None.  The matrix, primaries and range of the image's nclx
  ``colr`` box (a grid's own, not its tiles') win over the sequence
  header's.

* **Rescaling**: a decoded frame of another size than its ``ispe`` (a
  track's ``tkhd``, a grid tile's own ``ispe``) is rescaled to it after
  film grain, as ``avifImageScaleWithLimit`` does: every plane through
  libyuv's box-filtered ``ScalePlane`` / ``ScalePlane_12``
  (``data/yuv_scale.py``), chroma to the subsampled size of the target; a
  frame past 16384 a side is not rescaled (None).  An alpha image is
  checked the same way and, as OpenCV drops it, not rescaled.

An image past libavif's limits (32768 a side, 16384 x 16384 pixels) reads
as None.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from molnextr_tpu_torch.data import yuv_scale

_MAX_PIXELS = 16384 * 16384  # libavif's imageSizeLimit (OpenCV's 2^30 is larger)
_MAX_DIMENSION = 32768  # libavif's imageDimensionLimit
_UNIQUE_META = (b"hdlr", b"pitm", b"iloc", b"iinf", b"iref", b"iprp", b"idat")
_KNOWN_PROPS = (b"ispe", b"pixi", b"av1C", b"colr", b"irot", b"imir", b"clap", b"auxC",
                b"a1op", b"lsel", b"pasp", b"clli", b"mdcv", b"cclv", b"amve", b"a1lx")
_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
               b"urn:mpeg:hevc:2015:auxid:1")


class AVIFError(ValueError):
    """An AVIF file libavif or OpenCV refuses."""


def compatible(data: bytes) -> bool:
    """An ``ftyp`` box first, naming ``avif`` or ``avis`` as its major brand
    or among the compatible brands the file holds (OpenCV's signature check
    parses the file's start with libavif and accepts one cut short)."""
    if len(data) < 12 or data[4:8] != b"ftyp":
        return False
    size = int.from_bytes(data[:4], "big")
    if size == 1 or 0 < size < 16 or size % 4:
        return False
    end = min(size or len(data), len(data))
    brands = [data[8:12]] + [data[k : k + 4] for k in range(16, end - 3, 4)]
    return b"avif" in brands or b"avis" in brands


def _boxes(data: bytes, pos: int, end: int, top: bool = False
           ) -> List[Tuple[bytes, int, int]]:
    """The boxes of ``data[pos:end]`` as (type, body start, body end).  At
    the top level a box libavif does not read (``mdat``, ``free``, ...) may
    run past the end of the file, as libavif only skips it."""
    out = []
    while pos < end:
        if end - pos < 8:
            raise AVIFError("AVIF: box header cut short")
        size, typ = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            if end - pos < 16:
                raise AVIFError("AVIF: box header cut short")
            (size,) = struct.unpack_from(">Q", data, pos + 8)
            head = 16
        elif size == 0:
            size = end - pos
        if size < head:
            raise AVIFError(f"AVIF: box {typ!r} shorter than its header")
        if pos + size > end:
            if not top or typ in (b"ftyp", b"meta", b"moov"):
                raise AVIFError(f"AVIF: box {typ!r} runs past its parent")
            size = end - pos
        out.append((typ, pos + head, pos + size))
        pos += size
    return out


class _Reader:
    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end

    def u(self, n: int) -> int:
        if self.pos + n > self.end:
            raise AVIFError("AVIF: box body cut short")
        v = int.from_bytes(self.data[self.pos : self.pos + n], "big")
        self.pos += n
        return v

    def skip(self, n: int) -> None:
        if self.pos + n > self.end:
            raise AVIFError("AVIF: box body cut short")
        self.pos += n

    def full(self, top: int = 0) -> Tuple[int, int]:
        """A FullBox's version (at most ``top``, as libavif enforces) and
        flags."""
        v = self.u(4)
        if v >> 24 > top:
            raise AVIFError(f"AVIF: box version {v >> 24}")
        return v >> 24, v & 0xFFFFFF

    def string(self) -> bytes:
        k = self.data.find(b"\0", self.pos, self.end)
        if k < 0:
            raise AVIFError("AVIF: string without its terminator")
        s = self.data[self.pos : k]
        self.pos = k + 1
        return s


class _Item:
    def __init__(self, item_id: int):
        self.id = item_id
        self.type = b""
        self.extents: List[Tuple[int, int]] = []
        self.method = 0
        self.props: List[Tuple[int, bool]] = []  # (property index, essential)
        self.refs: Dict[bytes, List[int]] = {}


class _Track:
    """A ``trak`` box as libavif reads it for an image sequence: ``tkhd``
    (id and size), ``tref`` (``auxl``) and ``mdia``/``minf``'s sample table
    (``stsd`` entries, ``stsc``, ``stsz``, ``stco``/``co64``), its samples
    as (offset, size) in the file."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.id = self.width = self.height = 0
        self.auxl = False
        self.auxl_for: List[int] = []  # the tracks its auxl reference names
        self.entries: List[Tuple[bytes, int, int]] = []  # (format, body start, end)
        self.samples: List[Tuple[int, int]] = []
        stbl = None
        for typ, start, stop in _boxes(data, pos, end):
            if typ == b"tkhd":
                r = _Reader(data, start, stop)
                version, _ = r.full(1)
                r.skip(16 if version else 8)  # creation and modification times
                self.id = r.u(4)
                r.skip(4 + (8 if version else 4) + 8 + 8 + 36)  # to the width
                self.width, self.height = r.u(4) >> 16, r.u(4) >> 16
            elif typ == b"tref":
                for t, a, b in _boxes(data, start, stop):
                    if t == b"auxl":
                        self.auxl = True
                        self.auxl_for += [int.from_bytes(data[k : k + 4], "big")
                                          for k in range(a, b - 3, 4)]
            elif typ == b"mdia":  # libavif reads no handler type: minf's stbl
                for t, a, b in _boxes(data, start, stop):
                    if t == b"minf":
                        stbl = next(((a2, b2) for t2, a2, b2 in _boxes(data, a, b)
                                     if t2 == b"stbl"), stbl)
        if stbl is not None:
            self._samples(data, *stbl)

    def _samples(self, data: bytes, pos: int, end: int) -> None:
        """``avifCodecDecodeInputFillFromSampleTable``: chunk after chunk,
        its count of samples from ``stsc``, their sizes from ``stsz``."""
        to_chunk, sizes, offsets, uniform = [], [], [], 0
        for typ, start, stop in _boxes(data, pos, end):
            r = _Reader(data, start, stop)
            if typ == b"stsd":
                r.full()
                count = r.u(4)
                entries = _boxes(data, r.pos, stop)[:count]
                self.entries = [(t, a + 78, b) for t, a, b in entries]  # past VisualSampleEntry
            elif typ == b"stsc":
                r.full()
                for _ in range(r.u(4)):
                    first, per = r.u(4), r.u(4)
                    r.u(4)
                    to_chunk.append((first, per))
            elif typ == b"stsz":
                r.full()
                uniform, count = r.u(4), r.u(4)
                if not uniform:
                    sizes = [r.u(4) for _ in range(count)]
            elif typ in (b"stco", b"co64"):
                r.full()
                offsets = [r.u(8 if typ == b"co64" else 4) for _ in range(r.u(4))]
        k = 0
        for chunk, offset in enumerate(offsets):
            count = next((per for first, per in reversed(to_chunk) if first <= chunk + 1), 0)
            if count == 0:
                raise AVIFError("AVIF: a chunk of no samples")
            for _ in range(count):
                if not uniform and k >= len(sizes):
                    raise AVIFError("AVIF: sample table cut short")
                size = uniform or sizes[k]
                if offset + size > len(data):
                    raise AVIFError("AVIF: sample past the end of the file")
                self.samples.append((offset, size))
                offset += size
                k += 1


class _Avif:
    def __init__(self, data: bytes):
        if not compatible(data):
            raise AVIFError("AVIF: not an AVIF file")
        self.data = data
        top = _boxes(data, 0, len(data), top=True)
        if top[0][0] != b"ftyp":
            raise AVIFError("AVIF: ftyp is not the first box")
        brands = {data[top[0][1] : top[0][1] + 4]} | {
            data[k : k + 4] for k in range(top[0][1] + 8, top[0][2] - 3, 4)}
        metas = [b for b in top if b[0] == b"meta"]
        moovs = [b for b in top if b[0] == b"moov"]
        if len(metas) > 1 or len(moovs) > 1:
            raise AVIFError("AVIF: more than one meta or moov box")
        if (b"avif" in brands and not metas) or (b"avis" in brands and not moovs):
            raise AVIFError("AVIF: an avif brand without meta, or avis without moov")
        self.items: Dict[int, _Item] = {}
        self.properties: List[Tuple[bytes, int, int]] = []
        self.idat: Optional[Tuple[int, int]] = None
        self.primary = None
        self.tracks: List[_Track] = []
        if metas:
            self._meta(*metas[0][1:])
        if moovs:
            self.tracks = [_Track(data, start, stop)
                           for typ, start, stop in _boxes(data, *moovs[0][1:]) if typ == b"trak"]
        # libavif's AVIF_DECODER_SOURCE_AUTO: the major brand decides, else
        # the tracks if there are any
        major = data[top[0][1] : top[0][1] + 4]
        self.from_track = major == b"avis" or (major != b"avif" and bool(self.tracks))
        if not self.from_track and self.primary is None:
            raise AVIFError("AVIF: no primary item")

    def _item(self, item_id: int) -> _Item:
        return self.items.setdefault(item_id, _Item(item_id))

    def _meta(self, pos: int, end: int) -> None:
        r = _Reader(self.data, pos, end)
        r.full()
        children = _boxes(self.data, r.pos, end)
        if not children or children[0][0] != b"hdlr":
            raise AVIFError("AVIF: meta without hdlr first")
        seen = set()
        for typ, start, stop in children:
            if typ in _UNIQUE_META:
                if typ in seen:
                    raise AVIFError(f"AVIF: duplicate {typ!r} box")
                seen.add(typ)
            body = _Reader(self.data, start, stop)
            if typ == b"hdlr":
                body.full()
                if body.u(4):
                    raise AVIFError("AVIF: hdlr pre_defined is not zero")
                if body.u(4) != int.from_bytes(b"pict", "big"):
                    raise AVIFError("AVIF: handler is not pict")
                body.u(12)  # reserved
                body.string()  # the name, which must be terminated
            elif typ == b"pitm":
                version, _ = body.full(1)
                self.primary = body.u(2 if version == 0 else 4)
            elif typ == b"iloc":
                self._iloc(body)
            elif typ == b"iinf":
                self._iinf(body)
            elif typ == b"iref":
                self._iref(body)
            elif typ == b"iprp":
                self._iprp(start, stop)
            elif typ == b"idat":
                self.idat = (start, stop)

    def _iloc(self, r: _Reader) -> None:
        version, _ = r.full(2)
        sizes = r.u(2)
        off_size, len_size = sizes >> 12, (sizes >> 8) & 15
        base_size, index_size = (sizes >> 4) & 15, (sizes & 15) if version else 0
        for s in (off_size, len_size, base_size):
            if s not in (0, 4, 8):
                raise AVIFError("AVIF: iloc field size")
        if index_size not in (0, 4, 8):
            raise AVIFError("AVIF: iloc index size")
        for _ in range(r.u(2 if version < 2 else 4)):
            item = self._item(r.u(2 if version < 2 else 4))
            if item.extents:
                raise AVIFError("AVIF: item located twice")
            if version:
                item.method = r.u(2) & 15
                if item.method > 1:
                    raise AVIFError(f"AVIF: iloc construction method {item.method}")
            r.u(2)  # data_reference_index, which libavif does not check
            base = r.u(base_size)
            count = r.u(2)
            if count == 0:
                raise AVIFError("AVIF: item without extents")
            for _ in range(count):
                if index_size:
                    r.u(index_size)
                item.extents.append((base + r.u(off_size), r.u(len_size)))

    def _iinf(self, r: _Reader) -> None:
        version, _ = r.full(1)
        count = r.u(2 if version == 0 else 4)
        entries = _boxes(self.data, r.pos, r.end)
        if len(entries) != count:
            raise AVIFError("AVIF: iinf entry count")
        for typ, start, stop in entries:
            if typ != b"infe":
                raise AVIFError("AVIF: iinf holds a box other than infe")
            e = _Reader(self.data, start, stop)
            v, _ = e.full(3)
            if v < 2:
                raise AVIFError(f"AVIF: infe version {v}")
            item = self._item(e.u(2 if v == 2 else 4))
            e.u(2)  # item_protection_index
            item.type = self.data[e.pos : e.pos + 4]
            e.u(4)
            e.string()  # item_name

    def _iref(self, r: _Reader) -> None:
        version, _ = r.full(1)
        width = 2 if version == 0 else 4
        for typ, start, stop in _boxes(self.data, r.pos, r.end):
            e = _Reader(self.data, start, stop)
            item = self._item(e.u(width))
            item.refs.setdefault(typ, []).extend(e.u(width) for _ in range(e.u(2)))

    def _iprp(self, pos: int, end: int) -> None:
        children = _boxes(self.data, pos, end)
        if not children or children[0][0] != b"ipco":
            raise AVIFError("AVIF: iprp without ipco first")
        self.properties = _boxes(self.data, children[0][1], children[0][2])
        for typ, start, stop in children[1:]:
            if typ != b"ipma":
                continue
            r = _Reader(self.data, start, stop)
            version, flags = r.full(1)
            for _ in range(r.u(4)):
                item = self._item(r.u(2 if version < 1 else 4))
                if item.props:
                    raise AVIFError("AVIF: item associated twice")
                for _ in range(r.u(1)):
                    v = r.u(2 if flags & 1 else 1)
                    bits = 15 if flags & 1 else 7
                    index = v & ((1 << bits) - 1)
                    if index:
                        if index > len(self.properties):
                            raise AVIFError("AVIF: property index past ipco")
                        item.props.append((index - 1, bool(v >> bits)))

    def prop(self, item: _Item, kind: bytes) -> Optional[Tuple[int, int]]:
        for index, _essential in item.props:
            typ, start, stop = self.properties[index]
            if typ == kind:
                return start, stop
        return None

    def payload(self, item: _Item) -> bytes:
        if item.method == 1:
            if self.idat is None:
                raise AVIFError("AVIF: construction method 1 without idat")
            base, end = self.idat
        else:
            base, end = 0, len(self.data)
        out = bytearray()
        for off, length in item.extents:
            if length == 0:
                length = end - base - off
            if off < 0 or base + off + length > end:
                raise AVIFError("AVIF: item data past the end of the file")
            out += self.data[base + off : base + off + length]
        return bytes(out)


def _primary(f: _Avif) -> _Item:
    item = f.items.get(f.primary)
    if item is None or not item.type:
        raise AVIFError("AVIF: primary item not found")
    if item.type == b"grid":
        _check_essential(f, item)
    elif item.type == b"av01":
        _check_av01(f, item)
    else:
        raise AVIFError(f"AVIF: primary item of type {item.type!r}")
    return item


def _check_essential(f: _Avif, item: _Item) -> None:
    for index, essential in item.props:
        typ = f.properties[index][0]
        if essential and typ not in _KNOWN_PROPS:
            raise AVIFError(f"AVIF: unsupported essential property {typ!r}")


def _check_av01(f: _Avif, item: _Item) -> None:
    """The properties libavif requires of an ``av01`` item."""
    _check_essential(f, item)
    av1c = f.prop(item, b"av1C")
    if av1c is None or f.prop(item, b"ispe") is None:
        raise AVIFError("AVIF: item without av1C or ispe")
    if av1c[1] - av1c[0] < 4 or f.data[av1c[0]] != 0x81:
        raise AVIFError("AVIF: av1C marker and version")
    kinds = []
    for index, _essential in item.props:
        typ, start, stop = f.properties[index]
        if typ == b"colr" and stop - start >= 4:
            kinds.append(f.data[start : start + 4] == b"nclx")
    if kinds.count(True) > 1 or kinds.count(False) > 1:
        raise AVIFError("AVIF: more than one nclx or ICC colr property")
    flags = f.data[av1c[0] + 2]
    depth = 12 if flags & 0x20 else 10 if flags & 0x40 else 8
    pixi = f.prop(item, b"pixi")
    if pixi is not None:  # every plane depth must be av1C's
        r = _Reader(f.data, *pixi)
        r.full()
        count = r.u(1)
        if count == 0 or any(r.u(1) != depth for _ in range(count)):
            raise AVIFError("AVIF: pixi depths differ from av1C's")


def _alpha_item(f: _Avif, primary: _Item) -> Optional[_Item]:
    """The ``auxl`` item (an ``av01`` image or a grid) whose ``auxC`` names
    alpha, as libavif finds it."""
    for item in f.items.values():
        if primary.id in item.refs.get(b"auxl", ()) and item.type in (b"av01", b"grid"):
            aux = f.prop(item, b"auxC")
            if aux is not None:
                r = _Reader(f.data, *aux)
                r.full()
                if r.string() in _ALPHA_URNS:
                    return item
    return None


def _nclx(f: _Avif, item: _Item) -> Optional[Tuple[int, int, int, bool]]:
    colr = f.prop(item, b"colr")
    if colr is None:
        return None
    r = _Reader(f.data, *colr)
    if r.u(4) != int.from_bytes(b"nclx", "big"):
        return None
    primaries, transfer, matrix, flags = r.u(2), r.u(2), r.u(2), r.u(1)
    if flags & 0x7F:
        raise AVIFError("AVIF: nclx reserved bits set")
    return primaries, transfer, matrix, bool(flags >> 7)


def read_avif(data: bytes) -> Tuple[List[np.ndarray], int, int, int, bool, int, int]:
    """The primary image's planes (Y, then U and V unless monochrome), as
    decoded: (planes, bit depth, ss_x, ss_y, full range, matrix, width).
    The primary image is an item, a grid of items, or the first sample of
    an image sequence's colour track."""
    return _read(data)[:7]


def _read(data: bytes):
    """:func:`read_avif`'s tuple, the colour primaries and whether an alpha
    image was decoded beside the colour one."""
    f = _Avif(data)
    if f.from_track:
        item, payload, size, track = _track_image(f)
        planes, seq = _decode(payload, size)
        first = item
        alpha = _alpha_track(f, track)
        if alpha is not None and (_decode(*alpha, alpha=True)[1].bit_depth != seq.bit_depth
                                  or alpha[1] != size):  # the sizes both are rescaled to
            raise AVIFError("AVIF: an alpha track of another depth or size than the colour "
                            "track")
    else:
        item = _primary(f)
        alpha = _alpha_item(f, item)
        if item.type == b"grid":
            planes, seq, first = _grid(f, item)
        else:
            planes, seq = _decode(f.payload(item), _ispe(f, item))
            first = item
        if alpha is not None:
            _decode_alpha(f, alpha, _ispe(f, item), seq.bit_depth)
    av1c = f.prop(first, b"av1C")
    if f.data[av1c[0] + 2] & 0x10:  # av1C's monochrome: libavif keeps only Y
        planes = planes[:1]
    nclx = _nclx(f, item)
    primaries, matrix, full = (nclx[0], nclx[2], nclx[3]) if nclx is not None else (
        seq.primaries, seq.matrix, seq.full_range)
    return (planes, seq.bit_depth, seq.ss_x, seq.ss_y, full, matrix, planes[0].shape[1],
            primaries, alpha is not None)


def _av01_entry(track: _Track) -> Optional[Tuple[int, int]]:
    return next(((a, b) for t, a, b in track.entries if t == b"av01"), None)


def _track_image(f: _Avif) -> Tuple[_Item, bytes, Tuple[int, int], _Track]:
    """The colour track as libavif picks it (the first with an id, samples
    and an ``av01`` sample entry that is no ``auxl`` track): its sample
    entry's boxes as an item's properties, its first sample, its size, the
    track."""
    for track in f.tracks:
        entry = _av01_entry(track)
        if track.id and track.samples and entry is not None and not track.auxl:
            break
    else:
        raise AVIFError("AVIF: no colour track")
    item = _Item(0)
    item.type = b"av01"
    for box in _boxes(f.data, *entry):
        item.props.append((len(f.properties), False))
        f.properties.append(box)
    w, h = track.width, track.height
    if not (0 < w <= _MAX_DIMENSION and 0 < h <= _MAX_DIMENSION) or w * h > _MAX_PIXELS:
        raise AVIFError(f"AVIF: a track of {w} x {h}")
    av1c = f.prop(item, b"av1C")
    if av1c is None or av1c[1] - av1c[0] < 4 or f.data[av1c[0]] != 0x81:
        raise AVIFError("AVIF: a track without its av1C")
    offset, size = track.samples[0]
    return item, f.data[offset : offset + size], (w, h), track


def _alpha_track(f: _Avif, colour: _Track) -> Optional[Tuple[bytes, Tuple[int, int]]]:
    """The first sample of the alpha track libavif pairs with the colour
    track (the first with an id, samples and an ``av01`` entry whose
    ``auxl`` reference names the colour track first) and its ``tkhd``
    size, or None."""
    for track in f.tracks:
        if track.id and track.samples and _av01_entry(track) is not None \
                and track.auxl_for[:1] == [colour.id]:
            offset, size = track.samples[0]
            return f.data[offset : offset + size], (track.width, track.height)
    return None


def _ispe(f: _Avif, item: _Item) -> Tuple[int, int]:
    ispe = _Reader(f.data, *f.prop(item, b"ispe"))
    ispe.full()
    iw, ih = ispe.u(4), ispe.u(4)
    if not (0 < iw <= _MAX_DIMENSION and 0 < ih <= _MAX_DIMENSION) or iw * ih > _MAX_PIXELS:
        raise AVIFError(f"AVIF: {iw} x {ih} is past libavif's limits")
    return iw, ih


def _decode(data: bytes, size: Tuple[int, int], alpha: bool = False):
    """An AV1 image's planes (every plane the sequence codes, each cut to
    its size, film grain applied, then rescaled to ``size``, the (width,
    height) its ``ispe`` or ``tkhd`` gives) and its sequence header.  The
    planes of an ``alpha`` image, which OpenCV drops, are checked and not
    rescaled."""
    from molnextr_tpu_torch.data import av1_grain, av1_refs

    shown = av1_refs.first_shown(data, lambda w, h: _check_rescale((w, h), size))
    seq, planes, width = shown.seq, shown.planes, shown.width
    ss = [(0, 0)] + [(seq.ss_x, seq.ss_y)] * (len(planes) - 1)
    if shown.grain is not None:  # libaom adds the grain to every shown frame
        planes = av1_grain.apply_grain(planes, shown.grain, seq.bit_depth, seq.ss_x, seq.ss_y,
                                       seq.matrix == 0)
    if (width, shown.height) != size and not alpha:
        planes = [yuv_scale.scale_plane(a, (size[0] + sx) >> sx, (size[1] + sy) >> sy,
                                        seq.bit_depth > 8)
                  for a, (sx, sy) in zip(planes, ss)]
    return planes, seq


def _check_rescale(frame: Tuple[int, int], size: Tuple[int, int]) -> None:
    """``avifImageScaleWithLimit``'s refusals of a decoded frame of another
    size than its item's or track's: an empty or too large target, or a
    frame past 16384 a side (which libyuv is not trusted to scale)."""
    if frame == size:
        return
    (w, h), (iw, ih) = frame, size
    if not (0 < iw <= _MAX_DIMENSION and 0 < ih <= _MAX_DIMENSION) or iw * ih > _MAX_PIXELS:
        raise AVIFError(f"AVIF: a rescaling to {iw} x {ih}")
    if w > yuv_scale.MAX_SOURCE or h > yuv_scale.MAX_SOURCE:
        raise AVIFError(f"AVIF: a {w} x {h} frame, which libavif does not rescale")


def _grid_layout(f: _Avif, item: _Item) -> Tuple[int, int, int, int, List[_Item]]:
    """A ``grid`` item's ``ImageGrid`` body and ``dimg`` tiles, as libavif
    checks them before decoding: (rows, columns, output width, output
    height, tiles)."""
    body = f.payload(item)
    r = _Reader(body, 0, len(body))
    if r.u(1) != 0:
        raise AVIFError("AVIF: grid version")
    wide = r.u(1) & 1
    rows, cols = r.u(1) + 1, r.u(1) + 1
    out_w, out_h = r.u(4 if wide else 2), r.u(4 if wide else 2)
    if r.pos != r.end:
        raise AVIFError("AVIF: grid box longer than its fields")
    if not (0 < out_w <= _MAX_DIMENSION and 0 < out_h <= _MAX_DIMENSION) \
            or out_w * out_h > _MAX_PIXELS:
        raise AVIFError(f"AVIF: grid of {out_w} x {out_h}")
    if f.prop(item, b"ispe") is None or _ispe(f, item) != (out_w, out_h):
        raise AVIFError("AVIF: a grid without ispe, or of another size than its ispe")
    ids = item.refs.get(b"dimg", [])
    if len(ids) != rows * cols:
        raise AVIFError(f"AVIF: {len(ids)} grid tiles for {rows} x {cols}")
    tiles = []
    for i in ids:
        tile = f.items.get(i)
        if tile is None or tile.type != b"av01":
            raise AVIFError("AVIF: a grid tile that is not an av01 item")
        _check_av01(f, tile)
        tiles.append(tile)
    return rows, cols, out_w, out_h, tiles


def _grid_geometry(rows: int, cols: int, out_w: int, out_h: int, tw: int, th: int, sx: int,
                   sy: int) -> None:
    """libavif's rules for tiles of ``tw`` x ``th`` (chroma subsampled by
    ``sx``, ``sy``) in a grid: they cover the output, no row or column of
    them lies wholly outside it, each is 64 a side or more, and sizes are
    even where chroma is subsampled."""
    if tw * cols < out_w or th * rows < out_h:
        raise AVIFError("AVIF: grid tiles that do not cover the output")
    if tw * (cols - 1) >= out_w or th * (rows - 1) >= out_h:
        raise AVIFError("AVIF: a grid row or column of tiles outside the output")
    if tw < 64 or th < 64:
        raise AVIFError("AVIF: grid tiles below 64 a side")
    if (sx and (out_w % 2 or tw % 2)) or (sy and (out_h % 2 or th % 2)):
        raise AVIFError("AVIF: odd grid or tile size in a subsampled direction")


def _decode_alpha(f: _Avif, alpha: _Item, size: Tuple[int, int], depth: int) -> None:
    """The alpha item decoded as libavif decodes it, its planes dropped: a
    grid as a colour grid is (its tiles decoded and checked), an item with
    the properties libavif requires; then its ``ispe`` size and decoded
    depth against the colour image's (``size``, ``depth``)."""
    if alpha.type == b"grid":
        seq = _grid(f, alpha)[1]
    else:
        _check_av01(f, alpha)
        seq = _decode(f.payload(alpha), _ispe(f, alpha), alpha=True)[1]
    if _ispe(f, alpha) != size or seq.bit_depth != depth:
        raise AVIFError("AVIF: an alpha of another size or depth than the colour image")


def _grid(f: _Avif, item: _Item):
    """A ``grid`` item's planes: its tiles decoded, placed row-major and
    cut to the output size, with libavif's checks of the tiles against
    each other and the output; the sequence header and the item of the
    first tile."""
    rows, cols, out_w, out_h, tiles = _grid_layout(f, item)
    decoded = [_decode(f.payload(t), _ispe(f, t)) for t in tiles]
    planes0, seq0 = decoded[0]
    th, tw = planes0[0].shape

    def key(planes, seq):
        return (planes[0].shape, seq.bit_depth, seq.ss_x, seq.ss_y, seq.mono, seq.full_range,
                seq.primaries, seq.transfer, seq.matrix)

    if any(key(*d) != key(*decoded[0]) for d in decoded[1:]):
        raise AVIFError("AVIF: grid tiles that differ")
    sx, sy = (0, 0) if seq0.mono else (seq0.ss_x, seq0.ss_y)
    _grid_geometry(rows, cols, out_w, out_h, tw, th, sx, sy)
    planes = []
    for p in range(len(planes0)):
        psx, psy = (sx, sy) if p else (0, 0)
        canvas = np.empty((rows * (th >> psy), cols * (tw >> psx)), planes0[p].dtype)
        for k, (tile_planes, _seq) in enumerate(decoded):
            y, x = divmod(k, cols)
            a = tile_planes[p]
            canvas[y * a.shape[0] : (y + 1) * a.shape[0], x * a.shape[1] : (x + 1) * a.shape[1]] = a
        planes.append(canvas[: (out_h + psy) >> psy, : (out_w + psx) >> psx])
    return planes, seq0, tiles[0]


def filtered_planes(dec) -> List[np.ndarray]:
    """A decoded frame's planes after the in-loop filters: deblocking, CDEF,
    the superres upscaling of both the CDEF output and (for loop
    restoration's stripe edges) the deblocked frame, then loop restoration
    (which reads the deblocked frame at its stripes' edges)."""
    from molnextr_tpu_torch.data import (av1_cdef, av1_loopfilter, av1_restoration,
                                         av1_superres)

    planes = dec.frame_planes()
    deblocked = av1_loopfilter.deblock(dec, planes)
    cdefed = av1_cdef.cdef(dec, deblocked)
    if dec.fr.use_superres:
        cdefed = av1_superres.upscale_planes(dec, cdefed)
        deblocked = av1_superres.upscale_planes(dec, deblocked) if dec.fr.uses_lr else cdefed
    return av1_restoration.restore(dec, deblocked, cdefed)


def decode_avif(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """RGB uint8 (H, W, 3) of an AVIF file's primary image, as OpenCV reads
    it (module doc)."""
    planes, bd, ss_x, ss_y, full, matrix, _w, primaries, alpha = _read(data)
    return yuv_to_rgb(planes, bd, ss_x, ss_y, full, matrix, path, primaries, alpha)


# libyuv's YuvConstants (YG, YB, UB, UG, VG, VR) for the matrices libavif
# hands to libyuv: BT.709 (1), BT.601 (5, 6, and 2, unspecified) and
# BT.2020 (9), at full and limited range (found by probing OpenCV 5.0)
_LIBYUV = {
    ("709", True): (16320, 32, 119, 12, 30, 101),
    ("709", False): (18997, -1160, 128, 14, 34, 115),
    ("601", True): (16320, 32, 113, 22, 46, 90),
    ("601", False): (18997, -1160, 128, 25, 52, 102),
    ("2020", True): (16320, 32, 120, 11, 37, 94),
    ("2020", False): (19003, -1160, 128, 12, 42, 107),
}
_MATRIX_CLASS = {1: "709", 2: "601", 5: "601", 6: "601", 9: "2020"}
# chroma-derived NCL (12) goes to libyuv for the primaries it names
_PRIMARIES_CLASS = {1: "709", 2: "709", 5: "601", 6: "601", 9: "2020"}
# libavif 1.4's own tables, as float32 (read out of the sandbox's libavif by
# a scratch script): (Kr, Kb) per matrix, and the primaries' (x, y) of red,
# green, blue and white, BT.709's for any primaries it does not list
_KR_KB = {1: (0.2126, 0.0722), 4: (0.30, 0.11), 5: (0.299, 0.114), 6: (0.299, 0.114),
          7: (0.212, 0.087), 9: (0.2627, 0.0593)}
_PRIMARIES = {
    1: (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.329),
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.329),
    6: (0.63, 0.34, 0.31, 0.595, 0.155, 0.07, 0.3127, 0.329),
    7: (0.63, 0.34, 0.31, 0.595, 0.155, 0.07, 0.3127, 0.329),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.329),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.68, 0.32, 0.265, 0.69, 0.15, 0.06, 0.314, 0.351),
    12: (0.68, 0.32, 0.265, 0.69, 0.15, 0.06, 0.3127, 0.329),
    22: (0.63, 0.34, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.329),
}


def yuv_to_rgb(planes: List[np.ndarray], bd: int, ss_x: int, ss_y: int, full: bool,
               matrix: int, path: str = "<bytes>", primaries: int = 2,
               alpha: bool = False) -> np.ndarray:
    """``avifImageYUVToRGB`` into 8-bit RGB, as OpenCV 5.0 gets it: libyuv
    for the matrices it takes, libavif's float path for GBR, FCC (4), SMPTE
    240 (7), YCgCo (8, full range), chroma-derived NCL (12) on other
    primaries, 15 (BT.601's coefficients) and YCgCo-Re (16, full range, 10
    bits); None (an :class:`AVIFError`) for the matrices libavif refuses.
    With an ``alpha`` image OpenCV asks for BGRA, which libyuv converts
    from 10 bits as they are (``I010``/``I210``/``I410AlphaToARGB``, chroma
    filtered at 10 bits) and from 12-bit 4:2:0 unfiltered (``I012ToARGB``);
    OpenCV refuses grey with alpha."""
    if len(planes) == 1 and alpha:
        raise AVIFError("AVIF: a monochrome image with alpha, which OpenCV refuses")
    if len(planes) == 1:  # grey: as stored at 8 bits, else rounded half to even
        y = planes[0]
        grey = y if bd == 8 else np.rint(y / float(1 << (bd - 8)))
        return np.repeat(np.clip(grey, 0, 255).astype(np.uint8)[..., None], 3, axis=2)
    y, u, v = planes
    if matrix == 0:  # GBR, through libavif's float path; refused when subsampled
        if ss_x or ss_y:
            raise AVIFError("AVIF: GBR with subsampled chroma")
        if bd == 8 and full:
            return np.stack([v, y, u], axis=2).astype(np.uint8)
        return np.stack([_unorm8(v, bd, full), _unorm8(y, bd, full), _unorm8(u, bd, full)],
                        axis=2)
    kind = _PRIMARIES_CLASS.get(primaries) if matrix == 12 else _MATRIX_CLASS.get(matrix)
    if kind is None:
        if matrix in (3, 10, 11, 13, 14) or matrix > 16 or (matrix in (8, 16) and not full) \
                or (matrix == 16 and bd != 10):
            raise AVIFError(f"AVIF: matrix {matrix} ({'full' if full else 'limited'} range, "
                            f"{bd} bits), which libavif does not convert")
        return _libavif_float(y, u, v, bd, ss_x, ss_y, full, matrix, primaries)
    h, w = y.shape
    if alpha and bd == 12 and ss_x and ss_y:  # I012ToARGB: nearest chroma
        u, v = (c[np.arange(h) >> 1][:, np.arange(w) >> 1] for c in (u, v))
        ss_x = ss_y = 0
    elif not (alpha and bd == 10):  # libavif hands libyuv the samples shifted down to
        y, u, v = (a >> (bd - 8) for a in (y, u, v))  # 8 bits, chroma before it is upsampled
        bd = 8
    if ss_x and ss_y:
        u, v = yuv_scale.up2_bilinear(u, w, h), yuv_scale.up2_bilinear(v, w, h)
    elif ss_x:
        u, v = yuv_scale.up_linear(u, w), yuv_scale.up_linear(v, w)
    y = y.astype(np.int64)
    y16 = (y << (16 - bd)) | (y >> (2 * bd - 16))  # libyuv's 16-bit luma (y * 0x0101 at 8)
    u, v = (np.minimum(c >> (bd - 8), 255) for c in (u, v))
    return _libyuv(y16, u, v, *_LIBYUV[(kind, full)])


def _kr_kb(matrix: int, primaries: int) -> Tuple[np.float32, np.float32]:
    """``avifCalcYUVCoefficients``: Kr and Kb from libavif's table (BT.601's
    for a matrix it does not list), or for chroma-derived NCL from the
    primaries (H.273 equations 32-37), in float32 as libavif computes them."""
    f = np.float32
    if matrix != 12:
        kr, kb = _KR_KB.get(matrix, (0.299, 0.114))
        return f(kr), f(kb)
    rx, ry, gx, gy, bx, by, wx, wy = (f(c) for c in _PRIMARIES.get(primaries, _PRIMARIES[1]))
    one = f(1)
    rz, gz, bz, wz = one - (rx + ry), one - (gx + gy), one - (bx + by), one - (wx + wy)
    den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz) + bx * (ry * gz - gy * rz))
    kr = ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz) + wz * (gx * by - bx * gy)) / den
    kb = by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz) + wz * (rx * gy - gx * ry)) / den
    return kr, kb


def _libavif_float(y, u, v, bd: int, ss_x: int, ss_y: int, full: bool, matrix: int,
                   primaries: int) -> np.ndarray:
    """``avifImageYUVAnyToRGBAnySlow`` into 8 bits: samples to float32
    through libavif's unorm tables, chroma upsampled bilinearly (9/16,
    3/16, 3/16, 1/16 of the nearest, the adjacent column, the adjacent row
    and the diagonal; 4:2:2 linearly), the matrix's formulas, then
    ``0.5 + clamp(x, 0, 1) * 255`` truncated."""
    f = np.float32
    top = (1 << bd) - 1
    codes = np.arange(1 << bd, dtype=f)
    table_y = (codes - f(0 if full else 16 << (bd - 8))) / f(top if full else 219 << (bd - 8))
    table_uv = (codes - f(1 << (bd - 1))) / f(top if full else 224 << (bd - 8))
    h, w = y.shape
    luma = np.minimum(y, top)
    cb, cr = (_chroma(table_uv[np.minimum(c, top)], h, w, ss_x, ss_y) for c in (u, v))
    big_y = table_y[luma]
    if matrix == 8:  # YCgCo
        t = big_y - cb
        r, g, b = t + cr, big_y + cb, t - cr
    elif matrix == 16:  # YCgCo-Re, in integers at the samples' depth
        cg = _roundf(cb * f(top)).astype(np.int64)
        co = _roundf(cr * f(top)).astype(np.int64)
        t = luma.astype(np.int64) - (cg >> 1)
        g = np.clip(t + cg, 0, 255)
        b = np.clip(t - (co >> 1), 0, 255)
        r = np.clip(b + co, 0, 255)
        r, g, b = (a.astype(f) / f(255) for a in (r, g, b))
    else:
        kr, kb = _kr_kb(matrix, primaries)
        kg = f(1) - kr - kb
        r = big_y + (f(2) * (f(1) - kr)) * cr
        b = big_y + (f(2) * (f(1) - kb)) * cb
        g = big_y - (f(2) * ((kr * (f(1) - kr) * cr) + (kb * (f(1) - kb) * cb))) / kg
    return np.stack([(f(0.5) + np.clip(a, f(0), f(1)) * f(255)).astype(np.uint8)
                     for a in (r, g, b)], axis=2)


def _roundf(x: np.ndarray) -> np.ndarray:
    """libavif's ``avifRoundf``: ``floorf(x + 0.5f)``, halves up."""
    return np.floor(x + np.float32(0.5))


def _chroma(t: np.ndarray, h: int, w: int, ss_x: int, ss_y: int) -> np.ndarray:
    """A chroma plane of unorm floats at the luma size, as libavif's slow
    path upsamples it: the nearest sample, the one beside it toward the
    pixel (none at the first column or at an odd last one), the one above
    or below it likewise (none at 4:2:2)."""
    f = np.float32
    if not (ss_x or ss_y):
        return t
    i, j = np.arange(w), np.arange(h)

    def adjacent(k, n, on):
        if not on:
            return np.zeros_like(k)
        return np.where((k == 0) | ((k == n - 1) & (k % 2 == 1)), 0, np.where(k % 2 == 1, 1, -1))

    ci, cj = i >> ss_x, j >> ss_y
    ai, aj = ci + adjacent(i, w, ss_x), cj + adjacent(j, h, ss_y)
    near, col = t[cj][:, ci], t[cj][:, ai]
    row, diag = t[aj][:, ci], t[aj][:, ai]
    return near * f(9 / 16) + col * f(3 / 16) + row * f(3 / 16) + diag * f(1 / 16)


def _unorm8(a: np.ndarray, bd: int, full: bool = True) -> np.ndarray:
    """libavif's float32 path from a sample to 8 bits: over the full range,
    or less 16 and over 219 (times 2**(bd - 8)) at limited range."""
    if full:
        x = a.astype(np.float32) / np.float32((1 << bd) - 1)
    else:
        s = 1 << (bd - 8)
        x = (a.astype(np.float32) - np.float32(16 * s)) / np.float32(219 * s)
    return (np.float32(0.5) + np.clip(x, 0, 1) * np.float32(255)).astype(np.uint8)


def _libyuv(y16, u, v, yg: int, yb: int, ub: int, ug: int, vg: int, vr: int) -> np.ndarray:
    """libyuv's ``YuvPixel``: the 16-bit luma scaled by ``yg`` (16.16), 8-bit
    U and V less 128 times 6-bit coefficients, the sum over 64, clamped."""
    y1 = (y16 * yg) >> 16
    u = u.astype(np.int64) - 128
    v = v.astype(np.int64) - 128
    rgb = np.stack([(y1 + v * vr + yb) >> 6, (y1 - u * ug - v * vg + yb) >> 6,
                    (y1 + u * ub + yb) >> 6], axis=2)
    return np.clip(rgb, 0, 255).astype(np.uint8)
