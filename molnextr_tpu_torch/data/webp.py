"""A WebP reader in Python and numpy, exact against ``cv2.imread``.

:func:`decode_webp` returns RGB uint8 ``(H, W, 3)`` of a WebP file as
OpenCV 5.0 gives it under ``IMREAD_COLOR``, on libwebp (``grfmt_webp.cpp``
over ``src/dec/webp_dec.c``, ``alpha_dec.c`` and ``src/demux``):

* OpenCV reads the file's first 32 bytes for its features
  (``WebPGetFeatures``); a shorter file, or one whose header fails there,
  reads as None.  A size there (the ``VP8X`` canvas) past OpenCV's limits
  (2^20 a side, 2^30 pixels) makes ``cv2.imread`` raise ``cv2.error``; the
  port reads None (a difference by design).
* **A still image** is decoded as ``WebPDecode`` does: the RIFF size
  checked against the file (a file cut short fails; bytes past it are
  ignored), chunks padded to even sizes, ``VP8X`` (flags and a 24-bit canvas
  that must equal the image's), optional chunks skipped up to the ``VP8 ``
  or ``VP8L`` chunk (``ICCP``, ``XMP ``, ``EXIF``, unknown ones; ICC is not
  applied), the last ``ALPH`` before it kept, then the bitstream read to the
  end of the file (``data/vp8.py``, ``data/vp8l.py``).  A lossy image's
  ``ALPH`` chunk is decoded (raw or lossless, filter none, horizontal,
  vertical or gradient) even though the colour output drops it: a bad one
  fails the image.
* **Alpha** is dropped, never composited.
* **An animation** (the ``VP8X`` animation flag) reads as its first frame
  as ``WebPAnimDecoder`` draws it: the frame's RGB at its offset (x 2) on a
  canvas of transparent black, so black around a smaller frame; no blending
  on a first frame, whatever its blend bit, and the ``ANIM`` background
  colour unused.  The file must pass ``WebPDemux``'s validation.
* **EXIF.** The orientation of the first ``EXIF`` chunk (a TIFF header
  first; ``data/exif.py``) turns the image, where OpenCV 5.0 applies it: the
  ``VP8X`` EXIF flag set and the file valid for ``WebPDemux`` (for a still
  image an invalid layout, such as ``ALPH`` before ``VP8L``, still decodes,
  unturned).

Every malformed input raises a ``ValueError`` (``WebPError``, ``VP8Error``,
``VP8LError``) or ``IndexError``, which ``data/image.py`` turns into None.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from molnextr_tpu_torch.data.exif import apply_orientation, exif_orientation
from molnextr_tpu_torch.data.vp8 import VP8Error, decode_vp8, vp8_info, yuv_to_rgb
from molnextr_tpu_torch.data.vp8l import VP8LError, decode_alpha_stream, decode_vp8l, vp8l_info

_MAX_PAYLOAD = 0xFFFFFFF6
_ANIMATION, _VALID_FLAGS = 0x02, 0x3E  # VP8X flags: animation; every defined one
_OK, _MORE, _BAD = 0, 1, 2  # parse status: fine, data missing, invalid
_MAX_SIDE, _MAX_PIXELS = 1 << 20, 1 << 30  # OpenCV's CV_IO_MAX_IMAGE_* defaults


class WebPError(ValueError):
    """A WebP file that libwebp or OpenCV refuses."""


def _le(data: bytes, pos: int, n: int) -> int:
    return int.from_bytes(data[pos : pos + n], "little")


# ----- headers (ParseHeadersInternal) -------------------------------------

def _headers(data: bytes, full: bool) -> Tuple[int, dict]:
    """``ParseHeadersInternal``: with ``full`` as ``WebPDecode`` parses the
    whole file, else as ``WebPGetFeatures`` parses a prefix (where a
    ``VP8X`` header is enough).  Returns a status and what was found."""
    n = len(data)
    info = {"animation": False, "alpha": None}
    if n < 12:
        return _MORE, info
    pos = riff = 0
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            return _BAD, info
        riff = _le(data, 4, 4)
        if riff < 12 or riff > _MAX_PAYLOAD:
            return _BAD, info
        if full and riff > n - 8:
            return _MORE, info
        pos = 12
    if n - pos < 8:
        return _MORE, info
    vp8x = data[pos : pos + 4] == b"VP8X"
    canvas = None
    if vp8x:
        if _le(data, pos + 4, 4) != 10:
            return _BAD, info
        if n - pos < 18:
            return _MORE, info
        flags = _le(data, pos + 8, 4)
        canvas = (1 + _le(data, pos + 12, 3), 1 + _le(data, pos + 15, 3))
        if canvas[0] * canvas[1] >= 1 << 32:
            return _BAD, info
        pos += 18
        info["animation"] = bool(flags & _ANIMATION)
        info["size"] = canvas
        if not riff:
            return _BAD, info
        if info["animation"] and not full:
            return _OK, info

    def done(status):  # ReturnWidthHeight
        return (_OK if status == _MORE and vp8x and not full else status), info

    if n - pos < 4:
        return done(_MORE)
    if (riff and vp8x) or (not riff and not vp8x and data[pos : pos + 4] == b"ALPH"):
        total = 22
        while True:  # ParseOptionalChunks
            if n - pos < 8:
                return done(_MORE)
            size = _le(data, pos + 4, 4)
            if size > _MAX_PAYLOAD:
                return _BAD, info
            disk = (8 + size + 1) & ~1
            total = (total + disk) & 0xFFFFFFFF
            if riff and total > riff:
                return _BAD, info
            if data[pos : pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if n - pos < disk:
                return done(_MORE)
            if data[pos : pos + 4] == b"ALPH":
                info["alpha"] = (pos + 8, size)
            pos += disk
    if n - pos < 8:  # ParseVP8Header
        return done(_MORE)
    tag = data[pos : pos + 4]
    if tag in (b"VP8 ", b"VP8L"):
        size = _le(data, pos + 4, 4)
        if riff >= 12 and size > riff - 12:
            return _BAD, info
        if full and size > n - pos - 8:
            return done(_MORE)
        chunk, lossless = size, tag == b"VP8L"
        pos += 8
    else:  # a raw bitstream
        lossless = n - pos >= 5 and data[pos] == 0x2F and data[pos + 4] >> 5 == 0
        chunk = n - pos
    if chunk > _MAX_PAYLOAD:
        return _BAD, info
    try:
        if not lossless:
            if n - pos < 10:
                return done(_MORE)
            w, h = vp8_info(data[pos : pos + 10], chunk)
            has_alpha = False
        else:
            if n - pos < 5:
                return done(_MORE)
            w, h, has_alpha = vp8l_info(data[pos : pos + 5])
    except (VP8Error, VP8LError):
        return _BAD, info
    if vp8x and canvas != (w, h):
        return _BAD, info
    info.update(offset=pos, lossless=lossless, size=(w, h), has_alpha=has_alpha)
    return _OK, info


# ----- alpha ---------------------------------------------------------------

def _unfilter(a: np.ndarray, kind: int) -> np.ndarray:
    """``WebPUnfilters``: none, horizontal, vertical, gradient, mod 256."""
    a = a.astype(np.int64)
    if kind == 0:
        return a.astype(np.uint8)
    h, w = a.shape
    out = np.empty_like(a)
    out[0] = np.cumsum(a[0])  # the first row predicts from the left (0 first)
    if kind == 1:  # each row from the left, its first pixel from above
        col0 = np.cumsum(a[:, 0])
        out[1:] = col0[1:, None] + np.cumsum(a[1:], 1) - a[1:, :1]
    elif kind == 2:
        out[1:] = a[1:]
        out = np.cumsum(out, 0)
    else:  # gradient: clip(left + top - top-left), the first pixel from above
        out = out % 256
        for t in range(1, w + h - 1):  # anti-diagonals, each after the last
            ys = np.arange(max(1, t - w + 1), min(h - 1, t) + 1)
            if not len(ys):
                continue
            xs = t - ys
            top = out[ys - 1, xs]
            first = xs == 0
            left = np.where(first, top, out[ys, np.maximum(xs - 1, 0)])
            top_left = np.where(first, top, out[ys - 1, np.maximum(xs - 1, 0)])
            out[ys, xs] = (a[ys, xs] + np.clip(left + top - top_left, 0, 255)) % 256
    return (out % 256).astype(np.uint8)


def _alpha(data: bytes, start: int, size: int, w: int, h: int) -> np.ndarray:
    """An ``ALPH`` chunk's plane (``ALPHInit``, ``ALPHDecode``)."""
    if size <= 1:
        raise WebPError("WebP: empty ALPH chunk")
    head = data[start]
    method, kind, pre, reserved = head & 3, (head >> 2) & 3, (head >> 4) & 3, head >> 6
    if method > 1 or pre > 1 or reserved:
        raise WebPError("WebP: bad ALPH header")
    body = data[start + 1 : start + size]
    if method == 0:
        if len(body) < w * h:
            raise WebPError("WebP: ALPH data too short")
        plane = np.frombuffer(body, np.uint8, w * h).reshape(h, w)
    else:
        plane = decode_alpha_stream(body, w, h)
    return _unfilter(plane, kind)


# ----- still images (DecodeInto) -------------------------------------------

def _decode_still(data: bytes) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """RGB and alpha (None when opaque) as ``WebPDecode`` gives them."""
    status, info = _headers(data, full=True)
    if status != _OK or info["animation"]:
        raise WebPError("WebP: bad headers")
    payload = data[info["offset"] :]  # the decoder reads to the end of the data
    if info["lossless"]:
        argb = decode_vp8l(payload)
        rgb = np.stack([(argb >> 16) & 255, (argb >> 8) & 255, argb & 255], 2).astype(np.uint8)
        return rgb, (argb >> 24).astype(np.uint8)
    planes = decode_vp8(payload)
    alpha = None
    if info["alpha"] is not None:
        h, w = planes[0].shape
        alpha = _alpha(data, *info["alpha"], w, h)
    return yuv_to_rgb(*planes), alpha


# ----- demux (WebPDemux), for EXIF and animations ---------------------------

class _Frame:
    def __init__(self, num: int = 0, x: int = 0, y: int = 0, w: int = 0, h: int = 0):
        self.num, self.x, self.y, self.w, self.h = num, x, y, w, h
        self.image: Optional[Tuple[int, int]] = None  # (offset, size with header)
        self.alpha: Optional[Tuple[int, int]] = None
        self.complete = False


class _Demux:
    """``WebPDemux`` of a whole ``VP8X`` file: None where it fails."""

    def __init__(self, data: bytes):
        self.data = data
        self.frames: List[_Frame] = []
        self.chunks: List[Tuple[bytes, int, int]] = []  # (fourcc, offset, size with header)

    def parse(self) -> bool:
        data = self.data
        if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
            return False
        riff = _le(data, 4, 4)
        if riff < 8 or riff > _MAX_PAYLOAD:
            return False
        self.riff_end = riff + 8
        if len(data) < self.riff_end:
            return False  # partial
        self.end = self.riff_end
        self.pos = 12
        if data[12:16] != b"VP8X":
            return False
        # ParseVP8X
        if self.end - self.pos < 8:
            return False
        size = _le(data, self.pos + 4, 4)
        self.pos += 8
        if size > _MAX_PAYLOAD or size < 10:
            return False
        size += size & 1
        if size > self.riff_end - self.pos or self.end - self.pos < size:
            return False
        self.flags = data[self.pos]
        self.canvas = (1 + _le(data, self.pos + 4, 3), 1 + _le(data, self.pos + 7, 3))
        if self.canvas[0] * self.canvas[1] >= 1 << 32:
            return False
        self.pos += size
        if 8 > self.riff_end - self.pos or self.end - self.pos < 8:
            return False
        return self._chunks() == _OK and self._valid()

    def _chunks(self) -> int:
        """``ParseVP8XChunks``."""
        data, animation = self.data, bool(self.flags & _ANIMATION)
        anim_chunks = 0
        while True:
            start = self.pos
            fourcc, size = data[start : start + 4], _le(data, start + 4, 4)
            self.pos += 8
            if size > _MAX_PAYLOAD:
                return _BAD
            padded = size + (size & 1)
            if padded > self.riff_end - self.pos:
                return _BAD
            status, skip, store = _OK, False, True
            if fourcc == b"VP8X":
                return _BAD
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or animation:
                    return _BAD
                self.pos -= 8
                status = self._single()
            elif fourcc == b"ANIM":
                if padded < 6:
                    return _BAD
                if self.end - self.pos < padded:
                    status = _MORE
                elif not anim_chunks:
                    anim_chunks = 1
                    self.pos += padded
                else:
                    skip, store = True, False
            elif fourcc == b"ANMF":
                if not anim_chunks:
                    return _BAD
                status = self._anmf(padded)
            else:
                skip = True
                store = {b"ICCP": 0x20, b"EXIF": 0x08, b"XMP ": 0x04}.get(fourcc, -1)
                store = store == -1 or bool(self.flags & store)
            if skip:
                if padded <= self.end - self.pos:
                    if store:
                        self.chunks.append((fourcc, start, 8 + size))
                    self.pos += padded
                else:
                    status = _MORE
            if status == _BAD:
                return _BAD
            if self.pos == self.riff_end:
                return status
            if self.end - self.pos < 8:
                status = _MORE
            if status != _OK:
                return status

    def _store(self, frame: _Frame, min_size: int) -> int:
        """``StoreFrame``: the ``ALPH`` and image chunks of one frame."""
        data = self.data
        if self.end - self.pos < 8 or self.end - self.pos < min_size:
            return _MORE
        alpha_chunks = image_chunks = 0
        status = _OK
        while True:
            start = self.pos
            fourcc, size = data[start : start + 4], _le(data, start + 4, 4)
            self.pos += 8
            if size > _MAX_PAYLOAD:
                return _BAD
            padded = size + (size & 1)
            available = min(padded, self.end - self.pos)
            if padded > self.riff_end - self.pos:
                return _BAD
            if padded > self.end - self.pos:
                status = _MORE
            done = False
            if fourcc == b"VP8L" and alpha_chunks:  # VP8L holds its own alpha
                return _BAD
            if fourcc == b"ALPH" and not alpha_chunks:
                alpha_chunks = 1
                frame.alpha = (start, 8 + available)
                frame.num = frame.num or -1
                self.pos += available
            elif fourcc in (b"VP8 ", b"VP8L") and not image_chunks:
                feat, info = _headers(data[start : start + 8 + available], full=False)
                if status == _MORE and feat == _MORE:
                    return _MORE
                if feat != _OK:
                    return _BAD
                image_chunks = 1
                frame.image = (start, 8 + available)
                frame.w, frame.h = info["size"]
                frame.num = frame.num or -1
                frame.complete = status == _OK
                self.pos += available
            else:
                self.pos -= 8
                done = True
            if self.pos == self.riff_end:
                done = True
            elif self.end - self.pos < 8:
                status = _MORE
            if done or status != _OK:
                return status

    def _single(self) -> int:
        """``ParseSingleImage`` inside a ``VP8X`` file."""
        if self.frames or 8 > self.riff_end - self.pos:
            return _BAD
        if self.end - self.pos < 8:
            return _MORE
        frame = _Frame()
        status = self._store(frame, 0)
        if frame.num:
            frame.num = 1
        if status != _BAD:
            self.frames.append(frame)
        return status

    def _anmf(self, padded: int) -> int:
        """``ParseAnimationFrame``."""
        data = self.data
        if 16 > self.riff_end - self.pos or padded < 16:
            return _BAD
        if self.end - self.pos < 16:
            return _MORE
        p = self.pos
        frame = _Frame(0, 2 * _le(data, p, 3), 2 * _le(data, p + 3, 3),
                       1 + _le(data, p + 6, 3), 1 + _le(data, p + 9, 3))
        self.pos += 16
        if frame.w * frame.h >= 1 << 32:
            return _BAD
        start = self.pos
        status = self._store(frame, padded - 16)
        if status != _BAD and self.pos - start > padded - 16:
            status = _BAD
        if status != _BAD and self.flags & _ANIMATION and frame.num:
            if self.frames and not self.frames[-1].complete:
                return _BAD
            frame.num = len(self.frames) + 1
            self.frames.append(frame)
        return status

    def _valid(self) -> bool:
        """``IsValidExtendedFormat`` of a fully parsed file."""
        animation = bool(self.flags & _ANIMATION)
        if not self.frames or self.flags & ~_VALID_FLAGS:
            return False
        cw, ch = self.canvas
        for f in self.frames:
            if not animation and f.num > 1:
                return False
            if not f.complete:
                return False
            if f.alpha is not None and f.image is not None and f.alpha[0] > f.image[0]:
                return False
            if f.w <= 0 or f.h <= 0:
                return False
            if animation:
                if f.x + f.w > cw or f.y + f.h > ch:
                    return False
            elif (f.x, f.y, f.w, f.h) != (0, 0, cw, ch):
                return False
        return True

    def exif(self) -> Optional[bytes]:
        for fourcc, start, size in self.chunks:
            if fourcc == b"EXIF":
                return self.data[start + 8 : start + size]
        return None


def _first_frame(dmx: _Demux) -> Tuple[np.ndarray, np.ndarray]:
    """The canvas after ``WebPAnimDecoderGetNext``'s first frame."""
    f = dmx.frames[0]
    start, size = f.image
    if f.alpha is not None:
        size += start - f.alpha[0]
        start = f.alpha[0]
    rgb, alpha = _decode_still(dmx.data[start : start + size])
    cw, ch = dmx.canvas
    canvas = np.zeros((ch, cw, 3), np.uint8)
    alpha_canvas = np.zeros((ch, cw), np.uint8)
    h, w = rgb.shape[:2]
    canvas[f.y : f.y + h, f.x : f.x + w] = rgb
    alpha_canvas[f.y : f.y + h, f.x : f.x + w] = 255 if alpha is None else alpha
    return canvas, alpha_canvas


def read_webp(data: bytes) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    """RGB (H, W, 3) and alpha (H, W) or None of a WebP file as decoded,
    before the EXIF orientation, and that orientation (1-8)."""
    if len(data) < 32:
        raise WebPError("WebP: file too small")
    status, features = _headers(data[:32], full=False)
    if status != _OK:
        raise WebPError("WebP: bad header")
    w, h = features["size"]
    if w > _MAX_SIDE or h > _MAX_SIDE or w * h > _MAX_PIXELS:
        raise WebPError("WebP: past OpenCV's image size limits")
    dmx = _Demux(data)
    valid = dmx.parse()
    if features["animation"]:
        if not valid:
            raise WebPError("WebP: invalid animation")
        rgb, alpha = _first_frame(dmx)
    else:
        rgb, alpha = _decode_still(data)
    orientation = 1
    if valid:
        block = dmx.exif()
        if block is not None:
            orientation = exif_orientation(block)
    return rgb, alpha, orientation


def decode_webp(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """RGB uint8 (H, W, 3) of a WebP file as ``cv2.imread`` reads it (module
    doc).  Raises ``ValueError`` where OpenCV gives None."""
    rgb, _, orientation = read_webp(data)
    return apply_orientation(rgb, orientation)
