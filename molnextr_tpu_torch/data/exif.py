"""EXIF orientation: the tag's value from a TIFF-structured EXIF block, and
the transform that OpenCV's ``ApplyExifOrientation`` makes with it.

``cv2.imread`` (without ``IMREAD_IGNORE_ORIENTATION``) turns an image by
the orientation tag (0x0112) of its EXIF block's first IFD: a PNG's
``eXIf`` chunk, a JPEG's APP1 ``Exif\\0\\0`` segment or a WebP's ``EXIF``
chunk, read by OpenCV's ``ExifReader`` (:func:`exif_orientation`); a TIFF's
own tag 274 is read with its other tags (``data/tiff.py``).  The block is a
little TIFF file (byte order, 42, the offset of IFD0, then 12-byte
entries).  Malformed, absent or out-of-range data reads as orientation 1,
which changes nothing.
"""

from __future__ import annotations

import struct

import numpy as np

ORIENTATION_TAG = 0x0112
# the tags OpenCV's ExifReader parses, and what it reads of each: a string
# (its count, then the bytes at 8 or at an offset), a list of rationals at an
# offset (how many), or the SHORT at entry + 8
_STRING_TAGS = (0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298)
_RATIONAL_TAGS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3, 0x0214: 6}
_SHORT_TAGS = (ORIENTATION_TAG, 0x0128, 0x0213)


class _Malformed(Exception):
    pass


def exif_orientation(block: bytes) -> int:
    """Orientation 1-8 of an EXIF block that starts at its TIFF header, as
    OpenCV's ``ExifReader`` reads it: Intel order only for ``II``, else
    Motorola; the tag mark 42; the entries of IFD0 parsed in order until
    one reaches past the block (a string's or rationals' data too), the
    first orientation entry's SHORT at entry + 8 counting, whatever its
    type.  1 where it cannot be read or is out of range."""
    order = "<" if len(block) >= 2 and block[0] == block[1] == ord("I") else ">"
    size = len(block)

    def u16(pos):
        if pos + 1 >= size:
            raise _Malformed
        return struct.unpack_from(order + "H", block, pos)[0]

    def u32(pos):
        if pos + 3 >= size:
            raise _Malformed
        return struct.unpack_from(order + "I", block, pos)[0]

    try:
        if u16(2) != 42:
            return 1
        ifd = u32(4)
        entries = u16(ifd)
    except _Malformed:
        return 1
    orientation = None
    try:
        for k in range(entries):
            entry = ifd + 2 + 12 * k
            tag = u16(entry)
            if tag in _STRING_TAGS:
                count = u32(entry + 4)
                at = u32(entry + 8) if count > 4 else 8
                if at > size or at + count > size:
                    raise _Malformed
            elif tag in _RATIONAL_TAGS:
                at = u32(entry + 8)
                for i in range(_RATIONAL_TAGS[tag]):
                    u32((at + 8 * i) & 0xFFFFFFFF)
                    u32((at + 8 * i + 4) & 0xFFFFFFFF)
            elif tag in _SHORT_TAGS:
                value = u16(entry + 8)
                if tag == ORIENTATION_TAG and orientation is None:
                    orientation = value
    except _Malformed:
        pass  # the entries before the one that failed stand
    return orientation if orientation is not None and 1 <= orientation <= 8 else 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Turn ``img`` (H, W, ...) as ``ApplyExifOrientation`` does: 2 flips
    left-right, 3 turns by 180 degrees, 4 flips up-down, 5 transposes, 6
    turns 90 degrees clockwise, 7 transverses, 8 turns 90 degrees
    counter-clockwise."""
    if orientation >= 5:
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)
