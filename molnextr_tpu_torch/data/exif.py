"""EXIF orientation: the tag's value from a TIFF-structured EXIF block, and
the transform that OpenCV's ``ApplyExifOrientation`` makes with it.

``cv2.imread`` (without ``IMREAD_IGNORE_ORIENTATION``) turns an image by
the orientation tag (0x0112) of its EXIF block's first IFD: a PNG's
``eXIf`` chunk, a JPEG's APP1 ``Exif\\0\\0`` segment, or a TIFF's own tag
274.  The block is a little TIFF file (``II*\\0`` or ``MM\\0*``, the offset
of IFD0, then 12-byte entries).  Malformed, absent or out-of-range data
reads as orientation 1, which changes nothing.
"""

from __future__ import annotations

import struct

import numpy as np

ORIENTATION_TAG = 0x0112


def ifd_orientation(block: bytes, order: str, ifd: int) -> int:
    """Orientation 1-8 from the IFD at ``ifd`` of a TIFF-structured block in
    byte order ``order`` (``<`` or ``>``); 1 where it cannot be read."""
    try:
        (count,) = struct.unpack_from(order + "H", block, ifd)
        for k in range(count):
            tag, typ, _n = struct.unpack_from(order + "HHI", block, ifd + 2 + 12 * k)
            if tag != ORIENTATION_TAG:
                continue
            if typ == 3:  # SHORT
                (value,) = struct.unpack_from(order + "H", block, ifd + 10 + 12 * k)
            elif typ == 4:  # LONG
                (value,) = struct.unpack_from(order + "I", block, ifd + 10 + 12 * k)
            else:
                return 1
            return value if 1 <= value <= 8 else 1
    except struct.error:
        return 1
    return 1


def exif_orientation(block: bytes) -> int:
    """Orientation 1-8 of an EXIF block that starts at its TIFF header."""
    if len(block) < 8 or block[:4] not in (b"II*\x00", b"MM\x00*"):
        return 1
    order = "<" if block[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(order + "I", block, 4)
    return ifd_orientation(block, order, ifd)


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
