"""One image reader for every call site: :func:`imread`.

``imread(path)`` returns RGB uint8 ``(H, W, 3)``, equal to
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``, or None where
``cv2.imread`` returns None: a missing file, one that is empty, unreadable
or corrupt, or a TIFF whose orientation is 5-8 (which OpenCV 5.0 fails to
read; ``data/tiff.py``).  It dispatches on the file's first bytes to
``data/png.py``, ``data/jpeg.py`` or ``data/tiff.py``; each applies the
EXIF orientation as OpenCV does (``data/exif.py``).

A format that OpenCV reads and the port does not yet decode raises
:class:`UnsupportedFormat` (a ``ValueError``) naming it, and so does an
unported form of JPEG or TIFF (arithmetic coding, JPEG-in-TIFF, ...): such a
file is never silently dropped or whitened.  The call sites do on None what
their JAX counterparts do on ``cv2.imread``'s None: ``predict_image_files``
raises ``FileNotFoundError``, the dataset substitutes a white placeholder,
evaluation and the dataset-eval suite skip the row.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np


class UnsupportedFormat(ValueError):
    """A file OpenCV reads whose format or form the port does not decode."""


# (magic bytes at offset 0, format) of what OpenCV reads
_MAGIC = (
    (b"\x89PNG\r\n\x1a\n", "PNG"), (b"\xff\xd8\xff", "JPEG"), (b"II*\x00", "TIFF"),
    (b"MM\x00*", "TIFF"), (b"II+\x00", "BigTIFF"), (b"MM\x00+", "BigTIFF"),
    (b"BM", "BMP"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"), (b"\xffO\xffQ", "JPEG 2000"),
    (b"#?RADIANCE", "HDR"), (b"#?RGBE", "HDR"), (b"\x59\xa6\x6a\x95", "Sun raster"),
)


def sniff_format(data: bytes) -> str:
    """The image format that a file's first bytes show, or ``unknown format``."""
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis"):
        return "AVIF"
    if len(data) >= 3 and data[:1] == b"P" and data[1:2] in b"1234567fF" \
            and data[2:3] in b" \t\r\n":
        return "PNM"
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    return "unknown format"


def decode(data: bytes, path: str = "<bytes>") -> Optional[np.ndarray]:
    """:func:`imread` of a file's bytes."""
    kind = sniff_format(data)
    if kind == "unknown format":
        return None  # OpenCV finds no decoder for it
    if kind not in ("PNG", "JPEG", "TIFF"):
        raise UnsupportedFormat(f"{path}: {kind} is not decoded by the port yet "
                                "(PNG, JPEG and TIFF are; ROADMAP queue 1)")
    from molnextr_tpu_torch.data import jpeg, png, tiff

    reader = {"PNG": png.decode_png, "JPEG": jpeg.decode_jpeg, "TIFF": tiff.decode_tiff}[kind]
    try:
        return reader(data, path)
    except UnsupportedFormat:
        raise
    except (ValueError, IndexError, KeyError, struct.error, zlib.error):
        return None  # corrupt: the library under cv2.imread gives up too


def imread(path: str) -> Optional[np.ndarray]:
    """RGB uint8 (H, W, 3) of an image file as ``cv2.imread`` reads it, or
    None where it returns None (module doc)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return decode(data, path)
