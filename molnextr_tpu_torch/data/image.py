"""One image reader for every call site: :func:`imread`.

``imread(path)`` returns RGB uint8 ``(H, W, 3)``, equal to
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``, or None where
``cv2.imread`` returns None: a missing file, one that is empty, unreadable
or corrupt, or a form OpenCV 5.0 refuses (a TIFF of a compression its
libtiff lacks, float or 12-64-bit samples, ICC or ITU Lab; a 12-bit or
hierarchical JPEG, or one whose height is left to a DNL marker: each
reader module lists them), or a TIFF whose orientation is 5-8 (which
OpenCV 5.0 fails to read; ``data/tiff.py``).  It dispatches on the file's
first bytes to the port's readers: ``data/png.py``, ``data/jpeg.py``
(Huffman, arithmetic and lossless, with libjpeg's block smoothing),
``data/tiff.py`` (TIFF and BigTIFF; JPEG-in-TIFF, YCbCr, CMYK, CIE Lab,
ThunderScan and SGILog too), ``data/bmp.py``, ``data/pnm.py`` (PBM, PGM,
PPM, PAM, PFM), ``data/gif.py``, ``data/sunras.py``, ``data/hdr.py``,
``data/webp.py`` (lossy, lossless, alpha, animated: the first frame) and
``data/jp2.py`` (JPEG 2000: the JP2 file and the raw codestream, over
``data/j2k*.py``) and ``data/avif.py`` (AVIF: the HEIF container over the
AV1 decoder of ``data/av1_*.py``, lossless and lossy, intra and inter
frames at 8, 10 and 12 bits, film grain, superres, grids, the first shown
frame of a sequence,
frames rescaled to their ``ispe`` by ``data/yuv_scale.py``); PNG, JPEG,
TIFF and WebP apply the EXIF orientation as OpenCV does
(``data/exif.py``).
Each reader module names the few forms where it reads a file that OpenCV
5.0 returns None for (differences by design, pinned by tests).

A form that OpenCV reads and the port does not decode would raise
:class:`UnsupportedFormat` (a ``ValueError``) naming it, never None: none
is left since HTJ2K code-blocks (``data/j2k_ht.py``).  Such a file is never
silently dropped or whitened.  The call sites do on None
what their JAX counterparts do on ``cv2.imread``'s None:
``predict_image_files`` raises ``FileNotFoundError``, the dataset
substitutes a white placeholder, evaluation and the dataset-eval suite skip
the row.
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
    if data[4:8] == b"ftyp":
        from molnextr_tpu_torch.data.avif import compatible

        return "AVIF" if compatible(data) else "unknown format"
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
    from molnextr_tpu_torch.data import avif, bmp, gif, hdr, jp2, jpeg, png, pnm, sunras, tiff, webp

    reader = {"PNG": png.decode_png, "JPEG": jpeg.decode_jpeg, "TIFF": tiff.decode_tiff,
              "BigTIFF": tiff.decode_tiff, "BMP": bmp.decode_bmp, "PNM": pnm.decode_pnm,
              "GIF": gif.decode_gif, "HDR": hdr.decode_hdr,
              "Sun raster": sunras.decode_sunras, "WebP": webp.decode_webp,
              "JPEG 2000": jp2.decode_jpeg2000, "AVIF": avif.decode_avif}[kind]
    try:
        return reader(data, path)
    except UnsupportedFormat:
        raise
    except (ValueError, IndexError, KeyError, OverflowError, struct.error, zlib.error):
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
