"""AVIF ``grid`` derived images against ``cv2.imread``, exactly.

Grids come from ``torch_image_writers.avif_grid`` (no writer here makes
one): distinct tiles from ``cv2.imwrite`` and Pillow, lossless and lossy,
4:2:0, 4:4:4 and grey, with grain, in 1 x N, N x 1, 2 x 3 and 3 x 3
layouts, the output cropped to odd sizes where the format allows, in 16-
and 32-bit fields.  libavif places the decoded tiles row-major and
converts the whole canvas with the grid item's ``colr`` box, or with the
first tile's AV1 sequence header where the grid has none (the tiles'
own ``colr`` boxes are not read): both probed here.  Each form libavif
refuses reads as None, as in cv2: a tile count other than rows x columns,
tiles that differ in size, depth, subsampling or range, an output the
tiles do not cover or that leaves a row or column of tiles outside, tiles
below 64 a side, odd sizes where chroma is subsampled, a grid box of
another version or length, a grid without ``ispe`` or of another size
than it, and an alpha grid whose layout fails those checks.
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image
from test_torch_avif import check, cv2_avif, cv2_rgb, pil_avif, picture
from torch_image_writers import avif_boxes, avif_grid, film_grain_avif

from molnextr_tpu_torch.data import avif
from molnextr_tpu_torch.data.image import imread


def cv2_lossy(img, quality=60):
    ok, buf = cv2.imencode(".avif", img[..., ::-1].copy(), [cv2.IMWRITE_AVIF_QUALITY, quality])
    assert ok
    return buf.tobytes()


def pil_lossy(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "AVIF", **kw)
    return buf.getvalue()


def colr(matrix, full):
    return struct.pack(">I4s4sHHHB", 19, b"colr", b"nclx", 1, 13, matrix, 0x80 if full else 0)


def renclx(data, matrix, full):
    data = bytearray(data)
    k = data.find(b"colrnclx") + 8
    struct.pack_into(">H", data, k + 4, matrix)
    data[k + 6] = 0x80 if full else 0
    return bytes(data)


def tiles(kind, n, h, w, **kw):
    make = {"lossless": lambda k: pil_avif(picture("gradient", h, w, k), **kw),
            "lossy": lambda k: cv2_lossy(picture("gradient", h, w, k)),
            "pillow": lambda k: pil_lossy(picture("gradient", h, w, k), **kw)}[kind]
    return [make(k) for k in range(n)]


GRIDS = {
    "2x3 one tile repeated": lambda: avif_grid(cv2_avif(picture("flat", 64, 64)), 2, 3),
    "2x3 lossless 4:2:0": lambda: avif_grid(tiles("lossless", 6, 64, 64), 2, 3),
    "1x4": lambda: avif_grid(tiles("lossless", 4, 64, 64), 1, 4),
    "4x1": lambda: avif_grid(tiles("lossless", 4, 64, 64), 4, 1),
    "3x3 lossy": lambda: avif_grid(tiles("lossy", 9, 66, 70), 3, 3),
    "2x3 lossy, cropped": lambda: avif_grid(tiles("lossy", 6, 80, 96), 2, 3, size=(250, 130)),
    "4:4:4, cropped odd": lambda: avif_grid(tiles("lossless", 6, 64, 66, subsampling="4:4:4"),
                                            2, 3, size=(191, 101)),
    "4:4:4 odd tiles": lambda: avif_grid(tiles("pillow", 6, 65, 65, subsampling="4:4:4",
                                               quality=70), 2, 3),
    "grey, cropped odd": lambda: avif_grid(tiles("lossless", 6, 64, 64, subsampling="4:0:0"),
                                           2, 3, size=(131, 127)),
    "grey lossy 3x1": lambda: avif_grid(tiles("pillow", 3, 64, 80, subsampling="4:0:0",
                                              quality=40), 3, 1),
    "32-bit fields": lambda: avif_grid(tiles("lossy", 6, 80, 96), 2, 3, wide=True),
    "32-bit fields, cropped": lambda: avif_grid(tiles("lossy", 6, 80, 96), 2, 3,
                                                size=(200, 100), wide=True),
    "film grain tiles": lambda: avif_grid([film_grain_avif(k) for k in range(4)], 2, 2),
    "grain test set tiles": lambda: avif_grid(
        [pil_lossy(picture("gradient", 64, 64, k), quality=50,
                   advanced={"film-grain-test": str(k + 1)}) for k in range(6)], 3, 2),
    "grid colr, limited BT.709": lambda: avif_grid(tiles("lossy", 6, 80, 96), 2, 3,
                                                   grid_colr=colr(1, False)),
    "no grid colr": lambda: avif_grid(tiles("lossy", 6, 80, 96), 2, 3, grid_colr=b""),
    "tiles' colr not read": lambda: avif_grid(
        [renclx(t, 1, False) for t in tiles("lossy", 6, 80, 96)], 2, 3, grid_colr=b""),
    "grid colr over tiles' colr": lambda: avif_grid(
        [renclx(t, 1, False) for t in tiles("lossy", 6, 80, 96)], 2, 3, grid_colr=colr(9, True)),
    "alpha grid": lambda: avif_grid(tiles("lossy", 6, 80, 96), 2, 3, alpha=tiles(
        "pillow", 6, 80, 96, subsampling="4:0:0", quality=100)),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grids_read_exactly(tmp_path, name):
    data = GRIDS[name]()
    assert avif._primary(avif._Avif(data)).type == b"grid"
    check(tmp_path, data)


def test_grid_canvas_is_its_tiles_decoded(tmp_path):
    """Each tile's planes sit at its place in the canvas (the RGB differs
    at the seams, where chroma is upsampled across tiles)."""
    parts = tiles("lossy", 6, 80, 96)
    planes = avif.read_avif(avif_grid(parts, 2, 3))[0]
    for k, part in enumerate(parts):
        y, x = divmod(k, 3)
        own = avif.read_avif(part)[0]
        for p, a in enumerate(own):
            h, w = a.shape
            np.testing.assert_array_equal(planes[p][y * h : (y + 1) * h, x * w : (x + 1) * w], a)


REFUSED = {
    "5 tiles for 2x3": lambda t: avif_grid(t[:5], 2, 3),
    "7 tiles for 2x3": lambda t: avif_grid(t + t[:1], 2, 3),
    "tiles of two sizes": lambda t: avif_grid(t[:5] + [cv2_lossy(picture("gradient", 80, 98))],
                                              2, 3),
    "tiles of two depths": lambda t: avif_grid(t[:5] + [cv2_avif(
        picture("gradient", 80, 96).astype(np.uint16) * 4, 10)], 2, 3),
    "4:4:4 among 4:2:0": lambda t: avif_grid(t[:5] + [pil_lossy(
        picture("gradient", 80, 96), subsampling="4:4:4", quality=60)], 2, 3),
    "limited among full range": lambda t: avif_grid(t[:5] + [pil_lossy(
        picture("gradient", 80, 96), quality=60, range="limited")], 2, 3),
    "output not covered": lambda t: avif_grid(t, 2, 3, size=(290, 160)),
    "a row outside": lambda t: avif_grid(t, 2, 3, size=(288, 80)),
    "a column outside": lambda t: avif_grid(t, 2, 3, size=(192, 160)),
    "odd width at 4:2:0": lambda t: avif_grid(t, 2, 3, size=(251, 130)),
    "odd tiles at 4:2:0": lambda t: avif_grid(tiles("lossless", 6, 65, 64), 2, 3,
                                              size=(192, 129)),
    "tiles below 64": lambda t: avif_grid(tiles("lossy", 6, 32, 48), 2, 3),
    "grid version 1": lambda t: avif_grid(t, 2, 3, grid_data=bytes([1, 0, 1, 2])
                                          + struct.pack(">HH", 288, 160)),
    "grid box a byte long": lambda t: avif_grid(t, 2, 3, grid_data=bytes([0, 0, 1, 2])
                                                + struct.pack(">HH", 288, 160) + b"\0"),
    "grid box cut short": lambda t: avif_grid(t, 2, 3, grid_data=bytes([0, 0, 1, 2])
                                              + struct.pack(">H", 288)),
    "zero output width": lambda t: avif_grid(t, 2, 3, size=(0, 160)),
    "grid without ispe": lambda t: avif_grid(t, 2, 3).replace(
        b"ispe\0\0\0\0\0\0\x01\x20", b"zzzz\0\0\0\0\0\0\x01\x20"),
    "ispe of another size": lambda t: avif_grid(t, 2, 3).replace(
        b"ispe\0\0\0\0\0\0\x01\x20", b"ispe\0\0\0\0\0\0\x01\x10"),
    "unknown essential property": lambda t: avif_grid(
        t, 2, 3, grid_colr=struct.pack(">I4sI", 12, b"zzzz", 0)),
    "a dimg to no item": lambda t: _dimg_to(avif_grid(t, 2, 3), 99),
    "alpha grid not covering": lambda t: avif_grid(t, 2, 3, alpha=tiles(
        "lossless", 6, 64, 64, subsampling="4:0:0")),
    "alpha grid of 5 tiles": lambda t: avif_grid(t, 2, 3, alpha=tiles(
        "pillow", 5, 80, 96, subsampling="4:0:0", quality=100)),
}


def _dimg_to(data, item_id):
    data = bytearray(data)
    k = data.find(b"dimg") + 8
    struct.pack_into(">H", data, k, item_id)
    return bytes(data)


@pytest.fixture(scope="module")
def lossy_tiles():
    return tiles("lossy", 6, 80, 96)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_grids_read_as_none(tmp_path, lossy_tiles, name):
    path = tmp_path / "x.avif"
    path.write_bytes(REFUSED[name](lossy_tiles))
    assert cv2_rgb(path) is None
    assert imread(str(path)) is None


def test_grid_writer_lays_out_items(lossy_tiles):
    """``avif_grid``: a ``grid`` item 1 in ``idat`` with its ``ImageGrid``
    body, one ``av01`` item per tile in ``mdat`` referenced by ``dimg`` in
    order, an alpha grid as an ``auxl`` item with its own tiles."""
    data = avif_grid(lossy_tiles, 2, 3, size=(250, 130), wide=True, alpha=lossy_tiles)
    f = avif._Avif(data)
    grid = f.items[f.primary]
    assert grid.type == b"grid" and f.payload(grid) == bytes([0, 1, 1, 2]) + struct.pack(
        ">II", 250, 130)
    assert [f.items[i].type for i in grid.refs[b"dimg"]] == [b"av01"] * 6
    boxes = avif_boxes(lossy_tiles[4])
    assert f.payload(f.items[grid.refs[b"dimg"][4]]) == \
        lossy_tiles[4][boxes[b"mdat"][0] + 8 : boxes[b"mdat"][1]]
    alpha = avif._alpha_item(f, grid)
    assert alpha.type == b"grid" and len(alpha.refs[b"dimg"]) == 6
    assert avif_grid(lossy_tiles[0], 1, 2).count(b"infe") == 3
