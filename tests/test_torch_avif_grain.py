"""AV1 film grain (``data/av1_grain.py``) against ``cv2.imread``, exactly:
libaom's sixteen test parameter sets.

Pillow's libaom writes the grain of its ``film-grain-test`` sets 1-16 into
the frame header; libavif's libaom adds it to the decoded frame
(``av1_add_film_grain``) before OpenCV converts it.  Each set is written
at 4:2:0, 4:2:2, 4:4:4 and as grey (4:0:0), at sizes below one
32 x 32 block (16 x 16), odd (71 x 89) and over three 32-row stripes
(200 x 130), from seeded gradients; every file reads with 0 pixels
differing.  ``test_torch_avif_grain_params.py`` holds the parameters no
test set reaches, 10- and 12-bit grain and ``denoise-noise-level``.
"""

import io

import pytest
from PIL import Image
from test_torch_avif import check, first_headers, picture

from molnextr_tpu_torch.data import avif

SIZES = [(16, 16), (71, 89), (200, 130)]


def grain_test_avif(test, h, w, subsampling, quality=50):
    img = picture("gradient", h, w, test)
    buf = io.BytesIO()
    options = dict(quality=quality, advanced={"film-grain-test": str(test)})
    grey = subsampling == "4:0:0"
    Image.fromarray(img[..., 1].copy() if grey else img).save(buf, "AVIF",
                                                              subsampling=subsampling, **options)
    return buf.getvalue()


def frame_grain(data):
    f = avif._Avif(data)
    return first_headers(f.payload(avif._primary(f)))[1].grain


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
@pytest.mark.parametrize("test", range(1, 17))
def test_libaom_grain_test_sets_read_exactly(tmp_path, test, subsampling):
    for h, w in SIZES:
        data = grain_test_avif(test, h, w, subsampling)
        assert frame_grain(data) is not None
        check(tmp_path, data)
