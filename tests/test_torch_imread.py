"""``data/image.py::imread`` against ``cv2.imread``, and the five call sites
that read image files against their JAX counterparts.

* EXIF orientations 1-8 in a PNG ``eXIf`` chunk and a JPEG APP1 segment
  (both byte orders) read as cv2 reads them; a TIFF's tag 274 too for 1-4,
  while 5-8, which OpenCV 5.0 fails to read (None), read turned as a JPEG's
  are (a difference by design, pinned here);
* BMP, GIF, PNM/PAM/PFM, HDR, Sun raster, BigTIFF, WebP (lossy and
  lossless), JPEG 2000 and AVIF (an ``ispe`` of another size than the
  frame's too) read as cv2 reads them;
  a missing, empty, unknown or corrupt file reads as None, as in cv2;
* on a directory holding a PNG, a JPEG, a TIFF, a missing path and a
  corrupt file: ``MolNexTR.predict_image_files`` and the predict CLI raise
  the JAX package's ``FileNotFoundError``; ``TrainDataset`` items equal the
  JAX package's (the white placeholder included); ``evaluate_model`` (the
  demo bundle, float32) and ``suite_dataset_eval`` skip the same rows and
  give the same scores; and so do they on an LZMA TIFF and a 12-bit JPEG,
  which OpenCV 5.0 reads as None.
"""

import io
import multiprocessing
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image
from torch_image_writers import (encode_jpeg, encode_tiff, exif_block, rescaled_avif,
                                 with_jpeg_exif, with_png_exif)

from molnextr_tpu_torch.data.exif import apply_orientation, exif_orientation
from molnextr_tpu_torch.data.image import UnsupportedFormat, imread, sniff_format

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BUNDLE = os.path.join(ROOT, "examples", "demo_model")
FIXTURES = os.path.join(ROOT, "molnextr_tpu_torch", "fixtures")
DEMO_PNG = os.path.join(FIXTURES, "demo_0.png")
TURNS = {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
         4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
         6: lambda a: np.rot90(a, -1), 7: lambda a: a[::-1, ::-1].swapaxes(0, 1),
         8: lambda a: np.rot90(a, 1)}


def cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _picture(h=4, w=6, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_apply_orientation_is_opencvs_turn(orientation):
    a = _picture()
    np.testing.assert_array_equal(apply_orientation(a, orientation), TURNS[orientation](a))


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_reads_as_cv2(tmp_path, orientation, order):
    path = tmp_path / "x.png"
    png = cv2.imencode(".png", _picture()[..., ::-1])[1].tobytes()
    path.write_bytes(with_png_exif(png, orientation, order))
    want = cv2_rgb(path)
    np.testing.assert_array_equal(imread(str(path)), want)
    np.testing.assert_array_equal(want, TURNS[orientation](_picture()))


def test_png_exif_orientation_6_turns_a_4x6_picture():
    """The fault the port had: ``read_png`` ignored ``eXIf``; cv2 reads a 4 x 6
    PNG of orientation 6 as 6 x 4."""
    import tempfile

    from molnextr_tpu_torch.data.png import read_png

    png = with_png_exif(cv2.imencode(".png", _picture())[1].tobytes(), 6)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "x.png")
        with open(path, "wb") as f:
            f.write(png)
        assert cv2.imread(path).shape == (6, 4, 3)
        assert read_png(path).shape == (6, 4, 3)
        np.testing.assert_array_equal(read_png(path), cv2_rgb(path))


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation_reads_as_cv2(tmp_path, orientation, order):
    path = tmp_path / "x.jpg"
    jpeg = cv2.imencode(".jpg", _picture(8, 16))[1].tobytes()
    path.write_bytes(with_jpeg_exif(jpeg, orientation, order))
    want = cv2_rgb(path)
    assert want.shape == ((16, 8, 3) if orientation >= 5 else (8, 16, 3))
    np.testing.assert_array_equal(imread(str(path)), want)


def _tiff(img, orientation):
    h, w = img.shape[:2]
    return encode_tiff([img.tobytes()], w, h, {258: (3, [8, 8, 8]), 259: (3, [1]),
                                                262: (3, [2]), 277: (3, [3]), 278: (4, [h]),
                                                274: (3, [orientation])})


@pytest.mark.parametrize("orientation", range(1, 5))
def test_tiff_orientation_1_to_4_reads_as_cv2(tmp_path, orientation):
    path = tmp_path / "x.tif"
    path.write_bytes(_tiff(_picture(5, 7), orientation))
    want = cv2_rgb(path)
    np.testing.assert_array_equal(want, TURNS[orientation](_picture(5, 7)))
    np.testing.assert_array_equal(imread(str(path)), want)


@pytest.mark.parametrize("orientation", range(5, 9))
def test_tiff_orientation_5_to_8_turns_where_opencv_5_fails(tmp_path, orientation):
    """By design: OpenCV 5.0 returns None for a TIFF of orientation 5-8
    (``'original_ptr == real_mat.data' must be 'true'``); the port turns it
    as the JPEG of that orientation is turned."""
    path = tmp_path / "x.tif"
    path.write_bytes(_tiff(_picture(5, 7), orientation))
    assert cv2.imread(str(path)) is None
    np.testing.assert_array_equal(imread(str(path)), TURNS[orientation](_picture(5, 7)))


def test_malformed_exif_reads_as_orientation_1():
    good = exif_block(6, "<")
    assert exif_orientation(good) == 6 and exif_orientation(exif_block(6, ">")) == 6
    for block in (b"", b"II*\x00", good[:10], good[:14], b"XX*\x00" + good[4:],
                  exif_block(0, "<"), exif_block(9, ">")):
        assert exif_orientation(block) == 1


@pytest.mark.parametrize("name,data", [
    ("JPEG 2000", b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(8)),
    ("AVIF", b"\x00\x00\x00\x1cftypavif" + bytes(8))])
def test_formats_the_port_does_not_decode_raise_naming_them(tmp_path, name, data):
    """JPEG 2000 and AVIF raised here until the port read them: now this cut
    JP2 file and this stub AVIF file read as None, as cv2 reads them, and a
    whole JP2 file to its pixels (``test_torch_jpeg2000.py`` holds the
    reader).  An AVIF whose ``ispe`` is another size than its frame, which
    raised naming the ``ispe`` size until the port rescaled it as libavif
    does, reads to cv2's array (film grain and superres, this test's forms
    before, read too; ``test_torch_avif*.py`` hold the reader,
    ``test_torch_avif_rescale.py`` the rescaling).
    The BMP, GIF, PNM, HDR, Sun raster, BigTIFF and WebP cases this test
    held before the port read them are read to cv2's arrays (the next test
    and each format's own test file)."""
    path = tmp_path / "x.img"
    path.write_bytes(data)
    assert sniff_format(data) == name
    assert cv2_rgb(path) is None and imread(str(path)) is None
    if name == "JPEG 2000":
        img = _picture(9, 11)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG2000")
        path.write_bytes(buf.getvalue())
        np.testing.assert_array_equal(cv2_rgb(path), img)
        np.testing.assert_array_equal(imread(str(path)), img)
    else:
        path = tmp_path / "rescaled.avif"
        path.write_bytes(rescaled_avif())
        assert cv2_rgb(path).shape == (32, 32, 3)
        np.testing.assert_array_equal(imread(str(path)), cv2_rgb(path))
    assert isinstance(UnsupportedFormat("x"), ValueError)


def _bigtiff(img):
    h, w = img.shape[:2]
    return encode_tiff([img.tobytes()], w, h, {258: (3, [8, 8, 8]), 259: (3, [1]),
                                                262: (3, [2]), 277: (3, [3]), 278: (4, [h])},
                       big=True)


@pytest.mark.parametrize("name,ext", [("BMP", ".bmp"), ("GIF", ".gif"), ("PNM", ".ppm"),
                                      ("PNM", ".pgm"), ("PNM", ".pbm"), ("PNM", ".pam"),
                                      ("PNM", ".pfm"), ("HDR", ".hdr"), ("Sun raster", ".ras"),
                                      ("BigTIFF", ".tif"), ("WebP", "_lossy.webp"),
                                      ("WebP", ".webp")])
def test_formats_read_through_imread_as_cv2_reads_them(tmp_path, name, ext):
    path = tmp_path / ("x" + ext)
    picture = _picture(9, 13, seed=len(ext))
    if ext.endswith(".webp"):  # lossy at quality 80, lossless at cv2's 101
        quality = 80 if ext.startswith("_lossy") else 101
        assert cv2.imwrite(str(path), picture, [cv2.IMWRITE_WEBP_QUALITY, quality])
    elif ext == ".gif":
        from PIL import Image

        Image.fromarray(picture).save(str(path), "GIF")
    elif ext == ".tif":
        path.write_bytes(_bigtiff(picture))
    else:
        img = picture.astype(np.float32) / 255 if ext in (".hdr", ".pfm") else picture
        assert cv2.imwrite(str(path), img[..., 0] if ext in (".pgm", ".pbm") else img)
    data = path.read_bytes()
    assert sniff_format(data) == name
    want = cv2_rgb(path)
    assert want is not None
    np.testing.assert_array_equal(imread(str(path)), want)


def test_unreadable_files_read_as_none_as_in_cv2(tmp_path):
    png = cv2.imencode(".png", _picture())[1].tobytes()
    cases = {"missing.png": None, "empty.png": b"", "text.png": b"not an image at all",
             "bad_zlib.png": png[:41] + b"\x00" * 20 + png[61:],
             "no_ihdr.png": png[:8] + png[33:], "short.jpg": b"\xff\xd8\xff",
             "short.tif": b"II*\x00\x08\x00\x00\x00", "short.bmp": b"BM\x00\x00",
             "short.gif": b"GIF89a\x01", "short.ppm": b"P6\n2 2\n255\n" + bytes(11),
             "short.hdr": b"#?RADIANCE\n", "short.ras": b"\x59\xa6\x6a\x95" + bytes(28),
             "short_big.tif": b"II+\x00" + bytes(12)}
    for name, data in cases.items():
        path = tmp_path / name
        if data is not None:
            path.write_bytes(data)
        assert cv2.imread(str(path)) is None, name
        assert imread(str(path)) is None, name
    assert imread(str(tmp_path)) is None  # a directory


# -- the call sites ------------------------------------------------------------------


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """A PNG, a JPEG and a TIFF of demo_0, a missing path and a corrupt file."""
    d = tmp_path_factory.mktemp("images")
    bgr = cv2.imread(DEMO_PNG)
    paths = {"png": str(d / "a.png"), "jpeg": str(d / "b.jpg"), "tiff": str(d / "c.tif"),
             "missing": str(d / "missing.png"), "corrupt": str(d / "corrupt.png")}
    cv2.imwrite(paths["png"], bgr)
    cv2.imwrite(paths["jpeg"], bgr, [cv2.IMWRITE_JPEG_QUALITY, 90])
    cv2.imwrite(paths["tiff"], bgr, [cv2.IMWRITE_TIFF_COMPRESSION, 5])
    with open(paths["png"], "rb") as f:
        png = f.read()
    with open(paths["corrupt"], "wb") as f:
        f.write(png[:60])
    return paths


class Recorder:
    """Stands in for a model: records the images it is handed."""

    def __init__(self):
        self.images = []

    def predict_images(self, images, **kwargs):
        self.images += [np.array(im) for im in images]
        return [{"predicted_smiles": "C"} for _ in images]


def test_imread_reads_the_directory_as_cv2(image_dir):
    for kind, path in image_dir.items():
        want = cv2_rgb(path)
        got = imread(path)
        if want is None:
            assert got is None and kind in ("missing", "corrupt")
        else:
            np.testing.assert_array_equal(got, want, err_msg=kind)


def test_predict_image_files_raises_where_jax_raises(image_dir):
    from molnextr_tpu.api import MolNexTR as JaxMolNexTR
    from molnextr_tpu_torch.api import MolNexTR

    good = [image_dir[k] for k in ("png", "jpeg", "tiff")]
    jax_rec, port_rec = Recorder(), Recorder()
    JaxMolNexTR.predict_image_files(jax_rec, good)
    MolNexTR.predict_image_files(port_rec, good)
    for g, w in zip(port_rec.images, jax_rec.images):
        np.testing.assert_array_equal(g, w)
    for bad in ("missing", "corrupt"):
        paths = good + [image_dir[bad]]
        with pytest.raises(FileNotFoundError) as jax_err:
            JaxMolNexTR.predict_image_files(Recorder(), paths)
        with pytest.raises(FileNotFoundError) as port_err:
            MolNexTR.predict_image_files(Recorder(), paths)
        assert str(port_err.value) == str(jax_err.value) == image_dir[bad]


def test_predict_cli_raises_where_jax_raises(image_dir, monkeypatch):
    from molnextr_tpu import predict as jax_predict
    from molnextr_tpu_torch import predict

    import molnextr_tpu.api as jax_api
    import molnextr_tpu_torch.api as port_api

    class JaxStub(Recorder):
        def __init__(self, *a, **k):
            super().__init__()

        predict_image_files = jax_api.MolNexTR.predict_image_files

    class PortStub(Recorder):
        def __init__(self, *a, **k):
            super().__init__()

        predict_image_files = port_api.MolNexTR.predict_image_files

    monkeypatch.setattr(jax_api, "MolNexTR", JaxStub)
    monkeypatch.setattr(port_api, "MolNexTR", PortStub)
    args = [image_dir["png"], image_dir["missing"], "--model_path", BUNDLE]
    with pytest.raises(FileNotFoundError, match="missing.png"):
        jax_predict.main(args)
    with pytest.raises(FileNotFoundError, match="missing.png"):
        predict.main(args + ["--device", "cpu"])


def test_dataset_items_equal_jax_with_the_white_placeholder(image_dir):
    from molnextr_tpu.config import tiny_test_config as jax_tiny
    from molnextr_tpu.data.dataset import Sample as JaxSample
    from molnextr_tpu.data.dataset import TrainDataset as JaxDataset
    from molnextr_tpu.tokenization import get_tokenizer as jax_tokenizer
    from molnextr_tpu_torch.config import tiny_test_config
    from molnextr_tpu_torch.data.dataset import Sample, TrainDataset, read_image
    from molnextr_tpu_torch.tokenization import get_tokenizer

    kinds = ("png", "jpeg", "tiff", "missing", "corrupt")
    for kind in ("missing", "corrupt"):
        np.testing.assert_array_equal(read_image(image_dir[kind]),
                                      np.full((256, 256, 3), 255, np.uint8))
    jcfg, cfg = jax_tiny(), tiny_test_config()
    jds = JaxDataset(jcfg, [JaxSample("CC(C)O", image_path=image_dir[k]) for k in kinds],
                     jax_tokenizer(jcfg.data), split="valid")
    ds = TrainDataset(cfg, [Sample("CC(C)O", image_path=image_dir[k]) for k in kinds],
                      get_tokenizer(cfg.data), split="valid")
    for i, kind in enumerate(kinds):
        want, got = jds[i], ds[i]
        assert (want is None) == (got is None), kind
        np.testing.assert_array_equal(np.asarray(got["image"]), np.asarray(want["image"]),
                                      err_msg=kind)


def test_evaluate_model_skips_the_rows_jax_skips(image_dir, tmp_path):
    """The fault the port had: a missing file was decoded as a white
    placeholder and scored; the JAX package skips the row."""
    from molnextr_tpu.checkpoint import load_model as jax_load
    from molnextr_tpu.data.dataset import Sample as JaxSample
    from molnextr_tpu.inference import InferenceEngine as JaxEngine
    from molnextr_tpu.models.model import MolNexTRModel as JaxModel
    from molnextr_tpu.tokenization import get_tokenizer as jax_tokenizer
    from molnextr_tpu.train.loop import evaluate_model as jax_evaluate
    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.checkpoint import load_model
    from molnextr_tpu_torch.data.dataset import Sample
    from molnextr_tpu_torch.train.loop import evaluate_model

    kinds = ("png", "missing", "jpeg", "corrupt", "tiff")
    jcfg, jparams = jax_load(BUNDLE)
    jcfg.train.bf16 = False
    jtok = jax_tokenizer(jcfg.data)
    jmodel = JaxModel(jcfg, {f: len(t) for f, t in jtok.items()})
    jengine = JaxEngine(jcfg, jtok, jmodel, jparams)
    jcsv = str(tmp_path / "jax.csv")
    want = jax_evaluate(jcfg, jmodel, jparams, jtok,
                        [JaxSample("CC(C)O", image_path=image_dir[k]) for k in kinds],
                        num_workers=0, engine=jengine, dump_csv=jcsv)
    cfg, params = load_model(BUNDLE)
    cfg.train.bf16 = False
    api = MolNexTR(cfg=cfg, params=params, device="cpu", num_workers=1)
    csv = str(tmp_path / "port.csv")
    got = evaluate_model(cfg, api.engine.model, api.tokenizers,
                         [Sample("CC(C)O", image_path=image_dir[k]) for k in kinds],
                         num_workers=0, engine=api.engine, dump_csv=csv)
    assert want["n"] == 3 and got == want
    with open(jcsv) as f, open(csv) as g:
        assert g.read() == f.read()


@pytest.fixture(scope="module")
def refused_dir(tmp_path_factory):
    """demo_0 as a PNG, and two files cv2 5.0 reads as None: an LZMA TIFF (a
    codec its libtiff lacks) and a 12-bit JPEG (its reader is 8-bit)."""
    d = tmp_path_factory.mktemp("refused")
    bgr = cv2.imread(DEMO_PNG)
    h, w = bgr.shape[:2]
    paths = {"png": str(d / "a.png"), "lzma": str(d / "b.tif"), "twelve": str(d / "c.jpg")}
    cv2.imwrite(paths["png"], bgr)
    with open(paths["lzma"], "wb") as f:
        f.write(encode_tiff([bytes(64)], w, h, {258: (3, [8] * 3), 259: (3, [34925]),
                                                262: (3, [2]), 277: (3, [3])}))
    with open(paths["twelve"], "wb") as f:
        f.write(encode_jpeg([bgr[..., k].astype(np.int64) * 16 for k in (2, 1, 0)], [(1, 1)] * 3,
                            precision=12))
    for kind in ("lzma", "twelve"):
        assert cv2.imread(paths[kind]) is None and imread(paths[kind]) is None
    return paths


def test_files_opencv_refuses_are_skipped_as_jax_skips_them(refused_dir, tmp_path):
    """On an LZMA TIFF and a 12-bit JPEG (None in cv2 and in the port, where
    the port used to raise): ``evaluate_model`` skips both rows as the JAX
    package does, with the same scores and CSV, ``predict_image_files``
    raises the JAX package's ``FileNotFoundError``, and the dataset gives
    its white placeholder."""
    from molnextr_tpu.api import MolNexTR as JaxMolNexTR
    from molnextr_tpu.checkpoint import load_model as jax_load
    from molnextr_tpu.data.dataset import Sample as JaxSample
    from molnextr_tpu.inference import InferenceEngine as JaxEngine
    from molnextr_tpu.models.model import MolNexTRModel as JaxModel
    from molnextr_tpu.tokenization import get_tokenizer as jax_tokenizer
    from molnextr_tpu.train.loop import evaluate_model as jax_evaluate
    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.checkpoint import load_model
    from molnextr_tpu_torch.data.dataset import Sample, read_image
    from molnextr_tpu_torch.train.loop import evaluate_model

    kinds = ("lzma", "png", "twelve")
    jcfg, jparams = jax_load(BUNDLE)
    jcfg.train.bf16 = False
    jtok = jax_tokenizer(jcfg.data)
    jmodel = JaxModel(jcfg, {f: len(t) for f, t in jtok.items()})
    jcsv = str(tmp_path / "jax.csv")
    want = jax_evaluate(jcfg, jmodel, jparams, jtok,
                        [JaxSample("CC(C)O", image_path=refused_dir[k]) for k in kinds],
                        num_workers=0, engine=JaxEngine(jcfg, jtok, jmodel, jparams),
                        dump_csv=jcsv)
    cfg, params = load_model(BUNDLE)
    cfg.train.bf16 = False
    api = MolNexTR(cfg=cfg, params=params, device="cpu", num_workers=1)
    csv = str(tmp_path / "port.csv")
    got = evaluate_model(cfg, api.engine.model, api.tokenizers,
                         [Sample("CC(C)O", image_path=refused_dir[k]) for k in kinds],
                         num_workers=0, engine=api.engine, dump_csv=csv)
    assert want["n"] == 1 and got == want
    with open(jcsv) as f, open(csv) as g:
        assert g.read() == f.read()
    for kind in ("lzma", "twelve"):
        paths = [refused_dir["png"], refused_dir[kind]]
        with pytest.raises(FileNotFoundError) as jax_err:
            JaxMolNexTR.predict_image_files(Recorder(), paths)
        with pytest.raises(FileNotFoundError) as port_err:
            MolNexTR.predict_image_files(Recorder(), paths)
        assert str(port_err.value) == str(jax_err.value) == refused_dir[kind]
        np.testing.assert_array_equal(read_image(refused_dir[kind]),
                                      np.full((256, 256, 3), 255, np.uint8))


def test_dataset_eval_suite_skips_the_rows_jax_skips(image_dir, tmp_path, monkeypatch):
    from molnextr_tpu import benchmarks as jb
    from molnextr_tpu_torch import benchmarks as pb

    class SerialPool:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def map(self, fn, items, chunksize=None):
            return [fn(x) for x in items]

    monkeypatch.setattr(multiprocessing, "Pool", SerialPool)
    csv = tmp_path / "set.csv"
    csv.write_text("file_path,SMILES\n" + "".join(
        f"{image_dir[k]},{smi}\n" for k, smi in
        (("png", "CCO"), ("missing", "CCN"), ("jpeg", "CC(C)O"), ("corrupt", "CCCl"),
         ("tiff", "c1ccccc1"))))
    jrec, prec = Recorder(), Recorder()
    want = jb.suite_dataset_eval(jrec, str(csv))
    got = pb.suite_dataset_eval(prec, str(csv))
    assert got == want and got["n"] == 3
    for g, w in zip(prec.images, jrec.images):
        np.testing.assert_array_equal(g, w)


def test_rescaled_rlew_and_part2_demo_forms_predict_as_the_jax_package():
    """The demo forms of the AVIF frames libavif rescales, the RLE/W strips
    at odd offsets and the Part 2 JP2, through ``predict_image_files`` in
    the JAX package (``cv2.imread``) and in the port (float32, the CPU)."""
    from molnextr_tpu.api import MolNexTR as JaxMolNexTR

    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.chem import canonicalize_smiles

    names = ("demo_0_rescaled_down.avif", "demo_0_rescaled_up.avif", "demo_0_rlew.tif",
             "demo_0_part2.jp2")
    paths = [os.path.join(FIXTURES, "forms", n) for n in names]
    jax = JaxMolNexTR(model_path=BUNDLE).predict_image_files(paths)
    port = MolNexTR(model_path=BUNDLE, device="cpu", num_workers=1).predict_image_files(paths)
    got = [canonicalize_smiles(p["predicted_smiles"])[0] for p in port]
    want = [canonicalize_smiles(p["predicted_smiles"])[0] for p in jax]
    assert got == want == [canonicalize_smiles("CC(C)O")[0]] * len(paths)


def test_htj2k_demo_forms_predict_as_the_jax_package():
    """The HTJ2K demo forms (5/3 cleanup passes as a codestream and as JPH,
    9/7 with refinement passes), through ``predict_image_files`` in the
    JAX package (``cv2.imread``) and in the port (float32, the CPU)."""
    from molnextr_tpu.api import MolNexTR as JaxMolNexTR

    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.chem import canonicalize_smiles

    names = ("demo_0_htj2k.j2k", "demo_0_htj2k.jph", "demo_0_htj2k_refine.j2k")
    paths = [os.path.join(FIXTURES, "forms", n) for n in names]
    jax = JaxMolNexTR(model_path=BUNDLE).predict_image_files(paths)
    port = MolNexTR(model_path=BUNDLE, device="cpu", num_workers=1).predict_image_files(paths)
    got = [canonicalize_smiles(p["predicted_smiles"])[0] for p in port]
    want = [canonicalize_smiles(p["predicted_smiles"])[0] for p in jax]
    assert got == want == [canonicalize_smiles("CC(C)O")[0]] * len(paths)


def test_image_call_sites_import_no_format_reader_but_imread():
    """Every call site reads through ``imread`` (no PNG-only read is left)."""
    import ast

    for rel in ("api.py", "benchmarks.py", "data/dataset.py", "train/loop.py"):
        with open(os.path.join(ROOT, "molnextr_tpu_torch", rel)) as f:
            tree = ast.parse(f.read())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
                 for a in n.names}
        assert "read_png" not in names and "imread" in names, rel
