"""The port's host-side readers against the JAX package and OpenCV: the
msgpack bundle reader, the seeded parameter tree, the inference transforms
and the PNG reader.  Everything here is exact unless a test says otherwise.
"""

import os
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from molnextr_tpu.checkpoint import load_model as jax_load_model
from molnextr_tpu.config import Config as JConfig
from molnextr_tpu.config import tiny_test_config as jax_tiny_config
from molnextr_tpu.data import transforms as jtr
from molnextr_tpu.models.model import MolNexTRModel as JModel
from molnextr_tpu_torch import checkpoint as tck
from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.data import transforms as ttr
from molnextr_tpu_torch.data.png import read_png
from molnextr_tpu_torch.tokenization import get_tokenizer
from molnextr_tpu_torch.weights import seeded_flax_params

torch.set_num_threads(2)

BUNDLE = os.path.join(os.path.dirname(__file__), "..", "examples", "demo_model")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# msgpack bundle reader
# ---------------------------------------------------------------------------


def test_msgpack_reader_matches_flax_on_demo_bundle():
    with open(os.path.join(BUNDLE, "params.msgpack"), "rb") as f:
        data = f.read()
    want = dict(_leaves(serialization.msgpack_restore(data)))
    got = dict(_leaves(tck.msgpack_restore(data)))
    assert set(got) == set(want) and len(want) > 50
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_load_model_matches_jax():
    jcfg, jparams = jax_load_model(BUNDLE)
    cfg, params = tck.load_model(BUNDLE)
    assert cfg.to_dict() == jcfg.to_dict()
    assert cfg.decoder.kv_int8 and cfg.decode.unroll == 4  # decode knobs reset on load
    want = dict(_leaves(jparams))
    got = dict(_leaves(params))
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].dtype == np.float32, path  # f16 storage promoted
        np.testing.assert_array_equal(got[path], np.asarray(w), err_msg=path)


def test_msgpack_reader_types_and_chunks(monkeypatch):
    """Every type flax writes: scalars, bf16 and int arrays, numpy scalars,
    str/bytes/bool/None/float leaves, and chunked arrays."""
    tree = {
        "a": np.arange(12, dtype=np.int32).reshape(3, 4),
        "b": {"c": np.float32(2.5), "d": np.asarray(jnp.arange(5, dtype=jnp.bfloat16))},
        "e": np.linspace(-1, 1, 7).astype(np.float16),
        "f": 3, "g": -200000, "h": 1.5, "i": "text", "j": True, "k": None,
        "l": np.zeros((0, 3), np.float32), "m": np.int64(-7),
    }
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    tree["big"] = np.arange(40, dtype=np.float32).reshape(5, 8)
    data = serialization.to_bytes(tree)
    want = serialization.msgpack_restore(data)
    got = tck.msgpack_restore(data)
    assert set(got) == set(want)
    for key in tree:
        w, g = want[key], got[key]
        if key == "b":
            assert float(g["c"]) == float(w["c"]) and np.asarray(g["c"]).dtype == np.float32
            np.testing.assert_array_equal(g["d"], np.asarray(w["d"], np.float32))
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w and type(g) is type(w), key
    with pytest.raises(ValueError):
        tck.msgpack_restore(data[:-3])


# ---------------------------------------------------------------------------
# seeded parameter tree
# ---------------------------------------------------------------------------


def _demo_jcfg():
    with open(os.path.join(BUNDLE, "config.json")) as f:
        return JConfig.from_json(f.read())


@pytest.mark.parametrize("which", ["tiny", "demo", "full"])
def test_seeded_params_match_flax_init_shapes(which):
    jcfg = {"tiny": jax_tiny_config, "demo": _demo_jcfg, "full": JConfig}[which]()
    cfg = Config.from_dict(jcfg.to_dict())
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    model = JModel(jcfg, vocab, dtype=jnp.float32)
    s, k = jcfg.data.input_size, jcfg.data.max_atoms
    fmt = next(f for f in jcfg.data.formats if f != "edges")
    refs = {fmt: jax.ShapeDtypeStruct((1, 8), jnp.int32),
            "atom_indices": jax.ShapeDtypeStruct((1, k), jnp.int32),
            "edges": jax.ShapeDtypeStruct((1, k, k), jnp.int32)}
    shapes = jax.eval_shape(
        lambda r, x, refs: model.init(r, x, refs, deterministic=True),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jax.ShapeDtypeStruct((1, s, s, 3), jnp.float32), refs,
    )
    want = {p: (tuple(v.shape), v.dtype) for p, v in _leaves(shapes)}
    got = {p: (v.shape, v.dtype) for p, v in _leaves(seeded_flax_params(cfg, vocab, 0))}
    assert got == want


def test_seeded_params_values():
    cfg = Config.from_dict(jax_tiny_config().to_dict())
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    a = dict(_leaves(seeded_flax_params(cfg, vocab, 3)))
    b = dict(_leaves(seeded_flax_params(cfg, vocab, 3)))
    c = dict(_leaves(seeded_flax_params(cfg, vocab, 4)))
    for path, v in a.items():
        np.testing.assert_array_equal(v, b[path])
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "scale":
            assert (v == 1).all()
        elif leaf == "bias":
            assert (v == 0).all()
        else:
            assert abs(float(v.std()) - 0.02) < 0.01 and not np.array_equal(v, c[path]), path


# ---------------------------------------------------------------------------
# inference transforms and the PNG reader
# ---------------------------------------------------------------------------


def _image(seed, h, w, white_border=True):
    rng = np.random.RandomState(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    y0, x0 = (h // 5, w // 7) if white_border else (0, 0)
    patch = rng.randint(0, 256, (h - 2 * y0, w - 2 * x0, 3)).astype(np.uint8)
    img[y0 : h - y0, x0 : w - x0] = patch
    return img


def test_to_gray_exact():
    img = _image(0, 37, 53, white_border=False)
    want = jtr.Compose([jtr.ToGray(p=1.0)])(img)["image"]
    np.testing.assert_array_equal(ttr.to_gray(img), want)


@pytest.mark.parametrize("pad", [0, 50])
def test_crop_white_exact(pad):
    img = _image(1, 90, 70)
    want = jtr.Compose([jtr.CropWhite(pad=pad)])(img)["image"]
    np.testing.assert_array_equal(ttr.crop_white(img, pad=pad), want)
    blank = np.full((20, 30, 3), 255, np.uint8)
    np.testing.assert_array_equal(ttr.crop_white(blank, pad=pad),
                                  jtr.Compose([jtr.CropWhite(pad=pad)])(blank)["image"])


@pytest.mark.parametrize("src,dst", [((37, 53), (128, 128)), ((500, 310), (384, 384)),
                                     ((384, 384), (128, 128)), ((200, 90), (200, 45))])
def test_resize_within_one_grey_level(src, dst):
    img = _image(2, *src, white_border=False)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    got = ttr.resize_linear(img, *dst)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() > 0.99


def test_inference_transform_matches_jax():
    """CropWhite -> Resize -> ToGray, as MolNexTR.predict_images runs it."""
    jt = jtr.get_transforms(128, augment=False, rotate=False, normalize=False)
    tt = ttr.get_transforms(128, augment=False, rotate=False, normalize=False)
    for seed in range(3):
        img = _image(10 + seed, 150 + 17 * seed, 210 - 23 * seed)
        want = jt(image=img)["image"]
        got = tt(image=img)["image"]
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_device_normalize_matches_jax():
    imgs = np.random.RandomState(3).randint(0, 256, (2, 8, 8, 1)).astype(np.uint8)
    want = np.asarray(jtr.device_normalize(jnp.asarray(imgs)))
    got = ttr.device_normalize(torch.from_numpy(imgs)).numpy()
    assert got.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader_matches_cv2(tmp_path, channels):
    """cv2 picks a PNG filter per row, so a noisy image with smooth rows
    exercises several of the five filter types."""
    rng = np.random.RandomState(channels)
    h, w = 41, 67
    ramp = (np.arange(w)[None, :, None] * 3 + np.arange(h)[:, None, None] * 5) % 256
    img = (ramp + rng.randint(0, 4, (h, w, channels))).astype(np.uint8)
    img[::7] = rng.randint(0, 256, (len(img[::7]), w, channels))
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img if channels > 1 else img[..., 0])
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(read_png(path), want)


def _png_chunk(kind, body):
    import struct

    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def test_png_reader_all_filters_and_grey_alpha(tmp_path):
    """Hand-built grey+alpha PNG whose rows use each filter type 0-4."""
    import struct

    rng = np.random.RandomState(9)
    h, w, ch = 5, 9, 2
    pix = rng.randint(0, 256, (h, w, ch)).astype(np.int64)
    raw = bytearray()
    prior = np.zeros(w * ch, np.int64)
    for y in range(h):
        cur = pix[y].reshape(-1)
        ftype = y % 5
        out = []
        for x in range(w * ch):
            a = cur[x - ch] if x >= ch else 0
            b = prior[x]
            c = prior[x - ch] if x >= ch else 0
            pred = [0, a, b, (a + b) // 2][ftype] if ftype < 4 else None
            if ftype == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out.append((cur[x] - pred) & 0xFF)
        raw += bytes([ftype]) + bytes(out)
        prior = cur
    data = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 4, 0, 0, 0))
    data += _png_chunk(b"IDAT", zlib.compress(bytes(raw))) + _png_chunk(b"IEND", b"")
    path = tmp_path / "ga.png"
    path.write_bytes(data)
    want = np.repeat(pix[..., :1], 3, axis=2).astype(np.uint8)
    np.testing.assert_array_equal(read_png(str(path)), want)
    np.testing.assert_array_equal(read_png(str(path)), cv2.cvtColor(cv2.imread(str(path)),
                                                                     cv2.COLOR_BGR2RGB))


def test_png_reader_rejects_other_formats(tmp_path):
    import struct

    jpg = tmp_path / "x.jpg"
    cv2.imwrite(str(jpg), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="not a PNG file \\(JPEG\\)"):
        read_png(str(jpg))
    # 16-bit and palette PNG are read (tests/test_torch_png.py); a palette
    # image without PLTE, or a bit depth its colour type forbids, is refused
    p16 = tmp_path / "x16.png"
    cv2.imwrite(str(p16), np.zeros((4, 4), np.uint16))
    np.testing.assert_array_equal(read_png(str(p16)), np.zeros((4, 4, 3), np.uint8))
    pal = tmp_path / "pal.png"
    body = struct.pack(">IIBBBBB", 2, 2, 8, 3, 0, 0, 0)
    pal.write_bytes(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", body) + _png_chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="without PLTE"):
        read_png(str(pal))
    body = struct.pack(">IIBBBBB", 2, 2, 16, 3, 0, 0, 0)
    pal.write_bytes(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", body) + _png_chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="unsupported PNG"):
        read_png(str(pal))
