"""The port's GIF reader (``data/gif.py``) against ``cv2.imread``, exactly.

Files come from PIL (palette, grey and RGB images, interlaced, optimised,
with a transparent index, animated) and the hand encoder of
``torch_image_writers`` (an exact palette, global and local tables, frames
offset inside the logical screen, interlace, transparency, backgrounds,
GIF87a, a second frame), and from cutting and corrupting such files.
Behaviours found by test: the canvas is the background colour, which a
transparent index leaves showing; a frame outside the screen, a background
index past the global table, a file without its trailer, and LZW data that
ends early, overflows the frame or holds a byte more after the code that
follows a full frame read as None.
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_image_writers import encode_gif

from molnextr_tpu_torch.data.gif import decode_gif
from molnextr_tpu_torch.data.image import imread


def cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def check(tmp_path, data, name="x.gif"):
    """The port reads ``data`` as cv2 does (None included); returns cv2's array."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2_rgb(path)
    got = imread(str(path))
    if want is None:
        assert got is None
    else:
        assert got is not None and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(decode_gif(data), want)
    return want


@pytest.mark.parametrize("mode", ["P", "L", "RGB"])
def test_pil_writes(tmp_path, mode):
    rng = np.random.RandomState(len(mode))
    img = Image.fromarray(rng.randint(0, 256, (23, 31, 3)).astype(np.uint8)).convert(mode)
    for kwargs in ({}, {"interlace": True}, {"optimize": True}, {"transparency": 5}):
        buf = io.BytesIO()
        img.save(buf, "GIF", **kwargs)
        assert check(tmp_path, buf.getvalue()) is not None


def test_animated_file_reads_as_its_first_frame(tmp_path):
    rng = np.random.RandomState(0)
    frames = [Image.fromarray(rng.randint(0, 256, (20, 20, 3)).astype(np.uint8)).convert("P")
              for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=100, loop=0)
    np.testing.assert_array_equal(check(tmp_path, buf.getvalue()),
                                  np.asarray(frames[0].convert("RGB")))


@pytest.mark.parametrize("colours", [2, 3, 16, 119, 256])
@pytest.mark.parametrize("interlace", [False, True])
def test_exact_palettes(tmp_path, colours, interlace):
    rng = np.random.RandomState(colours)
    pal = rng.randint(0, 256, (colours, 3))
    for h, w in ((1, 1), (7, 9), (40, 33), (120, 150)):
        idx = rng.randint(0, colours, (h, w))
        idx[: h // 2] = idx[: h // 2] // 4 * 4 % colours  # runs, for the table
        data = encode_gif([{"indices": idx, "interlace": interlace}], w, h, pal)
        np.testing.assert_array_equal(check(tmp_path, data), pal[idx])


def test_random_frames_tables_and_transparency(tmp_path):
    rng = np.random.RandomState(1)
    read = 0
    for _ in range(200):
        W, H = rng.randint(1, 20), rng.randint(1, 20)
        ncol = int(rng.choice([2, 3, 4, 16, 100, 256]))
        pal = rng.randint(0, 256, (ncol, 3))
        w, h = rng.randint(1, W + 3), rng.randint(1, H + 3)
        frame = {"indices": rng.randint(0, ncol, (h, w)), "left": rng.randint(0, 4),
                 "top": rng.randint(0, 4), "interlace": rng.rand() < 0.3}
        if rng.rand() < 0.4:
            frame["transparent"] = int(rng.randint(0, ncol))
        gpal = pal
        if rng.rand() < 0.3:  # a local table, with or without a global one
            frame["palette"] = pal
            gpal = rng.randint(0, 256, (int(rng.choice([2, 8, 256])), 3)) if rng.rand() < 0.5 \
                else None
        frames = [frame] + ([{"indices": rng.randint(0, ncol, (H, W))}] if rng.rand() < 0.3 else [])
        data = encode_gif(frames, W, H, gpal, version=b"89a" if rng.rand() < 0.8 else b"87a",
                          background=int(rng.randint(0, 300 if rng.rand() < 0.1 else ncol)) % 256)
        read += check(tmp_path, data) is not None
    assert read > 50


def test_background_shows_around_the_frame_and_through_transparency(tmp_path):
    pal = np.array([[10, 20, 30], [40, 50, 60], [70, 80, 90], [100, 110, 120]])
    idx = np.array([[2, 3, 3, 3], [3, 2, 3, 0], [3, 2, 1, 0]])
    data = encode_gif([{"indices": idx, "left": 2, "top": 1, "transparent": 1}], 8, 6, pal,
                      background=2)
    want = np.tile(pal[2], (6, 8, 1))
    want[1:4, 2:6] = pal[idx]
    want[3, 4] = pal[2]
    np.testing.assert_array_equal(check(tmp_path, data), want)


def test_cut_and_corrupt_files(tmp_path):
    rng = np.random.RandomState(0)
    pal = rng.randint(0, 256, (16, 3))
    idx = rng.randint(0, 16, (30, 40))
    idx[10:20] = 3
    data = encode_gif([{"indices": idx}], 40, 30, pal)
    for cut in (12, 13, 20, 60, 100, len(data) // 2, len(data) - 2, len(data) - 1):
        assert check(tmp_path, data[:cut]) is None
    unread = 0
    for _ in range(300):
        bad = bytearray(data)
        bad[rng.randint(13 + 48 + 11, len(data) - 1)] = rng.randint(0, 256)
        unread += check(tmp_path, bytes(bad)) is None
    assert unread > 50


def _codes(codes, start=3, tlen=6):
    """LZW codes of a 2-bit stream packed as the decoder's widths grow."""
    acc = n = 0
    out = bytearray()
    width, prev = start, None
    for c in codes:
        acc |= c << n
        n += width
        if c == 4:
            tlen, width, prev = 6, start, None
        elif c != 5:
            tlen += prev is not None
            prev = c
            if tlen >= 1 << width and width < 12:
                width += 1
    while n > 0:
        out.append(acc & 255)
        acc >>= 8
        n -= 8
    return bytes(out)


@pytest.mark.parametrize("codes,readable", [
    ([4, 1, 2, 3, 1, 5], True), ([4, 1, 2, 3, 1], True), ([1, 2, 3, 1, 5], True),
    ([4, 1, 2, 3, 1, 2, 5], True), ([4, 1, 2, 3, 1, 6, 5], True),
    ([4, 1, 2, 3, 1, 2, 3, 5], False), ([4, 1, 2, 3, 1, 6, 7, 5], False),
    ([4, 1, 2, 3, 5], False), ([4, 1, 2, 3, 6, 5], False), ([4, 6, 2, 3, 1, 5], False),
    ([4, 1, 7, 3, 1, 5], False)])
def test_lzw_end_of_frame(tmp_path, codes, readable):
    """A 2 x 2 frame: codes past a full frame are ignored up to one more
    code and less than a byte; an end code before it is full is an error."""
    pal = np.arange(12).reshape(4, 3)
    head = encode_gif([{"indices": np.zeros((2, 2), int)}], 2, 2, pal)[:13 + 12 + 10]
    body = _codes(codes)
    data = head + bytes([2, len(body)]) + body + b"\x00\x3b"
    got = check(tmp_path, data)
    assert (got is not None) == readable
    if readable:
        np.testing.assert_array_equal(got, pal[[[1, 2], [3, 1]]])
