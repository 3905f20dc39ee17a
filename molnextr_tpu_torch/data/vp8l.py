"""The WebP lossless (VP8L) decoder in Python and numpy, exact against
libwebp (``src/dec/vp8l_dec.c``, ``src/dsp/lossless.c``).

:func:`decode_vp8l` decodes a ``VP8L`` chunk's bitstream (the 0x2f
signature, 14-bit width and height, the alpha hint, the version) to ARGB
``uint32`` ``(H, W)``; :func:`decode_alpha_stream` decodes the headerless
image stream of an ``ALPH`` chunk to the green channel, its alpha plane.

* **Bits.** LSB first.  The stream ends, as in libwebp's ``VP8LBitReader``,
  once more bits have been read than it holds (at least 64: a stream of
  fewer than 8 bytes reads as zeros up to 64 bits).  Reading past the end
  fails the image; the one exception is an ``ALPH`` stream that libwebp
  decodes a byte per pixel (colour indexing alone, no colour cache, single
  red, blue and alpha symbols), which may end inside its last symbol.
* **Prefix codes.** Simple codes of one or two symbols (a symbol past the
  alphabet is dropped); normal codes from the code-length code in the order
  17, 18, 0, 1, 2, 3, 4, 5, 16, 6, ..., 15, with an optional ``max_symbol``
  and repeat codes 16 (the last non-zero length, 8 at first), 17 and 18.
  A code must be complete, or hold one symbol, which then takes no bits.
  Each group holds five: green with the length prefixes and the cache,
  red, blue, alpha, distance.
* **Meta prefix codes.** An entropy image, ``prefix_bits`` 2-9, whose red
  and green bytes index the group of each tile; every group up to the
  largest index is read and must be valid.
* **Colour cache.** 1-11 bits, key ``(0x1e35a7bd * argb) >> (32 - bits)``,
  every decoded pixel inserted in order, copied ones too.
* **LZ77.** Length and distance prefixes with extra bits; distance codes
  up to 120 go through the (dx, dy) plane map, clamped to at least 1;
  copies may overlap; a copy reaching before the start or past the end is
  an error.
* **Transforms.** Read in stream order, each type at most once, undone in
  reverse: predictor (modes 0-13, 14 and 15 as 0; the top row predicts
  from the left, the left column from above; the last column's top-right
  is the row's first pixel), cross colour (signed 3.5 multipliers),
  subtract green, colour indexing (2, 4 and 16 colours bundled 8, 4 and 2
  to a pixel; an index past the palette is transparent black).  Colour
  indexing narrows the image that later transforms and the pixels see.

The entropy decoding runs in Python a symbol at a time (long copies and
their cache inserts in numpy); the predictor is undone along anti-diagonals
``x + 2y``, whose pixels depend only on earlier ones, in numpy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from molnextr_tpu_torch.data.vp8_tables import CODE_TO_PLANE

_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_ALPHABETS = (256 + 24, 256, 256, 256, 40)
_HASH = 0x1E35A7BD


class VP8LError(ValueError):
    """A VP8L bitstream that libwebp refuses."""


def _sub(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


class _Bits:
    """LSB-first reader: ``win[i]`` holds the 32 bits from byte ``i``."""

    __slots__ = ("win", "pos", "limit")

    def __init__(self, data: bytes):
        b = np.frombuffer(bytes(data) + bytes(80), np.uint8).astype(np.uint32)
        self.win = (b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16) | (b[3:] << 24)).tolist()
        self.pos = 0
        self.limit = 8 * max(len(data), 8)  # libwebp reads zeros up to 64 bits

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        return (self.win[p >> 3] >> (p & 7)) & ((1 << n) - 1)

    def check(self) -> None:
        if self.pos > self.limit:
            raise VP8LError("VP8L: data ends inside the stream")


def _build(lengths: Sequence[int], table: bool = True) -> Tuple[Optional[list], int]:
    """A lookup table for a canonical code of ``lengths`` (bit-reversed
    index to ``symbol << 4 | length``; None unless ``table``) and its index
    mask, 0 for a code of one symbol; raises unless the code is complete or
    holds one symbol."""
    count = [0] * 16
    for n in lengths:
        count[n] += 1
    used = len(lengths) - count[0]
    if used == 0:
        raise VP8LError("VP8L: a prefix code of no symbol")
    if used == 1:
        return ([next(s for s, n in enumerate(lengths) if n) << 4] if table else None), 0
    left = 1
    for n in range(1, 16):
        left = 2 * left - count[n]
        if left < 0:
            raise VP8LError("VP8L: an over-subscribed prefix code")
    if left:
        raise VP8LError("VP8L: an incomplete prefix code")
    top = max(lengths)
    if not table:
        return None, (1 << top) - 1
    out = np.zeros(1 << top, np.int32)
    code, first = 0, [0] * 17
    for n in range(1, 16):
        code = (code + count[n - 1]) << 1 if n > 1 else 0
        first[n] = code
    for sym, n in enumerate(lengths):
        if n:
            c = first[n]
            first[n] += 1
            rev = int(format(c, f"0{n}b")[::-1], 2)
            out[rev::1 << n] = (sym << 4) | n
    return out.tolist(), (1 << top) - 1


def _read_code(br: _Bits, size: int, table: bool = True):
    """One prefix code of an alphabet of ``size`` (``ReadHuffmanCode``)."""
    lengths = [0] * size
    if br.read(1):  # simple: one or two symbols of length 1
        two = br.read(1)
        sym = br.read(8 if br.read(1) else 1)
        if sym < size:
            lengths[sym] = 1
        if two:
            sym = br.read(8)
            if sym < size:
                lengths[sym] = 1
    else:
        cl = [0] * 19
        for i in range(br.read(4) + 4):
            cl[_LENGTH_ORDER[i]] = br.read(3)
        ltab, lmask = _build(cl)
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > size:
                raise VP8LError("VP8L: max_symbol past the alphabet")
        else:
            max_symbol = size
        sym, prev = 0, 8
        win = br.win
        while sym < size and max_symbol > 0:
            max_symbol -= 1
            p = br.pos
            v = ltab[(win[p >> 3] >> (p & 7)) & lmask]
            br.pos = p + (v & 15)
            c = v >> 4
            if c < 16:
                lengths[sym] = c
                sym += 1
                if c:
                    prev = c
            else:
                extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
                rep = br.read(extra) + offset
                if sym + rep > size:
                    raise VP8LError("VP8L: code lengths past the alphabet")
                lengths[sym : sym + rep] = [prev if c == 16 else 0] * rep
                sym += rep
    br.check()
    return _build(lengths, table)


def _read_groups(br: _Bits, xsize: int, ysize: int, cache_bits: int, meta: bool):
    """The prefix-code groups (``ReadHuffmanCodes``): a list of five
    (table, mask) pairs per group (no tables for a group the image does not
    use), the tile bits and the group image."""
    bits, image, count = 0, None, 1
    if meta and br.read(1):
        bits = br.read(3) + 2
        image = (_image_stream(br, _sub(xsize, bits), _sub(ysize, bits)) >> 8) & 0xFFFF
        count = int(image.max()) + 1
        used = np.zeros(count, bool)
        used[image] = True
    br.check()
    sizes = list(_ALPHABETS)
    sizes[0] += (1 << cache_bits) if cache_bits else 0
    groups: List[list] = []
    for g in range(count):
        keep = image is None or bool(used[g])
        groups.append([_read_code(br, n, keep) for n in sizes])
    return groups, bits, image


def _image_stream(br: _Bits, xsize: int, ysize: int) -> np.ndarray:
    """A sub-image (entropy, transform or palette image): ARGB (ysize, xsize)."""
    cache_bits = _cache_bits(br)
    groups, bits, image = _read_groups(br, xsize, ysize, cache_bits, False)
    return _pixels(br, xsize, ysize, cache_bits, groups, bits, image)


def _cache_bits(br: _Bits) -> int:
    if br.read(1):
        bits = br.read(4)
        if not 1 <= bits <= 11:
            raise VP8LError("VP8L: colour cache bits")
        return bits
    return 0


def _insert(cache: list, seg: list, shift: int) -> None:
    """Insert ``seg``'s pixels into the colour cache in order."""
    if len(seg) <= 32:
        for c in seg:
            cache[((c * _HASH) & 0xFFFFFFFF) >> shift] = c
        return
    a = np.asarray(seg, np.uint64)[::-1]
    keys = ((a * _HASH) & 0xFFFFFFFF) >> shift
    uk, first = np.unique(keys, return_index=True)  # last occurrence in order
    for k, c in zip(uk.tolist(), a[first].tolist()):
        cache[k] = c


def _pixels(br: _Bits, width: int, height: int, cache_bits: int, groups: list, bits: int,
            image: Optional[np.ndarray], eos_at_end_ok: bool = False) -> np.ndarray:
    """The entropy-coded pixels (``DecodeImageData``): ARGB (height, width)."""
    total = width * height
    out = [0] * total
    win, pos, limit = br.win, br.pos, br.limit
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    tiles = image.reshape(-1).tolist() if image is not None else None
    hx = _sub(width, bits) if bits else 0
    tmask = (1 << bits) - 1 if bits else 0
    p = x = y = 0
    gt = gm = rt = rm = bt = bm = at = am = dt = dm = None
    group = -1
    while p < total:
        g = tiles[(y >> bits) * hx + (x >> bits)] if tiles is not None else 0
        if g != group:
            group = g
            (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = groups[g]
        run_end = p + min(tmask + 1 - (x & tmask), width - x) if tiles is not None else total
        while p < run_end:  # pixels of one tile row: one group
            v = gt[(win[pos >> 3] >> (pos & 7)) & gm]
            pos += v & 15
            code = v >> 4
            if code < 256:
                v = rt[(win[pos >> 3] >> (pos & 7)) & rm]
                pos += v & 15
                red = v >> 4
                v = bt[(win[pos >> 3] >> (pos & 7)) & bm]
                pos += v & 15
                blue = v >> 4
                v = at[(win[pos >> 3] >> (pos & 7)) & am]
                pos += v & 15
                if pos > limit and not eos_at_end_ok:
                    break
                argb = ((v >> 4) << 24) | (red << 16) | (code << 8) | blue
                out[p] = argb
                if cache is not None:
                    cache[((argb * _HASH) & 0xFFFFFFFF) >> shift] = argb
                p += 1
            elif code < 280:
                sym = code - 256
                if sym < 4:
                    length = sym + 1
                else:
                    extra = (sym - 2) >> 1
                    length = ((2 + (sym & 1)) << extra) \
                        + ((win[pos >> 3] >> (pos & 7)) & ((1 << extra) - 1)) + 1
                    pos += extra
                v = dt[(win[pos >> 3] >> (pos & 7)) & dm]
                pos += v & 15
                sym = v >> 4
                if sym < 4:
                    dcode = sym + 1
                else:
                    extra = (sym - 2) >> 1
                    dcode = ((2 + (sym & 1)) << extra) \
                        + ((win[pos >> 3] >> (pos & 7)) & ((1 << extra) - 1)) + 1
                    pos += extra
                if dcode > 120:
                    dist = dcode - 120
                else:
                    pc = CODE_TO_PLANE[dcode - 1]
                    dist = max((pc >> 4) * width + 8 - (pc & 15), 1)
                if pos > limit and not eos_at_end_ok:
                    break
                if p < dist or total - p < length:
                    raise VP8LError("VP8L: a copy outside the image")
                src = p - dist
                if dist >= length:
                    seg = out[src : src + length]
                else:
                    seg = (out[src:p] * (length // dist + 1))[:length]
                out[p : p + length] = seg
                if cache is not None:
                    _insert(cache, seg, shift)
                p += length
                break  # the tile may have changed
            else:
                if cache is None:
                    raise VP8LError("VP8L: a cache code without a cache")
                argb = cache[code - 280]
                if pos > limit:
                    break
                out[p] = argb
                cache[((argb * _HASH) & 0xFFFFFFFF) >> shift] = argb
                p += 1
            if pos > limit and eos_at_end_ok:
                break
        if pos > limit:
            if not (eos_at_end_ok and p >= total):
                raise VP8LError("VP8L: data ends inside the pixels")
            break
        y, x = divmod(p, width)
    br.pos = pos
    return np.array(out, np.uint32).reshape(height, width)


# ----- inverse transforms --------------------------------------------------

def _add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Bytewise a + b mod 256 of packed ARGB."""
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) \
        | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _avg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _bytes(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint8).reshape(-1, 4).astype(np.int16)


def _pack(c: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(c.astype(np.uint8)).view(np.uint32).reshape(-1)


def _predict(mode: int, L, T, TR, TL) -> np.ndarray:
    """libwebp's ``VP8LPredictors[mode]`` on packed ARGB arrays."""
    if mode == 0:
        return np.full(L.shape, 0xFF000000, np.uint32)
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg(_avg(L, TR), T)
    if mode == 6:
        return _avg(L, TL)
    if mode == 7:
        return _avg(L, T)
    if mode == 8:
        return _avg(TL, T)
    if mode == 9:
        return _avg(T, TR)
    if mode == 10:
        return _avg(_avg(L, TL), _avg(T, TR))
    if mode == 11:  # Select: T where the left is no nearer the gradient
        l, t, tl = _bytes(L), _bytes(T), _bytes(TL)
        score = (np.abs(l - tl) - np.abs(t - tl)).sum(1)
        return np.where(score <= 0, T, L)
    if mode == 12:
        return _pack(np.clip(_bytes(L) + _bytes(T) - _bytes(TL), 0, 255))
    # 13: ClampedAddSubtractHalf, the halving truncated toward zero
    ave = _bytes(_avg(L, T))
    d = ave - _bytes(TL)
    return _pack(np.clip(ave + ((d + (d < 0)) >> 1), 0, 255))


def _undo_predictor(res: np.ndarray, bits: int, tiles: np.ndarray) -> np.ndarray:
    h, w = res.shape
    modes = np.repeat(np.repeat((tiles >> 8) & 15, 1 << bits, 0), 1 << bits, 1)[:h, :w]
    modes = np.where(modes >= 14, 0, modes).astype(np.int64)
    modes[0, :] = 1
    modes[1:, 0] = 2
    modes[0, 0] = 0
    yy, xx = np.indices((h, w))
    key = ((xx + 2 * yy) * 16 + modes).reshape(-1)
    order = np.argsort(key, kind="stable")
    cuts = np.flatnonzero(np.diff(key[order])) + 1
    starts = np.concatenate([[0], cuts]).tolist()
    ends = np.concatenate([cuts, [h * w]]).tolist()
    flat_res = res.reshape(-1)
    out = np.zeros(h * w, np.uint32)
    mode_of = (key[order] & 15).tolist()
    for s, e in zip(starts, ends):
        idx = order[s:e]
        mode = mode_of[s]
        if mode == 0:
            pred = _predict(0, idx, None, None, None)
        else:
            pred = _predict(mode, out[idx - 1], out[idx - w], out[idx - w + 1], out[idx - w - 1])
        out[idx] = _add(flat_res[idx], pred)
    return out.reshape(h, w)


def _undo_cross_colour(px: np.ndarray, bits: int, tiles: np.ndarray) -> np.ndarray:
    h, w = px.shape
    m = np.repeat(np.repeat(tiles, 1 << bits, 0), 1 << bits, 1)[:h, :w]
    g2r = (m & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    g2b = ((m >> 8) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    r2b = ((m >> 16) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    green = ((px >> 8) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    red = ((px >> 16) & 0xFF).astype(np.int32)
    blue = (px & 0xFF).astype(np.int32)
    red = (red + ((g2r * green) >> 5)) & 0xFF
    sred = red.astype(np.uint8).view(np.int8).astype(np.int32)
    blue = (blue + ((g2b * green) >> 5) + ((r2b * sred) >> 5)) & 0xFF
    return (px & 0xFF00FF00) | (red.astype(np.uint32) << 16) | blue.astype(np.uint32)


def _undo_subtract_green(px: np.ndarray) -> np.ndarray:
    g = (px >> 8) & 0xFF
    red = (((px >> 16) & 0xFF) + g) & 0xFF
    blue = ((px & 0xFF) + g) & 0xFF
    return (px & 0xFF00FF00) | (red << 16) | blue


def _undo_colour_indexing(px: np.ndarray, bits: int, palette: np.ndarray, width: int) -> np.ndarray:
    idx = (px >> 8) & 0xFF
    if bits:
        bpp = 8 >> bits
        x = np.arange(width)
        idx = (idx[:, x >> bits] >> ((x & ((1 << bits) - 1)) * bpp).astype(np.uint32)) \
            & ((1 << bpp) - 1)
    return palette[idx]


def _transforms(br: _Bits, xsize: int, ysize: int) -> Tuple[list, int]:
    """The transforms of a level-0 stream in stream order, and the width the
    pixels are coded at."""
    seen, out = set(), []
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise VP8LError("VP8L: a transform twice")
        seen.add(kind)
        if kind in (0, 1):  # predictor, cross colour
            bits = br.read(3) + 2
            out.append((kind, bits, xsize, _image_stream(br, _sub(xsize, bits), _sub(ysize, bits))))
        elif kind == 3:  # colour indexing
            num = br.read(8) + 1
            bits = 0 if num > 16 else 1 if num > 4 else 2 if num > 2 else 3
            raw = _image_stream(br, num, 1).reshape(-1)
            pal = np.zeros(1 << (8 >> bits), np.uint32)
            pal[:num] = raw
            for i in range(1, num):  # delta-coded bytewise
                pal[i] = _add(pal[i : i + 1], pal[i - 1 : i])[0]
            out.append((3, bits, xsize, pal))
            xsize = _sub(xsize, bits)
        else:
            out.append((2, 0, xsize, None))
    return out, xsize


def _undo(px: np.ndarray, transforms: list) -> np.ndarray:
    for kind, bits, width, data in reversed(transforms):
        if kind == 0:
            px = _undo_predictor(px, bits, data)
        elif kind == 1:
            px = _undo_cross_colour(px, bits, data)
        elif kind == 2:
            px = _undo_subtract_green(px)
        else:
            px = _undo_colour_indexing(px, bits, data, width)
    return px


def _level0(br: _Bits, width: int, height: int, alpha: bool = False) -> np.ndarray:
    transforms, coded = _transforms(br, width, height)
    cache_bits = _cache_bits(br)
    groups, bits, image = _read_groups(br, coded, height, cache_bits, True)
    # libwebp decodes an alpha plane a byte per pixel when colour indexing is
    # its only transform and it has no cache and single red, blue and alpha
    # symbols; that path lets the data end inside the last symbol
    # (over the groups it keeps: all, unless their count passes 1000 or the
    # pixels', when it keeps only those the entropy image uses)
    kept = [g for g in groups if g[0][0] is not None] \
        if len(groups) > 1000 or len(groups) > coded * height else groups
    eight_bit = alpha and len(transforms) == 1 and transforms[0][0] == 3 and not cache_bits \
        and all(t[1] == 0 for g in kept for t in g[1:4])
    px = _pixels(br, coded, height, cache_bits, groups, bits, image, eos_at_end_ok=eight_bit)
    return _undo(px, transforms)


def vp8l_info(data: bytes) -> Tuple[int, int, bool]:
    """(width, height, alpha hint) of a VP8L bitstream; raises on a bad
    signature or version (``VP8LGetInfo``)."""
    if len(data) < 5 or data[0] != 0x2F or data[4] >> 5:
        raise VP8LError("VP8L: bad signature or version")
    bits = int.from_bytes(data[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)


def decode_vp8l(data: bytes) -> np.ndarray:
    """ARGB uint32 (H, W) of a VP8L bitstream (its signature first)."""
    width, height, _ = vp8l_info(data)
    br = _Bits(data)
    br.pos = 40
    return _level0(br, width, height)


def decode_alpha_stream(data: bytes, width: int, height: int) -> np.ndarray:
    """The alpha plane uint8 (H, W) of an ``ALPH`` chunk's lossless stream
    (headerless; alpha is the green channel), before unfiltering."""
    px = _level0(_Bits(data), width, height, alpha=True)
    return ((px >> 8) & 0xFF).astype(np.uint8)
