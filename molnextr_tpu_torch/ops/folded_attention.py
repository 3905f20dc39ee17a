"""K5 and K6: decode attention over a head-folded stacked KV cache
(wrappers and the plain version).

The cache is ``(L, B, T, D)`` with ``D = H * hd``, head ``h`` owning
channels ``[h * hd, (h + 1) * hd)`` of a row; q is ``(B, D)`` and the result
``(B, D)``, every head's context concatenated in head order.  Ports of
``molnextr_tpu/ops/folded_attention.py``:

* :func:`folded_decode_attention` — K5 (``folded_decode_attention``);
* :func:`folded_decode_attention_bb` — K6 (``folded_decode_attention_bb``):
  the TPU kernel's ``bb`` batch rows per program.  On the card the rows of
  a ``bb`` group run side by side, so K6 launches K5's grid for every
  ``bb``; ``bb`` is held to the TPU kernel's contract only;
* :func:`folded_decode_attention_reference` — the plain version, the math
  of the JAX package's reference: float32 throughout, one rounding of the
  output to q's dtype;
* :func:`cached_folded_attention` — the JAX package's dispatcher: K5 for
  every CUDA tensor, the plain version for a CPU one.

The kernel-named functions hold their inputs to the TPU kernels' contract
(T a multiple of 128, ``B % bb == 0``) and to what the kernel takes (q and
cache in one dtype, float32 or bfloat16; hd of 32, 64 or 128) on either
device, then dispatch on the device: a CUDA tensor launches
``csrc/folded_attention.cu`` (positions split over a thread-block cluster
by ``_launch.split_plan``), a CPU tensor runs the plain version.
"""

from __future__ import annotations

import torch

from molnextr_tpu_torch.ops._build import check, load_library
from molnextr_tpu_torch.ops._launch import LAUNCHES, dtype_code, require_cuda, split_plan
from molnextr_tpu_torch.ops.decode_attention import CHUNK, _softmax_prefix

HEAD_DIMS = (32, 64, 128)  # a head spans a power of two of a warp's 16-byte lanes
MAX_ROW_BYTES = 128 * 16  # four 16-byte vectors per lane of a warp
CHUNK_BYTES = 32 * 1024  # K (and V) bytes a CTA stages at once


def folded_decode_attention_reference(q, k_full, v_full, pos: int, layer: int, n_heads: int):
    """q (B, D); k_full/v_full (L, B, T, D); attends to t <= pos."""
    k, v = k_full[layer], v_full[layer]
    b, t, d_model = k.shape
    hd = d_model // n_heads
    qh = q.reshape(b, n_heads, hd).float()
    kh = k.reshape(b, t, n_heads, hd).float()
    vh = v.reshape(b, t, n_heads, hd).float()
    s = torch.einsum("bhd,bthd->bht", qh, kh) / (hd ** 0.5)
    p = _softmax_prefix(s, pos)
    ctx = torch.einsum("bht,bthd->bhd", p, vh)
    return ctx.reshape(b, d_model).to(q.dtype)


def _check(name, q, k_full, v_full, pos: int, layer: int, n_heads: int, bb: int, whole_chunks: bool):
    if k_full.dtype != q.dtype or v_full.dtype != q.dtype:
        raise TypeError(f"{name}: q and the cache must share one dtype")
    dtype_code(q)  # raises TypeError but for float32 and bfloat16
    if k_full.dim() != 4 or v_full.shape != k_full.shape:
        raise ValueError(f"{name}: k/v must be one (L, B, T, D) shape")
    lcount, b, t, d_model = k_full.shape
    if tuple(q.shape) != (b, d_model):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match cache {tuple(k_full.shape)}")
    if d_model % n_heads or d_model // n_heads not in HEAD_DIMS:
        raise ValueError(f"{name}: head width {d_model}/{n_heads} is not one of {HEAD_DIMS}")
    if d_model * q.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"{name}: a row of {d_model} channels exceeds {MAX_ROW_BYTES} bytes")
    if whole_chunks and t % CHUNK:
        raise ValueError(f"{name}: cache length {t} is not a multiple of {CHUNK}")
    if bb < 1 or b % bb:
        raise ValueError(f"{name}: batch {b} is not a multiple of bb = {bb}")
    if not 0 <= pos < t or not 0 <= layer < lcount:
        raise ValueError(f"{name}: needs 0 <= pos < T and 0 <= layer < L")


def _launch(name, q, k_full, v_full, pos: int, layer: int, n_heads: int):
    stream = require_cuda(name, q, k_full, v_full)
    if any(t.data_ptr() % 16 for t in (q, k_full, v_full)):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    _, b, t, d_model = k_full.shape
    plan = split_plan(pos, b, d_model * q.element_size(), CHUNK_BYTES)
    out = torch.empty_like(q)
    lib = load_library("folded_attention")
    check(
        lib.mnx_folded_decode_attention(
            dtype_code(q), q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(), out.data_ptr(),
            b, t, d_model, n_heads, int(pos), int(layer), *plan, stream,
        ),
        name,
    )
    LAUNCHES[name] += 1
    return out


def folded_decode_attention(q, k_full, v_full, pos: int, layer: int, n_heads: int):
    """K5: q (B, D); k_full/v_full (L, B, T, D), T a multiple of 128."""
    _check("folded_decode_attention", q, k_full, v_full, pos, layer, n_heads, 1, True)
    if q.device.type == "cpu":
        return folded_decode_attention_reference(q, k_full, v_full, pos, layer, n_heads)
    return _launch("folded_decode_attention", q, k_full, v_full, pos, layer, n_heads)


def folded_decode_attention_bb(q, k_full, v_full, pos: int, layer: int, n_heads: int,
                               bb: int = 8):
    """K6: the TPU kernel's batch-blocked form, ``B % bb == 0``; on the card
    its rows run side by side, on K5's grid."""
    _check("folded_decode_attention_bb", q, k_full, v_full, pos, layer, n_heads, bb, True)
    if q.device.type == "cpu":
        return folded_decode_attention_reference(q, k_full, v_full, pos, layer, n_heads)
    return _launch("folded_decode_attention_bb", q, k_full, v_full, pos, layer, n_heads)


def cached_folded_attention(q, k_full, v_full, pos: int, layer: int, n_heads: int):
    """K5 on a CUDA tensor for every T the kernel takes, the plain version
    on a CPU one."""
    if q.device.type == "cpu":
        return folded_decode_attention_reference(q, k_full, v_full, pos, layer, n_heads)
    _check("folded_decode_attention", q, k_full, v_full, pos, layer, n_heads, 1, False)
    return _launch("folded_decode_attention", q, k_full, v_full, pos, layer, n_heads)
