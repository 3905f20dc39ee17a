"""K3 and K4 decode attention (wrappers and plain versions), int8
quantization, and the head-folded cross attention of one decode step.

* :func:`decode_attention_layered` / :func:`decode_attention_layered_q8` —
  K3: single-query attention over positions ``0..pos`` of layer ``layer``
  of a stacked ``(L, B, H, T, d)`` self cache, dense or int8 with per-token
  f32 scales ``(L, B, H, T, 1)``.  The dense form ports
  ``molnextr_tpu/ops/decode_attention.py::decode_attention_layered``; the
  int8 form computes ``cached_decode_attention_layered_q8``, which the JAX
  package leaves to XLA.  The math is that of ``decode_attention_reference``
  and ``decode_attention_reference_q8`` of the JAX package.
* :func:`decode_attention` / :func:`cached_decode_attention` — K4: the same
  attention on an unstacked ``(B, H, T, d)`` cache, port of
  ``decode_attention.py::decode_attention``.  It launches K3's kernel on the
  cache as a one-layer stack.
* :func:`quantize_per_token` — symmetric int8, one scale per token.
* :func:`cross_decode_attention_folded[_q8]` — cross attention against the
  head-folded ``(L, B, M, H*d)`` memory cache, in plain torch ops (the JAX
  package leaves it to XLA as well).

On a CUDA tensor the kernel wrappers launch ``csrc/decode_attention.cu``
(positions split over a thread-block cluster by ``_launch.split_plan``); on
a CPU tensor they run the plain versions below.  Both hold the head width
to what the kernel takes, 1..128.
"""

from __future__ import annotations

import torch

from molnextr_tpu_torch.ops._build import check, load_library
from molnextr_tpu_torch.ops._launch import LAUNCHES, dtype_code, require_cuda, split_plan

CHUNK = 128  # the TPU kernels' cache chunk: K4 takes T in whole chunks
MAX_HEAD = 128  # head widths the kernel takes: 1..128
CHUNK_BYTES = 16 * 1024  # K (and V) bytes a CTA stages at once
NEG_INF = -1e30


def quantize_per_token(x: torch.Tensor, dim: int = -1):
    """Symmetric int8 with one scale per token over ``dim``: round half to
    even, clip to +-127, ``scale = max(amax, 1e-8) / 127``.  Returns
    (int8 values, f32 scales keeping ``dim`` with size 1)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _softmax_prefix(scores: torch.Tensor, pos: int) -> torch.Tensor:
    t_idx = torch.arange(scores.shape[-1], device=scores.device)
    scores = torch.where(t_idx > pos, torch.full_like(scores, NEG_INF), scores)
    return torch.softmax(scores, dim=-1)


def decode_attention_reference(q, k, v, pos: int):
    """q (B, H, d); k/v (B, H, T, d) in q's dtype; attends to t <= pos."""
    d = q.shape[-1]
    scores = torch.einsum("bhd,bhtd->bht", q.float(), k.float()) / (d ** 0.5)
    p = _softmax_prefix(scores, pos).to(q.dtype).float()
    return torch.einsum("bht,bhtd->bhd", p, v.float()).to(q.dtype)


def decode_attention_reference_q8(q, k_q, k_s, v_q, v_s, pos: int):
    """int8 cache: k_q/v_q (B, H, T, d) int8, k_s/v_s (B, H, T, 1) f32.
    The per-token scales factor out of both contractions; ``p * s_v`` is
    rounded to q's dtype before the PV product, as in the JAX reference."""
    d = q.shape[-1]
    scores = torch.einsum("bhd,bhtd->bht", q.float(), k_q.float())
    scores = scores * k_s[..., 0] / (d ** 0.5)
    p = _softmax_prefix(scores, pos)
    pv = (p * v_s[..., 0]).to(q.dtype).float()
    return torch.einsum("bht,bhtd->bhd", pv, v_q.float()).to(q.dtype)


def decode_attention_layered_reference(q, k_full, v_full, pos: int, layer: int):
    return decode_attention_reference(q, k_full[layer], v_full[layer], pos)


def decode_attention_layered_q8_reference(q, k_full, k_scale, v_full, v_scale,
                                          pos: int, layer: int):
    return decode_attention_reference_q8(
        q, k_full[layer], k_scale[layer], v_full[layer], v_scale[layer], pos
    )


def _check_head(name, q):
    """The kernel takes head widths 1..MAX_HEAD; held on either device."""
    if not 1 <= q.shape[-1] <= MAX_HEAD:
        raise ValueError(f"{name}: head width {q.shape[-1]} is not in 1..{MAX_HEAD}")


def _launch_k3(name, q, k_full, v_full, k_scale, v_scale, pos: int, layer: int,
               cluster=None):
    """One launch of ``csrc/decode_attention.cu`` on the stacked cache;
    ``cluster`` overrides the split plan's cluster size (for timing)."""
    lcount, b, h, t, d = k_full.shape
    if tuple(q.shape) != (b, h, d) or v_full.shape != k_full.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match cache {tuple(k_full.shape)}")
    if not 0 <= pos < t or not 0 <= layer < lcount:
        raise ValueError(f"{name}: needs 0 <= pos < T, 0 <= layer < L")
    scales = () if k_scale is None else (k_scale, v_scale)
    stream = require_cuda(name, q, k_full, v_full, *scales)
    plan = split_plan(pos, b * h, d * k_full.element_size(), CHUNK_BYTES, cluster)
    out = torch.empty_like(q)
    lib = load_library("decode_attention")
    check(
        lib.mnx_decode_attention_layered(
            dtype_code(q), int(k_scale is not None), q.data_ptr(), k_full.data_ptr(),
            v_full.data_ptr(), None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(), out.data_ptr(),
            b, h, t, d, int(pos), int(layer), *plan, stream,
        ),
        name,
    )
    LAUNCHES[name] += 1
    return out


def decode_attention_layered(q, k_full, v_full, pos: int, layer: int):
    """Dense stacked cache (L, B, H, T, d) in q's dtype."""
    _check_head("decode_attention_layered", q)
    if q.device.type == "cpu":
        return decode_attention_layered_reference(q, k_full, v_full, pos, layer)
    if k_full.dtype != q.dtype:
        raise TypeError("decode_attention_layered: cache must be in q's dtype")
    return _launch_k3("decode_attention_layered", q, k_full, v_full, None, None, pos, layer)


def decode_attention_layered_q8(q, k_full, k_scale, v_full, v_scale, pos: int, layer: int):
    """int8 stacked cache (L, B, H, T, d) with f32 scales (L, B, H, T, 1)."""
    _check_head("decode_attention_layered_q8", q)
    if q.device.type == "cpu":
        return decode_attention_layered_q8_reference(
            q, k_full, k_scale, v_full, v_scale, pos, layer
        )
    if k_full.dtype != torch.int8 or v_full.dtype != torch.int8:
        raise TypeError("decode_attention_layered_q8: cache must be int8")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("decode_attention_layered_q8: scales must be float32")
    if k_scale.shape != k_full.shape[:-1] + (1,) or v_scale.shape != k_scale.shape:
        raise ValueError("decode_attention_layered_q8: scale shape does not match cache")
    return _launch_k3(
        "decode_attention_layered_q8", q, k_full, v_full, k_scale, v_scale, pos, layer
    )


# the JAX package's dispatcher picks the kernel by backend; here the
# tensor's device does, for every T
cached_decode_attention_layered = decode_attention_layered


def cached_decode_attention(q, k, v, pos: int):
    """K4 on a CUDA tensor for every T, the plain version on a CPU one.
    q (B, H, d); k/v (B, H, T, d) in q's dtype."""
    _check_head("decode_attention", q)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, pos)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention: cache must be in q's dtype")
    # a one-layer stack of the cache: a free view, read at layer 0
    return _launch_k3("decode_attention", q, k[None], v[None], None, None, pos, 0)


def decode_attention(q, k, v, pos: int):
    """K4: q (B, H, d); k/v (B, H, T, d) with T a multiple of 128, as the
    TPU kernel takes it."""
    if k.shape[2] % CHUNK:
        raise ValueError(f"decode_attention: cache length {k.shape[2]} is not a multiple of {CHUNK}")
    return cached_decode_attention(q, k, v, pos)


# ---------------------------------------------------------------------------
# cross attention against the head-folded memory cache (torch ops)
# ---------------------------------------------------------------------------


def cross_decode_attention_folded(q, mem_k, mem_v, layer: int, num_heads: int):
    """q (B, H, d); mem_k/mem_v (L, B, M, H*d) in q's dtype."""
    kl, vl = mem_k[layer], mem_v[layer]
    b, m, hd_total = kl.shape
    d = hd_total // num_heads
    k4 = kl.reshape(b, m, num_heads, d).float()
    v4 = vl.reshape(b, m, num_heads, d).float()
    scores = torch.einsum("bhd,bmhd->bhm", q.float(), k4) / (d ** 0.5)
    p = torch.softmax(scores, dim=-1).to(q.dtype).float()
    return torch.einsum("bhm,bmhd->bhd", p, v4).to(q.dtype)


def cross_decode_attention_folded_q8(q, mem_k, mem_k_scale, mem_v, mem_v_scale,
                                     layer: int, num_heads: int):
    """int8 memory cache (L, B, M, H*d) with one f32 scale per memory
    position over the folded H*d axis, (L, B, M, 1)."""
    kl, vl = mem_k[layer], mem_v[layer]
    ks, vs = mem_k_scale[layer], mem_v_scale[layer]
    b, m, hd_total = kl.shape
    d = hd_total // num_heads
    k4 = kl.reshape(b, m, num_heads, d).float()
    v4 = vl.reshape(b, m, num_heads, d).float()
    scores = torch.einsum("bhd,bmhd->bhm", q.float(), k4)
    scores = scores * ks[..., 0][:, None, :] / (d ** 0.5)
    p = torch.softmax(scores, dim=-1)
    pv = (p * vs[..., 0][:, None, :]).to(q.dtype).float()
    return torch.einsum("bhm,bmhd->bhd", pv, v4).to(q.dtype)
