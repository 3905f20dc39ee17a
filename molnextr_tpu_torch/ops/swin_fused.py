"""K1 and K2 of the Swin encoder: wrappers and plain PyTorch versions.

* :func:`fused_window_attention` — LN1 -> qkv projection -> per-window
  multi-head attention with relative-position bias (+ shift mask) -> output
  projection, on ``(B, Hres, Wres, C)`` in the natural layout (the caller
  rolls).  Port of ``molnextr_tpu/ops/swin_fused.py::fused_window_attention``.
* :func:`fused_ln_mlp` — LN2 -> fc1 -> exact GELU -> fc2 on ``(T, C)``.
  Port of ``swin_fused.py::fused_ln_mlp``.

On a CUDA tensor each wrapper launches the hand-written kernels in
``csrc/swin_fused.cu``, with the launch plan of ``_launch.encoder_plan``;
on a CPU tensor it runs the plain version, which rounds at the same points
as the kernels (LN output, attention context and the GELU output are
rounded to the weight dtype before their products; in bf16 also qkv after
its bias and the normalised attention weights p, where the tensor-core
attention takes them as bf16 operands; everything accumulates in float32).
In float32 those roundings are no-ops and the plain versions equal
``window_attention_reference`` / ``ln_mlp_reference`` of the JAX package.
The kernels have no backward: on a CUDA tensor, with gradients enabled and
an input that requires one, a wrapper raises ``RuntimeError`` instead of
returning an output autograd cannot differentiate.

Weights use the flax layout: ``(in, out)`` kernels in the model dtype;
biases, LayerNorm parameters, the gathered rel-pos bias ``(H, N, N)`` and
the additive ``-100/0`` mask ``(nW, N, N)`` in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from molnextr_tpu_torch.ops._build import check, load_library
from molnextr_tpu_torch.ops._launch import (
    LAUNCHES, SMEM_LIMIT, STATIC_SMEM, EncoderPlan, check_gemm_rows, dtype_code, encoder_plan,
    require_cuda,
)

LN_EPS = 1e-5


def _ln_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), LN_EPS)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_bf16_operands(name: str, width: int, plan: EncoderPlan, kernels, *tensors) -> None:
    """What the bf16 kernels need: TMA reads rows from 16-byte-aligned bases
    with row pitches that are multiples of 16 bytes, and the LN prologue and
    the epilogues move 16 bytes a thread, so every width is a multiple of 8
    and every operand (LN parameters too) starts on 16 bytes; each kernel's
    shared memory fits in a block."""
    if width % 8 or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: bf16 needs widths that are multiples of 8 and "
                         "16-byte-aligned operands")
    for k in kernels:
        if plan.smem[k] > SMEM_LIMIT - STATIC_SMEM:
            raise ValueError(f"{name}: width {width} needs {plan.smem[k]} bytes of shared "
                             f"memory in its {k} kernel, more than {SMEM_LIMIT - STATIC_SMEM}")


# ---------------------------------------------------------------------------
# K1: fused window attention
# ---------------------------------------------------------------------------


def window_attention_reference(
    x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, bias, mask, num_heads, ws
):
    """Plain version of :func:`fused_window_attention` (same signature)."""
    b, hres, wres, c = x.shape
    hd = c // num_heads
    n = ws * ws
    wd = wqkv.dtype
    xn = _ln_f32(x, ln_scale, ln_bias).to(wd).float()
    qkv = (xn @ wqkv.float() + bqkv.float()).to(wd).float()
    qkv = qkv.reshape(b, hres // ws, ws, wres // ws, ws, 3 * c)
    qkv = qkv.permute(0, 1, 3, 2, 4, 5).reshape(-1, n, 3, num_heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (nwin, H, N, hd)
    s = (q @ k.transpose(-1, -2)) * (hd ** -0.5) + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(b, nw, num_heads, n, n) + mask.float()[None, :, None]).reshape(
            -1, num_heads, n, n
        )
    p = torch.softmax(s, dim=-1).to(wd).float()
    ctx = (p @ v).transpose(1, 2).reshape(-1, n, c).to(wd).float()
    out = ctx @ wproj.float() + bproj.float()
    out = out.reshape(b, hres // ws, wres // ws, ws, ws, c)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, hres, wres, c)
    return out.to(x.dtype)


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """The kernels have no backward: an output that autograd should
    differentiate would carry no ``grad_fn`` and train nothing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; run it under torch.no_grad() "
            "(training takes the Swin module path)")


def fused_window_attention(
    x: torch.Tensor,       # (B, Hres, Wres, C) in the model dtype
    wqkv: torch.Tensor,    # (C, 3C) model dtype
    bqkv: torch.Tensor,    # (3C,) f32
    wproj: torch.Tensor,   # (C, C) model dtype
    bproj: torch.Tensor,   # (C,) f32
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    bias: torch.Tensor,    # (H, N, N) f32 rel-pos bias
    mask: Optional[torch.Tensor],  # (nW, N, N) f32 additive, or None
    num_heads: int,
    ws: int,
) -> torch.Tensor:
    """LN1 + windowed MHA + proj; CPU tensors take the plain version.
    Head widths above 128 and windows of more than 256 tokens raise
    ``ValueError`` on either device."""
    b, hres, wres, c = x.shape
    n = ws * ws
    if hres % ws or wres % ws or c % num_heads:
        raise ValueError(f"fused_window_attention: unsupported shape {x.shape}, ws={ws}")
    plan = encoder_plan(c, b * hres * wres, num_heads, ws, b)
    if x.device.type == "cpu":
        return window_attention_reference(
            x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, bias, mask, num_heads, ws
        )
    _refuse_grad("fused_window_attention", x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, bias)
    if wqkv.dtype != x.dtype or wproj.dtype != x.dtype:
        raise TypeError("fused_window_attention: weights must be in the activation dtype")
    f32 = (bqkv, bproj, ln_scale, ln_bias, bias) + (() if mask is None else (mask,))
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("fused_window_attention: biases, LN params and masks are float32")
    if tuple(wqkv.shape) != (c, 3 * c) or tuple(wproj.shape) != (c, c) or tuple(
        bias.shape
    ) != (num_heads, n, n):
        raise ValueError("fused_window_attention: weight shapes do not match x")
    if mask is not None and tuple(mask.shape) != ((hres // ws) * (wres // ws), n, n):
        raise ValueError("fused_window_attention: mask shape does not match x")
    if x.dtype == torch.bfloat16:
        _check_bf16_operands("fused_window_attention", c, plan, ("ln_gemm", "gemm", "attention"),
                             x, wqkv, wproj, ln_scale, ln_bias)
    check_gemm_rows("fused_window_attention", b * hres * wres)
    stream = require_cuda(
        "fused_window_attention", x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, bias,
        *(() if mask is None else (mask,)),
    )
    t = b * hres * wres
    qkv = torch.empty((t, 3 * c), dtype=x.dtype, device=x.device)
    ctx = torch.empty((t, c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    lib = load_library("swin_fused")
    check(
        lib.mnx_fused_window_attention(
            dtype_code(x), x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            wproj.data_ptr(), bproj.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            bias.data_ptr(), _ptr(mask), qkv.data_ptr(), ctx.data_ptr(), out.data_ptr(),
            b, hres, wres, c, num_heads, ws, plan.attn_key_tiles, plan.attn_hd_tiles,
            plan.attn_windows, plan.attn_buffers, plan.ln_form, plan.ln_gemm_stages,
            plan.gemm_stages, plan.qkv_tiles, stream,
        ),
        "fused_window_attention",
    )
    LAUNCHES["fused_window_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: fused LN + MLP
# ---------------------------------------------------------------------------


def ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """Plain version of :func:`fused_ln_mlp` (same signature)."""
    wd = w1.dtype
    xn = _ln_f32(x, ln_scale, ln_bias).to(wd).float()
    h = F.gelu(xn @ w1.float() + b1.float()).to(wd).float()
    return (h @ w2.float() + b2.float()).to(x.dtype)


def fused_ln_mlp(
    x: torch.Tensor,  # (T, C) model dtype
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor,  # (C, F) model dtype, (F,) f32
    w2: torch.Tensor, b2: torch.Tensor,  # (F, C) model dtype, (C,) f32
) -> torch.Tensor:
    """LN + fc1 + GELU + fc2; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2)
    _refuse_grad("fused_ln_mlp", x, ln_scale, ln_bias, w1, b1, w2, b2)
    t, c = x.shape
    f = w1.shape[1]
    if tuple(w1.shape) != (c, f) or tuple(w2.shape) != (f, c):
        raise ValueError("fused_ln_mlp: weight shapes do not match x")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError("fused_ln_mlp: weights must be in the activation dtype")
    if any(p.dtype != torch.float32 for p in (ln_scale, ln_bias, b1, b2)):
        raise TypeError("fused_ln_mlp: biases and LN params are float32")
    plan = encoder_plan(c, t)
    fused = x.dtype == torch.bfloat16 and plan.mlp_fused
    if x.dtype == torch.bfloat16:
        _check_bf16_operands("fused_ln_mlp", math.gcd(c, f), plan,
                             ("mlp",) if fused else ("ln_gemm", "gemm"), x, w1, w2, ln_scale, ln_bias)
    if not fused:  # the fused kernel's row blocks run along the grid's x
        check_gemm_rows("fused_ln_mlp", t)
    stream = require_cuda("fused_ln_mlp", x, ln_scale, ln_bias, w1, b1, w2, b2)
    # the 4C intermediate goes through device memory only where K2 is two GEMMs
    h = None if fused else torch.empty((t, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    lib = load_library("swin_fused")
    check(
        lib.mnx_fused_ln_mlp(
            dtype_code(x), x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            _ptr(h), out.data_ptr(), t, c, f, int(fused), plan.mlp_stages, plan.ln_form,
            plan.ln_gemm_stages, plan.gemm_stages, plan.fc1_tiles, stream,
        ),
        "fused_ln_mlp",
    )
    LAUNCHES["fused_ln_mlp"] += 1
    return out
