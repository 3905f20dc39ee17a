"""K7, K8 and K9: causal flash attention for the decoder's teacher-forced
self-attention (the dispatcher, its autograd function, the kernel wrappers
and the plain version).

Port of the path ``molnextr_tpu/models/decoder.py::MHA.__call__`` takes
into JAX's library kernel
``jax.experimental.pallas.ops.tpu.flash_attention.flash_attention(q, k, v,
causal=True, sm_scale=hd ** -0.5)``: its forward ``_flash_attention_impl``
(K7), its backward ``_flash_attention_bwd_dkv`` (K8) and
``_flash_attention_bwd_dq`` (K9), wired together by a ``jax.custom_vjp``,
here a :class:`torch.autograd.Function`.

* :func:`flash_attention` — the library's name and signature, less ``ab``,
  ``segment_ids`` and ``block_sizes``, which the repo never passes: q, k, v
  ``(B, H, T, d)`` in, ``(B, H, T, d)`` out, differentiable (also under
  ``torch.utils.checkpoint`` and bf16 autocast; gradients come back in the
  inputs' dtype).  A CPU tensor takes the plain forward and backward; a
  CUDA tensor launches K7, and K8 and K9 in the backward, or raises.
* :func:`flash_attention_reference` — the plain forward: scores in float32
  with the library's mask value (``DEFAULT_MASK_VALUE``) added where a key
  follows the query, as ``mha_reference_no_custom_vjp`` does; returns the
  output and the per-row log-sum-exp, which the backward needs.
* :func:`flash_attention_bwd_dkv_reference`,
  :func:`flash_attention_bwd_dq_reference` — the plain backward, the
  library's formulas: ``p = exp(s - lse)``, ``ds = p * (dp - di)`` with
  ``dp = do v^T`` and ``di = sum(o * do, -1)`` in float32, which the
  autograd function computes outside the kernels, as the library does.
* :func:`flash_attention_fwd`, :func:`flash_attention_bwd_dkv`,
  :func:`flash_attention_bwd_dq` — K7, K8 and K9: hold their inputs to what
  the kernels take (one dtype, float32 or bfloat16; d up to 128, or 256; T
  a multiple of 64, the float32 grid's B H T / 64 blocks within 2^31 - 1)
  on every device, then dispatch on it: a CPU tensor runs the plain
  version, any other launches ``csrc/flash_attention.cu``.  The kernels
  are built for the head widths 32, 64, 128 and 256, and stream any wider
  head through shared memory 64 columns at a time; any other d up to 128
  runs at the next of the built widths through :func:`at_native_width`,
  which gives the operands zero columns and cuts the outputs back (exact:
  a zero column adds nothing to ``q k^T`` and gives zero columns of o, dq,
  dk and dv).  Above 128, JAX's library kernel takes the multiples of 128
  only, so any other width is refused with its reason, and every multiple
  of 128 runs at its own width.  A width above 128 is never padded: that
  would run where the library raises.
  The kernels read every operand through its batch, head and row strides,
  so the decoder's q, k and v are read in place from its qkv projection,
  and the outputs are views of ``(B, T, H, d)`` buffers, the layout the
  output projection reads.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from molnextr_tpu_torch.ops._build import check, load_library
from molnextr_tpu_torch.ops._launch import LAUNCHES, dtype_code

# the library's mask value (flash_attention.py:29)
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
NATIVE_WIDTHS = (32, 64, 128)  # the widths up to PAD_LIMIT that the kernels are built for
PAD_LIMIT = 128  # a width up to this runs at the next native width; above, only at its own
TILE = 64  # rows of the kernels' query and key tiles: T is a multiple of it
GRID_LIMIT = 2 ** 31 - 1  # blocks of a grid's x: the float32 and the wide kernels take B H T / 64


def _no_autocast(t: torch.Tensor):
    """The plain version computes in float32 whatever autocast is on."""
    return torch.autocast(device_type=t.device.type, enabled=False)


def _scores(q, k, sm_scale: float):
    """Scaled float32 scores (B, H, T, T) with the mask value added where a
    key follows its query."""
    t = q.shape[-2]
    s = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    visible = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return s + torch.where(visible, 0.0, DEFAULT_MASK_VALUE)


def flash_attention_reference(q, k, v, sm_scale: float):
    """q, k, v (B, H, T, d) -> (o (B, H, T, d) in q's dtype, lse (B, H, T)
    float32), causal."""
    with _no_autocast(q):
        s = _scores(q, k, sm_scale)
        m = s.amax(-1)
        e = torch.exp(s - m[..., None])
        l = e.sum(-1)
        o = (e / l[..., None]) @ v.float()
        return o.to(q.dtype), m + torch.log(l)


def _probs(q, k, lse, sm_scale: float):
    return torch.exp(_scores(q, k, sm_scale) - lse[..., None])


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, di, sm_scale: float):
    """(dk, dv) in k's and v's dtypes: ``dv = p^T do``,
    ``dk = (p * (do v^T - di) * sm_scale)^T q``."""
    with _no_autocast(q):
        p = _probs(q, k, lse, sm_scale)
        dof = do.float()
        ds = p * (dof @ v.float().transpose(-1, -2) - di[..., None]) * sm_scale
        dk = ds.transpose(-1, -2) @ q.float()
        dv = p.transpose(-1, -2) @ dof
        return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, do, lse, di, sm_scale: float):
    """dq in q's dtype: ``(p * (do v^T - di) * sm_scale) k``."""
    with _no_autocast(q):
        p = _probs(q, k, lse, sm_scale)
        ds = p * (do.float() @ v.float().transpose(-1, -2) - di[..., None]) * sm_scale
        return (ds @ k.float()).to(q.dtype)


def _check(name: str, *ts) -> None:
    """Every (B, H, T, d) operand in one dtype and shape, as the kernels take
    them; raises naming the limit."""
    q = ts[0]
    dtype_code(q)  # raises TypeError but for float32 and bfloat16
    for t in ts:
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: q, k, v (and do) must share one dtype")
        if t.shape != q.shape:
            raise ValueError(f"{name}: q, k, v (and do) must share one (B, H, T, d) shape")
    if q.dim() != 4:
        raise ValueError(f"{name}: operands are (B, H, T, d), got {tuple(q.shape)}")
    t, d = q.shape[2:]
    reason = _width_refusal(d)
    if reason:
        raise ValueError(f"{name}: {reason}")
    if t < TILE or t % TILE:
        raise ValueError(f"{name}: the kernels take T a multiple of their {TILE}-row tile, got {t}")
    b, h = q.shape[:2]
    if b * h * (t // TILE) > GRID_LIMIT:
        raise ValueError(f"{name}: the kernels' grid takes B H T / {TILE} up to {GRID_LIMIT} "
                         f"blocks, got {b * h * (t // TILE)}")


def _width_refusal(d: int):
    """Why the kernels do not take head width d, or None where they do."""
    if d <= 0:
        return f"head widths are positive, got {d}"
    if d > PAD_LIMIT and d % 128:
        return (f"above {PAD_LIMIT} the head width must be a multiple of 128, as JAX's library "
                f"flash attention requires, got {d}")
    return None


def native_width(d: int) -> int:
    """The head width the kernels run d at: up to ``PAD_LIMIT``, the least
    of NATIVE_WIDTHS from d up; above it, d itself.  Raises ``ValueError``
    for a width they do not take."""
    reason = _width_refusal(d)
    if reason:
        raise ValueError(reason)
    return d if d > PAD_LIMIT else next(w for w in NATIVE_WIDTHS if d <= w)


def at_native_width(run, heads, *rest):
    """``run(*heads, *rest)`` at the kernels' width: each (B, H, T, d)
    operand of ``heads`` given zero columns up to ``native_width(d)``, each
    (B, H, T, w) output of ``run`` cut back to d (lse stays whole).  The
    caller passes ``sm_scale`` itself, so the padding never moves it."""
    d = heads[0].shape[-1]
    w = native_width(d)
    if w == d:
        return run(*heads, *rest)
    out = run(*(torch.nn.functional.pad(t, (0, w - d)) for t in heads), *rest)

    def cut(x):
        return x[..., :d] if x.dim() == 4 else x

    return tuple(cut(x) for x in out) if isinstance(out, tuple) else cut(out)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernels can read it through its strides (rows contiguous,
    every row 16-byte aligned, the batch, head and row strides positive, as
    the bf16 kernels' tensor maps take them), else a contiguous, aligned
    copy."""
    es = t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            s > 0 and (s * es) % 16 == 0 for s in t.stride()[:3]):
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _bhtd_empty(like: torch.Tensor) -> torch.Tensor:
    """An uninitialised (B, H, T, d) output, the view of a (B, T, H, d)
    buffer."""
    b, h, t, d = like.shape
    return torch.empty(b, t, h, d, dtype=like.dtype, device=like.device).transpose(1, 2)


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _vec(name: str, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """lse or di: (B, H, T) float32, contiguous and 16-byte aligned (K8 reads
    each tile's 64 values by one bulk copy)."""
    if x.dtype != torch.float32 or tuple(x.shape) != tuple(like.shape[:3]):
        raise ValueError(f"{name}: lse and di are (B, H, T) float32")
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _stream(name: str, *ts) -> int:
    """The current stream of the current CUDA device, which every operand
    must lie on (``require_cuda`` without its contiguity check: the
    kernels take strided operands)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: every operand must be on {dev}, got {t.device}")
    return torch.cuda.current_stream(dev).cuda_stream


def flash_attention_fwd(q, k, v, sm_scale: float):
    """K7: (o (B, H, T, d), lse (B, H, T) float32)."""
    name = "flash_attention_fwd"
    _check(name, q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, sm_scale)
    stream = _stream(name, q, k, v)

    def launch(q, k, v):
        q, k, v = (_rows(t) for t in (q, k, v))
        b, h, t, d = q.shape
        o = _bhtd_empty(q)
        lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
        check(load_library("flash_attention").mnx_flash_attention_fwd(
            dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, t, d, _strides(q, k, v, o), float(sm_scale), stream), name)
        LAUNCHES[name] += 1
        return o, lse

    return at_native_width(launch, (q, k, v))


def flash_attention_bwd_dkv(q, k, v, do, lse, di, sm_scale: float):
    """K8: (dk, dv), each (B, H, T, d) in the operands' dtype."""
    name = "flash_attention_bwd_dkv"
    _check(name, q, k, v, do)
    lse, di = _vec(name, lse, q), _vec(name, di, q)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, di, sm_scale)
    stream = _stream(name, q, k, v, do, lse, di)

    def launch(q, k, v, do):
        q, k, v, do = (_rows(t) for t in (q, k, v, do))
        b, h, t, d = q.shape
        dk, dv = _bhtd_empty(k), _bhtd_empty(v)
        check(load_library("flash_attention").mnx_flash_attention_bwd_dkv(
            dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t, d,
            _strides(q, k, v, do, dk, dv), float(sm_scale), stream), name)
        LAUNCHES[name] += 1
        return dk, dv

    return at_native_width(launch, (q, k, v, do))


def flash_attention_bwd_dq(q, k, v, do, lse, di, sm_scale: float):
    """K9: dq (B, H, T, d) in the operands' dtype."""
    name = "flash_attention_bwd_dq"
    _check(name, q, k, v, do)
    lse, di = _vec(name, lse, q), _vec(name, di, q)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, di, sm_scale)
    stream = _stream(name, q, k, v, do, lse, di)

    def launch(q, k, v, do):
        q, k, v, do = (_rows(t) for t in (q, k, v, do))
        b, h, t, d = q.shape
        dq = _bhtd_empty(q)
        check(load_library("flash_attention").mnx_flash_attention_bwd_dq(
            dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), b, h, t, d,
            _strides(q, k, v, do, dq), float(sm_scale), stream), name)
        LAUNCHES[name] += 1
        return dq

    return at_native_width(launch, (q, k, v, do))


class _FlashAttention(torch.autograd.Function):
    """K7 forward; K8 and K9 backward, with ``di`` computed between them."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        di = (o.float() * do.float()).sum(-1)  # the library's di, outside its kernels
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, ctx.sm_scale)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, di, ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True, sm_scale: float = 1.0):
    """Causal attention of q, k, v (B, H, T, d) -> (B, H, T, d): K7 (and K8,
    K9 in the backward) for a CUDA tensor, the plain version for a CPU one.
    ``causal=False`` is refused: the decoder, the repo's one caller, passes
    True."""
    if not causal:
        raise NotImplementedError("flash_attention: the port implements the causal form only")
    return _FlashAttention.apply(q, k, v, float(sm_scale))
