"""K1 and K2 of the Swin encoder on the CPU: the plain versions against the
JAX package's Pallas kernels (interpret mode) at the widths the card's
kernels take, and the launch plan (``ops/_launch.py::encoder_plan``) that
the wrappers hand the CUDA kernels.

Tolerances: 2e-5 in float32, where both sides accumulate in float32 and
only the order of the sums differs; 3e-2 in bf16, where the port rounds at
two points the Pallas kernel does not (qkv after its bias and the
normalised attention weights p, the tensor-core attention's bf16
operands), each within one bf16 rounding of the kernel's value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molnextr_tpu.ops import swin_fused as jsf
from molnextr_tpu_torch.models.swin import shift_attn_mask
from molnextr_tpu_torch.ops import swin_fused as tsf
from molnextr_tpu_torch.ops._launch import (
    ATTN_MAX_HD, ATTN_MAX_N, ATTN_MAX_WINDOWS, LN_APART, LN_PINGPONG, LN_RESIDENT,
    SMEM_LIMIT, SMEM_TWO_BLOCKS, STATIC_SMEM, encoder_plan,
)

torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_RTOL = 3e-2
ARG_NAMES = ("x", "wqkv", "bqkv", "wproj", "bproj", "ln_s", "ln_b", "bias")


def _attn_inputs(b, res, c, heads, ws, shifted, seed):
    rng = np.random.RandomState(seed)
    n = ws * ws
    a = dict(
        x=rng.randn(b, res, res, c).astype(np.float32),
        wqkv=(rng.randn(c, 3 * c) * c ** -0.5).astype(np.float32),
        bqkv=(rng.randn(3 * c) * 0.1).astype(np.float32),
        wproj=(rng.randn(c, c) * c ** -0.5).astype(np.float32),
        bproj=(rng.randn(c) * 0.1).astype(np.float32),
        ln_s=(rng.rand(c) + 0.5).astype(np.float32),
        ln_b=(rng.randn(c) * 0.1).astype(np.float32),
        bias=(rng.randn(heads, n, n) * 0.5).astype(np.float32),
    )
    mask = None
    if shifted:
        mask = np.where(shift_attn_mask(res, res, ws, ws // 2), -100.0, 0.0).astype(np.float32)
    return [a[k] for k in ARG_NAMES], mask


@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_bf16_stage_shape_matches_pallas(shifted):
    """The plain K1 in bf16, with its two extra rounding points, against the
    Pallas kernel at a Swin-B head (hd 32) and window (N 144): res 24, C 128,
    4 heads, ws 12."""
    res, c, heads, ws = 24, 128, 4, 12
    args, mask = _attn_inputs(1, res, c, heads, ws, shifted, seed=24 + shifted)
    bf = torch.bfloat16
    want = jsf.fused_window_attention(
        *[jnp.asarray(v, jnp.bfloat16 if i in (0, 1, 3) else jnp.float32)
          for i, v in enumerate(args)],
        mask, heads, ws, interpret=True,
    )
    want = np.asarray(want.astype(jnp.float32))
    targs = [torch.from_numpy(v) for v in args]
    for i in (0, 1, 3):
        targs[i] = targs[i].to(bf)
    got = tsf.fused_window_attention(
        *targs, None if mask is None else torch.from_numpy(mask), heads, ws)
    assert got.dtype == bf
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL, atol=BF16_RTOL)


@pytest.mark.parametrize("res,c,heads,ws,shifted", [
    (8, 128, 2, 4, False),   # hd 64
    (8, 128, 2, 4, True),
    (14, 64, 2, 7, False),   # N 49
    (14, 64, 2, 7, True),
])
def test_window_attention_f32_new_widths_match_pallas(res, c, heads, ws, shifted):
    """The widths the card's K1 now takes beyond Swin-B's: head width 64 and
    a 7 x 7 window, in float32 against the Pallas kernel and its XLA
    reference."""
    args, mask = _attn_inputs(2, res, c, heads, ws, shifted, seed=res + c + ws)
    jargs = [jnp.asarray(v) for v in args]
    want = jsf.fused_window_attention(*jargs, mask, heads, ws, interpret=True)
    want_ref = jsf.window_attention_reference(*jargs, mask, heads, ws)
    got = tsf.fused_window_attention(
        *[torch.from_numpy(v) for v in args],
        None if mask is None else torch.from_numpy(mask), heads, ws,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), rtol=F32_TOL, atol=F32_TOL)


# (res, C, heads, ws, batch): Swin-B's four stages at batch 32 (Config()),
# Swin-L's first and last (embed_dim 192), the demo bundle's two stages,
# tiny_test_config's two stages
SHAPES = {
    "swin_b_1": (96, 128, 4, 12, 32), "swin_b_2": (48, 256, 8, 12, 32),
    "swin_b_3": (24, 512, 16, 12, 32), "swin_b_4": (12, 1024, 32, 12, 32),
    "swin_l_1": (96, 192, 6, 12, 32), "swin_l_4": (12, 1536, 48, 12, 32),
    "demo_1": (32, 48, 3, 4, 6), "demo_2": (16, 96, 6, 4, 6),
    "tiny_1": (8, 16, 2, 4, 2), "tiny_2": (4, 32, 2, 4, 2),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_encoder_plan_fits_and_picks_the_fused_mlp(shape):
    """Every kernel a shape runs fits in a block's shared memory; K2 is one
    fused kernel exactly where two of its blocks share an SM (C <= 128),
    with the 3 ring stages it needs, else two GEMMs; the attention's padded
    tiles cover the window and the head."""
    res, c, heads, ws, batch = SHAPES[shape]
    tokens = batch * res * res
    k1 = encoder_plan(c, tokens, heads, ws, batch)
    k2 = encoder_plan(c, tokens)
    for key in ("ln_gemm", "gemm", "attention"):
        assert 0 < k1.smem[key] <= SMEM_LIMIT - STATIC_SMEM, (key, k1.smem)
    assert k2.mlp_fused == (c <= 128)
    if k2.mlp_fused:
        assert k2.smem["mlp"] <= SMEM_TWO_BLOCKS and k2.mlp_stages >= 3
    else:
        assert k2.mlp_stages == 0 and "mlp" not in k2.smem
    for key in (("mlp",) if k2.mlp_fused else ("ln_gemm", "gemm")):
        assert 0 < k2.smem[key] <= SMEM_LIMIT - STATIC_SMEM, (key, k2.smem)
    assert k1.attn_key_tiles * 16 >= ws * ws and k1.attn_hd_tiles * 16 >= c // heads
    assert 1 <= k1.attn_windows <= ATTN_MAX_WINDOWS and k1.attn_buffers in (1, 2)
    assert 2 <= k1.gemm_stages and 2 <= k1.ln_gemm_stages
    assert k1.qkv_tiles >= 1 and k2.fc1_tiles >= 1


def test_encoder_plan_largest_widths_and_refusals():
    """hd 128 and N 256 are the largest the window attention takes; one past
    either raises ValueError, in the plan and in the wrapper on any device."""
    plan = encoder_plan(256, 2 * 32 * 32, 2, 16, 2)
    assert plan.attn_hd_tiles * 16 == ATTN_MAX_HD and plan.attn_key_tiles * 16 == ATTN_MAX_N
    assert plan.smem["attention"] <= SMEM_LIMIT
    for c, heads, ws in ((258, 2, 4), (256, 1, 4), (32, 2, 17)):
        with pytest.raises(ValueError):
            encoder_plan(c, 4 * ws * ws, heads, ws, 1)
        args, _ = _attn_inputs(1, ws, c, heads, ws, False, seed=1)
        with pytest.raises(ValueError):
            tsf.fused_window_attention(*[torch.from_numpy(v) for v in args], None, heads, ws)


@pytest.mark.parametrize("c,form", [
    (16, LN_RESIDENT), (128, LN_RESIDENT), (256, LN_RESIDENT), (512, LN_PINGPONG),
    (1024, LN_RESIDENT), (1408, LN_RESIDENT), (1472, LN_APART), (1536, LN_APART),
    (4096, LN_APART),
])
def test_encoder_plan_ln_form(c, form):
    """The LN GEMMs keep the block's 64 normalised rows in shared memory
    while they fit beside a ring of 2 stages (C <= 1408), running ping-pong
    at C 512 only; wider rows (Swin-L's C 1536) are LayerNormed apart and
    streamed through the plain GEMM, with its ring and shared memory."""
    plan = encoder_plan(c, 32 * 144)
    assert plan.ln_form == form
    assert 2 <= plan.ln_gemm_stages and plan.smem["ln_gemm"] <= SMEM_LIMIT - STATIC_SMEM
    if form == LN_APART:
        assert plan.ln_gemm_stages == plan.gemm_stages
        assert plan.smem["ln_gemm"] == plan.smem["gemm"]
