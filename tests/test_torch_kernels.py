"""The port's kernel modules on the CPU (their plain versions) against the
JAX package's kernels and references, on the same numpy inputs.

Tolerances: 2e-5 for float32 kernels (both sides accumulate in float32,
only the summation order differs); 3e-2 relative for bfloat16, where both
sides round at the same points but their float32 sums still differ.
Kernel launches on a CUDA tensor are checked by ``test_torch_cuda.py`` on
the card.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molnextr_tpu.models.swin import shift_attn_mask as jax_shift_attn_mask
from molnextr_tpu.ops import swin_fused as jsf
from molnextr_tpu_torch.models.swin import shift_attn_mask
from molnextr_tpu_torch.ops import swin_fused as tsf

torch.set_num_threads(2)
# both packages' __init__ re-export a function under the module's name
jdec = importlib.import_module("molnextr_tpu.ops.decode_attention")
tdec = importlib.import_module("molnextr_tpu_torch.ops.decode_attention")

F32_TOL = 2e-5
BF16_RTOL = 3e-2


def _attn_inputs(b, res, c, heads, ws, seed):
    rng = np.random.RandomState(seed)
    n = ws * ws
    return dict(
        x=rng.randn(b, res, res, c).astype(np.float32),
        wqkv=(rng.randn(c, 3 * c) * 0.1).astype(np.float32),
        bqkv=(rng.randn(3 * c) * 0.1).astype(np.float32),
        wproj=(rng.randn(c, c) * 0.1).astype(np.float32),
        bproj=(rng.randn(c) * 0.1).astype(np.float32),
        ln_s=(rng.rand(c) + 0.5).astype(np.float32),
        ln_b=(rng.randn(c) * 0.1).astype(np.float32),
        bias=(rng.randn(heads, n, n) * 0.1).astype(np.float32),
    )


def _mask(res, ws, shifted):
    if not shifted:
        return None
    return np.where(shift_attn_mask(res, res, ws, ws // 2), -100.0, 0.0).astype(np.float32)


ATTN_CASES = [  # (res, C, heads, ws, shifted): hd 16 and 32, N 16 and 144
    (8, 32, 2, 4, False),
    (8, 32, 2, 4, True),
    (8, 64, 2, 4, True),
    (24, 64, 2, 12, False),
    (24, 64, 2, 12, True),
]


@pytest.mark.parametrize("res,c,heads,ws,shifted", ATTN_CASES)
def test_window_attention_f32_matches_pallas(res, c, heads, ws, shifted):
    a = _attn_inputs(2, res, c, heads, ws, seed=res + c + ws)
    mask = _mask(res, ws, shifted)
    args = [a[k] for k in ("x", "wqkv", "bqkv", "wproj", "bproj", "ln_s", "ln_b", "bias")]
    want = jsf.fused_window_attention(
        *[jnp.asarray(v) for v in args], mask, heads, ws, interpret=True
    )
    want_ref = jsf.window_attention_reference(*[jnp.asarray(v) for v in args], mask, heads, ws)
    got = tsf.fused_window_attention(
        *[torch.from_numpy(v) for v in args],
        None if mask is None else torch.from_numpy(mask), heads, ws,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), rtol=F32_TOL, atol=F32_TOL)


def test_window_attention_bf16_matches_pallas():
    res, c, heads, ws = 8, 32, 2, 4
    a = _attn_inputs(2, res, c, heads, ws, seed=11)
    mask = _mask(res, ws, True)
    want = jsf.fused_window_attention(
        jnp.asarray(a["x"], jnp.bfloat16), jnp.asarray(a["wqkv"]), jnp.asarray(a["bqkv"]),
        jnp.asarray(a["wproj"]), jnp.asarray(a["bproj"]), jnp.asarray(a["ln_s"]),
        jnp.asarray(a["ln_b"]), jnp.asarray(a["bias"]), mask, heads, ws, interpret=True,
    )
    bf = torch.bfloat16
    got = tsf.fused_window_attention(
        torch.from_numpy(a["x"]).to(bf), torch.from_numpy(a["wqkv"]).to(bf),
        torch.from_numpy(a["bqkv"]), torch.from_numpy(a["wproj"]).to(bf),
        torch.from_numpy(a["bproj"]), torch.from_numpy(a["ln_s"]), torch.from_numpy(a["ln_b"]),
        torch.from_numpy(a["bias"]), torch.from_numpy(mask), heads, ws,
    )
    assert got.dtype == bf
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL, atol=BF16_RTOL)


def test_shift_mask_matches_jax():
    for h, ws, shift in ((8, 4, 2), (32, 4, 2), (96, 12, 6), (24, 12, 6)):
        np.testing.assert_array_equal(shift_attn_mask(h, h, ws, shift),
                                      jax_shift_attn_mask(h, h, ws, shift))


def _mlp_inputs(t, c, f, seed):
    rng = np.random.RandomState(seed)
    return [
        rng.randn(t, c).astype(np.float32),
        (rng.rand(c) + 0.5).astype(np.float32),
        (rng.randn(c) * 0.1).astype(np.float32),
        (rng.randn(c, f) * 0.1).astype(np.float32),
        (rng.randn(f) * 0.1).astype(np.float32),
        (rng.randn(f, c) * 0.1).astype(np.float32),
        (rng.randn(c) * 0.1).astype(np.float32),
    ]


@pytest.mark.parametrize("t,c", [(256, 16), (512, 32), (128, 64)])
def test_ln_mlp_f32_matches_pallas(t, c):
    args = _mlp_inputs(t, c, 4 * c, seed=t + c)
    want = jsf.fused_ln_mlp(*[jnp.asarray(a) for a in args], tile=128, chunk=64, interpret=True)
    want_ref = jsf.ln_mlp_reference(*[jnp.asarray(a) for a in args])
    got = tsf.fused_ln_mlp(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), rtol=F32_TOL, atol=F32_TOL)


def test_ln_mlp_bf16_matches_pallas():
    args = _mlp_inputs(256, 32, 128, seed=5)
    want = jsf.fused_ln_mlp(
        jnp.asarray(args[0], jnp.bfloat16), *[jnp.asarray(a) for a in args[1:]],
        tile=128, chunk=64, interpret=True,
    )
    bf = torch.bfloat16
    t = [torch.from_numpy(a) for a in args]
    got = tsf.fused_ln_mlp(t[0].to(bf), t[1], t[2], t[3].to(bf), t[4], t[5].to(bf), t[6])
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=BF16_RTOL)


# ---------------------------------------------------------------------------
# K3 and the decode-step attention pieces
# ---------------------------------------------------------------------------


def _cache(seed, L=2, b=3, h=4, t=256, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((L, b, h, t, d)).astype(np.float32)
    v = rng.standard_normal((L, b, h, t, d)).astype(np.float32)
    return q, k, v


def test_quantize_per_token_equal():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 16, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0  # the 1e-8 floor
    x[0, 1, 1, :4] = [1.27, 0.005, 0.015, -0.025]  # x / scale lands on .5
    jq, js = jdec.quantize_per_token(jnp.asarray(x))
    tq, ts = tdec.quantize_per_token(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("pos,layer", [(0, 0), (127, 1), (128, 0), (200, 1)])
def test_decode_attention_layered_dense_matches_jax(pos, layer):
    q, k, v = _cache(pos)
    want = jdec.decode_attention_layered_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jnp.asarray(layer)
    )
    got = tdec.decode_attention_layered(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos, layer
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 127, 128, 200])
def test_decode_attention_unstacked_matches_jax(dtype, pos):
    """K4 and its dispatcher against the JAX dispatcher, which returns
    decode_attention_reference off a TPU: f32 to the order of the sums, bf16
    within one bf16 rounding (1e-2 of the output's max)."""
    q, k, v = _cache(300 + pos, L=1, b=4)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jdec.cached_decode_attention(
        jnp.asarray(q, jd), jnp.asarray(k[0], jd), jnp.asarray(v[0], jd), jnp.asarray(pos))
    want = np.asarray(want.astype(jnp.float32))
    tol = F32_TOL if dtype == "float32" else 1e-2 * np.abs(want).max()
    t = [torch.from_numpy(a).to(td) for a in (q, k[0], v[0])]
    for fn in (tdec.decode_attention, tdec.cached_decode_attention):
        got = fn(*t, pos)
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_decode_attention_unstacked_needs_whole_chunks():
    q, k, v = (torch.from_numpy(a) for a in _cache(5, L=1, t=200))
    with pytest.raises(ValueError, match="multiple of 128"):
        tdec.decode_attention(q, k[0], v[0], 3)
    want = tdec.decode_attention_reference(q, k[0], v[0], 150)
    torch.testing.assert_close(tdec.cached_decode_attention(q, k[0], v[0], 150), want)


@pytest.mark.parametrize("pos,layer", [(0, 1), (127, 0), (128, 1), (255, 0)])
def test_decode_attention_layered_q8_matches_jax(pos, layer):
    q, k, v = _cache(100 + pos)
    kq, ks = jdec.quantize_per_token(jnp.asarray(k))
    vq, vs = jdec.quantize_per_token(jnp.asarray(v))
    want = jdec.cached_decode_attention_layered_q8(
        jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(pos), jnp.asarray(layer)
    )
    t = [torch.from_numpy(np.asarray(a)) for a in (q, kq, ks, vq, vs)]
    got = tdec.decode_attention_layered_q8(*t, pos, layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_decode_attention_layered_q8_bf16_matches_jax():
    """bf16 q: p * s_v is rounded to bf16 before the PV product on both
    sides."""
    q, k, v = _cache(7)
    kq, ks = jdec.quantize_per_token(jnp.asarray(k))
    vq, vs = jdec.quantize_per_token(jnp.asarray(v))
    want = jdec.cached_decode_attention_layered_q8(
        jnp.asarray(q, jnp.bfloat16), kq, ks, vq, vs, jnp.asarray(150), jnp.asarray(1)
    )
    t = [torch.from_numpy(np.asarray(a)) for a in (kq, ks, vq, vs)]
    got = tdec.decode_attention_layered_q8(torch.from_numpy(q).to(torch.bfloat16), *t, 150, 1)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=BF16_RTOL)


@pytest.mark.parametrize("int8", [False, True])
def test_cross_attention_matches_jax(int8):
    rng = np.random.default_rng(2)
    L, b, m, heads, d = 2, 3, 16, 4, 32
    q = rng.standard_normal((b, heads, d)).astype(np.float32)
    mk = rng.standard_normal((L, b, m, heads * d)).astype(np.float32)
    mv = rng.standard_normal((L, b, m, heads * d)).astype(np.float32)
    if int8:
        mkq, mks = jdec.quantize_per_token(jnp.asarray(mk))
        mvq, mvs = jdec.quantize_per_token(jnp.asarray(mv))
        want = jdec.cross_decode_attention_folded_q8(
            jnp.asarray(q), mkq, mks, mvq, mvs, jnp.asarray(1), heads
        )
        t = [torch.from_numpy(np.asarray(a)) for a in (q, mkq, mks, mvq, mvs)]
        got = tdec.cross_decode_attention_folded_q8(*t, 1, heads)
    else:
        want = jdec.cross_decode_attention_folded(
            jnp.asarray(q), jnp.asarray(mk), jnp.asarray(mv), jnp.asarray(1), heads
        )
        got = tdec.cross_decode_attention_folded(
            torch.from_numpy(q), torch.from_numpy(mk), torch.from_numpy(mv), 1, heads
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_cpu_tensors_take_plain_versions():
    """On CPU tensors the wrappers never launch: the counters stay put."""
    from molnextr_tpu_torch import ops

    ops.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _cache(3, t=128))
    tdec.decode_attention_layered(q, k, v, 5, 0)
    ops.decode_attention(q, k[0], v[0], 5)
    ops.cached_decode_attention(q, k[0], v[0], 5)
    qf, kf = q.reshape(3, -1), k.transpose(2, 3).reshape(2, 3, 128, -1)  # heads folded
    ops.folded_decode_attention(qf, kf, kf, 5, 1, 4)
    ops.folded_decode_attention_bb(qf, kf, kf, 5, 1, 4, bb=3)
    ops.cached_folded_attention(qf, kf, kf, 5, 1, 4)
    args = _mlp_inputs(64, 16, 64, seed=1)
    tsf.fused_ln_mlp(*[torch.from_numpy(a) for a in args])
    assert all(n == 0 for n in ops.LAUNCHES.values())
