"""The port's kernels on the card: each against its plain version at small
shapes, and a few decode steps of a small model on the card against the
same model on the CPU.  Every test here needs a CUDA card of compute
capability 9.x and skips without one; run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor OpenCV, which the card's machine lacks
(``--noconftest`` skips the suite's ``conftest.py``, which configures JAX).
``chip_smoke.py`` runs the same comparisons at the full-width shapes.
"""

import importlib

import numpy as np
import pytest
import torch

from molnextr_tpu_torch import ops
from molnextr_tpu_torch.config import Config, tiny_test_config
from molnextr_tpu_torch.models.model import MolNexTRModel
from molnextr_tpu_torch.models.swin import shift_attn_mask
from molnextr_tpu_torch.ops import LAUNCHES, reset_launch_counts
from molnextr_tpu_torch.ops import folded_attention as fa
from molnextr_tpu_torch.ops._launch import split_plan
from molnextr_tpu_torch.ops import swin_fused as sf
from molnextr_tpu_torch.tokenization import get_tokenizer
from molnextr_tpu_torch.weights import load_flax_params, seeded_flax_params

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)
# the ops package exports the K4 function under its module's name
da = importlib.import_module("molnextr_tpu_torch.ops.decode_attention")

F32_TOL = 1e-4  # float32 kernel against float32 plain version: summation order only
BF16_RTOL = 3e-2  # relative to the output's largest magnitude
BF16_ROW_RTOL = 2e-2  # a flash output's row against its own norm (chip_smoke.check_rows)
ROW_FLOOR = 1e-2  # of the head's rms row norm: dq's first row is zero by construction


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (compute capability 9.x)")
    if torch.cuda.get_device_capability()[0] != 9:
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    tol = F32_TOL if dtype == torch.float32 else BF16_RTOL * max(1.0, want.float().abs().max().item())
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol


def _close_rows(got, want):
    """Each row (last axis) of a bf16 flash output against that row's norm,
    floored at ``ROW_FLOOR`` of its head's rms row norm, so an error in a
    row of small values is not hidden by the output's largest value."""
    g, w = got.float(), want.float()
    norms = w.norm(dim=-1)
    floor = ROW_FLOOR * norms.pow(2).mean(-1, keepdim=True).sqrt()
    err = ((g - w).norm(dim=-1) / (norms + floor).clamp_min(1e-30)).max().item()
    assert err <= BF16_ROW_RTOL, f"max row relative error {err:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,c,heads,ws,shifted", [
    (8, 32, 2, 4, False), (8, 48, 3, 4, True), (24, 64, 2, 12, False), (24, 64, 2, 12, True),
])
def test_window_attention_kernel(dev, dtype, res, c, heads, ws, shifted):
    g = torch.Generator(device=dev).manual_seed(res + c)
    r = lambda *s, k=1.0: torch.randn(*s, generator=g, device=dev) * k  # noqa: E731
    mask = None
    if shifted:
        mask = torch.from_numpy(
            np.where(shift_attn_mask(res, res, ws, ws // 2), -100.0, 0.0).astype(np.float32)
        ).to(dev)
    args = (r(2, res, res, c).to(dtype), r(c, 3 * c, k=c ** -0.5).to(dtype), r(3 * c, k=0.1),
            r(c, c, k=c ** -0.5).to(dtype), r(c, k=0.1), 1 + r(c, k=0.1), r(c, k=0.1),
            r(heads, ws * ws, ws * ws, k=0.5), mask, heads, ws)
    before = LAUNCHES["fused_window_attention"]
    got = sf.fused_window_attention(*args)
    assert LAUNCHES["fused_window_attention"] == before + 1
    _close(got, sf.window_attention_reference(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,c", [(64, 16), (200, 48), (96, 128)])
def test_ln_mlp_kernel(dev, dtype, t, c):
    g = torch.Generator(device=dev).manual_seed(t + c)
    r = lambda *s, k=1.0: torch.randn(*s, generator=g, device=dev) * k  # noqa: E731
    args = (r(t, c).to(dtype), 1 + r(c, k=0.1), r(c, k=0.1), r(c, 4 * c, k=c ** -0.5).to(dtype),
            r(4 * c, k=0.1), r(4 * c, c, k=(4 * c) ** -0.5).to(dtype), r(c, k=0.1))
    _close(sf.fused_ln_mlp(*args), sf.ln_mlp_reference(*args), dtype)


def _window_args(dev, dtype, b, res, c, heads, ws, shifted, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, k=1.0: torch.randn(*s, generator=g, device=dev) * k  # noqa: E731
    mask = None
    if shifted:
        mask = torch.from_numpy(
            np.where(shift_attn_mask(res, res, ws, ws // 2), -100.0, 0.0).astype(np.float32)
        ).to(dev)
    return (r(b, res, res, c).to(dtype), r(c, 3 * c, k=c ** -0.5).to(dtype), r(3 * c, k=0.1),
            r(c, c, k=c ** -0.5).to(dtype), r(c, k=0.1), 1 + r(c, k=0.1), r(c, k=0.1),
            r(heads, ws * ws, ws * ws, k=0.5), mask, heads, ws)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("ws,res", [(4, 8), (7, 14), (12, 24), (14, 28)])
@pytest.mark.parametrize("c,heads", [(16, 2), (48, 3), (64, 2), (128, 2), (512, 16)])
def test_window_attention_kernel_widths(dev, dtype, shifted, ws, res, c, heads):
    """K1 at head width 8, 16, 32 and 64 and windows of 16, 49, 144 and 196
    tokens, on a ragged batch of 3 images (T not a multiple of the GEMMs'
    64-row tile, the last attention block short of images); C 512 takes
    the ping-pong QKV GEMM."""
    args = _window_args(dev, dtype, 3, res, c, heads, ws, shifted, seed=c + ws)
    before = LAUNCHES["fused_window_attention"]
    got = sf.fused_window_attention(*args)
    assert LAUNCHES["fused_window_attention"] == before + 1
    _close(got, sf.window_attention_reference(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_kernel_largest(dev, dtype):
    """The widest window attention the kernels take: hd 128, N 256; one
    past either raises."""
    args = _window_args(dev, dtype, 2, 32, 256, 2, 16, True, seed=7)
    _close(sf.fused_window_attention(*args), sf.window_attention_reference(*args), dtype)
    for c, heads, ws, res in ((258, 2, 4, 8), (32, 2, 17, 17)):
        with pytest.raises(ValueError):
            sf.fused_window_attention(*_window_args(dev, dtype, 1, res, c, heads, ws, False, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [16, 48, 128, 256, 512, 1024, 1536])
def test_ln_mlp_kernel_widths(dev, dtype, c):
    """K2 at every width from the tiny config to Swin-L's last stage: the
    fused kernel up to C 128, two GEMMs above, LayerNorm apart at C 1536;
    T = 200 and 4100 are not multiples of the 64-row tile."""
    for t in (200, 4100):
        g = torch.Generator(device=dev).manual_seed(t + c)
        r = lambda *s, k=1.0: torch.randn(*s, generator=g, device=dev) * k  # noqa: E731
        args = (r(t, c).to(dtype), 1 + r(c, k=0.1), r(c, k=0.1),
                r(c, 4 * c, k=c ** -0.5).to(dtype), r(4 * c, k=0.1),
                r(4 * c, c, k=(4 * c) ** -0.5).to(dtype), r(c, k=0.1))
        before = LAUNCHES["fused_ln_mlp"]
        got = sf.fused_ln_mlp(*args)
        assert LAUNCHES["fused_ln_mlp"] == before + 1
        _close(got, sf.ln_mlp_reference(*args), dtype)


@pytest.mark.parametrize("c", [16, 48, 128])
def test_ln_mlp_both_bf16_forms(dev, c):
    """Wherever the fused K2 kernel runs (C <= 128), it and the two-GEMM
    form agree with the plain version (the C entry point's fused flag;
    T 4100 is not a multiple of the tile)."""
    from molnextr_tpu_torch.ops._build import check, load_library
    from molnextr_tpu_torch.ops._launch import encoder_plan

    t, f = 4100, 4 * c
    g = torch.Generator(device=dev).manual_seed(c)
    r = lambda *s, k=1.0: torch.randn(*s, generator=g, device=dev) * k  # noqa: E731
    args = (r(t, c).to(torch.bfloat16), 1 + r(c, k=0.1), r(c, k=0.1),
            r(c, f, k=c ** -0.5).to(torch.bfloat16), r(f, k=0.1),
            r(f, c, k=f ** -0.5).to(torch.bfloat16), r(c, k=0.1))
    x, ln_s, ln_b, w1, b1, w2, b2 = args
    plan = encoder_plan(c, t)
    want = sf.ln_mlp_reference(*args)
    for fused in (1, 0):
        h = torch.empty((t, f), dtype=x.dtype, device=dev)
        out = torch.empty_like(x)
        check(load_library("swin_fused").mnx_fused_ln_mlp(
            1, x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), h.data_ptr(), out.data_ptr(), t, c, f, fused,
            plan.mlp_stages, plan.ln_form, plan.ln_gemm_stages, plan.gemm_stages, plan.fc1_tiles,
            torch.cuda.current_stream().cuda_stream), "fused_ln_mlp")
        _close(out, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_kernel_wide_rows(dev, dtype):
    """K1 at Swin-L's last stage (C 1536, 48 heads, ws 12): rows too wide to
    stay in the QKV GEMM block's shared memory are LayerNormed apart; T 288
    is not a multiple of the 64-row tile."""
    from molnextr_tpu_torch.ops._launch import LN_APART, encoder_plan

    assert encoder_plan(1536, 2 * 144, 48, 12, 2).ln_form == LN_APART
    args = _window_args(dev, dtype, 2, 12, 1536, 48, 12, False, seed=1536)
    _close(sf.fused_window_attention(*args), sf.window_attention_reference(*args), dtype)


def test_full_width_encode_launch_counts(dev):
    """One full-width bf16 encode (Swin-B, 24 blocks) launches K1 and K2 24
    times each and gives finite features."""
    cfg = Config()
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    model = load_flax_params(MolNexTRModel(cfg, vocab), seeded_flax_params(cfg, vocab, 0))
    model = model.to(dev).eval()
    model.to_dtype(torch.bfloat16)
    s = cfg.data.input_size
    imgs = torch.from_numpy(np.random.RandomState(0).randn(1, s, s, 3).astype(np.float32))
    reset_launch_counts()
    with torch.no_grad():
        memory = model.encode(imgs.to(dev))
    torch.cuda.synchronize()
    assert LAUNCHES["fused_window_attention"] == LAUNCHES["fused_ln_mlp"] == 24
    assert torch.isfinite(memory.float()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q8", [True, False])
def test_decode_attention_kernel(dev, dtype, q8):
    g = torch.Generator(device=dev).manual_seed(int(q8))
    q = torch.randn(3, 4, 32, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 3, 4, 256, 32, generator=g, device=dev)
    v = torch.randn(2, 3, 4, 256, 32, generator=g, device=dev)
    for pos in (0, 31, 127, 128, 255):
        for layer in (0, 1):
            if q8:
                ins = (q, *da.quantize_per_token(k), *da.quantize_per_token(v))
                got = da.decode_attention_layered_q8(*ins, pos, layer)
                want = da.decode_attention_layered_q8_reference(*ins, pos, layer)
            else:
                got = da.decode_attention_layered(q, k.to(dtype), v.to(dtype), pos, layer)
                want = da.decode_attention_layered_reference(q, k.to(dtype), v.to(dtype), pos, layer)
            _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_beam_rows(dev, dtype):
    """K3-int8 at the rows of a beam-4 decode of batch 32: B 128, H 8 (1024
    (b, h) groups, cluster 1), the decoder's T 512 and d 32."""
    g = torch.Generator(device=dev).manual_seed(128)
    assert split_plan(479, 128 * 8, 32, da.CHUNK_BYTES).cluster == 1
    q = torch.randn(128, 8, 32, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 128, 8, 512, 32, generator=g, device=dev)
    v = torch.randn(2, 128, 8, 512, 32, generator=g, device=dev)
    ins = (q, *da.quantize_per_token(k), *da.quantize_per_token(v))
    for pos in (0, 7, 8, 255, 479):
        _close(da.decode_attention_layered_q8(*ins, pos, 1),
               da.decode_attention_layered_q8_reference(*ins, pos, 1), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("q8", [True, False])
def test_decode_attention_kernel_every_slice_boundary(dev, dtype, d, q8):
    """K3 at every position of a 136-long cache: pos 0, pos below the
    cluster size (empty slices), and pos on and either side of every slice
    boundary of every split plan the wrapper makes here (cluster 8)."""
    g = torch.Generator(device=dev).manual_seed(d + int(q8))
    b, h, t = 2, 3, 136
    assert split_plan(t - 1, b * h, d, da.CHUNK_BYTES).cluster == 8
    q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(2, b, h, t, d, generator=g, device=dev)
    v = torch.randn(2, b, h, t, d, generator=g, device=dev)
    if q8:
        ins = (q, *da.quantize_per_token(k), *da.quantize_per_token(v))
        fn, ref = da.decode_attention_layered_q8, da.decode_attention_layered_q8_reference
    else:
        ins = (q, k.to(dtype), v.to(dtype))
        fn, ref = da.decode_attention_layered, da.decode_attention_layered_reference
    for pos in range(t):
        layer = pos % 2
        _close(fn(*ins, pos, layer), ref(*ins, pos, layer), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_long_cache(dev, dtype):
    """K4 on a T = 4096 cache up to pos 4095 (slices of 512 positions, staged
    in several chunks), which the one-warp kernel could not launch; and a
    d 128 float32 cache whose slices take 4 chunks."""
    g = torch.Generator(device=dev).manual_seed(4096)
    q = torch.randn(2, 4, 32, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 4, 4096, 32, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 4, 4096, 32, generator=g, device=dev).to(dtype)
    for pos in (4095, 4094, 2048, 511):
        _close(da.decode_attention(q, k, v, pos), da.decode_attention_reference(q, k, v, pos),
               dtype)
    q = torch.randn(2, 2, 128, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 2, 1024, 128, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 2, 1024, 128, generator=g, device=dev).to(dtype)
    for pos in (1023, 700, 257, 256, 255):
        _close(ops.cached_decode_attention(q, k, v, pos),
               da.decode_attention_reference(q, k, v, pos), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bb", [1, 2, 4, 8])
def test_folded_attention_kernel_bb_every_position(dev, dtype, bb):
    """K6 at bb 1, 2, 4 and 8 at every position of a 128-long cache."""
    g = torch.Generator(device=dev).manual_seed(bb)
    heads, hd, t = 4, 32, 128
    q = torch.randn(8, heads * hd, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 8, t, heads * hd, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 8, t, heads * hd, generator=g, device=dev).to(dtype)
    for pos in range(t):
        layer = pos % 2
        want = fa.folded_decode_attention_reference(q, k, v, pos, layer, heads)
        _close(fa.folded_decode_attention_bb(q, k, v, pos, layer, heads, bb=bb), want, dtype)


def test_kernels_in_a_cuda_graph(dev):
    """Each decode-attention kernel captured in a CUDA graph and replayed
    gives what the eager call gives."""
    g = torch.Generator(device=dev).manual_seed(9)
    bf = torch.bfloat16
    q = torch.randn(4, 8, 32, generator=g, device=dev).to(bf)
    k = torch.randn(2, 4, 8, 256, 32, generator=g, device=dev)
    v = torch.randn(2, 4, 8, 256, 32, generator=g, device=dev)
    kq, ks = da.quantize_per_token(k)
    vq, vs = da.quantize_per_token(v)
    kb, vb = k.to(bf), v.to(bf)
    qf = torch.randn(4, 256, generator=g, device=dev).to(bf)
    kf = torch.randn(2, 4, 256, 256, generator=g, device=dev).to(bf)
    vf = torch.randn(2, 4, 256, 256, generator=g, device=dev).to(bf)
    calls = [
        lambda: da.decode_attention_layered_q8(q, kq, ks, vq, vs, 200, 1),
        lambda: da.decode_attention_layered(q, kb, vb, 5, 0),
        lambda: da.decode_attention(q, kb[1], vb[1], 255),
        lambda: fa.folded_decode_attention(qf, kf, vf, 130, 1, 8),
        lambda: fa.folded_decode_attention_bb(qf, kf, vf, 3, 0, 8, bb=2),
    ]
    eager = [fn() for fn in calls]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [fn() for fn in calls]
    for _ in range(2):
        for out in captured:
            out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)


def test_wrappers_raise_on_bad_operands(dev):
    q = torch.zeros(2, 4, 32, device=dev)
    k = torch.zeros(2, 2, 4, 128, 32, device=dev)
    with pytest.raises(ValueError):
        da.decode_attention_layered(q, k, k, 128, 0)  # pos past the cache
    with pytest.raises(ValueError):
        da.decode_attention_layered(q.transpose(0, 1).contiguous().transpose(0, 1), k, k, 3, 0)
    with pytest.raises(TypeError):
        da.decode_attention_layered(q, k.half(), k.half(), 3, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unstacked_decode_attention_kernel(dev, dtype):
    """K4 and its dispatcher (any T): one launch per call."""
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(3, 4, 32, generator=g, device=dev).to(dtype)
    for t in (256, 200):
        k = torch.randn(3, 4, t, 32, generator=g, device=dev).to(dtype)
        v = torch.randn(3, 4, t, 32, generator=g, device=dev).to(dtype)
        fns = (da.decode_attention, ops.cached_decode_attention) if t % 128 == 0 else (
            ops.cached_decode_attention,)
        for pos in (0, 31, 127, 128, t - 1):
            for fn in fns:
                before = LAUNCHES["decode_attention"]
                got = fn(q, k, v, pos)
                assert LAUNCHES["decode_attention"] == before + 1
                _close(got, da.decode_attention_reference(q, k, v, pos), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,hd,t", [
    (4, 32, 256), (4, 64, 256), (4, 128, 256), (16, 32, 1024), (4, 32, 200),
])
def test_folded_attention_kernels(dev, dtype, heads, hd, t):
    """K5, K6 (bb 8 and 4) and the dispatcher at every row width the kernel
    takes (1, 2 and 4 16-byte vectors per lane; hd 128 in float32 is one
    head per warp), a cache whose scores need more than 48 KB of shared
    memory (16 heads x 1024 positions), and a length that only the
    dispatcher takes."""
    g = torch.Generator(device=dev).manual_seed(hd + t)
    d = heads * hd
    q = torch.randn(8, d, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 8, t, d, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 8, t, d, generator=g, device=dev).to(dtype)
    calls = [("folded_decode_attention", lambda p, l: ops.cached_folded_attention(q, k, v, p, l, heads))]
    if t % 128 == 0:
        calls += [
            ("folded_decode_attention", lambda p, l: fa.folded_decode_attention(q, k, v, p, l, heads)),
            ("folded_decode_attention_bb", lambda p, l: fa.folded_decode_attention_bb(q, k, v, p, l, heads)),
            ("folded_decode_attention_bb",
             lambda p, l: fa.folded_decode_attention_bb(q, k, v, p, l, heads, bb=4)),
        ]
    for pos in (0, 5, 127, 128, t - 1):
        for layer in (0, 1):
            want = fa.folded_decode_attention_reference(q, k, v, pos, layer, heads)
            for name, call in calls:
                before = LAUNCHES[name]
                got = call(pos, layer)
                assert LAUNCHES[name] == before + 1
                _close(got, want, dtype)


def test_cuda_tensors_never_reach_plain_versions(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(da, "decode_attention_reference", refuse)
    monkeypatch.setattr(fa, "folded_decode_attention_reference", refuse)
    q = torch.randn(2, 4, 32, device=dev)
    k = torch.randn(2, 4, 128, 32, device=dev)
    ops.decode_attention(q, k, k, 5)
    ops.cached_decode_attention(q, k, k, 5)
    qf = torch.randn(8, 128, device=dev)
    kf = torch.randn(2, 8, 128, 128, device=dev)
    ops.folded_decode_attention(qf, kf, kf, 5, 1, 4)
    ops.folded_decode_attention_bb(qf, kf, kf, 5, 1, 4)
    ops.cached_folded_attention(qf, kf, kf, 5, 1, 4)
    torch.cuda.synchronize()


def test_new_wrappers_raise_on_bad_operands(dev):
    q = torch.zeros(2, 4, 32, device=dev)
    k = torch.zeros(2, 4, 200, 32, device=dev)
    with pytest.raises(ValueError):
        da.decode_attention(q, k, k, 3)  # T not a multiple of 128
    with pytest.raises(TypeError):
        ops.cached_decode_attention(q, k.bfloat16(), k.bfloat16(), 3)
    with pytest.raises(ValueError):
        ops.cached_decode_attention(q, k, k, 200)  # pos past the cache
    qf = torch.zeros(8, 128, device=dev)
    kf = torch.zeros(2, 8, 128, 128, device=dev)
    with pytest.raises(ValueError):
        fa.folded_decode_attention_bb(qf, kf, kf, 3, 0, 4, bb=3)  # B % bb
    with pytest.raises(ValueError):
        fa.folded_decode_attention(qf, kf, kf, 3, 0, 8)  # hd 16
    with pytest.raises(ValueError):
        fa.folded_decode_attention(qf, kf[:, :, :100].contiguous(), kf[:, :, :100].contiguous(),
                                   3, 0, 4)  # T not a multiple of 128
    with pytest.raises(TypeError):
        fa.folded_decode_attention(qf.half(), kf.half(), kf.half(), 3, 0, 4)
    with pytest.raises(ValueError):
        ops.cached_folded_attention(qf, kf.transpose(2, 3), kf, 3, 0, 4)  # not contiguous


@pytest.mark.parametrize("kv_int8", [True, False])
def test_tiny_model_decode_on_card_matches_cpu(dev, kv_int8):
    """Encode and 10 decode steps of the tiny config in float32: the card
    (kernels) against the CPU (plain versions)."""
    cfg = tiny_test_config()
    cfg.decoder.kv_int8 = kv_int8
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    cpu = load_flax_params(MolNexTRModel(cfg, vocab), seeded_flax_params(cfg, vocab, 0)).eval()
    card = load_flax_params(MolNexTRModel(Config.from_dict(cfg.to_dict()), vocab),
                            seeded_flax_params(cfg, vocab, 0)).to(dev).eval()
    imgs = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32))
    fmt = "chartok_coords"
    reset_launch_counts()
    with torch.no_grad():
        m_cpu, m_card = cpu.encode(imgs), card.encode(imgs.to(dev))
        assert (m_card.cpu() - m_cpu).abs().max().item() <= F32_TOL
        c_cpu, c_card = cpu.init_cache(fmt, m_cpu), card.init_cache(fmt, m_card)
        tok = torch.ones(2, dtype=torch.long)
        for pos in range(10):
            l_cpu, _, c_cpu = cpu.decode_step(fmt, tok, pos, c_cpu)
            l_card, _, c_card = card.decode_step(fmt, tok.to(dev), pos, c_card)
            assert (l_card.cpu() - l_cpu).abs().max().item() <= F32_TOL
            tok = l_cpu.argmax(-1)
    k3 = "decode_attention_layered_q8" if kv_int8 else "decode_attention_layered"
    assert LAUNCHES["fused_window_attention"] == LAUNCHES["fused_ln_mlp"] == 2
    assert LAUNCHES[k3] == 10 * cfg.decoder.num_layers


@pytest.mark.parametrize("kv_int8", [True, False])
def test_tiny_model_beam_on_card_matches_cpu(dev, kv_int8):
    """Beam search (beam 3, n-best) of the tiny config in float32: the card
    (kernels) against the CPU (plain versions)."""
    from molnextr_tpu_torch.decoding.beam import beam_decode

    cfg = tiny_test_config()
    cfg.decoder.kv_int8 = kv_int8
    toks = get_tokenizer(cfg.data)
    vocab = {f: len(t) for f, t in toks.items()}
    fmt = "chartok_coords"
    tc, cm = toks[fmt].constraint_tables()
    imgs = torch.from_numpy(np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32))
    outs = []
    for device in ("cpu", dev):
        model = load_flax_params(MolNexTRModel(Config.from_dict(cfg.to_dict()), vocab),
                                 seeded_flax_params(cfg, vocab, 0)).to(device).eval()
        with torch.no_grad():
            out = beam_decode(
                lambda t, p, c: model.decode_step(fmt, t, p, c),
                lambda m: model.init_cache(fmt, m), model.encode(imgs.to(device)),
                torch.as_tensor(tc, device=device).long(), torch.as_tensor(cm, device=device),
                cfg.decoder.max_len, cfg.decoder.hidden_size, beam_size=3, return_all=True,
                unroll=4,
            )
        outs.append([o.cpu() for o in out])
    (_, _, _, _, seq_cpu, sc_cpu), (_, _, _, _, seq_card, sc_card) = outs
    assert torch.equal(seq_card, seq_cpu)
    assert (sc_card - sc_cpu).abs().max().item() <= F32_TOL


@pytest.mark.parametrize("kv_int8", [True, False])
def test_tiny_model_rerank_on_card_matches_cpu(dev, kv_int8):
    """``MolNexTR`` with ``rerank="roundtrip"`` at beam 4 (tiny config,
    float32) on the port's own renders: the card's predictions, after
    rerank, equal the CPU's."""
    import random

    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.data.synthetic import generate_synthetic_image

    cfg = tiny_test_config()
    cfg.decoder.kv_int8 = kv_int8
    cfg.decode.rerank = "roundtrip"
    cfg.decode.beam_size = cfg.decode.n_best = 4
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    params = seeded_flax_params(cfg, vocab, 0)
    random.seed(5)
    images = [generate_synthetic_image(s, mol_augment=False, default_option=True, size=128)[0]
              for s in ("CC(C)O", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O")]
    outs = []
    for device in ("cpu", "cuda"):
        model = MolNexTR(cfg=Config.from_dict(cfg.to_dict()), params=params, device=device,
                         num_workers=1)
        reset_launch_counts()
        random.seed(0)
        outs.append(model.predict_images(images))
    k3 = "decode_attention_layered_q8" if kv_int8 else "decode_attention_layered"
    assert LAUNCHES["fused_window_attention"] > 0 and LAUNCHES[k3] > 0
    cpu, card = outs
    assert [o["predicted_smiles"] for o in card] == [o["predicted_smiles"] for o in cpu]
    assert [o["predicted_molfile"] for o in card] == [o["predicted_molfile"] for o in cpu]


def test_swin_kernels_refuse_inputs_that_need_gradients(dev):
    """K1 and K2 have no backward: with gradients enabled and an input that
    requires one, they raise instead of returning an output that would
    train nothing; under no_grad they launch."""
    c, res, ws, heads = 32, 8, 4, 2
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.1  # noqa: E731
    attn = [r(2, res, res, c), r(c, 3 * c), r(3 * c), r(c, c), r(c), 1 + r(c), r(c),
            r(heads, ws * ws, ws * ws)]
    mlp = [r(64, c), 1 + r(c), r(c), r(c, 4 * c), r(4 * c), r(4 * c, c), r(c)]
    attn[1].requires_grad_(True)
    mlp[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        sf.fused_window_attention(*attn, None, heads, ws)
    with pytest.raises(RuntimeError, match="no backward"):
        sf.fused_ln_mlp(*mlp)
    with torch.no_grad():
        sf.fused_window_attention(*attn, None, heads, ws)
        sf.fused_ln_mlp(*mlp)


def _tiny_train_batch(cfg):
    rng = np.random.RandomState(0)
    k, t = cfg.data.max_atoms, 20
    labels = rng.randint(3, 60, (4, t)).astype(np.int32)
    labels[:, 0] = 1
    edges = np.full((4, k, k), -100, np.int8)
    edges[:, :3, :3] = rng.randint(0, 7, (4, 3, 3))
    return {"images": rng.randint(0, 256, (4, 32, 32, 1)).astype(np.uint8),
            "refs": {"chartok_coords": labels,
                     "atom_indices": np.tile(np.array([[2, 4, 6] + [-1] * (k - 3)]), (4, 1)),
                     "edges": edges,
                     "atom_grid": rng.randint(-1, 12, (4, 4, 4)).astype(np.int8)}}


def test_tiny_train_step_on_card_matches_cpu(dev):
    """Two float32 train steps of the tiny model (remat on, dropout rates 0:
    the card's generators draw other masks than the CPU's) on the card and
    on the CPU, from the same seeded weights: the same losses and
    parameters; no K1 or K2 launch while training, both in the eval step."""
    from molnextr_tpu_torch.train.loop import _criterion
    from molnextr_tpu_torch.train.state import create_train_state
    from molnextr_tpu_torch.train.step import eval_step, train_step

    cfg = tiny_test_config()
    cfg.encoder.use_remat = cfg.decoder.use_remat = True
    cfg.encoder.drop_path_rate = cfg.decoder.hidden_dropout = cfg.decoder.attn_dropout = 0.0
    toks = get_tokenizer(cfg.data)
    vocab = {f: len(t) for f, t in toks.items()}
    batch = _tiny_train_batch(cfg)
    runs = []
    for device in ("cpu", "cuda"):
        state = create_train_state(cfg, MolNexTRModel(cfg, vocab), 10, seed=0, device=device)
        criterion = _criterion(cfg, toks)
        reset_launch_counts()
        losses = [float(train_step(cfg, criterion, state, batch, seed=3)["loss"])
                  for _ in range(2)]
        if device == "cuda":
            assert LAUNCHES["fused_window_attention"] == LAUNCHES["fused_ln_mlp"] == 0
            eval_step(cfg, criterion, state.model, batch)
            assert LAUNCHES["fused_window_attention"] > 0 and LAUNCHES["fused_ln_mlp"] > 0
        runs.append((losses, {n: p.detach().cpu() for n, p in state.model.named_parameters()}))
    (l_cpu, p_cpu), (l_card, p_card) = runs
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-5)
    for name in p_cpu:
        assert (p_card[name] - p_cpu[name]).abs().max().item() <= 1e-5, name


def test_remat_on_card_equals_remat_off_with_dropout(dev):
    """On the card, with dropout on: checkpointed blocks and layers redraw
    the same seeded masks in the backward pass, so remat on and off give the
    same gradients."""
    from molnextr_tpu_torch.train.loop import _criterion
    from molnextr_tpu_torch.train.wire import as_model_images, as_model_refs

    grads = []
    for remat in (False, True):
        cfg = tiny_test_config()
        cfg.encoder.use_remat = cfg.decoder.use_remat = remat
        cfg.encoder.drop_path_rate = 0.2
        toks = get_tokenizer(cfg.data)
        vocab = {f: len(t) for f, t in toks.items()}
        model = load_flax_params(MolNexTRModel(cfg, vocab), seeded_flax_params(cfg, vocab, 0))
        model = model.to(dev).train()
        batch = _tiny_train_batch(cfg)
        refs = as_model_refs(batch["refs"], dev)
        total, _ = _criterion(cfg, toks)(
            model(as_model_images(batch["images"], dev), refs, dropout_seed=7), refs)
        total.backward()
        grads.append({n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], rtol=1e-5, atol=1e-7)


def _tiny_convnext_cfg(kv_int8=True):
    cfg = tiny_test_config()
    cfg.encoder.name = "convnext_tiny_test"
    cfg.encoder.convnext_depths = (1, 1, 2, 1)
    cfg.encoder.convnext_dims = (16, 32, 64, 128)
    cfg.decoder.kv_int8 = kv_int8
    cfg.data.input_size = 64
    return cfg


@pytest.mark.parametrize("kv_int8", [True, False])
def test_tiny_convnext_on_card_matches_cpu(dev, kv_int8):
    """The tiny ConvNeXt (depths 1/1/2/1, dims 16-128, 64 px, seeded gamma)
    in float32: encode and 10 decode steps on the card (cuDNN convolutions
    with TF32 off, the decode kernel) against the CPU; no Swin kernel runs."""
    cfg = _tiny_convnext_cfg(kv_int8)
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    params = seeded_flax_params(cfg, vocab, 0)
    cpu = load_flax_params(MolNexTRModel(cfg, vocab), params).eval()
    card = load_flax_params(MolNexTRModel(Config.from_dict(cfg.to_dict()), vocab),
                            params).to(dev).eval()
    imgs = torch.from_numpy(np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32))
    fmt = "chartok_coords"
    reset_launch_counts()
    with torch.no_grad():
        m_cpu, m_card = cpu.encode(imgs), card.encode(imgs.to(dev))
        assert (m_card.cpu() - m_cpu).abs().max().item() <= F32_TOL
        c_cpu, c_card = cpu.init_cache(fmt, m_cpu), card.init_cache(fmt, m_card)
        tok = torch.ones(2, dtype=torch.long)
        for pos in range(10):
            l_cpu, _, c_cpu = cpu.decode_step(fmt, tok, pos, c_cpu)
            l_card, _, c_card = card.decode_step(fmt, tok.to(dev), pos, c_card)
            assert (l_card.cpu() - l_cpu).abs().max().item() <= F32_TOL
            tok = l_cpu.argmax(-1)
        card.to_dtype(torch.bfloat16)
        low = card.encode(imgs.to(dev))
    assert low.dtype == torch.bfloat16 and torch.isfinite(low.float()).all()
    k3 = "decode_attention_layered_q8" if kv_int8 else "decode_attention_layered"
    assert LAUNCHES["fused_window_attention"] == LAUNCHES["fused_ln_mlp"] == 0
    assert LAUNCHES[k3] == 10 * cfg.decoder.num_layers


def test_clutter_pipeline_as_a_wire_batch(dev):
    """Training items drawn with the clutter transforms (``clutter_augment``)
    padded into a batch: the card receives the same uint8 images and refs
    as the CPU, normalizes them within a few float32 ulps of the CPU
    (1e-6: its division rounds on its own), and an eval step of the tiny
    model on them is finite."""
    import random

    from molnextr_tpu_torch.data.dataset import Sample, TrainDataset, pad_batch
    from molnextr_tpu_torch.train.loop import _criterion
    from molnextr_tpu_torch.train.step import eval_step
    from molnextr_tpu_torch.train.wire import as_model_images, as_model_refs

    cfg = tiny_test_config()
    cfg.data.clutter_augment = True
    cfg.data.input_size = 64
    toks = get_tokenizer(cfg.data)
    ds = TrainDataset(cfg, [Sample(s) for s in ("CCO", "c1ccccc1", "CC(=O)O", "CCN")], toks,
                      rng=random.Random(0), np_rng=np.random.RandomState(0))
    random.seed(0)
    np.random.seed(0)
    items = [ds[i] for i in range(len(ds))]
    batch = pad_batch(items, cfg.data.formats, cfg.decoder.max_len, cfg.data.max_atoms)
    batch.pop("smiles")
    batch["refs"].pop("num_atoms")
    assert batch["images"].dtype == np.uint8 and batch["images"].shape[1:] == (64, 64, 1)
    wire = torch.from_numpy(batch["images"])
    assert torch.equal(wire.to(dev).cpu(), wire)
    on_card, on_cpu = as_model_images(batch["images"], dev), as_model_images(batch["images"], "cpu")
    assert (on_card.cpu() - on_cpu).abs().max().item() <= 1e-6
    refs = as_model_refs(batch["refs"], dev)
    for key, value in as_model_refs(batch["refs"], "cpu").items():
        assert torch.equal(refs[key].cpu(), value), key
    vocab = {f: len(t) for f, t in toks.items()}
    model = load_flax_params(MolNexTRModel(cfg, vocab), seeded_flax_params(cfg, vocab, 0))
    metrics = eval_step(cfg, _criterion(cfg, toks), model.to(dev), batch)
    assert torch.isfinite(metrics["loss"]).item()


def _dp_tiny_cfg():
    cfg = tiny_test_config()
    cfg.encoder.use_remat = cfg.decoder.use_remat = True
    cfg.encoder.drop_path_rate = cfg.decoder.hidden_dropout = cfg.decoder.attn_dropout = 0.0
    return cfg


def test_world_one_nccl_step_equals_the_step_with_no_group(dev):
    """A process group of one rank over NCCL: the count all-reduce and the
    gradient reduction change nothing (expected 0 difference; held to
    1e-6 for the card's atomics)."""
    import torch_parallel_worker as worker
    from molnextr_tpu_torch.parallel.distributed import initialize, shutdown
    from molnextr_tpu_torch.parallel.mesh import make_mesh
    from molnextr_tpu_torch.train.loop import _criterion
    from molnextr_tpu_torch.train.state import create_train_state
    from molnextr_tpu_torch.train.step import train_step

    cfg = _dp_tiny_cfg()
    toks = get_tokenizer(cfg.data)
    vocab = {f: len(t) for f, t in toks.items()}
    batch = _tiny_train_batch(cfg)

    def run(mesh):
        state = create_train_state(cfg, MolNexTRModel(cfg, vocab), 10, seed=0, device="cuda",
                                   mesh=mesh)
        losses = [float(train_step(cfg, _criterion(cfg, toks), state, batch, seed=3)["loss"])
                  for _ in range(2)]
        return losses, {n: p.detach().cpu() for n, p in state.model.named_parameters()}

    plain = run(None)
    initialize(backend="nccl", init_method=f"tcp://127.0.0.1:{worker.free_port()}",
               world_size=1, rank=0, local_rank=0, device="cuda")
    try:
        grouped = run(make_mesh(device="cuda"))
    finally:
        shutdown()
    np.testing.assert_allclose(grouped[0], plain[0], rtol=0, atol=1e-6)
    for name, p in plain[1].items():
        assert (grouped[1][name] - p).abs().max().item() <= 1e-6, name


def test_world_two_gloo_ranks_share_the_card(dev, tmp_path):
    """Two gloo ranks on one card, 2 rows each of the tiny batch: both take
    the same steps, so their parameters are equal bit for bit."""
    import torch_parallel_worker as worker

    cfg = _dp_tiny_cfg()
    batch = _tiny_train_batch(cfg)
    path = str(tmp_path / "batch.npz")
    np.savez(path, images=batch["images"], **{f"ref_{k}": v for k, v in batch["refs"].items()})
    r0, r1 = worker.spawn("steps", 2, tmp_path / "ranks", device="cuda:0", backend="gloo",
                          cfg_json=cfg.to_json(), batch_path=path)
    assert r0["local_rows"] == r1["local_rows"] == 2 and r0["step"] == r1["step"] == 2
    assert r0["metrics"] == r1["metrics"]
    for name, p in r0["params"].items():
        assert torch.equal(p, r1["params"][name]), name


def test_nccl_ranks_sharing_a_card_are_refused(dev, tmp_path):
    """Two NCCL ranks named onto one card: each raises, naming the card,
    instead of hanging in NCCL's first collective."""
    import torch_parallel_worker as worker

    refusals = worker.Ranks(2, tmp_path, [], device="cuda:0", backend="nccl",
                            start_only=True).join()
    name = torch.cuda.get_device_name(0)
    for (message,) in refusals:
        assert message is not None and "share cuda:0" in message and name in message


# ---------------------------------------------------------------------------
# K7, K8 and K9: the decoder's causal flash attention
# ---------------------------------------------------------------------------

fl = importlib.import_module("molnextr_tpu_torch.ops.flash_attention")
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")


def _flash_inputs(dev, dtype, b, h, t, seed, strided, d=32):
    """q, k, v (B, H, T, d) and a cotangent; ``strided``: q, k and v are
    head views of one (B, T, 3 * H * d) projection, as the decoder's."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if strided:
        qkv = torch.randn(b, t, 3 * h * d, generator=g, device=dev).to(dtype)
        q, k, v = (x.reshape(b, t, h, d).transpose(1, 2) for x in qkv.split(h * d, dim=-1))
    else:
        q, k, v = (torch.randn(b, h, t, d, generator=g, device=dev).to(dtype) for _ in range(3))
    return q, k, v, torch.randn(b, h, t, d, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,strided", [(1, 1, 64, False), (2, 3, 128, True),
                                           (3, 8, 256, False), (2, 8, 256, True),
                                           (1, 2, 448, False)])
def test_flash_attention_kernels(dev, dtype, b, h, t, strided):
    """K7, K8 and K9 each against its plain version on the same inputs (the
    backward kernels given the plain lse and di), one launch each."""
    _check_flash_kernels(dev, dtype, b, h, t, strided)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,strided", [(1, 1, 1024, False), (1, 1, 2048, True),
                                           (7, 19, 256, True), (7, 19, 448, False),
                                           (2, 3, 64, True), (1, 1, 448, True),
                                           (2, 2, 1024, True)])
def test_flash_attention_kernel_edges(dev, dtype, b, h, t, strided):
    """The edges of K7's, K8's and K9's persistent bf16 design, each kernel against
    its plain version: one head (B * H = 1); 133 heads, no multiple of the
    persistent grid; T 1024 and 2048, several rounds of tile pairs a head
    through the ring; odd tile counts (T 64 and 448: a pair of one tile, a
    warpgroup idle for a round); strided and contiguous operands."""
    _check_flash_kernels(dev, dtype, b, h, t, strided)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 48, 64, 128, 256, 384, 512, 1024])
@pytest.mark.parametrize("b,h,t,strided", [(1, 1, 128, False), (7, 19, 256, True),
                                           (1, 1, 1024, True), (7, 19, 128, False)])
def test_flash_attention_kernel_widths(dev, dtype, d, b, h, t, strided):
    """Head widths other than the decoders' 32: 64, 128 and 256 (the
    kernels' other widths; at 256 K8's and K9's two warpgroups split each
    tile's columns), 16 and 48 (given zero columns up to 32 and 64 by the
    wrappers), and 384, 512 and 1024 (the wide kernels, the head width
    streamed), each kernel against its plain version, one launch each; one
    head and 133, T 128 to 1024, strided and contiguous operands."""
    _check_flash_kernels(dev, dtype, b, h, t, strided, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_take_any_number_of_heads(dev, dtype):
    """B * H = 70000 (b, h) heads of one 64-row tile, more than a grid's y
    takes: the bf16 kernels walk the heads persistently, the float32 ones
    put (b, h) on grid x."""
    _check_flash_kernels(dev, dtype, 7000, 10, 64, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [64, 192])
def test_flash_attention_kernels_take_many_heads_at_d256(dev, dtype, t):
    """B * H = 14000 heads at d 256, about 106 a block of the persistent
    grid, each of one tile (T 64) or three (T 192, the split's rounds of one
    tile with one own slot); the float32 kernels at 512 threads a block."""
    _check_flash_kernels(dev, dtype, 1400, 10, t, True, 256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_stream_d2048(dev, dtype):
    """The widest head timed nowhere else: d 2048 at B 1, H 2, T 256."""
    _check_flash_kernels(dev, dtype, 1, 2, 256, True, 2048)


def _check_flash_kernels(dev, dtype, b, h, t, strided, d=32):
    q, k, v, do = _flash_inputs(dev, dtype, b, h, t, b + h + t, strided, d)
    scale = d ** -0.5
    reset_launch_counts()
    o, lse = fl.flash_attention_fwd(q, k, v, scale)
    o_ref, lse_ref = fl.flash_attention_reference(q, k, v, scale)
    di = (o_ref.float() * do.float()).sum(-1)
    dk, dv = fl.flash_attention_bwd_dkv(q, k, v, do, lse_ref, di, scale)
    dq = fl.flash_attention_bwd_dq(q, k, v, do, lse_ref, di, scale)
    torch.cuda.synchronize()
    assert {n: LAUNCHES[n] for n in FLASH_KERNELS} == dict.fromkeys(FLASH_KERNELS, 1)
    _close(o, o_ref, dtype)
    _close(lse, lse_ref, torch.float32)
    dk_ref, dv_ref = fl.flash_attention_bwd_dkv_reference(q, k, v, do, lse_ref, di, scale)
    _close(dk, dk_ref, dtype)
    _close(dv, dv_ref, dtype)
    dq_ref = fl.flash_attention_bwd_dq_reference(q, k, v, do, lse_ref, di, scale)
    _close(dq, dq_ref, dtype)
    assert o.dtype == dk.dtype == dv.dtype == dq.dtype == dtype
    if dtype == torch.bfloat16:
        for got, want in ((o, o_ref), (dk, dk_ref), (dv, dv_ref), (dq, dq_ref)):
            _close_rows(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_on_card(dev, dtype):
    """The dispatcher on CUDA tensors (strided head views) under autograd:
    the output and dQ, dK, dV against the plain forward's autograd on the
    same tensors; K7 once, K8 and K9 once each."""
    q, k, v, do = _flash_inputs(dev, dtype, 2, 8, 256, 11, True)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    reset_launch_counts()
    out = ops.flash_attention(*leaves, causal=True, sm_scale=32 ** -0.5)
    got = torch.autograd.grad(out, leaves, do)
    assert {n: LAUNCHES[n] for n in FLASH_KERNELS} == dict.fromkeys(FLASH_KERNELS, 1)
    plain = [x.detach().requires_grad_() for x in (q, k, v)]
    want_out = fl.flash_attention_reference(*plain, 32 ** -0.5)[0]
    want = torch.autograd.grad(want_out, plain, do)
    _close(out, want_out, dtype)
    for g_, w_ in zip(got, want):
        assert g_.dtype == dtype
        _close(g_, w_, dtype)


def test_flash_kernels_refuse_bad_operands(dev):
    q = torch.zeros(2, 2, 128, 32, device=dev)
    with pytest.raises(ValueError, match="multiple of 128.*got 192"):
        fl.flash_attention_fwd(*(torch.zeros(2, 2, 128, 192, device=dev),) * 3, 1.0)
    with pytest.raises(ValueError, match="64-row tile"):
        fl.flash_attention_fwd(*(torch.zeros(2, 2, 96, 32, device=dev),) * 3, 1.0)
    with pytest.raises(TypeError):
        fl.flash_attention_fwd(q, q.half(), q, 1.0)
    with pytest.raises(ValueError, match="must be on"):
        fl.flash_attention_fwd(q, q.cpu(), q, 1.0)


def _flash_config(hidden=64):
    """The tiny config with a decoder the flash route takes: 2 layers,
    hidden 64 (or ``hidden``), 2 heads (d 32, or hidden / 2), T 128, remat
    on, every dropout rate 0."""
    from molnextr_tpu_torch.config import DecoderConfig

    cfg = tiny_test_config()
    cfg.decoder = DecoderConfig(num_layers=2, hidden_size=hidden, attn_heads=2, max_len=128,
                                hidden_dropout=0.0, attn_dropout=0.0, use_remat=True,
                                use_flash_attention=True)
    cfg.encoder.drop_path_rate = 0.0
    return cfg


def _flash_batch(cfg):
    batch = _tiny_train_batch(cfg)
    rng = np.random.RandomState(1)
    labels = rng.randint(3, 60, (4, 128)).astype(np.int32)
    labels[:, 0] = 1
    labels[1, 90:] = 0  # PAD after the sequence's end
    batch["refs"]["chartok_coords"] = labels
    return batch


@pytest.mark.parametrize("dtype_name,hidden", [
    pytest.param("float32", 64, id="float32"), pytest.param("bf16", 64, id="bf16"),
    pytest.param("float32", 128, id="float32-d64"), pytest.param("bf16", 128, id="bf16-d64"),
    pytest.param("float32", 512, id="float32-d256"), pytest.param("bf16", 512, id="bf16-d256"),
    pytest.param("float32", 1024, id="float32-d512"), pytest.param("bf16", 1024, id="bf16-d512")])
def test_flash_route_train_and_eval_steps_on_card(dev, dtype_name, hidden):
    """The train step (remat on) and the eval step of a model whose decoder
    takes the flash route, against the same model with the flag off, on the
    card (head width 32, 64 at hidden 128, 256 at 512 and 512, streamed, at
    1024): K7 twice a layer in a train
    step (forward and remat recompute), K8 and K9 once, K7 once a layer in
    the eval step, none with the flag off."""
    from molnextr_tpu_torch.train.loop import _criterion
    from molnextr_tpu_torch.train.state import create_train_state
    from molnextr_tpu_torch.train.step import eval_step, train_step

    layers = 2
    runs = {}
    for flag in (True, False):
        cfg = _flash_config(hidden)
        cfg.train.bf16 = dtype_name == "bf16"
        cfg.decoder.use_flash_attention = flag
        toks = get_tokenizer(cfg.data)
        vocab = {f: len(t) for f, t in toks.items()}
        batch = _flash_batch(cfg)
        state = create_train_state(cfg, MolNexTRModel(cfg, vocab), 10, seed=0, device="cuda")
        criterion = _criterion(cfg, toks)
        reset_launch_counts()
        loss = float(train_step(cfg, criterion, state, batch, seed=3)["loss"])
        grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()
                 if p.grad is not None}
        train_counts = {n: LAUNCHES[n] for n in FLASH_KERNELS}
        reset_launch_counts()
        ev = float(eval_step(cfg, criterion, state.model, batch)["loss"])
        eval_counts = {n: LAUNCHES[n] for n in FLASH_KERNELS}
        runs[flag] = (loss, ev, grads)
        if flag:
            assert train_counts == {"flash_attention_fwd": 2 * layers,
                                    "flash_attention_bwd_dkv": layers,
                                    "flash_attention_bwd_dq": layers}
            assert eval_counts == {"flash_attention_fwd": layers, "flash_attention_bwd_dkv": 0,
                                   "flash_attention_bwd_dq": 0}
        else:
            assert not any(train_counts.values()) and not any(eval_counts.values())
    tol = 1e-5 if dtype_name == "float32" else 3e-2
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=tol)
    np.testing.assert_allclose(runs[True][1], runs[False][1], rtol=tol)
    if dtype_name == "float32":
        for name, want in runs[False][2].items():
            got = runs[True][2][name]
            scale = max(want.abs().max().item(), 1e-6)
            assert (got - want).abs().max().item() <= 1e-4 * scale + 1e-7, name
