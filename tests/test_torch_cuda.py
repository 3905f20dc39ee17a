"""The port's kernels on the card: each against its plain version at small
shapes, and a few decode steps of a small model on the card against the
same model on the CPU.  Every test here needs a CUDA card of compute
capability 9.x and skips without one; run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor OpenCV, which the card's machine lacks
(``--noconftest`` skips the suite's ``conftest.py``, which configures JAX).
``chip_smoke.py`` runs the same comparisons at the full-width shapes.
"""

import numpy as np
import pytest
import torch

from molnextr_tpu_torch.config import Config, tiny_test_config
from molnextr_tpu_torch.models.model import MolNexTRModel
from molnextr_tpu_torch.models.swin import shift_attn_mask
from molnextr_tpu_torch.ops import LAUNCHES, reset_launch_counts
from molnextr_tpu_torch.ops import decode_attention as da
from molnextr_tpu_torch.ops import swin_fused as sf
from molnextr_tpu_torch.tokenization import get_tokenizer
from molnextr_tpu_torch.weights import load_flax_params, seeded_flax_params

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)

F32_TOL = 1e-4  # float32 kernel against float32 plain version: summation order only
BF16_RTOL = 3e-2  # relative to the output's largest magnitude


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


def test_wrappers_raise_on_bad_operands(dev):
    q = torch.zeros(2, 4, 32, device=dev)
    k = torch.zeros(2, 2, 4, 128, 32, device=dev)
    with pytest.raises(ValueError):
        da.decode_attention_layered(q, k, k, 128, 0)  # pos past the cache
    with pytest.raises(ValueError):
        da.decode_attention_layered(q.transpose(0, 1).contiguous().transpose(0, 1), k, k, 3, 0)
    with pytest.raises(TypeError):
        da.decode_attention_layered(q, k.half(), k.half(), 3, 0)


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
