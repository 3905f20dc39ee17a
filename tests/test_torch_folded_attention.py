"""K5 and K6 of the port on the CPU (their plain version) against the JAX
package's head-folded decode-attention kernels in interpret mode, its
reference and a numpy oracle, on the same numpy inputs; the checks that hold
inputs to the kernels' contract; and the port's ``ops`` exports.

Tolerances: 2e-4 for float32, as ``tests/test_folded_attention.py`` holds
the Pallas kernels to the reference (float32 throughout, only the order of
the sums differs); bf16 inputs within 1e-2 of the output's largest
magnitude (both sides compute in float32 and round the output once).
Kernel launches on a CUDA tensor are checked by ``test_torch_cuda.py`` on
the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import molnextr_tpu.ops as jops
import molnextr_tpu_torch.ops as tops
from molnextr_tpu.ops import folded_attention as jfa
from molnextr_tpu_torch.ops import folded_attention as tfa

torch.set_num_threads(2)

F32_TOL = 2e-4
BF16_RTOL = 1e-2
L, B, T, H, HD = 2, 8, 256, 4, 32  # the case of tests/test_folded_attention.py


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    d = H * HD
    q = rng.standard_normal((B, d), dtype=np.float32)
    k = rng.standard_normal((L, B, T, d), dtype=np.float32)
    v = rng.standard_normal((L, B, T, d), dtype=np.float32)
    return q, k, v


def _numpy_oracle(q, k_full, v_full, pos, layer, n_heads):
    k, v = k_full[layer], v_full[layer]
    b, _, d = k.shape
    hd = d // n_heads
    out = np.zeros((b, d), np.float32)
    for bi in range(b):
        for h in range(n_heads):
            sl = slice(h * hd, (h + 1) * hd)
            s = k[bi, : pos + 1, sl] @ q[bi, sl] / np.sqrt(hd)
            p = np.exp(s - s.max())
            out[bi, sl] = (p / p.sum()) @ v[bi, : pos + 1, sl]
    return out


POS_LAYER = [(0, 0), (5, 1), (127, 0), (145, 1), (0, 1), (5, 0), (127, 1), (145, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,layer", POS_LAYER)
def test_folded_attention_matches_pallas_interpret(case, dtype, pos, layer):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = [jnp.asarray(a, jd) for a in case]
    t = [torch.from_numpy(a).to(td) for a in case]
    jpos, jlayer = jnp.int32(pos), jnp.int32(layer)
    jax_outs = {
        "K5": jfa.folded_decode_attention(*j, jpos, jlayer, H, interpret=True),
        "K6": jfa.folded_decode_attention_bb(*j, jpos, jlayer, H, bb=4, interpret=True),
        "reference": jfa.folded_decode_attention_reference(*j, jpos, jlayer, H),
    }
    port_outs = {
        "K5": tfa.folded_decode_attention(*t, pos, layer, H),
        "K6": tfa.folded_decode_attention_bb(*t, pos, layer, H, bb=4),
        "reference": tfa.cached_folded_attention(*t, pos, layer, H),
    }
    for name, got in port_outs.items():
        assert got.dtype == td and tuple(got.shape) == (B, H * HD)
        want = np.asarray(jax_outs[name].astype(jnp.float32))
        tol = F32_TOL if dtype == "float32" else BF16_RTOL * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("pos,layer", POS_LAYER[:4])
def test_folded_attention_matches_numpy_oracle(case, pos, layer):
    want = _numpy_oracle(*case, pos, layer, H)
    t = [torch.from_numpy(a) for a in case]
    for got in (tfa.folded_decode_attention(*t, pos, layer, H),
                tfa.folded_decode_attention_bb(*t, pos, layer, H, bb=4),
                tops.folded_decode_attention_reference(*t, pos, layer, H)):
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_kernel_contract_raises(case):
    """Where the JAX functions assert (T a multiple of 128, B % bb == 0),
    and where the kernel takes no such input (hd, dtypes), the port raises
    on either device; the dispatcher takes any T."""
    q, k, v = (torch.from_numpy(a) for a in case)
    short_k, short_v = k[:, :, :200].contiguous(), v[:, :, :200].contiguous()
    for fn in (tfa.folded_decode_attention, tfa.folded_decode_attention_bb):
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(q, short_k, short_v, 3, 0, H)
        with pytest.raises(ValueError, match="head width"):
            fn(q, k, v, 3, 0, 2 * H)  # hd 16
        with pytest.raises(TypeError):
            fn(q.to(torch.bfloat16), k, v, 3, 0, H)
        with pytest.raises(TypeError):
            fn(q.half(), k.half(), v.half(), 3, 0, H)
        with pytest.raises(ValueError):
            fn(q, k, v, T, 0, H)  # pos past the cache
    with pytest.raises(ValueError, match="multiple of bb"):
        tfa.folded_decode_attention_bb(q, k, v, 3, 0, H, bb=3)
    want = _numpy_oracle(q.numpy(), short_k.numpy(), short_v.numpy(), 150, 1, H)
    got = tfa.cached_folded_attention(q, short_k, short_v, 150, 1, H)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_ops_exports_every_jax_entry_point():
    """Every name of molnextr_tpu.ops but use_pallas (the tensor's device
    does its job) has a callable counterpart of the same name."""
    names = set(jops.__all__) - {"use_pallas"}
    assert names <= set(tops.__all__)
    assert all(callable(getattr(tops, n)) for n in names | {"folded_decode_attention_bb"})
