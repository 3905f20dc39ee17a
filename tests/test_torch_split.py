"""The decode-attention kernels' split plan (``ops/_launch.py``) and the head
widths the decode wrappers take, on the CPU.

The plan is what the wrappers hand the CUDA kernels: how the positions
``0..pos`` of each (b, h) group are cut into slices, one CTA of a
thread-block cluster per slice.  The kernels' ``slice_bounds`` computes the
same slices as :func:`slices`.  The head-width cases hold the decode
wrappers at d 64 and 128 to the JAX package's ``decode_attention_reference``
(2e-5 in float32, where only the order of the sums differs; 1e-2 of the
output's largest magnitude in bf16, within one bf16 rounding).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molnextr_tpu_torch.ops._launch import CLUSTER_MAX, split_plan, slices

jdec = importlib.import_module("molnextr_tpu.ops.decode_attention")
tdec = importlib.import_module("molnextr_tpu_torch.ops.decode_attention")
torch.set_num_threads(2)

F32_TOL = 2e-5
# (groups, row bytes): the decoder's B 32 x H 8 at d 32 in bf16 and int8,
# the folded cache's B 32 at D 256, a test-sized cache, and a large batch
SHAPES = [(256, 64), (256, 32), (32, 512), (6, 32), (12, 512), (4096, 64)]
POSITIONS = list(range(0, 20)) + [31, 32, 33, 63, 64, 65, 127, 128, 479, 511, 4095]


@pytest.mark.parametrize("groups,row_bytes", SHAPES)
def test_every_position_in_exactly_one_slice(groups, row_bytes):
    for pos in POSITIONS:
        plan = split_plan(pos, groups, row_bytes, tdec.CHUNK_BYTES)
        covered = np.zeros(pos + 1, int)
        for start, stop in slices(plan, pos):
            covered[start:stop] += 1
        assert (covered == 1).all(), (pos, plan)


@pytest.mark.parametrize("groups,row_bytes", SHAPES)
def test_no_slice_starts_past_pos(groups, row_bytes):
    for pos in POSITIONS:
        plan = split_plan(pos, groups, row_bytes, tdec.CHUNK_BYTES)
        cut = slices(plan, pos)
        assert len(cut) == plan.cluster
        for start, stop in cut:
            assert 0 <= start <= pos and start <= stop <= pos + 1
            assert stop - start <= plan.slice_rows


def test_pos_below_the_cluster_size_leaves_empty_slices():
    plan = split_plan(2, 6, 32, tdec.CHUNK_BYTES)
    assert plan.cluster == CLUSTER_MAX and plan.slice_rows == 1
    assert slices(plan, 2) == [(0, 1), (1, 2), (2, 3)] + [(2, 2)] * 5


@pytest.mark.parametrize("groups,row_bytes", SHAPES)
def test_cluster_divides_the_grid(groups, row_bytes):
    for pos in POSITIONS:
        plan = split_plan(pos, groups, row_bytes, tdec.CHUNK_BYTES)
        grid = groups * plan.cluster  # the kernels' grid: one CTA per slice
        assert 1 <= plan.cluster <= CLUSTER_MAX
        assert plan.cluster & (plan.cluster - 1) == 0
        assert grid % plan.cluster == 0
        # every position of a decode launches the same grid
        assert plan.cluster == split_plan(0, groups, row_bytes, tdec.CHUNK_BYTES).cluster


def test_full_width_plan_fills_the_card():
    """B 32, H 8, d 32 in bf16 at pos 479: at least twice 132 CTAs."""
    plan = split_plan(479, 32 * 8, 32 * 2, tdec.CHUNK_BYTES)
    assert 32 * 8 * plan.cluster >= 2 * 132
    assert plan.chunk_rows >= plan.slice_rows  # one chunk: K and V read once


@pytest.mark.parametrize("row_bytes", [16, 64, 256, 512])
def test_staged_rows_do_not_grow_with_t(row_bytes):
    for pos in (511, 4095, 65535):
        plan = split_plan(pos, 8, row_bytes, tdec.CHUNK_BYTES)
        assert 1 <= plan.chunk_rows <= plan.slice_rows
        assert plan.chunk_rows * row_bytes <= tdec.CHUNK_BYTES


def test_cluster_override():
    assert split_plan(479, 256, 64, tdec.CHUNK_BYTES, cluster=1).slice_rows == 480
    with pytest.raises(ValueError):
        split_plan(479, 256, 64, tdec.CHUNK_BYTES, cluster=16)


def _cache(seed, b, h, t, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, h, t, d)).astype(np.float32),
            rng.standard_normal((b, h, t, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
def test_k4_takes_wide_heads(dtype, d):
    """K4, its dispatcher and K3 at head widths 64 and 128 (the one-warp
    kernel refused d > 32) against the JAX package's reference."""
    q, k, v = _cache(d, 2, 3, 256, d)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    t = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    for pos in (0, 5, 128, 255):
        want = jdec.decode_attention_reference(
            jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), jnp.asarray(pos))
        want = np.asarray(want.astype(jnp.float32))
        tol = F32_TOL if dtype == "float32" else 1e-2 * np.abs(want).max()
        got = [tdec.decode_attention(*t, pos), tdec.cached_decode_attention(*t, pos),
               tdec.decode_attention_layered(t[0], t[1][None], t[2][None], pos, 0)]
        for g in got:
            assert g.dtype == td
            np.testing.assert_allclose(g.float().numpy(), want, rtol=0, atol=tol)


def test_decode_wrappers_refuse_heads_past_128():
    q, k, v = (torch.from_numpy(a) for a in _cache(1, 1, 2, 128, 256))
    with pytest.raises(ValueError, match="head width"):
        tdec.decode_attention(q, k, v, 3)
    with pytest.raises(ValueError, match="head width"):
        tdec.decode_attention_layered(q, k[None], v[None], 3, 0)
    kq, ks = tdec.quantize_per_token(k[None])
    with pytest.raises(ValueError, match="head width"):
        tdec.decode_attention_layered_q8(q, kq, ks, kq, ks, 3, 0)
