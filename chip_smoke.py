#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``molnextr_tpu_torch``) on one Hopper card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the hand-written kernels of ``molnextr_tpu_torch/ops/csrc`` with
``nvcc`` (one process per source, in parallel), then runs, raising on any
failure:

1. setup: the card, its power limit, compute capability 9.x, build seconds;
2. kernels: K1-K6 against their plain PyTorch versions at the full-width
   shapes, in float32 and bf16, each error beside its tolerance (K1 also
   at head width 64 and at 7 x 7 and 14 x 14 windows); the
   decode-attention kernels at positions on and beside the split plan's
   slice boundaries, K4 at head width 64, and K3-int8 at the beam's 128
   rows;
3. parity: ``Config()`` (Swin-B 384 + 6x256x8 decoder) in float32 with
   ``seeded_flax_params(seed=0)`` against the JAX package's memory bank and
   first greedy steps stored in ``molnextr_tpu_torch/fixtures``;
4. paths: the serving path through the public API at full width (seeded
   weights, bf16, int8 KV cache) and its dense-cache form
   (``MOLNEXTR_KV_INT8=0``), each with the launch counters zeroed before
   and read after;
5. ops: the public ``molnextr_tpu_torch.ops`` entry points of K4-K6
   (``cached_decode_attention``, ``cached_folded_attention``,
   ``folded_decode_attention_bb``) over every position and layer of one
   full-width bf16 decode, with the counters zeroed before and read after,
   and their outputs at a few positions against the plain versions;
6. demo: the trained demo bundle through the public API, hits against gold
   and agreement with the JAX package's SMILES, and ``get_predictions`` on
   a PNG file;
7. beam: beam search (beam 4) held against the JAX fixture at full width
   in float32 (all 4 hypotheses of a 12-step search); the full-width bf16
   serving path at ``beam_size=4, n_best=4`` on 32 images (128 decode
   rows) through ``MolNexTR.predict_images`` in both cache forms, with the
   launch counters zeroed before and read after; the demo bundle's n-best
   lists against the JAX package's in float32, and its hits in bf16;
8. rerank: the port draws the demo SMILES itself (``generate_synthetic_image``,
   default style, 128 px; pixel-equal to the JAX package's renders in
   ``demo.npz``), the demo bundle reads them at bf16 with the int8 KV
   cache, beam 4, n-best 4 and ``rerank="roundtrip"`` through
   ``MolNexTR.predict_images`` (launch counters zeroed before and read
   after: K1, K2 and K3-int8 must run), hits against gold; then the port's
   ``roundtrip_rerank`` on every case of ``fixtures/rerank.npz`` must pick
   the JAX package's winner; the host's ms per image for drawing and for
   rerank are logged; the reactions of ``fixtures/reaction.npz`` drawn by
   ``generate_reaction_image`` must equal the JAX package's drawings pixel
   for pixel, with the same labels and graphs; the one-thread augmenting
   data pipeline's items/s over 64 ``generate_corpus(seed=0)`` SMILES with
   the native matcher and with ``MOLNEXTR_NO_NATIVE=1`` (each after a
   warm-up; both must build the same items);
9. train: the training path at full width.  ``Config()`` in float32 with
   ``seeded_flax_params(seed=0)``, dropout 0 and remat on, against the JAX
   package's loss terms, per-group gradient norms, gradient leaves and the
   leaves after two optimizer updates on ``fixtures/train.npz``'s batch of
   2; 30 bf16 steps with dropout on one batch of 16 of the port's own
   renders (the loss falls); K1 and K2 at 0 launches during train steps,
   and K1, K2, K3-int8 above 0 during the eval step and ``evaluate_model``;
   ``train_loop`` for 2 epochs with a checkpoint written, read back by
   ``load_model`` and resumed for a third; ms per optimizer step at batch
   32 (bf16, remat, dropout), images/s, peak memory, the step's parts and
   a profiler window; the host's augmented 384 px items per second over
   ``generate_corpus(seed=0)``'s drug-like SMILES, in one thread and in
   the spawn pool, each after a warm-up;
10. dp: data parallel at full width (``Config()``, remat on).  A world of
   one rank over NCCL in this process: two float32 steps on
   ``train.npz``'s batch against the step with no process group (expected
   0 apart), then bf16 steps at batch 32 of both forms in turns, and the
   gradient reduction and the count all-reduce timed alone.  Then two
   spawned gloo ranks sharing ``cuda:0``: ``evaluate_model`` of the seeded
   weights on 8 ``generate_corpus(seed=0)`` SMILES (bf16, int8 cache; each
   rank's K1, K2, K3-int8 launches above 0, rank 0's scores equal one
   process's, rank 1's ``{}``), then two float32 steps on 16 rows a rank of
   a global batch of 32, the ranks' parameters equal bit for bit and rank
   0's held to one process on all 32 rows; step ms, reduction ms and peak
   memory a rank;
11. cli: the console entry points.  ``predict.main`` (the demo bundle,
   bf16) on every PNG form of ``fixtures/demo_0.png`` (grey, grey+alpha,
   RGB, RGBA at 8 and 16 bits, palette, Adam7), which must read to the
   same pixels and give ``demo.npz``'s SMILES, with the launch counters
   zeroed before and read after; once more as ``python3 -m
   molnextr_tpu_torch.predict`` in a new process; the JPEG, TIFF and
   oriented PNG forms of ``fixtures/forms`` (4:2:0, 4:2:2, 4:4:4, 4:1:1,
   progressive, restart markers, grey, EXIF orientation 6; LZW with
   predictor 2, Deflate, PackBits, tiled, 16-bit, G4; PNG ``eXIf``) read
   by ``imread`` to the arrays ``cv2.imread`` gave (``arrays.npz``), and
   ``predict.main`` on them with the counters zeroed before and read after
   (K1, K2, K3-int8 above 0; each SMILES equal to demo_0.png's and to the
   JAX package's on that form; tokens equal to demo_0.png's, the lossy
   JPEG forms' within one coordinate bin); which of the files this
   machine's cv2 reads to the same arrays (information only); the
   readers' host ms per image and per megapixel on 1024 x 1024 JPEG
   4:2:0, progressive JPEG, TIFF LZW and TIFF G4; ``evaluate_cli.main`` on
   the PNG forms' output (exact match 1.0); ``train.main`` at full width (Swin-B 384,
   batch 32, 3 steps, 8 workers, evaluation on 8 SMILES), whose bundle
   ``MolNexTR`` reads back and predicts with;
12. convnext: ``Config()`` with ``encoder.name = "convnext_base"``
   (ConvNeXt-B, depths 3/3/27/3, dims 128-1024, 384 px) in float32
   against ``fixtures/convnext.npz``; bf16 serving with the int8 KV cache
   at batch 32 through ``MolNexTR.predict_images`` (launch counters: K1 =
   K2 = 0, K3-int8 = 6 x the decode steps taken); encode ms per batch;
   three train steps through ``train.main --encoder convnext_base`` at
   batch 32, ms per step and peak memory;
13. suites: ``benchmarks.run_all`` on the demo bundle (n 16) and
   ``suite_train_throughput`` at full width (batch 32, 8 workers), each
   suite's dict on a line and gated on the JAX suites' keys; and which of
   PIL, torchvision, pandas and cv2 import on the card's machine;
14. timing: batch 32, bf16, int8 cache, 480 forced decode steps, the edge
   head on all 128 atom slots; then each kernel's time over one batch's
   launches (K3-K6: one 480-step decode) beside its bound, its plain
   version and a library call, and K3-dense with its split forced to one
   CTA per (b, h); then the beam-4 decode of the same batch (480 forced
   steps on 128 rows): ms per step, the cache reorder's ms per step, and
   K3-int8's launches and time at 128 rows beside their bound.

The build's ``nvcc -Xptxas -v`` report (registers, spills) is logged per
kernel; each phase logs its seconds.

The last three lines are the kernels line, the card line and the device
line.  ``--phases`` runs a subset (for development); the contract run uses
every phase.  Exits non-zero, printing no result, without a CUDA card or
outside a checkout.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("kernels", "parity", "paths", "ops", "demo", "beam", "rerank", "train", "dp", "cli",
          "convnext", "suites", "timing")
# the ops package exports the K4 function under its module's name
DA_MODULE = "molnextr_tpu_torch.ops.decode_attention"

# peak rates of one H100 SXM (NVIDIA data sheet, dense): bytes/s of HBM3 and
# operations/s by type (bf16 on the tensor cores, float32 on the CUDA cores,
# which is where the float32 kernels run)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# the card's tolerances: float32 kernels against float32 plain versions
# (summation order only); bf16 relative to the output's max magnitude (both
# round at the same points, a one-ulp flip of an intermediate propagates)
F32_TOL = 1e-4
BF16_RTOL = 3e-2

STAGES = ((96, 128, 4, 2), (48, 256, 8, 2), (24, 512, 16, 18), (12, 1024, 32, 2))  # res, C, heads, depth
SWIN_L_LAST = ((12, 1536, 48, 2),)  # Swin-L (embed_dim 192), stage 4: held in phase kernels only
WS = 12
BATCH = 32
DEC_L, DEC_H, DEC_T, DEC_D, DEC_STEPS = 6, 8, 512, 32, 480
# positions checked in phase kernels: pos 0, pos below the cluster size (8
# for K5/K6 at B 32, 2 for K3/K4 at B 32 x H 8), and pos on and either side
# of slice boundaries of the split plan (ops/_launch.py::split_plan: cluster
# slices of ceil((pos + 1) / cluster) positions each)
CHECK_POS = (0, 3, 7, 8, 9, 63, 64, 65, 127, 128, 300, 479)
# beam search: batch 32 x beam 4 = 128 decode rows, 1024 (b, h) groups of K3
BEAM = 4
BEAM_ROWS = BATCH * BEAM
BEAM_CHECK_POS = (0, 7, 8, 255, 479)
TIMED_ITERS = 2  # after one warm-up iteration
# phase train: the overfit run, the timed steps, the loop's corpus
TRAIN_OVERFIT_BATCH, TRAIN_OVERFIT_STEPS = 16, 30
TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS = 3, 12
TRAIN_SMILES = ("CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CCCCC1", "CCOC", "CN", "CO",
                "CCC", "CCCl", "CBr", "CCS", "CC=C", "C#N", "CCCO", "COC",
                "CC(=O)Oc1ccccc1C(=O)O", "CN1C=NC2=C1C(=O)N(C)C(=O)N2C",
                "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "OC(=O)c1ccccc1O")
# the data pipeline's rate: drug-like SMILES from generate_corpus, timed
# after a warm-up, in one thread and in a spawn pool of up to 8 workers
DATA_ITEMS, DATA_WARMUP_ITEMS, DATA_POOL_WORKERS = 256, 8, 8
MATCHER_ITEMS, MATCHER_WARMUP_ITEMS = 64, 8
READER_REPS = 3  # reads of each 1024 x 1024 file for the reader timings
# phase dp: the world-2 run's global batch (16 rows a rank), the total updates
# of its schedule (warmup 1: the first update's rate is 0), the timed bf16
# steps of each world-1 form, the evaluation's SMILES, the ranks' join limit
DP_BATCH, DP_TOTAL_STEPS, DP_TIMED_STEPS, DP_EVAL_ITEMS, DP_JOIN_S = 32, 10, 3, 8, 240
# the evaluations' decode batch: a rank's share of the 8 SMILES, so one
# process decodes each image in a batch of the same shape as its rank does
DP_EVAL_BATCH = 4
# small molecules the demo bundle reads (7 of 8 on the CPU), each prediction
# distinct: its evaluation shows a gather that loses, zeroes or reorders rows
DP_DEMO_SMILES = ("C", "CC", "CCO", "CCC", "CCN", "CCCC", "OCCO", "CC(C)O")
# phases cli and convnext: the train CLI's corpus (3 batches of 32) and valid set
CLI_TRAIN_ITEMS, CLI_VALID_ITEMS = 96, 8
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """CUDA-event timing of a callable; ``graph=True`` captures ``reps``
    calls in a CUDA graph first, so host launch overhead is left out."""

    def __init__(self, torch):
        self.torch = torch

    def ms(self, fn, reps: int, graph: bool = False, warmup: int = 1) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        if graph:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(reps):
                    fn()
            g.replay()
            torch.cuda.synchronize()
            run = g.replay
            calls = 1
        else:
            run = fn
            calls = reps
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps


def check_close(name: str, got, want, torch, dtype) -> float:
    e = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        tol = F32_TOL
    else:
        tol = BF16_RTOL * max(1.0, float(want.float().abs().max()))
    ok = e <= tol and bool(torch.isfinite(got.float()).all())
    log(f"  {name}: max_abs_err {e:.3e} (tol {tol:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return e


# ---------------------------------------------------------------------------
# work and bound of one call, from its shapes
# ---------------------------------------------------------------------------


def k1_work(b, res, c, heads, ws, shifted, es):
    t, n = b * res * res, ws * ws
    nw = (res // ws) ** 2
    bytes_ = 2 * t * c * es + 4 * c * c * es + 6 * c * 4 + heads * n * n * 4
    bytes_ += nw * n * n * 4 if shifted else 0
    ops = 2 * t * c * 4 * c + 4 * t * n * c
    return bytes_, ops


def k2_work(t, c, f, es):
    return 2 * t * c * es + 2 * c * f * es + (f + 3 * c) * 4, 4 * t * c * f


def k3_work(b, h, d, pos, es, q8):
    per_pos = 2 * d * (1 if q8 else es) + (8 if q8 else 0)
    return b * h * ((pos + 1) * per_pos + 2 * d * es), 4 * b * h * (pos + 1) * d


def folded_work(b, d_model, pos, es):
    """K5/K6: q and out (B, D), K and V rows 0..pos of one layer."""
    return b * ((pos + 1) * 2 * d_model * es + 2 * d_model * es), 4 * b * (pos + 1) * d_model


class Bound:
    """Sums the least time of a run of calls: per call the larger of its
    bytes over HBM bandwidth and its operations over the type's peak."""

    def __init__(self):
        self.ms = self.bytes_ms = self.ops_ms = 0.0

    def add(self, bytes_, ops, dtype_name, count=1):
        tb = bytes_ / HBM_BYTES_PER_S * 1e3
        to = ops / PEAK_OPS[dtype_name] * 1e3
        self.ms += count * max(tb, to)
        self.bytes_ms += count * tb
        self.ops_ms += count * to

    @property
    def by(self):
        return "operations" if self.ops_ms > self.bytes_ms else "bytes"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def window_inputs(torch, gen, b, res, c, heads, ws, shifted, dtype):
    from molnextr_tpu_torch.models.swin import shift_attn_mask

    dev = DEVICE
    n = ws * ws

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    mask = None
    if shifted:
        import numpy as np

        mb = shift_attn_mask(res, res, ws, ws // 2)
        mask = torch.from_numpy(np.where(mb, -100.0, 0.0).astype(np.float32)).to(dev)
    return (
        randn(b, res, res, c).to(dtype),
        randn(c, 3 * c, scale=c ** -0.5).to(dtype), randn(3 * c, scale=0.1),
        randn(c, c, scale=c ** -0.5).to(dtype), randn(c, scale=0.1),
        1.0 + randn(c, scale=0.1), randn(c, scale=0.1),
        randn(heads, n, n, scale=0.5), mask, heads, ws,
    )


def mlp_inputs(torch, gen, t, c, dtype):
    dev = DEVICE

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    f = 4 * c
    return (
        randn(t, c).to(dtype), 1.0 + randn(c, scale=0.1), randn(c, scale=0.1),
        randn(c, f, scale=c ** -0.5).to(dtype), randn(f, scale=0.1),
        randn(f, c, scale=f ** -0.5).to(dtype), randn(c, scale=0.1),
    )


def cache_inputs(torch, gen, dtype, q8, batch=BATCH):
    from molnextr_tpu_torch.ops.decode_attention import quantize_per_token

    shape = (DEC_L, batch, DEC_H, DEC_T, DEC_D)
    q = torch.randn(batch, DEC_H, DEC_D, generator=gen, device=DEVICE).to(dtype)
    k = torch.randn(*shape, generator=gen, device=DEVICE)
    v = torch.randn(*shape, generator=gen, device=DEVICE)
    if q8:
        kq, ks = quantize_per_token(k)
        vq, vs = quantize_per_token(v)
        return q, kq, ks, vq, vs
    return q, k.to(dtype), v.to(dtype)


def folded_inputs(torch, gen, dtype):
    """q (B, D) and a head-folded stacked cache (L, B, T, D), D = H * d."""
    dm = DEC_H * DEC_D
    q = torch.randn(BATCH, dm, generator=gen, device=DEVICE).to(dtype)
    k = torch.randn(DEC_L, BATCH, DEC_T, dm, generator=gen, device=DEVICE).to(dtype)
    v = torch.randn(DEC_L, BATCH, DEC_T, dm, generator=gen, device=DEVICE).to(dtype)
    return q, k, v


def phase_kernels(torch, results):
    from molnextr_tpu_torch.ops import folded_attention as fa
    from molnextr_tpu_torch.ops import swin_fused as sf

    da = importlib.import_module(DA_MODULE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    errs = {k: 0.0 for k in ("fused_window_attention", "fused_ln_mlp",
                             "decode_attention_layered_q8", "decode_attention_layered",
                             "decode_attention", "folded_decode_attention",
                             "folded_decode_attention_bb")}
    log("phase kernels: each kernel against its plain version")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        cases = [(BATCH, res, c, heads, WS, shifted)
                 for res, c, heads, _ in STAGES
                 for shifted in ((False, True) if res > WS else (False,))]
        cases += [(BATCH, 32, 48, 3, 4, False), (BATCH, 32, 48, 3, 4, True)]  # demo stage 0, hd 16
        # widths beyond Swin-B's: hd 64 (N 144), a 7 x 7 window (N 49), a
        # 14 x 14 window (N 196)
        cases += [(BATCH, res, c, heads, ws, shifted)
                  for res, c, heads, ws in ((24, 256, 4, 12), (28, 96, 3, 7), (28, 128, 4, 14))
                  for shifted in (False, True)]
        # Swin-L's last stage: rows too wide to stay in the LN GEMM's shared
        # memory, LayerNormed apart
        cases += [(BATCH, res, c, heads, WS, False) for res, c, heads, _ in SWIN_L_LAST]
        for b, res, c, heads, ws, shifted in cases:
            args = window_inputs(torch, gen, b, res, c, heads, ws, shifted, dtype)
            got = sf.fused_window_attention(*args)
            want = sf.window_attention_reference(*args)
            torch.cuda.synchronize()
            name = f"K1 {dn} res {res} C {c} heads {heads} ws {ws} {'shifted' if shifted else 'unshifted'}"
            errs["fused_window_attention"] = max(
                errs["fused_window_attention"], check_close(name, got, want, torch, dtype))
            del args, got, want
        for res, c, _, _ in STAGES + SWIN_L_LAST:
            args = mlp_inputs(torch, gen, BATCH * res * res, c, dtype)
            got = sf.fused_ln_mlp(*args)
            want = sf.ln_mlp_reference(*args)
            torch.cuda.synchronize()
            errs["fused_ln_mlp"] = max(errs["fused_ln_mlp"], check_close(
                f"K2 {dn} T {BATCH * res * res} C {c}", got, want, torch, dtype))
            del args, got, want
        for q8 in (True, False):
            ins = cache_inputs(torch, gen, dtype, q8)
            for pos in CHECK_POS:
                for layer in (0, 5):
                    if q8:
                        got = da.decode_attention_layered_q8(*ins, pos, layer)
                        want = da.decode_attention_layered_q8_reference(*ins, pos, layer)
                        key = "decode_attention_layered_q8"
                    else:
                        got = da.decode_attention_layered(*ins, pos, layer)
                        want = da.decode_attention_layered_reference(*ins, pos, layer)
                        key = "decode_attention_layered"
                    torch.cuda.synchronize()
                    errs[key] = max(errs[key], check_close(
                        f"K3 {'int8' if q8 else 'dense'} q {dn} pos {pos} layer {layer}",
                        got, want, torch, dtype))
                    if not q8:  # K4 on the same layer as an unstacked cache
                        q, kc, vc = ins
                        got = da.decode_attention(q, kc[layer], vc[layer], pos)
                        want = da.decode_attention_reference(q, kc[layer], vc[layer], pos)
                        torch.cuda.synchronize()
                        errs["decode_attention"] = max(errs["decode_attention"], check_close(
                            f"K4 {dn} pos {pos} layer {layer}", got, want, torch, dtype))
            del ins
        # K3-int8 at the beam's rows (B 32 x beam 4)
        ins = cache_inputs(torch, gen, dtype, True, batch=BEAM_ROWS)
        for pos in BEAM_CHECK_POS:
            got = da.decode_attention_layered_q8(*ins, pos, 5)
            want = da.decode_attention_layered_q8_reference(*ins, pos, 5)
            torch.cuda.synchronize()
            errs["decode_attention_layered_q8"] = max(errs["decode_attention_layered_q8"], check_close(
                f"K3 int8 q {dn} B {BEAM_ROWS} pos {pos} layer 5", got, want, torch, dtype))
        del ins
        # K4 at head width 64
        q = torch.randn(BATCH, DEC_H, 64, generator=gen, device=DEVICE).to(dtype)
        kc = torch.randn(BATCH, DEC_H, DEC_T, 64, generator=gen, device=DEVICE).to(dtype)
        vc = torch.randn(BATCH, DEC_H, DEC_T, 64, generator=gen, device=DEVICE).to(dtype)
        for pos in (0, 7, 9, 300, 511):
            got = da.decode_attention(q, kc, vc, pos)
            want = da.decode_attention_reference(q, kc, vc, pos)
            torch.cuda.synchronize()
            errs["decode_attention"] = max(errs["decode_attention"], check_close(
                f"K4 {dn} d 64 pos {pos}", got, want, torch, dtype))
        del q, kc, vc
        ins = folded_inputs(torch, gen, dtype)
        for pos in CHECK_POS:
            for layer in (0, 5):
                want = fa.folded_decode_attention_reference(*ins, pos, layer, DEC_H)
                runs = [("folded_decode_attention", "K5",
                         fa.folded_decode_attention(*ins, pos, layer, DEC_H))]
                for bb in (8, 4):
                    runs.append(("folded_decode_attention_bb", f"K6 bb {bb}",
                                 fa.folded_decode_attention_bb(*ins, pos, layer, DEC_H, bb=bb)))
                torch.cuda.synchronize()
                for key, label, got in runs:
                    errs[key] = max(errs[key], check_close(
                        f"{label} {dn} pos {pos} layer {layer}", got, want, torch, dtype))
        del ins
    torch.cuda.empty_cache()
    results["max_abs_err"] = errs


def fixture_path(name):
    return os.path.join(HERE, "molnextr_tpu_torch", "fixtures", name)


def phase_parity(torch):
    from molnextr_tpu_torch.config import Config

    log("phase parity: Config() float32, seeded_flax_params(seed=0), against the JAX fixture")
    model_parity(torch, "full_width.npz", Config())


def model_parity(torch, name, cfg, params=None):
    """``cfg`` in float32 with ``seeded_flax_params`` (or ``params``, the
    same tree made by the caller) against a JAX fixture (``full_width.npz``,
    ``convnext.npz``): the memory bank of its two renders, then the greedy
    steps' log-probs and tokens.  Returns the largest errors."""
    import numpy as np

    from molnextr_tpu_torch.data.transforms import device_normalize
    from molnextr_tpu_torch.decoding.greedy import greedy_decode
    from molnextr_tpu_torch.models.model import MolNexTRModel
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.weights import load_flax_params, seeded_flax_params

    ref = np.load(fixture_path(name))
    meta = json.loads(str(ref["meta"]))
    toks = get_tokenizer(cfg.data)
    vocab = {f: len(t) for f, t in toks.items()}
    if params is None:
        params = seeded_flax_params(cfg, vocab, meta["seed"])
    model = load_flax_params(MolNexTRModel(cfg, vocab), params).to(DEVICE).eval()
    fmt = meta["format"]
    with torch.no_grad():
        images = device_normalize(torch.from_numpy(ref["images"]).to(DEVICE))
        memory = model.encode(images)
        mem_err = float((memory.cpu() - torch.from_numpy(ref["memory"])).abs().max())
        log(f"  memory bank {tuple(memory.shape)}: max_abs_err {mem_err:.3e} "
            f"(tol {meta['memory_tol']:.0e}, max |ref| {float(np.abs(ref['memory']).max()):.3f})")
        if not mem_err <= meta["memory_tol"]:
            raise AssertionError(f"memory bank disagrees with the JAX fixture {name}")
        tc, cm = toks[fmt].constraint_tables()
        steps = []

        def step(tok, pos, cache):  # the decode step, recording its log-probs
            logits, hidden, cache = model.decode_step(fmt, tok, pos, cache)
            steps.append(torch.log_softmax(logits.float(), dim=-1))
            return logits, hidden, cache

        seq, _, _, _ = greedy_decode(
            step, lambda m: model.init_cache(fmt, m), memory,
            torch.as_tensor(tc, device=DEVICE).long(), torch.as_tensor(cm, device=DEVICE),
            ref["tokens"].shape[1], cfg.decoder.hidden_size,
            use_constraint=bool(toks[fmt].output_constraint),
        )
    tokens = seq[:, :len(steps)].cpu().numpy()
    logp = torch.stack(steps, dim=1).cpu().numpy()
    tol = meta["logp_tol"]
    worst = 0.0
    for b in range(tokens.shape[0]):
        for s in range(ref["tokens"].shape[1]):
            e = float(np.abs(logp[b, s] - ref["logp"][b, s]).max())
            worst = max(worst, e)
            gap = float(ref["gap"][b, s])
            log(f"  image {b} step {s}: token {tokens[b, s]} (JAX {ref['tokens'][b, s]}), "
                f"log-prob max_abs_err {e:.3e} (tol {tol:.0e}), JAX top-2 gap {gap:.3e}")
            if not e <= tol:
                raise AssertionError(f"log-probs disagree with the JAX fixture {name}")
            if tokens[b, s] != ref["tokens"][b, s]:
                if gap < 2 * tol:
                    log(f"  image {b}: the JAX top-2 gap is below the tolerance; "
                        "either token is right, comparison stops here")
                    break
                raise AssertionError(f"greedy token disagrees with the JAX fixture {name}")
    del model
    torch.cuda.empty_cache()
    return {"memory_max_abs_err": mem_err, "logp_max_abs_err": worst}


def drive_api(torch, api, images, label, batch_size=16):
    """One run of the serving path through MolNexTR.predict_images with the
    launch counters zeroed before and read after."""
    from molnextr_tpu_torch.ops import LAUNCHES, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    out = api.predict_images(images, return_atoms_bonds=True, return_confidence=True,
                             batch_size=batch_size)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    log(f"  {label}: {len(out)} images in {time.perf_counter() - t0:.2f} s, launches {json.dumps(counts)}")
    for o in out:
        if not isinstance(o["predicted_smiles"], str) or o["confidence"] is None:
            raise AssertionError(f"{label}: malformed result {o}")
    return out, counts


def phase_paths(torch, results):
    import numpy as np

    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.config import Config

    log("phase paths: full width (Config(), seeded weights, bf16) through MolNexTR.predict_images")
    rng = np.random.RandomState(1)
    renders = np.load(fixture_path("full_width.npz"))["images"]
    # the API takes RGB uint8 images of any size: two stored renders plus
    # two seeded noise images of another size
    images = [np.repeat(r, 3, axis=2) for r in renders]
    images += [rng.randint(0, 256, (300, 420, 3)).astype(np.uint8) for _ in range(2)]
    paths = {}
    for kv in ("1", "0"):
        os.environ["MOLNEXTR_KV_INT8"] = kv
        api = MolNexTR(cfg=Config(), device=DEVICE, num_workers=1)
        label = "int8 KV cache (default)" if kv == "1" else "dense KV cache (MOLNEXTR_KV_INT8=0)"
        _, counts = drive_api(torch, api, images, label)
        paths["int8" if kv == "1" else "dense"] = counts
        del api
        torch.cuda.empty_cache()
    os.environ.pop("MOLNEXTR_KV_INT8")
    check_path_kernels(paths)
    results["paths"] = paths


def check_path_kernels(paths):
    """Each cache form's run launched K1, K2 and its own K3, and not the
    other form's."""
    need = {"int8": ("fused_window_attention", "fused_ln_mlp", "decode_attention_layered_q8"),
            "dense": ("fused_window_attention", "fused_ln_mlp", "decode_attention_layered")}
    for path, names in need.items():
        for name in names:
            if paths[path][name] == 0:
                raise AssertionError(f"{path} path never launched {name}")
    if paths["int8"]["decode_attention_layered"] or paths["dense"]["decode_attention_layered_q8"]:
        raise AssertionError("a path launched the other cache form's kernel")


OPS_KERNELS = ("decode_attention", "folded_decode_attention", "folded_decode_attention_bb")


def phase_ops(torch, results):
    """The public ops entry points of K4-K6, which the JAX package gives
    these kernels, over one full-width bf16 decode: every position of
    every layer, a new query each step."""
    from molnextr_tpu_torch import ops

    log(f"phase ops: molnextr_tpu_torch.ops over {DEC_STEPS} positions x {DEC_L} layers, "
        f"batch {BATCH}, bf16")
    bf = torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    _, kc, vc = cache_inputs(torch, gen, bf, False)  # (L, B, H, T, d)
    _, kf, vf = folded_inputs(torch, gen, bf)  # (L, B, T, H * d)
    qs = torch.randn(DEC_STEPS, BATCH, DEC_H, DEC_D, generator=gen, device=DEVICE).to(bf)
    qf = qs.reshape(DEC_STEPS, BATCH, DEC_H * DEC_D)
    kept = {(0, 0): None, (127, 5): None, (128, 3): None, (479, 5): None}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for pos in range(DEC_STEPS):
        for layer in range(DEC_L):
            outs = (ops.cached_decode_attention(qs[pos], kc[layer], vc[layer], pos),
                    ops.cached_folded_attention(qf[pos], kf, vf, pos, layer, DEC_H),
                    ops.folded_decode_attention_bb(qf[pos], kf, vf, pos, layer, DEC_H))
            if (pos, layer) in kept:
                kept[pos, layer] = outs
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    log(f"  {DEC_STEPS * DEC_L} steps x 3 calls in {time.perf_counter() - t0:.2f} s, "
        f"launches {json.dumps(counts)}")
    for name, n in counts.items():
        want = DEC_STEPS * DEC_L if name in OPS_KERNELS else 0
        if n != want:
            raise AssertionError(f"phase ops: {name} launched {n} times, expected {want}")
    for (pos, layer), (k4, k5, k6) in kept.items():
        want4 = ops.decode_attention_reference(qs[pos], kc[layer], vc[layer], pos)
        want5 = ops.folded_decode_attention_reference(qf[pos], kf, vf, pos, layer, DEC_H)
        check_close(f"K4 pos {pos} layer {layer}", k4, want4, torch, bf)
        check_close(f"K5 pos {pos} layer {layer}", k5, want5, torch, bf)
        check_close(f"K6 bb 8 pos {pos} layer {layer}", k6, want5, torch, bf)
    results["ops"] = counts
    del kc, vc, kf, vf, qs, kept
    torch.cuda.empty_cache()


def phase_demo(torch):
    import numpy as np

    from molnextr_tpu_torch.api import MolNexTR, MolNexTRSingleton, get_predictions
    from molnextr_tpu_torch.chem import canonicalize_smiles

    log("phase demo: examples/demo_model (bf16, int8 KV cache) through MolNexTR")
    bundle = os.path.join(HERE, "examples", "demo_model")
    fx = np.load(fixture_path("demo.npz"))
    meta = json.loads(str(fx["meta"]))
    api = MolNexTR(model_path=bundle, device=DEVICE, num_workers=1)
    preds = api.predict_images(list(fx["images"]), return_atoms_bonds=True, return_confidence=True)
    smiles = [p["predicted_smiles"] for p in preds]
    canon = [canonicalize_smiles(s)[0] for s in smiles]
    hits = sum(c == canonicalize_smiles(g)[0] for c, g in zip(canon, meta["gold"]))
    agree = sum(a == b for a, b in zip(smiles, meta["jax_bf16"]["smiles"]))
    for s, g, j in zip(smiles, meta["gold"], meta["jax_bf16"]["smiles"]):
        log(f"  {s!r:28} gold {g!r:14} JAX bf16 {j!r}")
    log(f"  hits {hits}/6 against gold (need >= 4); SMILES equal to the JAX package's: {agree}/6")
    if hits < 4:
        raise AssertionError("demo bundle: fewer than 4/6 hits")
    os.environ["MOLNEXTR_MODEL_PATH"] = bundle
    MolNexTRSingleton.reset()
    res = get_predictions(fixture_path("demo_0.png"), atoms_bonds=True, device=DEVICE)
    log(f"  get_predictions(demo_0.png): {res['predicted_smiles']!r} on {res['device_info']} "
        f"in {res['prediction_time_seconds']:.3f} s")
    if canonicalize_smiles(res["predicted_smiles"])[0] != canon[0]:
        raise AssertionError("get_predictions on the PNG disagrees with predict_images")
    MolNexTRSingleton.reset()
    del api
    torch.cuda.empty_cache()


def capture_engine(api):
    """Record the engine's predictions (the n-best lists live there) while
    MolNexTR.predict_images runs its path unchanged."""
    seen = []
    inner = api.engine.predict_images

    def predict_images(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.extend(out)
        return out

    api.engine.predict_images = predict_images
    return seen


def check_n_best(preds, fmt, label):
    for p in preds:
        beams = p["beams"]
        scores = [b["score"] for b in beams]
        if len(beams) != BEAM or scores != sorted(scores, reverse=True):
            raise AssertionError(f"{label}: n-best list not {BEAM} entries sorted by score: {beams}")
        if beams[0]["smiles"] != p[fmt]["smiles"]:
            raise AssertionError(f"{label}: beams[0] is not the top-1 hypothesis")


def phase_beam(torch):
    beam_parity(torch)
    beam_paths(torch)
    beam_demo(torch)


def beam_parity(torch):
    """Full-width float32 beam search against the JAX fixture."""
    import numpy as np

    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.data.transforms import device_normalize
    from molnextr_tpu_torch.decoding.beam import beam_decode
    from molnextr_tpu_torch.models.model import MolNexTRModel
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.weights import load_flax_params, seeded_flax_params

    ref = np.load(fixture_path("full_width.npz"))
    meta = json.loads(str(ref["meta"]))
    steps, tol = meta["beam_steps"], meta["beam_score_tol"]
    log(f"phase beam: Config() float32, beam {meta['beam_size']}, {meta['beam_max_len']} steps, "
        "against the JAX fixture")
    for s in range(meta["beam_max_len"]):
        log(f"  step {s}: JAX gap between candidates {BEAM} and {BEAM + 1}: "
            + ", ".join(f"{g:.3e}" for g in ref["beam_gap"][:, s])
            + f" (2 x what the sums may differ by: {2 * (s + 1) * meta['logp_tol']:.1e})")
    if steps < meta["beam_max_len"]:
        log(f"  a gap at step {steps} is below twice what the candidates may differ by there: "
            f"the comparison stops there, holding the search cut to {steps} steps")
    cfg = Config()
    toks = get_tokenizer(cfg.data)
    vocab = {f: len(t) for f, t in toks.items()}
    fmt = meta["format"]
    model = load_flax_params(MolNexTRModel(cfg, vocab), seeded_flax_params(cfg, vocab, meta["seed"]))
    model = model.to(DEVICE).eval()
    tc, cm = toks[fmt].constraint_tables()
    with torch.no_grad():
        memory = model.encode(device_normalize(torch.from_numpy(ref["images"]).to(DEVICE)))
        out = beam_decode(
            lambda t, p, c: model.decode_step(fmt, t, p, c), lambda m: model.init_cache(fmt, m),
            memory, torch.as_tensor(tc, device=DEVICE).long(), torch.as_tensor(cm, device=DEVICE),
            steps, cfg.decoder.hidden_size, beam_size=meta["beam_size"],
            min_len=cfg.decode.min_length, use_constraint=bool(toks[fmt].output_constraint),
            return_all=True, unroll=cfg.decode.unroll,
        )
    all_seq, all_scores = out[4].cpu().numpy(), out[5].cpu().numpy()
    for b in range(all_seq.shape[0]):
        want = {tuple(q): sc for q, sc in zip(ref["beam_seq"][b].tolist(), ref["beam_scores"][b])}
        got = {tuple(q): sc for q, sc in zip(all_seq[b].tolist(), all_scores[b])}
        if set(got) != set(want) or len(got) != meta["beam_size"]:
            raise AssertionError(f"image {b}: beam hypotheses differ from the JAX fixture\n"
                                 f"  got  {sorted(got)}\n  want {sorted(want)}")
        err = max(abs(float(got[q]) - float(want[q])) for q in want)
        log(f"  image {b}: {len(got)} hypotheses equal to JAX's token for token; "
            f"score max_abs_err {err:.3e} (tol {tol:.0e})")
        if not err <= tol or list(all_scores[b]) != sorted(all_scores[b], reverse=True):
            raise AssertionError("beam scores disagree with the JAX fixture or are not sorted")
    del model, memory, out
    torch.cuda.empty_cache()


def beam_paths(torch):
    """The full-width serving path at beam 4 on 32 images, both cache forms."""
    import numpy as np

    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.config import Config

    renders = np.load(fixture_path("full_width.npz"))["images"]
    log(f"  full width (Config(), seeded weights, bf16) at beam_size={BEAM}, n_best={BEAM} "
        f"on {BATCH} images ({BEAM_ROWS} decode rows) through MolNexTR.predict_images")
    rng = np.random.RandomState(3)
    images = [np.repeat(r, 3, axis=2) for r in renders]
    images += [rng.randint(0, 256, (300 + 3 * i, 420 - 2 * i, 3)).astype(np.uint8)
               for i in range(BATCH - len(images))]
    paths = {}
    for kv in ("1", "0"):
        os.environ["MOLNEXTR_KV_INT8"] = kv
        cfg = Config()
        cfg.decode.beam_size = cfg.decode.n_best = BEAM
        api = MolNexTR(cfg=cfg, device=DEVICE, num_workers=1)
        seen = capture_engine(api)
        label = "beam, int8 KV cache" if kv == "1" else "beam, dense KV cache"
        _, counts = drive_api(torch, api, images, label, batch_size=BATCH)
        check_n_best(seen, api.engine.fmt, label)
        steps_run = counts["decode_attention_layered_q8" if kv == "1" else "decode_attention_layered"]
        log(f"  {label}: K1 {counts['fused_window_attention']} and K2 {counts['fused_ln_mlp']} "
            f"launches (24 each per encode), K3 {steps_run} = {DEC_L} x {steps_run / DEC_L:g} "
            f"steps on {BEAM_ROWS} rows; every n-best list has {BEAM} entries sorted by score")
        if counts["fused_window_attention"] != 24 or counts["fused_ln_mlp"] != 24 \
                or steps_run % DEC_L:
            raise AssertionError(f"{label}: unexpected launch counts {counts}")
        paths["int8" if kv == "1" else "dense"] = counts
        del api
        torch.cuda.empty_cache()
    os.environ.pop("MOLNEXTR_KV_INT8")
    check_path_kernels(paths)


def beam_demo(torch):
    """The demo bundle's n-best lists against the JAX package's."""
    import numpy as np

    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.chem import canonicalize_smiles
    from molnextr_tpu_torch.checkpoint import load_model

    fx = np.load(fixture_path("demo.npz"))
    dmeta = json.loads(str(fx["meta"]))
    bundle = os.path.join(HERE, "examples", "demo_model")
    for bf16 in (False, True):
        dn = "bf16" if bf16 else "f32"
        cfg, params = load_model(bundle)
        cfg.train.bf16 = bf16
        cfg.decode.beam_size = cfg.decode.n_best = BEAM
        api = MolNexTR(cfg=cfg, params=params, device=DEVICE, num_workers=1)
        seen = capture_engine(api)
        preds = api.predict_images(list(fx["images"]), batch_size=8)
        check_n_best(seen, api.engine.fmt, f"demo {dn}")
        jax_nbest = dmeta[f"jax_{dn}_beam4"]
        nbest = [[b["smiles"] for b in p["beams"]] for p in seen]
        for got, want, g_sc, w_sc in zip(nbest, jax_nbest["smiles"], seen, jax_nbest["scores"]):
            err = max(abs(b["score"] - w) for b, w in zip(g_sc["beams"], w_sc))
            log(f"  demo {dn} n-best {got} (JAX {want}), score max_abs_err {err:.2e}")
        equal = sum(g == w for g, w in zip(nbest, jax_nbest["smiles"]))
        hits = sum(canonicalize_smiles(p["predicted_smiles"])[0] == canonicalize_smiles(g)[0]
                   for p, g in zip(preds, dmeta["gold"]))
        log(f"  demo {dn} at beam {BEAM}: n-best lists equal to JAX's {equal}/6, "
            f"top-1 hits against gold {hits}/6")
        if not bf16 and equal != 6:
            raise AssertionError("demo f32: the n-best SMILES differ from the JAX package's")
        if bf16 and hits < 4:
            raise AssertionError("demo bf16 at beam 4: fewer than 4/6 hits")
        del api
        torch.cuda.empty_cache()


def phase_rerank(torch, results, card):
    """Round-trip rerank at beam 4 on the demo bundle, on images the port
    draws itself, and the rerank fixture against the JAX package's
    winners."""
    import dataclasses
    import random

    import numpy as np

    from molnextr_tpu_torch import rerank
    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.chem import canonicalize_smiles
    from molnextr_tpu_torch.checkpoint import load_model
    from molnextr_tpu_torch.data.synthetic import generate_synthetic_image
    from molnextr_tpu_torch.ops import LAUNCHES, reset_launch_counts

    log(f"phase rerank: demo bundle (bf16, int8 KV cache) at beam {BEAM} with "
        f"rerank='roundtrip' on the port's own renders")
    fx = np.load(fixture_path("demo.npz"))
    dmeta = json.loads(str(fx["meta"]))
    draw_ms = []
    for _ in range(2):  # the first pass also loads the glyph table and builds the cap tables
        random.seed(5)  # as the fixture's renders were drawn
        t0 = time.perf_counter()
        renders = []
        for smi in dmeta["inputs"]:
            img, _, _, ok = generate_synthetic_image(smi, mol_augment=False,
                                                     default_option=True, size=128)
            if not ok:
                raise AssertionError(f"rerank: the port failed to draw {smi}")
            renders.append(img)
        draw_ms.append((time.perf_counter() - t0) * 1e3 / len(renders))
        same = sum(np.array_equal(a, b) for a, b in zip(renders, fx["images"]))
        if same != len(renders):
            raise AssertionError(f"rerank: {len(renders) - same} of the port's renders differ "
                                 "from the JAX package's")
    render_ms = draw_ms[1]
    log(f"  drew the {len(renders)} demo images, pixel-equal to the JAX package's renders, "
        f"in {draw_ms[0]:.2f} ms each (first pass) and {draw_ms[1]:.2f} ms (second) on the host")

    cfg, params = load_model(os.path.join(HERE, "examples", "demo_model"))
    cfg.train.bf16 = True
    cfg.decoder = dataclasses.replace(cfg.decoder, kv_int8=True)
    cfg.decode.beam_size = cfg.decode.n_best = BEAM
    cfg.decode.rerank = "roundtrip"
    api = MolNexTR(cfg=cfg, params=params, device=DEVICE, num_workers=1)
    api.predict_images(renders[:1])  # warm-up, off the counts
    spent = []
    inner = rerank.roundtrip_rerank

    def timed(*args, **kwargs):
        t = time.perf_counter()
        out = inner(*args, **kwargs)
        spent.append(time.perf_counter() - t)
        return out

    rerank.roundtrip_rerank = timed
    try:
        random.seed(0)
        reset_launch_counts()
        t0 = time.perf_counter()
        preds = api.predict_images(renders, batch_size=8)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        total_s = time.perf_counter() - t0
    finally:
        rerank.roundtrip_rerank = inner
    rerank_ms = sum(spent) * 1e3 / len(renders)
    hits = sum(canonicalize_smiles(p["predicted_smiles"])[0] == canonicalize_smiles(g)[0]
               for p, g in zip(preds, dmeta["gold"]))
    for p, g in zip(preds, dmeta["gold"]):
        log(f"  {p['predicted_smiles']!r:28} gold {g!r}")
    log(f"  {len(renders)} images in {total_s:.2f} s, launches {json.dumps(counts)}")
    log(f"  hits {hits}/{len(renders)} against gold on the port's renders (need >= 4)")
    if hits < 4:
        raise AssertionError("rerank: fewer than 4/6 demo hits at beam 4 with rerank")
    for name in ("fused_window_attention", "fused_ln_mlp", "decode_attention_layered_q8"):
        if counts[name] == 0:
            raise AssertionError(f"rerank path never launched {name}")
    del api
    torch.cuda.empty_cache()

    rx = np.load(fixture_path("rerank.npz"))
    rmeta = json.loads(str(rx["meta"]))
    worst, t0 = 0.0, time.perf_counter()
    for k, case in enumerate(rmeta["cases"]):
        random.seed(rmeta["seed"] + k)
        winner, scores = rerank.roundtrip_rerank(rx[f"image_{k}"], case["candidates"])
        if winner != case["winner"] or len(scores) != len(case["scores"]):
            raise AssertionError(f"rerank fixture {case['name']}: winner {winner!r}, "
                                 f"JAX {case['winner']!r}")
        if scores:
            worst = max(worst, max(abs(a - b) for a, b in zip(scores, case["scores"])))
    fixture_ms = (time.perf_counter() - t0) * 1e3 / len(rmeta["cases"])
    log(f"  rerank fixture: {len(rmeta['cases'])}/{len(rmeta['cases'])} winners equal the JAX "
        f"package's, score max_abs_err {worst:.2e}, {fixture_ms:.2f} ms per case (host)")
    log(f"  host ms per image: drawing {render_ms:.2f}, rerank {rerank_ms:.2f} "
        f"(card: {card})")
    results["rerank"] = {"launches": counts, "hits": hits, "render_ms": render_ms,
                         "render_first_ms": draw_ms[0], "rerank_ms": rerank_ms,
                         "fixture_ms": fixture_ms, "reactions": reaction_drawings(),
                         "matcher": matcher_pipeline_rate(card)}


def reaction_drawings():
    """``generate_reaction_image`` on ``fixtures/reaction.npz``'s reactions,
    each after the seeds it was drawn with: the image pixel for pixel, the
    label and the graph must equal the JAX package's."""
    import random

    import numpy as np

    from molnextr_tpu_torch.data.reaction import generate_reaction_image

    fx = np.load(fixture_path("reaction.npz"))
    rows = json.loads(str(fx["meta"]))
    t0 = time.perf_counter()
    for k, row in enumerate(rows):
        random.seed(k)
        np.random.seed(k)
        image, label, graph, ok = generate_reaction_image(row["reaction"],
                                                          mol_augment=row["mol_augment"])
        same = (ok == row["ok"] and label == row["label"]
                and np.array_equal(image, fx[f"image_{k}"])
                and graph.get("symbols", []) == row["symbols"]
                and [[float(v) for v in c] for c in graph.get("coords", [])] == row["coords"]
                and np.array_equal(np.asarray(graph.get("edges", np.zeros((0, 0)))),
                                   fx[f"edges_{k}"]))
        if not same:
            raise AssertionError(f"reaction {row['reaction']!r}: the port's drawing, label or "
                                 "graph differs from the JAX package's")
    ms = (time.perf_counter() - t0) * 1e3 / len(rows)
    log(f"  reactions: {len(rows)}/{len(rows)} drawings pixel-equal to the JAX package's "
        f"(reaction.npz), labels and graphs equal, {ms:.2f} ms each (host)")
    return {"n": len(rows), "ms_per_reaction": ms}


def matcher_pipeline_rate(card):
    """Items per second of the one-thread augmenting data pipeline (384 px,
    ``Config()``'s data options) over ``MATCHER_ITEMS`` SMILES of
    ``generate_corpus(seed=0)``, with ``MOLNEXTR_NO_NATIVE=1`` and with the
    native matcher in turns (Python, native, native, Python), each run after
    ``MATCHER_WARMUP_ITEMS`` items and from the same seeds, with the time
    spent inside the matcher per item; every run must build the same items."""
    import random

    import numpy as np

    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.data import synthetic
    from molnextr_tpu_torch.data.corpus import generate_corpus
    from molnextr_tpu_torch.data.dataset import Sample, TrainDataset
    from molnextr_tpu_torch.tokenization import get_tokenizer

    cfg = Config()
    toks = get_tokenizer(cfg.data)
    smiles = generate_corpus(MATCHER_WARMUP_ITEMS + MATCHER_ITEMS, seed=0)
    inner = synthetic.find_substructures
    spent = []

    def timed(*args, **kwargs):
        t = time.perf_counter()
        out = inner(*args, **kwargs)
        spent.append(time.perf_counter() - t)
        return out

    runs, first = {"python": [], "native": []}, {}
    synthetic.find_substructures = timed
    try:
        for name in ("python", "native", "native", "python"):
            os.environ["MOLNEXTR_NO_NATIVE"] = "1" if name == "python" else ""
            random.seed(0)
            np.random.seed(0)
            ds = TrainDataset(cfg, [Sample(s) for s in smiles], toks)
            for i in range(MATCHER_WARMUP_ITEMS):
                ds[i]
            spent.clear()
            t0 = time.perf_counter()
            built = [ds[i] for i in range(MATCHER_WARMUP_ITEMS, len(smiles))]
            wall = time.perf_counter() - t0
            runs[name].append({"items_per_s": len(built) / wall,
                               "matcher_ms_per_item": sum(spent) * 1e3 / len(built),
                               "matcher_calls": len(spent)})
            images = [None if b is None else b["image"] for b in built]
            if name in first and not all(
                    (a is None and b is None) or (a is not None and b is not None
                                                  and np.array_equal(a, b))
                    for a, b in zip(first[name], images)):
                raise AssertionError(f"two {name} runs of the data pipeline built different items")
            first.setdefault(name, images)
    finally:
        synthetic.find_substructures = inner
        os.environ.pop("MOLNEXTR_NO_NATIVE", None)
    same = all((a is None and b is None) or (a is not None and b is not None
                                             and np.array_equal(a, b))
               for a, b in zip(first["native"], first["python"]))
    log(f"  data pipeline, one thread, {MATCHER_ITEMS} generate_corpus(seed=0) SMILES after "
        f"{MATCHER_WARMUP_ITEMS}, in turns (host of {card}): " + json.dumps(runs))
    if not same:
        raise AssertionError("the native and the Python matcher built different items")
    return runs


def read_train_fixture(path):
    """``fixtures/train.npz`` -> (batch {"images", "refs"}, gradient leaves,
    the leaves after two updates, meta)."""
    import numpy as np

    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    meta = json.loads(str(arrays.pop("meta")))
    batch = {"images": arrays["images"],
             "refs": {k[4:]: v for k, v in arrays.items() if k.startswith("ref_")}}
    n = len(meta["leaves"])
    return (batch, [arrays[f"grad_{i}"] for i in range(n)],
            [arrays[f"after_{i}"] for i in range(n)], meta)


def _leaf_names(leaves):
    """Flax paths of the fixture's leaves -> the port's parameter names."""
    from molnextr_tpu_torch.weights import flax_to_state_dict

    names = []
    for leaf in leaves:
        parts = leaf.split("/")
        tree = {}
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = None
        (name,) = flax_to_state_dict({"params": tree}).keys()
        names.append(name)
    return names


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


def train_parity(torch):
    """Config() float32, rates 0, remat on: the fixture's batch of 2 through
    the port's train step pieces, each number against the JAX package's."""
    import numpy as np

    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.models.model import MolNexTRModel
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.train.loop import _criterion
    from molnextr_tpu_torch.train.state import create_train_state
    from molnextr_tpu_torch.train.wire import as_model_images, as_model_refs

    batch, grads, after, meta = read_train_fixture(fixture_path("train.npz"))
    tols = meta["tols"]
    cfg = Config()
    cfg.train.bf16 = False
    cfg.encoder.drop_path_rate = 0.0
    cfg.decoder.hidden_dropout = cfg.decoder.attn_dropout = 0.0
    cfg.encoder.use_remat = cfg.decoder.use_remat = True
    toks = get_tokenizer(cfg.data)
    vocab = {f: len(t) for f, t in toks.items()}
    state = create_train_state(cfg, MolNexTRModel(cfg, vocab), meta["total_steps"],
                               seed=meta["seed"], device=DEVICE)
    criterion = _criterion(cfg, toks)
    refs = as_model_refs(batch["refs"], DEVICE)
    outputs = state.model(as_model_images(batch["images"], DEVICE), refs, dropout_seed=0)
    total, losses = criterion(outputs, refs)
    total.backward()
    errs = {}
    got = {"loss": total.item(), **{k: v.item() for k, v in losses.items()}}
    for name, want in meta["losses"].items():
        e = _rel(got[name], want)
        tol = tols["loss_rtol"] if not name.startswith("acc_") else 1e-6
        log(f"  {name}: {got[name]:.6f} (JAX {want:.6f}), rel err {e:.2e} (tol {tol:.0e})")
        if not e <= tol:
            raise AssertionError(f"train parity: {name} disagrees with the JAX fixture")
        errs[name] = e
    norms = state.optimizer.group_norms()
    for group, want in meta["grad_norms"].items():
        e = _rel(float(norms[group]), want)
        log(f"  {group} gradient norm: {float(norms[group]):.6f} (JAX {want:.6f}), "
            f"rel err {e:.2e} (tol {tols['grad_norm_rtol']:.0e})")
        if not e <= tols["grad_norm_rtol"]:
            raise AssertionError(f"train parity: {group} gradient norm disagrees")
        errs[f"norm_{group}"] = e
    params = dict(state.model.named_parameters())
    names = _leaf_names(meta["leaves"])
    for leaf, name, want in zip(meta["leaves"], names, grads):
        g = params[name].grad.detach().cpu().numpy()
        e = float(np.abs(g - want).max() / np.abs(want).max())
        log(f"  grad {leaf}: max err / max |g| {e:.2e} (tol {tols['grad_rtol']:.0e})")
        if not e <= tols["grad_rtol"]:
            raise AssertionError(f"train parity: gradient of {leaf} disagrees")
        errs[f"grad {leaf}"] = e
    for _ in range(meta["updates"]):  # the same gradient, as the fixture's updates
        state.optimizer.step()
    for leaf, name, want in zip(meta["leaves"], names, after):
        e = float(np.abs(params[name].detach().cpu().numpy() - want).max())
        log(f"  {leaf} after {meta['updates']} updates: max abs err {e:.2e} "
            f"(tol {tols['param_atol']:.0e})")
        if not e <= tols["param_atol"]:
            raise AssertionError(f"train parity: {leaf} after the updates disagrees")
        errs[f"after {leaf}"] = e
    del state, outputs, total
    torch.cuda.empty_cache()
    return errs


def overfit_batch(cfg, toks, n):
    """A fixed batch of ``n`` of the port's own renders of the loop's corpus
    (default style, no augmentation), on the wire."""
    import copy
    import random as pyrandom

    import numpy as np

    from molnextr_tpu_torch.data.dataset import Sample, TrainDataset, pad_batch
    from molnextr_tpu_torch.utils import FORMAT_INFO

    dcfg = copy.deepcopy(cfg)
    dcfg.data.augment = dcfg.data.mol_augment = False
    dcfg.data.default_style = True
    pyrandom.seed(0)
    np.random.seed(0)
    ds = TrainDataset(dcfg, [Sample(s) for s in TRAIN_SMILES], toks)
    items = [it for it in (ds[i] for i in range(len(ds))) if it is not None]
    items = (items * (n // len(items) + 1))[:n]
    fmt = next(f for f in cfg.data.formats if f != "edges")
    max_len = min(FORMAT_INFO[fmt]["max_len"], cfg.decoder.max_len)
    batch = pad_batch(items, cfg.data.formats, max_len, cfg.data.max_atoms)
    batch.pop("smiles")
    batch["refs"].pop("num_atoms")
    return batch


def train_breakdown(torch, cfg, criterion, state, batch, steps=3):
    """CUDA-event times of the parts of one train step (the wire to the
    device, forward and loss, backward, the optimizer), median over
    ``steps`` after a warm-up."""
    import numpy as np

    from molnextr_tpu_torch.models.layers import fold_in
    from molnextr_tpu_torch.train.step import _autocast
    from molnextr_tpu_torch.train.wire import as_model_images, as_model_refs

    model, parts = state.model, []
    dev = torch.device(DEVICE)
    for i in range(steps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        for p in model.parameters():
            p.grad = None
        ev[0].record()
        refs = as_model_refs(batch["refs"], dev)
        images = as_model_images(batch["images"], dev)
        ev[1].record()
        with _autocast(cfg, dev):
            outputs = model(images, refs, dropout_seed=fold_in(5, i))
        total, _ = criterion(outputs, refs)
        ev[2].record()
        total.backward()
        ev[3].record()
        state.optimizer.step()
        ev[4].record()
        torch.cuda.synchronize()
        if i:
            parts.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
    med = np.median(np.asarray(parts), axis=0)
    return dict(zip(("wire_ms", "forward_loss_ms", "backward_ms", "optimizer_ms"), map(float, med)))


def train_profile(torch, cfg, criterion, state, batch, steps=2, top=12):
    """``torch.profiler`` over ``steps`` train steps: the summed device time
    of the CUDA kernels against the host's wall time (the device's busy
    share), and the kernels that take the most of it."""
    from molnextr_tpu_torch.train.step import train_step

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step(cfg, criterion, state, batch, seed=4)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(  # noqa: E731
        e, "self_cuda_time_total", 0)
    busy = sum(dev_us(e) for e in kernels) / 1e3
    if not kernels or busy <= 0:
        return {"device_ms_per_step": None, "note": "the profiler recorded no device time"}
    ranked = sorted(kernels, key=dev_us, reverse=True)[:top]
    return {"wall_ms_per_step": wall / steps, "device_ms_per_step": busy / steps,
            "device_busy_share": busy / wall,
            "top_kernels": [{"name": e.key[:90], "ms_per_step": dev_us(e) / 1e3 / steps,
                             "calls_per_step": e.count / steps} for e in ranked]}


def phase_train(torch, results, card):
    import shutil

    import numpy as np

    from molnextr_tpu_torch.checkpoint import load_model
    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.data.dataset import Sample
    from molnextr_tpu_torch.models.model import MolNexTRModel
    from molnextr_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.train.loop import _criterion, evaluate_model, serving_engine, train_loop
    from molnextr_tpu_torch.train.state import create_train_state
    from molnextr_tpu_torch.train.step import eval_step, train_step
    from molnextr_tpu_torch.weights import _flatten, model_to_flax_params

    log("phase train: Config() float32, seeded_flax_params(seed=0), dropout 0, remat on, "
        "against the JAX fixture (train.npz, batch 2)")
    out = {"parity_errors": train_parity(torch)}

    cfg = Config()  # bf16, dropout and drop-path on, remat on
    toks = get_tokenizer(cfg.data)
    vocab = {f: len(t) for f, t in toks.items()}
    criterion = _criterion(cfg, toks)
    batch = overfit_batch(cfg, toks, TRAIN_OVERFIT_BATCH)
    log(f"  overfit: {TRAIN_OVERFIT_STEPS} bf16 steps with dropout on one batch of "
        f"{TRAIN_OVERFIT_BATCH} renders")
    state = create_train_state(cfg, MolNexTRModel(cfg, vocab), TRAIN_OVERFIT_STEPS, seed=0,
                               device=DEVICE)
    reset_launch_counts()
    losses = [float(train_step(cfg, criterion, state, batch, seed=1)["loss"])
              for _ in range(TRAIN_OVERFIT_STEPS)]
    torch.cuda.synchronize()
    train_counts = dict(LAUNCHES)
    log(f"  loss by step: {' '.join(f'{x:.3f}' for x in losses)}")
    log(f"  launches during the train steps: {json.dumps(train_counts)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("overfit: the loss is not finite or did not fall")
    if train_counts["fused_window_attention"] or train_counts["fused_ln_mlp"]:
        raise AssertionError("a train step launched K1 or K2: training must take the module path")

    reset_launch_counts()
    ev = eval_step(cfg, criterion, state.model, batch)
    torch.cuda.synchronize()
    eval_counts = dict(LAUNCHES)
    reset_launch_counts()
    engine = serving_engine(cfg, toks, DEVICE)
    valid = [Sample(s) for s in TRAIN_SMILES[16:]]
    scores = evaluate_model(cfg, state.model, toks, valid, num_workers=1, engine=engine)
    torch.cuda.synchronize()
    evaluate_counts = dict(LAUNCHES)
    log(f"  eval step loss {float(ev['loss']):.4f}, launches {json.dumps(eval_counts)}")
    log(f"  evaluate_model {json.dumps(scores)}, launches {json.dumps(evaluate_counts)}")
    for name in ("fused_window_attention", "fused_ln_mlp"):
        if not eval_counts[name] or not evaluate_counts[name]:
            raise AssertionError(f"the eval step or evaluate_model never launched {name}")
    if not evaluate_counts["decode_attention_layered_q8"]:
        raise AssertionError("evaluate_model never launched K3-int8")
    if not state.model.training or state.model.enc_trans.kernel.dtype != torch.float32:
        raise AssertionError("evaluation changed the training module's mode or dtype")
    out.update(overfit_first=losses[0], overfit_last=losses[-1], train_launches=train_counts,
               eval_step_launches=eval_counts, evaluate_launches=evaluate_counts,
               eval_scores=scores)
    del engine

    # card numbers: batch 32, bf16, remat, dropout; CUDA events per step
    big = {"images": np.concatenate([batch["images"]] * (BATCH // TRAIN_OVERFIT_BATCH)),
           "refs": {k: np.concatenate([v] * (BATCH // TRAIN_OVERFIT_BATCH))
                    for k, v in batch["refs"].items()}}
    for _ in range(TRAIN_WARMUP_STEPS):
        train_step(cfg, criterion, state, big, seed=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_TIMED_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        train_step(cfg, criterion, state, big, seed=2)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    ms = float(np.median(times))
    timing = {"batch": BATCH, "dtype": "bf16", "remat": True, "ms_per_step": ms,
              "ms_min": min(times), "ms_max": max(times), "steps": TRAIN_TIMED_STEPS,
              "images_per_s": BATCH / ms * 1e3,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    log("  train step " + json.dumps(timing))
    parts = train_breakdown(torch, cfg, criterion, state, big)
    log("  train step parts, median ms " + json.dumps(parts))
    try:
        prof = train_profile(torch, cfg, criterion, state, big)
    except (RuntimeError, AttributeError) as e:  # a measurement, not a check
        prof = {"device_ms_per_step": None, "note": f"profiler failed: {e!r}"}
    log("  train step profile " + json.dumps(prof))
    out["timing"] = dict(timing, parts=parts, profile=prof)
    del state, big
    torch.cuda.empty_cache()

    out["data"] = data_pipeline_rate(cfg, toks)

    # the loop: 2 epochs, a checkpoint, read back, resumed for a third
    save = os.path.join(HERE, "output", "chip_smoke_train")
    shutil.rmtree(save, ignore_errors=True)
    lcfg = Config()
    lcfg.train.epochs, lcfg.train.batch_size, lcfg.train.train_steps_per_epoch = 2, 4, 3
    lcfg.train.save_path, lcfg.train.save_mode = save, "last"
    samples = [Sample(s) for s in TRAIN_SMILES[:16]]
    t0 = time.perf_counter()
    state = train_loop(lcfg, samples, valid_samples=valid, num_workers=0, print_freq=1,
                       device=DEVICE)
    loop_s = time.perf_counter() - t0
    _, params = load_model(os.path.join(save, "ckpt_last"))
    saved, live = _flatten(params), _flatten(model_to_flax_params(state.model))
    if set(saved) != set(live) or any(not np.array_equal(saved[k], live[k]) for k in live):
        raise AssertionError("the checkpoint read back differs from the trained parameters")
    lcfg.train.epochs = 3
    state = train_loop(lcfg, samples, valid_samples=valid, num_workers=0, print_freq=1,
                       resume="last", device=DEVICE)
    with open(os.path.join(save, "metrics.jsonl")) as f:
        epochs = [json.loads(line)["epoch"] for line in f]
    log(f"  train_loop: 2 epochs in {loop_s:.1f} s, checkpoint read back equal, resumed to "
        f"step {state.step}, metrics epochs {epochs}")
    if state.step != 9 or epochs != [0, 1, 2]:
        raise AssertionError("train_loop did not resume from its checkpoint")
    out["loop"] = {"seconds_2_epochs": loop_s, "resumed_step": state.step}
    del state
    shutil.rmtree(save, ignore_errors=True)
    torch.cuda.empty_cache()
    results["train"] = out



def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_config(bf16):
    """``Config()`` at full width with remat on; float32 runs take dropout
    and drop-path 0, so a world of ranks can be held to one process."""
    from molnextr_tpu_torch.config import Config

    cfg = Config()
    cfg.train.bf16 = bf16
    cfg.encoder.use_remat = cfg.decoder.use_remat = True
    if not bf16:
        cfg.encoder.drop_path_rate = 0.0
        cfg.decoder.hidden_dropout = cfg.decoder.attn_dropout = 0.0
    return cfg


def dp_state(cfg, toks, mesh=None):
    from molnextr_tpu_torch.models.model import MolNexTRModel
    from molnextr_tpu_torch.train.state import create_train_state

    return create_train_state(cfg, MolNexTRModel(cfg, {f: len(t) for f, t in toks.items()}),
                              DP_TOTAL_STEPS, seed=0, device=DEVICE, mesh=mesh)


def params_gap(torch, a, b):
    """Largest absolute difference between two models' parameters."""
    return max(float((p - q).detach().abs().max()) for p, q in zip(a.parameters(), b.parameters()))


def read_predictions(path):
    """The rows of ``evaluate_model``'s predictions CSV, header first (None
    where no file was written: a rank other than 0)."""
    import csv

    if not os.path.exists(path):
        return None
    with open(path, newline="") as f:
        return list(csv.reader(f))


def dp_eval(torch, cfg, toks, model, dump_csv):
    """``evaluate_model`` in bf16 with the int8 cache over the first
    ``DP_EVAL_ITEMS`` SMILES of ``generate_corpus(seed=0)``, with the launch
    counters zeroed before and read after; returns the scores, the counts
    and the predictions CSV's rows."""
    from molnextr_tpu_torch.data.corpus import generate_corpus
    from molnextr_tpu_torch.data.dataset import Sample
    from molnextr_tpu_torch.train.loop import evaluate_model, serving_engine

    serve = dp_config(bf16=True)
    engine = serving_engine(serve, toks, DEVICE)
    samples = [Sample(s) for s in generate_corpus(DP_EVAL_ITEMS, seed=0)]
    scores, launches = count_launches(torch, lambda: evaluate_model(
        serve, model, toks, samples, num_workers=1, batch_size=DP_EVAL_BATCH, engine=engine,
        dump_csv=dump_csv))
    return scores, launches, read_predictions(dump_csv)


def dp_demo_eval(dump_csv):
    """``evaluate_model`` of the trained demo bundle (bf16, int8 cache) over
    ``DP_DEMO_SMILES``; returns the scores and the predictions CSV's rows."""
    import dataclasses

    from molnextr_tpu_torch.checkpoint import load_model
    from molnextr_tpu_torch.data.dataset import Sample
    from molnextr_tpu_torch.models.model import MolNexTRModel
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.train.loop import evaluate_model
    from molnextr_tpu_torch.weights import load_flax_params

    cfg, params = load_model(os.path.join(HERE, "examples", "demo_model"))
    cfg.train.bf16 = True
    cfg.decoder = dataclasses.replace(cfg.decoder, kv_int8=True)
    toks = get_tokenizer(cfg.data)
    model = MolNexTRModel(cfg, {f: len(t) for f, t in toks.items()})
    load_flax_params(model, params)
    scores = evaluate_model(cfg, model.to(DEVICE), toks, [Sample(s) for s in DP_DEMO_SMILES],
                            num_workers=1, batch_size=DP_EVAL_BATCH, dump_csv=dump_csv)
    return scores, read_predictions(dump_csv)


def dp_rank(rank, port, work):
    """One rank of the world-2 run: gloo, sharing ``cuda:0`` with the other.
    Evaluates the seeded weights and the demo bundle, then takes two
    float32 steps on its 16 rows of the global batch; writes its numbers
    (rank 0 its predictions and parameters too) to ``work``."""
    import hashlib

    import numpy as np
    import torch

    from molnextr_tpu_torch.parallel.distributed import initialize, shutdown
    from molnextr_tpu_torch.parallel.mesh import axis_group, make_mesh, shard_batch
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.train.loop import _criterion
    from molnextr_tpu_torch.train.step import reduce_gradients, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize(backend="gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
               local_rank=rank, device="cuda:0")
    try:
        cfg = dp_config(bf16=False)
        toks = get_tokenizer(cfg.data)
        mesh = make_mesh(device="cuda:0")
        state = dp_state(cfg, toks, mesh)
        scores, launches, rows = dp_eval(torch, cfg, toks, state.model,
                                         os.path.join(work, f"eval_rank{rank}.csv"))
        demo_scores, demo_rows = dp_demo_eval(os.path.join(work, f"demo_rank{rank}.csv"))
        with np.load(os.path.join(work, "batch.npz")) as f:
            batch = {"images": f["images"],
                     "refs": {k[4:]: f[k] for k in f.files if k.startswith("ref_")}}
        local = shard_batch(mesh, batch)
        criterion = _criterion(cfg, toks)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for _ in range(2):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            losses.append(float(train_step(cfg, criterion, state, local, seed=0)["loss"]))
            e1.record()
            torch.cuda.synchronize()
            step_ms.append(e0.elapsed_time(e1))
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()  # the reduction alone, on the last step's gradients
        reduce_gradients(state.model, axis_group(mesh, "data"))
        e1.record()
        torch.cuda.synchronize()
        flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
        digest = hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()
        if rank == 0:
            torch.save({n: p.detach().cpu() for n, p in state.model.named_parameters()},
                       os.path.join(work, "rank0_params.pt"))
        out = {"rank": rank, "rows": int(local["images"].shape[0]), "losses": losses,
               "step_ms": step_ms, "reduce_ms": e0.elapsed_time(e1),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "params_sha256": digest, "eval_scores": scores, "eval_launches": launches,
               "eval_rows": rows, "demo_scores": demo_scores, "demo_rows": demo_rows}
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        shutdown()


def dp_world_one(torch, card):
    """World 1 over NCCL in this process: the step on a mesh against the
    step with no group, float32 on the fixture's batch of 2; then the
    bf16 step at batch 32, each form timed in turns."""
    import numpy as np

    from molnextr_tpu_torch.parallel.mesh import axis_group, make_mesh
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.train.loop import _criterion
    from molnextr_tpu_torch.train.step import global_denominators, reduce_gradients, train_step
    from molnextr_tpu_torch.train.wire import as_model_refs

    batch, _, _, meta = read_train_fixture(fixture_path("train.npz"))
    cfg = dp_config(bf16=False)
    toks = get_tokenizer(cfg.data)
    criterion = _criterion(cfg, toks)
    mesh = make_mesh(device=DEVICE)
    runs = {}
    for name, m in (("no_group", None), ("no_group_again", None), ("nccl_world_1", mesh)):
        state = dp_state(cfg, toks, m)
        losses = [float(train_step(cfg, criterion, state, batch, seed=0)["loss"])
                  for _ in range(2)]
        runs[name] = (state, losses)
    ref_state, ref_losses = runs["no_group"]
    out = {}
    for name in ("no_group_again", "nccl_world_1"):
        state, losses = runs[name]
        out[name] = {"loss_gap": max(abs(a - b) for a, b in zip(losses, ref_losses)),
                     "param_gap": params_gap(torch, state.model, ref_state.model)}
    log(f"  world 1 over NCCL, float32, fixture batch of 2, 2 steps: losses {ref_losses}; "
        f"against the step with no group {json.dumps(out['nccl_world_1'])} (expected 0); "
        f"the no-group step run twice {json.dumps(out['no_group_again'])}")
    tol = meta["tols"]
    if not (out["nccl_world_1"]["loss_gap"] <= tol["loss_rtol"] * abs(ref_losses[0])
            and out["nccl_world_1"]["param_gap"] <= tol["param_atol"]):
        raise AssertionError("the world-1 NCCL step disagrees with the step with no group")
    del runs, ref_state, state
    torch.cuda.empty_cache()

    # bf16, batch 32 (phase train's timed cell), the two forms in turns
    cfg = dp_config(bf16=True)
    criterion = _criterion(cfg, toks)
    half = overfit_batch(cfg, toks, TRAIN_OVERFIT_BATCH)
    big = {"images": np.concatenate([half["images"]] * (BATCH // TRAIN_OVERFIT_BATCH)),
           "refs": {k: np.concatenate([v] * (BATCH // TRAIN_OVERFIT_BATCH))
                    for k, v in half["refs"].items()}}
    states = {"no_group": dp_state(cfg, toks), "nccl_world_1": dp_state(cfg, toks, mesh)}
    times = {name: [] for name in states}
    for i in range(DP_TIMED_STEPS + 1):
        for name in (("no_group", "nccl_world_1") if i % 2 else ("nccl_world_1", "no_group")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            train_step(cfg, criterion, states[name], big, seed=2)
            e1.record()
            torch.cuda.synchronize()
            if i:  # the first round warms up
                times[name].append(e0.elapsed_time(e1))
    peak = torch.cuda.max_memory_allocated() / 1e9
    group = axis_group(mesh, "data")
    model = states["nccl_world_1"].model
    refs = as_model_refs(big["refs"], torch.device(DEVICE))
    part_ms = {"reduce_gradients": [], "count_all_reduce": []}
    for _ in range(3):
        for name, fn in (("reduce_gradients", lambda: reduce_gradients(model, group)),
                         ("count_all_reduce", lambda: global_denominators(criterion, refs,
                                                                           group))):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            part_ms[name].append(e0.elapsed_time(e1))
    timing = {"batch": BATCH, "dtype": "bf16", "remat": True, "dropout": True,
              "ms_no_group": times["no_group"], "ms_nccl_world_1": times["nccl_world_1"],
              "median_ms_no_group": float(np.median(times["no_group"])),
              "median_ms_nccl_world_1": float(np.median(times["nccl_world_1"])),
              "reduce_gradients_ms": part_ms["reduce_gradients"],
              "count_all_reduce_ms": part_ms["count_all_reduce"],
              "peak_memory_gb_last_step": peak, "card": card}
    log("  world 1 over NCCL, bf16 steps " + json.dumps(timing))
    del states, model
    torch.cuda.empty_cache()
    return {"parity": out, "timing": timing}


def dp_world_two(torch, card):
    """World 2 over gloo: two spawned ranks share ``cuda:0``.  This process
    holds the one-process reference: the same seeded weights and the demo
    bundle evaluated, then two float32 steps on all 32 rows."""
    import multiprocessing as mp
    import shutil

    import numpy as np

    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.train.loop import _criterion
    from molnextr_tpu_torch.train.step import train_step

    cfg = dp_config(bf16=False)
    toks = get_tokenizer(cfg.data)
    work = os.path.join(HERE, "output", "chip_smoke_dp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    batch = overfit_batch(cfg, toks, DP_BATCH)
    np.savez(os.path.join(work, "batch.npz"), images=batch["images"],
             **{f"ref_{k}": v for k, v in batch["refs"].items()})
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=dp_rank, args=(r, port, work)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        # the one-process reference, while the ranks start
        ref = dp_state(cfg, toks)
        ref_scores, ref_launches, ref_rows = dp_eval(torch, cfg, toks, ref.model,
                                                     os.path.join(work, "eval_one.csv"))
        ref_demo_scores, ref_demo_rows = dp_demo_eval(os.path.join(work, "demo_one.csv"))
        criterion = _criterion(cfg, toks)
        ref_losses = [float(train_step(cfg, criterion, ref, batch, seed=0)["loss"])
                      for _ in range(2)]
        deadline = time.monotonic() + DP_JOIN_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"world-2 ranks exited with {codes}")
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    got = torch.load(os.path.join(work, "rank0_params.pt"))
    lr = cfg.train.encoder_lr
    worst = {"tight": 0.0, "loose": 0.0}  # |g| >= 1e-6: param_atol; below: Adam's 2 lr
    for name, p in ref.model.named_parameters():
        err = (got[name].to(p.device) - p.detach()).abs()
        sure = p.grad.abs() >= 1e-6
        worst["tight"] = max(worst["tight"], float(err[sure].max()) if sure.any() else 0.0)
        worst["loose"] = max(worst["loose"], float(err[~sure].max()) if (~sure).any() else 0.0)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], ref_losses))
    for r in ranks:
        log(f"  world 2 over gloo, rank {r['rank']}: {r['rows']} rows, float32 step ms "
            f"{[round(x, 3) for x in r['step_ms']]}, gradient reduction {r['reduce_ms']:.3f} ms, "
            f"peak {r['peak_memory_gb']:.2f} GB, evaluate_model launches "
            f"{json.dumps(r['eval_launches'])} (card: {card})")
    log(f"  world 2 losses {ranks[0]['losses']} against one process on 32 rows {ref_losses}: "
        f"rel gap {loss_gap:.2e}; rank 0 parameters against one process: max abs gap "
        f"{worst['tight']:.2e} where |g| >= 1e-6, {worst['loose']:.2e} elsewhere (2 lr = "
        f"{2 * lr:.0e}); evaluate_model rank 0 {json.dumps(ranks[0]['eval_scores'])}, one "
        f"process {json.dumps(ref_scores)} (launches {json.dumps(ref_launches)}); "
        f"{len(ref_rows) - 1} predictions, {distinct(ref_rows)} distinct, rank 0's in global "
        f"order equal one process's: {ranks[0]['eval_rows'] == ref_rows}")
    log(f"  demo bundle over {len(DP_DEMO_SMILES)} small molecules: rank 0 "
        f"{json.dumps(ranks[0]['demo_scores'])}, one process {json.dumps(ref_demo_scores)}; "
        f"{distinct(ref_demo_rows)} distinct predictions, rank 0's equal one process's: "
        f"{ranks[0]['demo_rows'] == ref_demo_rows}")
    if ranks[0]["params_sha256"] != ranks[1]["params_sha256"]:
        raise AssertionError("the two ranks' parameters differ")
    if not (loss_gap <= 1e-4 and worst["tight"] <= 1e-6 and worst["loose"] <= 2 * lr + 1e-6):
        raise AssertionError("the world-2 step disagrees with the one-process step")
    for r in ranks:
        for name in ("fused_window_attention", "fused_ln_mlp", "decode_attention_layered_q8"):
            if not r["eval_launches"][name]:
                raise AssertionError(f"rank {r['rank']}'s evaluate_model never launched {name}")
    if ranks[0]["eval_scores"] != ref_scores or ranks[1]["eval_scores"] != {}:
        raise AssertionError("the world-2 evaluation's scores are not the one-process scores")
    if ranks[0]["eval_rows"] != ref_rows or ranks[1]["eval_rows"] is not None:
        raise AssertionError("the world-2 evaluation's predictions are not one process's")
    if not (ref_demo_scores["canon_smiles"] > 0
            and distinct(ref_demo_rows) == len(DP_DEMO_SMILES)):
        raise AssertionError("the demo bundle's evaluation cannot show a wrong gather: "
                             f"{json.dumps(ref_demo_scores)}")
    if (ranks[0]["demo_rows"] != ref_demo_rows or ranks[0]["demo_scores"] != ref_demo_scores
            or ranks[1]["demo_scores"] != {}):
        raise AssertionError("the world-2 evaluation of the demo bundle is not one process's")
    del ref, got
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"ranks": ranks, "reference_losses": ref_losses, "loss_rel_gap": loss_gap,
            "param_gap": worst, "reference_scores": ref_scores,
            "reference_demo_scores": ref_demo_scores}


def distinct(rows):
    """How many different predictions (every column after the gold) a
    predictions CSV holds."""
    return len({tuple(r[2:]) for r in rows[1:]})


def phase_dp(torch, results, card):
    from molnextr_tpu_torch.parallel.distributed import initialize, shutdown

    log("phase dp: data parallel at full width (Config(), remat on): world 1 over NCCL in "
        "this process, then world 2 over gloo on this one card")
    initialize(backend="nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
               rank=0, local_rank=0, device=DEVICE)
    try:
        one = dp_world_one(torch, card)
    finally:
        shutdown()
    results["dp"] = {"world_1": one, "world_2": dp_world_two(torch, card)}


def data_pipeline_rate(cfg, toks):
    """Augmented 384 px items per second of ``TrainDataset`` (render,
    augment, tokenize) over ``DATA_ITEMS`` drug-like SMILES of
    ``generate_corpus(seed=0)``: in this thread after ``DATA_WARMUP_ITEMS``
    items, and through ``DataLoader``'s spawn pool at batch 32, timing the
    batches after the first (which carries the pool's start)."""
    import numpy as np

    from molnextr_tpu_torch.chem import num_atoms
    from molnextr_tpu_torch.data.corpus import generate_corpus
    from molnextr_tpu_torch.data.dataset import DataLoader, Sample, TrainDataset

    smiles = generate_corpus(DATA_WARMUP_ITEMS + DATA_ITEMS + BATCH, seed=0)
    atoms = [num_atoms(s) for s in smiles]
    ds = TrainDataset(cfg, [Sample(s) for s in smiles], toks)
    for i in range(DATA_WARMUP_ITEMS):
        ds[i]
    t0 = time.perf_counter()
    built = sum(ds[i] is not None for i in range(DATA_WARMUP_ITEMS, DATA_WARMUP_ITEMS + DATA_ITEMS))
    thread_s = time.perf_counter() - t0
    workers = min(DATA_POOL_WORKERS, len(os.sched_getaffinity(0)))
    pool_ds = TrainDataset(cfg, [Sample(s) for s in smiles[DATA_WARMUP_ITEMS:]], toks)
    loader = DataLoader(pool_ds, batch_size=BATCH, shuffle=False, num_workers=workers)
    pooled = 0
    t0 = time.perf_counter()
    for b, batch in enumerate(loader):
        if b == 0:  # the pool's start and first batch
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
        else:
            pooled += len(batch["smiles"])
    pool_s = time.perf_counter() - t0
    data = {"corpus": "generate_corpus(seed=0)", "input_size": cfg.data.input_size,
            "median_atoms": float(np.median(atoms)), "thread_items": built,
            "thread_seconds": thread_s, "thread_items_per_s": built / thread_s,
            "pool_workers": workers, "pool_first_batch_seconds": first_s,
            "pool_items": pooled, "pool_seconds": pool_s, "pool_items_per_s": pooled / pool_s}
    log("  data pipeline (render, augment, tokenize) " + json.dumps(data))
    if not built or not pooled:
        raise AssertionError("the data pipeline built no item")
    return data

def count_launches(torch, run):
    """``run()`` with the launch counters zeroed before and read after."""
    from molnextr_tpu_torch.ops import LAUNCHES, reset_launch_counts

    reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    return out, dict(LAUNCHES)


def run_cli(main, argv):
    """A console entry point's ``main(argv)`` and what it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def write_csv(path, header, rows):
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return path


def timed_train_main(torch, argv):
    """``molnextr_tpu_torch.train.main(argv)`` with each train step timed by
    CUDA events and the peak device memory read after."""
    from molnextr_tpu_torch.train import loop
    from molnextr_tpu_torch.train import main as train_main

    inner, times = loop.train_step, []

    def timed_step(*args, **kwargs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = inner(*args, **kwargs)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loop.train_step = timed_step
    t0 = time.perf_counter()
    try:
        train_main(argv)
    finally:
        loop.train_step = inner
    return {"wall_s": time.perf_counter() - t0, "step_ms": times,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def corpus_csvs(work, n_train, n_valid):
    """Train and valid CSVs (a ``SMILES`` column) of ``generate_corpus(seed=0)``."""
    from molnextr_tpu_torch.data.corpus import generate_corpus

    smiles = generate_corpus(n_train + n_valid, seed=0)
    return (write_csv(os.path.join(work, "train.csv"), ["SMILES"], [[s] for s in smiles[:n_train]]),
            write_csv(os.path.join(work, "valid.csv"), ["SMILES"],
                      [[s] for s in smiles[n_train:n_train + n_valid]]))


def image_forms(torch, card, bundle, work, want):
    """The JPEG, TIFF and oriented PNG forms of demo_0.png in
    ``fixtures/forms``: each read by ``imread`` to the array ``cv2.imread``
    gave (``arrays.npz``); ``predict.main`` on them (the demo bundle, bf16)
    with the launch counters zeroed before and read after (K1, K2, K3-int8
    above 0), each SMILES equal to demo_0.png's and to the JAX package's on
    that form; the tokens of the lossless forms equal demo_0.png's, those
    of the lossy JPEG forms equal in every symbol and within one bin in
    every coordinate; which files this machine's cv2 reads to the same
    array (information); and the readers' host ms on the 1024 x 1024 files."""
    import numpy as np

    from molnextr_tpu_torch import predict
    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.chem import canonicalize_smiles
    from molnextr_tpu_torch.data.image import imread
    from molnextr_tpu_torch.data.transforms import stack_gray_batch

    folder = fixture_path("forms")
    stored = np.load(os.path.join(folder, "arrays.npz"))
    fmeta = json.loads(str(stored["meta"]))
    names = sorted(f for f in os.listdir(folder) if f != "arrays.npz")
    images = {}
    for name in names:
        images[name] = imread(os.path.join(folder, name))
        if images[name] is None or not np.array_equal(images[name], stored[name]):
            raise AssertionError(f"forms/{name}: imread differs from cv2.imread's array")
    demo = fmeta["names"]
    log(f"  {len(names)} JPEG/TIFF/PNG files read to cv2.imread's arrays: {' '.join(names)}")
    out_json = os.path.join(work, "predict_forms.json")
    paths = [os.path.join(folder, n) for n in demo]
    t0 = time.perf_counter()
    _, counts = count_launches(torch, lambda: predict.main(
        paths + ["--model_path", bundle, "--output", out_json, "--device", DEVICE]))
    predict_s = time.perf_counter() - t0
    with open(out_json) as f:
        preds = json.load(f)
    log(f"  predict.main: {len(preds)} forms in {predict_s:.2f} s, launches {json.dumps(counts)}")
    for name, p, jax_smiles in zip(demo, preds, fmeta["jax_bf16"]["smiles"]):
        got = canonicalize_smiles(p["predicted_smiles"])[0]
        if got != want or got != canonicalize_smiles(jax_smiles)[0]:
            raise AssertionError(f"predict CLI on forms/{name}: {p['predicted_smiles']!r}, the "
                                 f"JAX package's {jax_smiles!r}, demo_0.png's {want!r}")
    for kname in ("fused_window_attention", "fused_ln_mlp", "decode_attention_layered_q8"):
        if not counts[kname]:
            raise AssertionError(f"the predict CLI on the forms never launched {kname}")
    api = MolNexTR(model_path=bundle, device=DEVICE, num_workers=1)
    png = imread(fixture_path("demo_0.png"))
    batch = stack_gray_batch([png] + [images[n] for n in demo], api.transform)
    seq = api.engine.predict_images_raw(batch)["seq"]
    offset = api.engine.tokenizer.offset
    token_gaps = {}
    for name, row in zip(demo, seq[1:]):
        coord = seq[0] >= offset
        gap = np.abs(row.astype(np.int64) - seq[0])
        token_gaps[name] = int((gap > 0).sum())
        lossy = name.endswith(".jpg")
        ok = (gap[~coord] == 0).all() and (gap[coord] <= 1).all() if lossy else not gap.any()
        if not ok or (row >= offset).tolist() != coord.tolist():
            raise AssertionError(f"forms/{name}: tokens {row.tolist()} against demo_0.png's "
                                 f"{seq[0].tolist()}")
    log(f"  tokens against demo_0.png's (positions that differ; JPEG forms by one "
        f"coordinate bin at most, others none): {json.dumps(token_gaps)}")
    del api
    probe = subprocess.run([sys.executable, "-c", CV2_PROBE, folder], capture_output=True,
                           text=True, timeout=300)
    if probe.returncode == 0:
        log(f"  this machine's cv2 reads to the stored array: {probe.stdout.strip()}")
    else:
        log(f"  this machine's cv2 was not compared (exit {probe.returncode}: "
            f"{(probe.stderr.strip().splitlines() or [''])[-1]})")
    timings = {}
    for name in ("big_420.jpg", "big_progressive.jpg", "big_lzw.tif", "big_g4.tif"):
        path = os.path.join(folder, name)
        spent = []
        for _ in range(READER_REPS):
            t0 = time.perf_counter()
            img = imread(path)
            spent.append((time.perf_counter() - t0) * 1e3)
        mpix = img.shape[0] * img.shape[1] / 1e6
        timings[name] = {"ms_per_image": float(np.median(spent)),
                         "ms_per_megapixel": float(np.median(spent)) / mpix,
                         "all_ms": spent, "size": list(img.shape[:2])}
    log("  readers on the host, median of "
        f"{READER_REPS} reads (host of {card}): " + json.dumps(timings))
    return {"files": names, "predict_launches": counts, "predict_s": predict_s,
            "token_gaps": token_gaps, "cv2": probe.stdout.strip(), "readers": timings}


# run in a new process on the card's machine: which files of the forms folder
# that machine's cv2 reads to the array stored beside them
CV2_PROBE = """
import json, os, sys
import cv2
import numpy as np
folder = sys.argv[1]
stored = np.load(os.path.join(folder, 'arrays.npz'))
same = {}
for name in sorted(f for f in os.listdir(folder) if f != 'arrays.npz'):
    img = cv2.imread(os.path.join(folder, name))
    same[name] = img is not None and np.array_equal(cv2.cvtColor(img, cv2.COLOR_BGR2RGB),
                                                    stored[name])
print(json.dumps({'cv2': cv2.__version__, 'same_array': same}))
"""


def phase_cli(torch, results, card):
    """The console entry points on the card: predict on every PNG form of
    demo_0.png (in-process with the launch counters, and once more as a
    subprocess), evaluate on its output, and train at full width, whose
    bundle is read back and predicts."""
    import shutil

    import numpy as np

    from molnextr_tpu_torch import evaluate_cli, predict
    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.chem import canonicalize_smiles
    from molnextr_tpu_torch.data.png import read_png

    log("phase cli: molnextr-torch-predict / -evaluate / -train on the card")
    work = os.path.join(HERE, "output", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    fixtures = os.path.join(HERE, "molnextr_tpu_torch", "fixtures")
    forms = sorted(f for f in os.listdir(fixtures) if f.startswith("demo_0") and f.endswith(".png"))
    paths = [os.path.join(fixtures, f) for f in forms]
    ref = read_png(fixture_path("demo_0.png"))
    for form, path in zip(forms, paths):
        if not np.array_equal(read_png(path), ref):
            raise AssertionError(f"{form}: its pixels differ from demo_0.png")
    log(f"  {len(forms)} PNG forms read to demo_0.png's pixels: {' '.join(forms)}")
    meta = json.loads(str(np.load(fixture_path("demo.npz"))["meta"]))
    want = canonicalize_smiles(meta["jax_bf16"]["smiles"][0])[0]
    bundle = os.path.join(HERE, "examples", "demo_model")
    out_json = os.path.join(work, "predict.json")
    t0 = time.perf_counter()
    _, counts = count_launches(torch, lambda: predict.main(
        paths + ["--model_path", bundle, "--molfile", "--confidence", "--output", out_json,
                 "--device", DEVICE]))
    predict_s = time.perf_counter() - t0
    with open(out_json) as f:
        preds = json.load(f)
    log(f"  predict.main: {len(preds)} images in {predict_s:.2f} s, launches {json.dumps(counts)}")
    for p in preds:
        ok = (canonicalize_smiles(p["predicted_smiles"])[0] == want and p["predicted_molfile"]
              and 0.0 <= p["confidence"] <= 1.0)
        if not ok:
            raise AssertionError(f"predict CLI on {p['image']}: {p['predicted_smiles']!r}, "
                                 f"demo.npz's {meta['jax_bf16']['smiles'][0]!r}")
    for name in ("fused_window_attention", "fused_ln_mlp", "decode_attention_layered_q8"):
        if not counts[name]:
            raise AssertionError(f"the predict CLI never launched {name}")
    log(f"  every form: {preds[0]['predicted_smiles']!r} (demo.npz: "
        f"{meta['jax_bf16']['smiles'][0]!r})")
    forms = image_forms(torch, card, bundle, work, want)
    sub_json = os.path.join(work, "predict_sub.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "molnextr_tpu_torch.predict", paths[0],
                           "--model_path", bundle, "--molfile", "--output", sub_json,
                           "--device", DEVICE],
                          cwd=HERE, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"python3 -m molnextr_tpu_torch.predict failed: {proc.stderr[-3000:]}")
    with open(sub_json) as f:
        sub = json.load(f)
    log(f"  python3 -m molnextr_tpu_torch.predict: {sub[0]['predicted_smiles']!r} in "
        f"{time.perf_counter() - t0:.2f} s (a new process)")
    if canonicalize_smiles(sub[0]["predicted_smiles"])[0] != want:
        raise AssertionError("the predict subprocess disagrees")
    gold = write_csv(os.path.join(work, "gold.csv"), ["image_id", "SMILES"],
                     [[i, meta["gold"][0]] for i in range(len(preds))])
    pred = write_csv(os.path.join(work, "pred.csv"), ["image_id", "SMILES"],
                     [[i, p["predicted_smiles"]] for i, p in enumerate(preds)])
    text = run_cli(evaluate_cli.main, ["--gold_file", gold, "--pred_file", pred,
                                       "--num_workers", "1"])
    scores = json.loads(text[text.index("{"):])
    log(f"  evaluate_cli.main: {json.dumps(scores)} (exact match = canon_smiles)")
    if scores["canon_smiles"] != 1.0 or scores["graph"] != 1.0:
        raise AssertionError("evaluate CLI: exact match below 1.0 on the demo forms")

    train_csv, valid_csv = corpus_csvs(work, CLI_TRAIN_ITEMS, CLI_VALID_ITEMS)
    save = os.path.join(work, "train")
    run = timed_train_main(torch, [
        "--train_file", train_csv, "--valid_file", valid_csv, "--save_path", save,
        "--epochs", "1", "--steps_per_epoch", "3", "--batch_size", str(BATCH),
        "--num_workers", "8", "--device", DEVICE])
    with open(os.path.join(save, "metrics.jsonl")) as f:
        epoch = json.loads(f.readline())
    ckpts = sorted(d for d in os.listdir(save) if d.startswith("ckpt_"))
    log(f"  train.main (Config() Swin-B 384, batch {BATCH}, 3 steps, 8 workers, eval on "
        f"{CLI_VALID_ITEMS}): {run['wall_s']:.1f} s, steps ms "
        f"{' '.join(f'{t:.1f}' for t in run['step_ms'])}, peak {run['peak_memory_gb']:.2f} GB, "
        f"epoch {json.dumps(epoch)}, bundles {ckpts}")
    if epoch["step"] != 3 or not np.isfinite(epoch["train_loss"]) or not ckpts:
        raise AssertionError("train CLI: no 3 finite steps or no bundle written")
    api = MolNexTR(model_path=os.path.join(save, ckpts[0]), device=DEVICE, num_workers=1)
    out = api.predict_image_files([paths[0]])[0]
    log(f"  the trained bundle {ckpts[0]} reloaded: predicts {out['predicted_smiles']!r}")
    if not isinstance(out["predicted_smiles"], str):
        raise AssertionError("the trained bundle did not predict")
    del api
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    results["cli"] = {"predict_launches": counts, "predict_s": predict_s, "scores": scores,
                      "train": run, "forms": forms}


def convnext_config():
    """``Config()`` with the ConvNeXt-B encoder at the config's defaults."""
    from molnextr_tpu_torch.config import Config

    cfg = Config()
    cfg.encoder.name = "convnext_base"
    return cfg


def phase_convnext(torch, results, card):
    """ConvNeXt-B at full width and depth: float32 parity with the JAX
    fixture, the bf16 serving path with the launch counters, encode ms, and
    three train steps through the train CLI."""
    import copy
    import shutil

    import numpy as np

    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.data.transforms import device_normalize
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.weights import seeded_flax_params

    log("phase convnext: Config() with encoder convnext_base (depths 3/3/27/3, dims "
        "128-1024, 384 px), float32 against fixtures/convnext.npz")
    cfg = convnext_config()
    f32 = copy.deepcopy(cfg)
    f32.train.bf16 = False
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    params = seeded_flax_params(cfg, vocab, 0)  # the fixture's seed, and MolNexTR's
    out = {"parity": model_parity(torch, "convnext.npz", f32, params)}

    api = MolNexTR(cfg=cfg, params=params, device=DEVICE, num_workers=1)  # bf16, int8 KV
    renders = np.load(fixture_path("convnext.npz"))["images"]
    rng = np.random.RandomState(2)
    images = [np.repeat(renders[i % 2], 3, axis=2) for i in range(BATCH // 2)]
    images += [rng.randint(0, 256, (300, 420, 3)).astype(np.uint8) for _ in range(BATCH // 2)]
    model, steps = api.model, []
    inner = model.decode_step

    def counted_step(*args, **kwargs):
        steps.append(1)
        return inner(*args, **kwargs)

    model.decode_step = counted_step
    t0 = time.perf_counter()
    preds, counts = count_launches(torch, lambda: api.predict_images(
        images, return_atoms_bonds=True, return_confidence=True, batch_size=BATCH))
    serve_s = time.perf_counter() - t0
    del model.decode_step
    log(f"  serving (bf16, int8 KV cache, batch {BATCH}): {len(preds)} images in "
        f"{serve_s:.2f} s, {len(steps)} decode steps, launches {json.dumps(counts)}")
    if counts["fused_window_attention"] or counts["fused_ln_mlp"]:
        raise AssertionError("the ConvNeXt path launched a Swin kernel")
    if counts["decode_attention_layered_q8"] != DEC_L * len(steps) or not steps:
        raise AssertionError(f"K3-int8 launched {counts['decode_attention_layered_q8']} times, "
                             f"not {DEC_L} x {len(steps)} steps")
    if any(not isinstance(p["predicted_smiles"], str) for p in preds):
        raise AssertionError("ConvNeXt serving: malformed result")

    tm = Timer(torch)
    batch = np.stack([renders[i % 2] for i in range(BATCH)])
    with torch.no_grad():
        x = device_normalize(torch.from_numpy(batch).to(DEVICE))
        encode_ms = tm.ms(lambda: api.model.encode(x), reps=TIMED_ITERS * 5)
    log(f"  encode, batch {BATCH} bf16: {encode_ms:.3f} ms ({card})")
    del api, x
    torch.cuda.empty_cache()

    work = os.path.join(HERE, "output", "chip_smoke_convnext")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    train_csv, _ = corpus_csvs(work, CLI_TRAIN_ITEMS, 0)
    run = timed_train_main(torch, [
        "--train_file", train_csv, "--save_path", os.path.join(work, "train"),
        "--encoder", "convnext_base", "--epochs", "1", "--steps_per_epoch", "3",
        "--batch_size", str(BATCH), "--num_workers", "8", "--no_eval", "--device", DEVICE])
    log(f"  train.main --encoder convnext_base, batch {BATCH} (bf16 autocast, dropout, drop-path "
        f"0.1, no remat): steps ms {' '.join(f'{t:.1f}' for t in run['step_ms'])}, peak "
        f"{run['peak_memory_gb']:.2f} GB, {run['wall_s']:.1f} s in all ({card})")
    if len(run["step_ms"]) != 3:
        raise AssertionError("the ConvNeXt train CLI did not take 3 steps")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    out.update(serving_launches=counts, decode_steps=len(steps), serve_s=serve_s,
               encode_ms=encode_ms, train=run)
    results["convnext"] = out


# the keys each bench suite returns, as the JAX package's suites return them
SCORE_KEYS = {"canon_smiles", "graph", "chiral", "chiral_ratio"}
SUITE_KEYS = {
    "single_image_greedy": {"suite", "first_call_s", "steady_s", "smiles"},
    "batch_greedy": {"suite", "n", "img_per_s"} | SCORE_KEYS,
    "batch_beam": {"suite", "n", "img_per_s"} | SCORE_KEYS,
    "dataset_eval": {"suite", "dataset", "n"} | SCORE_KEYS,
    "perturbed": {"suite", "n"} | SCORE_KEYS,
    "train_throughput": {"suite", "global_batch", "img_per_s", "step_s"},
}


def phase_suites(torch, results, card):
    """The bench suites on the card: ``run_all`` on the demo bundle, the
    train suite at full width, and which image libraries this machine has."""
    from molnextr_tpu_torch import benchmarks
    from molnextr_tpu_torch.checkpoint import load_model
    from molnextr_tpu_torch.config import Config

    log("phase suites: benchmarks.run_all on examples/demo_model (n 16), "
        "suite_train_throughput(Config(), batch 32, 8 workers)")
    cfg, params = load_model(os.path.join(HERE, "examples", "demo_model"))
    t0 = time.perf_counter()
    report, counts = count_launches(torch, lambda: benchmarks.run_all(
        cfg, params, n=16, device=DEVICE))
    log(f"  run_all in {time.perf_counter() - t0:.1f} s, launches {json.dumps(counts)} ({card})")
    tcfg = Config()
    tcfg.train.batch_size = BATCH
    report.append(benchmarks.suite_train_throughput(tcfg, num_workers=8, device=DEVICE))
    for suite in report:
        log("  suite " + json.dumps(suite))
        want = SUITE_KEYS.get(suite["suite"])
        if want is None or set(suite) != want:
            raise AssertionError(f"suite {suite['suite']}: keys {sorted(suite)}, not the JAX "
                                 "package's")
    if len(report) != len(SUITE_KEYS) + 1:
        raise AssertionError(f"run_all returned {len(report) - 1} suites, not {len(SUITE_KEYS)}")
    present = {}  # module -> its version, or False where it does not import
    for name in ("PIL", "torchvision", "pandas", "cv2"):
        probe = subprocess.run([sys.executable, "-c", f"import {name}; print({name}.__version__)"],
                               capture_output=True, text=True, timeout=120)
        present[name] = probe.returncode == 0 and probe.stdout.strip()
    log(f"  image libraries importable on this machine (version or false): "
        f"{json.dumps(present)}")
    results["suites"] = {"report": report, "launches": counts, "imports": present}


def decode_ms(tm, fn):
    """Time ``fn(pos, layer)`` over every position 0..479 of each layer of
    one decode, from one CUDA graph per position so host launch overhead
    is left out (a graph of the whole decode would keep every call's
    temporaries)."""
    def per_step(pos):
        for layer in range(DEC_L):
            fn(pos, layer)

    return sum(tm.ms(lambda p=p: per_step(p), reps=1, graph=True) for p in range(DEC_STEPS))


def beam_timing(torch, tm, model, eng, gen, card):
    """The beam-4 decode of one batch of 32 (128 rows), 480 forced steps:
    ms per step; the cache reorder's ms per step; K3-int8's launches in
    that decode and their time at 128 rows beside their bound and the
    plain version's."""
    from molnextr_tpu_torch.decoding.beam import beam_decode, reorder_cache
    from molnextr_tpu_torch.data.transforms import device_normalize
    from molnextr_tpu_torch.ops import LAUNCHES, reset_launch_counts

    da = importlib.import_module(DA_MODULE)
    cfg = eng.cfg
    s = cfg.data.input_size
    log(f"  beam {BEAM} decode: batch {BATCH} x beam {BEAM} = {BEAM_ROWS} rows, "
        f"{DEC_STEPS} forced steps, bf16, int8 KV cache")
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    per_step = []
    with torch.no_grad():
        for it in range(TIMED_ITERS + 1):  # the first iteration is warm-up
            images = torch.randint(0, 256, (BATCH, s, s, 1), generator=gen, device=DEVICE,
                                   dtype=torch.uint8)
            memory = model.encode(device_normalize(images))
            reset_launch_counts()
            e0, e1 = ev(), ev()
            e0.record()
            out = beam_decode(
                lambda t, p, c: model.decode_step(eng.fmt, t, p, c),
                lambda m: model.init_cache(eng.fmt, m),
                memory, eng._token_class, eng._class_mask, DEC_STEPS, cfg.decoder.hidden_size,
                beam_size=BEAM, min_len=DEC_STEPS, use_constraint=eng._use_constraint,
                return_all=True, unroll=cfg.decode.unroll,
            )
            e1.record()
            torch.cuda.synchronize()
            launches = LAUNCHES["decode_attention_layered_q8"]
            if tuple(out[4].shape) != (BATCH, BEAM, DEC_STEPS) or launches != DEC_L * DEC_STEPS:
                raise AssertionError(f"beam decode: shape {tuple(out[4].shape)}, {launches} K3 launches")
            if it:
                per_step.append(e0.elapsed_time(e1) / DEC_STEPS)
        # the cache reorder of one step, on the decode's own cache
        cache = model.init_cache(eng.fmt, memory.repeat_interleave(BEAM, dim=0))
        beams = torch.randint(0, BEAM, (BATCH, BEAM), generator=gen, device=DEVICE)
        flat_idx = (torch.arange(BATCH, device=DEVICE)[:, None] * BEAM + beams).reshape(-1)
        cache_bytes = sum(x.numel() * x.element_size() for x in cache.values())
        reorder_ms = tm.ms(lambda: reorder_cache(cache, flat_idx), reps=20)
        del cache, memory, out
    torch.cuda.empty_cache()

    bf = torch.bfloat16
    ins = cache_inputs(torch, gen, bf, True, batch=BEAM_ROWS)
    bound = Bound()
    for pos in range(DEC_STEPS):
        bound.add(*k3_work(BEAM_ROWS, DEC_H, DEC_D, pos, 2, True), "bfloat16", DEC_L)
    t_k = decode_ms(tm, lambda p, l: da.decode_attention_layered_q8(*ins, p, l))
    t_p = decode_ms(tm, lambda p, l: da.decode_attention_layered_q8_reference(*ins, p, l))
    del ins
    torch.cuda.empty_cache()
    step_ms = sum(per_step) / len(per_step)
    res = {"rows": BEAM_ROWS, "decode_ms_per_step": step_ms, "iters": TIMED_ITERS,
           "reorder_ms_per_step": reorder_ms, "reorder_bytes": 2 * cache_bytes,
           "reorder_share": reorder_ms / step_ms,
           "k3_int8_launches": launches, "k3_int8_ms": t_k, "k3_int8_plain_ms": t_p,
           "k3_int8_bound_ms": bound.ms,
           "k3_int8_bound_by": bound.by, "card": card}
    log("  beam " + json.dumps(res))


def phase_timing(torch, results, card):
    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.data.transforms import device_normalize
    from molnextr_tpu_torch.decoding.greedy import greedy_decode
    from molnextr_tpu_torch.inference import InferenceEngine
    from molnextr_tpu_torch.models.model import MolNexTRModel
    from molnextr_tpu_torch.ops import folded_attention as fa
    from molnextr_tpu_torch.ops import swin_fused as sf
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.weights import load_flax_params, seeded_flax_params

    da = importlib.import_module(DA_MODULE)
    tm = Timer(torch)
    log(f"phase timing: Config() bf16, int8 KV cache, batch {BATCH}, {DEC_STEPS} forced decode steps")
    cfg = Config()
    toks = get_tokenizer(cfg.data)
    vocab = {f: len(t) for f, t in toks.items()}
    model = load_flax_params(MolNexTRModel(cfg, vocab), seeded_flax_params(cfg, vocab, 0))
    model.to_dtype(torch.bfloat16)
    eng = InferenceEngine(cfg, toks, model, device=DEVICE)
    s, k = cfg.data.input_size, cfg.data.max_atoms
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    indices = torch.arange(k, device=DEVICE)[None].repeat(BATCH, 1)
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    rows = []
    with torch.no_grad():
        for it in range(TIMED_ITERS + 1):  # the first iteration is warm-up
            images = torch.randint(0, 256, (BATCH, s, s, 1), generator=gen, device=DEVICE,
                                   dtype=torch.uint8)
            e0, e1, e2, e3 = ev(), ev(), ev(), ev()
            e0.record()
            memory = model.encode(device_normalize(images))
            e1.record()
            seq, _, _, hiddens = greedy_decode(
                lambda t, p, c: model.decode_step(eng.fmt, t, p, c),
                lambda m: model.init_cache(eng.fmt, m),
                memory, eng._token_class, eng._class_mask, DEC_STEPS, cfg.decoder.hidden_size,
                min_len=DEC_STEPS, use_constraint=eng._use_constraint, unroll=cfg.decode.unroll,
            )
            e2.record()
            cls, _ = eng.edges(hiddens, indices)
            e3.record()
            torch.cuda.synchronize()
            if tuple(seq.shape) != (BATCH, DEC_STEPS) or tuple(cls.shape) != (BATCH, k, k):
                raise AssertionError("unexpected output shapes in the timed run")
            if it:
                rows.append((e0.elapsed_time(e1), e1.elapsed_time(e2), e2.elapsed_time(e3)))
    enc = sum(r[0] for r in rows) / len(rows)
    dec = sum(r[1] for r in rows) / len(rows)
    edg = sum(r[2] for r in rows) / len(rows)
    total = enc + dec + edg
    e2e = {"batch": BATCH, "encode_ms": enc, "decode_ms_per_step": dec / DEC_STEPS,
           "edges_ms": edg, "images_per_s": BATCH / total * 1e3, "iters": TIMED_ITERS,
           "card": card}
    log("  end-to-end " + json.dumps(e2e))
    results["e2e"] = e2e
    del memory, hiddens, seq, cls
    torch.cuda.empty_cache()
    beam_timing(torch, tm, model, eng, gen, card)
    del model, eng
    torch.cuda.empty_cache()

    log("  per-kernel times over one batch's launches (bf16, batch 32)")
    bf, es = torch.bfloat16, 2
    kern = {}
    # K1 and K2: per call at each stage shape, weighted by the launches of one encode
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound()}
    k2 = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound()}
    for res, c, heads, depth in STAGES:
        variants = ((False, depth // 2), (True, depth - depth // 2)) if res > WS else ((False, depth),)
        for shifted, count in variants:
            args = window_inputs(torch, gen, BATCH, res, c, heads, WS, shifted, bf)
            t_k = tm.ms(lambda: sf.fused_window_attention(*args), reps=5)
            t_p = tm.ms(lambda: sf.window_attention_reference(*args), reps=5)
            k1["ms"] += count * t_k
            k1["plain_ms"] += count * t_p
            k1["bound"].add(*k1_work(BATCH, res, c, heads, WS, shifted, es), "bfloat16", count)
            log(f"    K1 res {res} C {c} {'shifted' if shifted else 'unshifted'}: {t_k:.3f} ms "
                f"(plain {t_p:.3f} ms) x {count}")
            del args
        args = mlp_inputs(torch, gen, BATCH * res * res, c, bf)
        t_k = tm.ms(lambda: sf.fused_ln_mlp(*args), reps=5)
        t_p = tm.ms(lambda: sf.ln_mlp_reference(*args), reps=5)
        k2["ms"] += depth * t_k
        k2["plain_ms"] += depth * t_p
        k2["bound"].add(*k2_work(BATCH * res * res, c, 4 * c, es), "bfloat16", depth)
        log(f"    K2 T {BATCH * res * res} C {c}: {t_k:.3f} ms (plain {t_p:.3f} ms) x {depth}")
        del args
        torch.cuda.empty_cache()
    kern["fused_window_attention"] = dict(k1, library_ms=None)
    kern["fused_ln_mlp"] = dict(k2, library_ms=None)

    # K3-K6: every launch of one forced decode, pos 0..479 in each of 6
    # layers (decode_ms)
    steps = range(DEC_STEPS)
    t_idx = torch.arange(DEC_T, device=DEVICE)

    def sdpa(q, k, v, pos):  # q (B, H, 1, d), k/v (B, H, T, d): the library's prefix attention
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=(t_idx <= pos)[None, None, None])

    for q8, name in ((True, "decode_attention_layered_q8"), (False, "decode_attention_layered")):
        ins = cache_inputs(torch, gen, bf, q8)
        bound = Bound()
        for pos in steps:
            bound.add(*k3_work(BATCH, DEC_H, DEC_D, pos, es, q8), "bfloat16", DEC_L)
        if q8:
            kfn, pfn = da.decode_attention_layered_q8, da.decode_attention_layered_q8_reference
        else:
            kfn, pfn = da.decode_attention_layered, da.decode_attention_layered_reference
        t_k = decode_ms(tm, lambda p, l: kfn(*ins, p, l))
        t_p = decode_ms(tm, lambda p, l: pfn(*ins, p, l))
        lib = None
        if not q8:
            q, kc, vc = ins
            lib = decode_ms(tm, lambda p, l: sdpa(q[:, :, None], kc[l], vc[l], p))
        kern[name] = {"ms": t_k, "plain_ms": t_p, "bound": bound, "library_ms": lib}
        log(f"    K3 {'int8' if q8 else 'dense'}: {t_k:.3f} ms per decode (plain {t_p:.3f} ms"
            + (f", SDPA {lib:.3f} ms" if lib is not None else "") + ")")
        if not q8:
            # K4 on each layer of the same cache, unstacked: the work, the
            # plain version and the library call are K3-dense's
            t_k = decode_ms(tm, lambda p, l: da.decode_attention(q, kc[l], vc[l], p))
            kern["decode_attention"] = dict(kern[name], ms=t_k)
            log(f"    K4: {t_k:.3f} ms per decode (plain and SDPA as K3 dense)")
            # the same kernel with the split forced to one CTA per (b, h)
            t_1 = decode_ms(tm, lambda p, l: da._launch_k3(
                "decode_attention_layered", q, kc, vc, None, None, p, l, cluster=1))
            log(f"    K3 dense, one CTA per (b, h) (cluster 1): {t_1:.3f} ms per decode")
        del ins

    qf, kf, vf = folded_inputs(torch, gen, bf)
    bound = Bound()
    for pos in steps:
        bound.add(*folded_work(BATCH, DEC_H * DEC_D, pos, es), "bfloat16", DEC_L)
    t5 = decode_ms(tm, lambda p, l: fa.folded_decode_attention(qf, kf, vf, p, l, DEC_H))
    t6 = decode_ms(tm, lambda p, l: fa.folded_decode_attention_bb(qf, kf, vf, p, l, DEC_H))
    t_p = decode_ms(tm, lambda p, l: fa.folded_decode_attention_reference(qf, kf, vf, p, l, DEC_H))
    qh = qf.view(BATCH, DEC_H, 1, DEC_D)
    kh = kf.view(DEC_L, BATCH, DEC_T, DEC_H, DEC_D).transpose(2, 3)  # (L, B, H, T, d) views
    vh = vf.view(DEC_L, BATCH, DEC_T, DEC_H, DEC_D).transpose(2, 3)
    lib = decode_ms(tm, lambda p, l: sdpa(qh, kh[l], vh[l], p))
    kern["folded_decode_attention"] = {"ms": t5, "plain_ms": t_p, "bound": bound, "library_ms": lib}
    kern["folded_decode_attention_bb"] = dict(kern["folded_decode_attention"], ms=t6)
    log(f"    K5: {t5:.3f} ms per decode, K6 (bb 8): {t6:.3f} ms (plain {t_p:.3f} ms, "
        f"SDPA on the (B, H, T, d) view {lib:.3f} ms)")
    del qf, kf, vf, qh, kh, vh
    results["timing"] = kern
    log(f"  per-kernel times on {card}")


# kernel -> (source, the JAX function it replaces, the run whose launches count)
SOURCES = {
    "fused_window_attention": ("molnextr_tpu_torch/ops/csrc/swin_fused.cu",
                               "molnextr_tpu/ops/swin_fused.py:127", "int8"),
    "fused_ln_mlp": ("molnextr_tpu_torch/ops/csrc/swin_fused.cu",
                     "molnextr_tpu/ops/swin_fused.py:277", "int8"),
    # the int8 form computes cached_decode_attention_layered_q8, XLA in the
    # JAX package: the Pallas kernel at :177 is dense only
    "decode_attention_layered_q8": ("molnextr_tpu_torch/ops/csrc/decode_attention.cu",
                                    "molnextr_tpu/ops/decode_attention.py:361", "int8"),
    "decode_attention_layered": ("molnextr_tpu_torch/ops/csrc/decode_attention.cu",
                                 "molnextr_tpu/ops/decode_attention.py:177", "dense"),
    "decode_attention": ("molnextr_tpu_torch/ops/csrc/decode_attention.cu",
                         "molnextr_tpu/ops/decode_attention.py:83", "ops"),
    "folded_decode_attention": ("molnextr_tpu_torch/ops/csrc/folded_attention.cu",
                                "molnextr_tpu/ops/folded_attention.py:91", "ops"),
    "folded_decode_attention_bb": ("molnextr_tpu_torch/ops/csrc/folded_attention.cu",
                                   "molnextr_tpu/ops/folded_attention.py:214", "ops"),
}


def kernels_line(results):
    runs = dict(results.get("paths", {}), ops=results.get("ops", {}))
    timing = results.get("timing", {})
    out = []
    for name, (src, replaces, run) in SOURCES.items():
        t = timing.get(name)
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": runs.get(run, {}).get(name),
            "max_abs_err": results.get("max_abs_err", {}).get(name),
            "ms": t and t["ms"], "plain_ms": t and t["plain_ms"],
            "bound_ms": t and t["bound"].ms, "bound_by": t and t["bound"].by,
            "library_ms": t and t["library_ms"],
        })
    return json.dumps({"kernels": out})


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help=f"comma-separated subset of {','.join(PHASES)} (default: all)")
    args = p.parse_args()
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        p.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import molnextr_tpu_torch

    if os.path.dirname(os.path.abspath(molnextr_tpu_torch.__file__)) != os.path.join(
            HERE, "molnextr_tpu_torch"):
        print("chip_smoke: run from the root of a molnextr-tpu checkout", file=sys.stderr)
        return 2
    from molnextr_tpu_torch.inference import resolve_device
    from molnextr_tpu_torch.ops._build import BUILD_LOG, build_all

    resolve_device("cuda")  # raises unless the card is compute capability 9.x
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"capability {torch.cuda.get_device_capability(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_s = build_all()
    log(f"kernels built in {build_s:.1f} s")
    from molnextr_tpu_torch import native

    t1 = time.perf_counter()
    native.get_lib()
    log(f"native matcher built and loaded in {time.perf_counter() - t1:.1f} s "
        f"({native.get_lib()._name})")
    for name, text in BUILD_LOG.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
                log(f"  nvcc {name}: {line.strip()}")
    results = {}
    runs = {
        "kernels": lambda: phase_kernels(torch, results),
        "parity": lambda: phase_parity(torch),
        "paths": lambda: phase_paths(torch, results),
        "ops": lambda: phase_ops(torch, results),
        "demo": lambda: phase_demo(torch),
        "beam": lambda: phase_beam(torch),
        "rerank": lambda: phase_rerank(torch, results, card),
        "train": lambda: phase_train(torch, results, card),
        "dp": lambda: phase_dp(torch, results, card),
        "cli": lambda: phase_cli(torch, results, card),
        "convnext": lambda: phase_convnext(torch, results, card),
        "suites": lambda: phase_suites(torch, results, card),
        "timing": lambda: phase_timing(torch, results, card),
    }
    for name in PHASES:
        if name in phases:
            t1 = time.perf_counter()
            runs[name]()
            log(f"phase {name} passed in {time.perf_counter() - t1:.1f} s")
    log(f"all phases ({','.join(phases)}) passed in {time.perf_counter() - t0:.1f} s")
    print(kernels_line(results))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
