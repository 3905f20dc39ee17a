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
   rerank are logged;
9. timing: batch 32, bf16, int8 cache, 480 forced decode steps, the edge
   head on all 128 atom slots; then each kernel's time over one batch's
   launches (K3-K6: one 480-step decode) beside its bound, its plain
   version and a library call, and K3-dense with its split forced to one
   CTA per (b, h); then the beam-4 decode of the same batch (480 forced
   steps on 128 rows): ms per step, the cache reorder's ms per step, and
   K3-int8's launches and time at 128 rows beside their bound.

The build's ``nvcc -Xptxas -v`` report (registers, spills) is logged per
kernel.

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
PHASES = ("kernels", "parity", "paths", "ops", "demo", "beam", "rerank", "timing")
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
    import numpy as np

    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.data.transforms import device_normalize
    from molnextr_tpu_torch.decoding.greedy import greedy_decode
    from molnextr_tpu_torch.models.model import MolNexTRModel
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.weights import load_flax_params, seeded_flax_params

    log("phase parity: Config() float32, seeded_flax_params(seed=0), against the JAX fixture")
    ref = np.load(fixture_path("full_width.npz"))
    meta = json.loads(str(ref["meta"]))
    cfg = Config()
    toks = get_tokenizer(cfg.data)
    vocab = {f: len(t) for f, t in toks.items()}
    model = load_flax_params(MolNexTRModel(cfg, vocab), seeded_flax_params(cfg, vocab, meta["seed"]))
    model = model.to(DEVICE).eval()
    fmt = meta["format"]
    with torch.no_grad():
        images = device_normalize(torch.from_numpy(ref["images"]).to(DEVICE))
        memory = model.encode(images)
        mem_err = float((memory.cpu() - torch.from_numpy(ref["memory"])).abs().max())
        log(f"  memory bank {tuple(memory.shape)}: max_abs_err {mem_err:.3e} "
            f"(tol {meta['memory_tol']:.0e}, max |ref| {float(np.abs(ref['memory']).max()):.3f})")
        if not mem_err <= meta["memory_tol"]:
            raise AssertionError("memory bank disagrees with the JAX fixture")
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
    for b in range(tokens.shape[0]):
        for s in range(ref["tokens"].shape[1]):
            e = float(np.abs(logp[b, s] - ref["logp"][b, s]).max())
            gap = float(ref["gap"][b, s])
            log(f"  image {b} step {s}: token {tokens[b, s]} (JAX {ref['tokens'][b, s]}), "
                f"log-prob max_abs_err {e:.3e} (tol {tol:.0e}), JAX top-2 gap {gap:.3e}")
            if not e <= tol:
                raise AssertionError("log-probs disagree with the JAX fixture")
            if tokens[b, s] != ref["tokens"][b, s]:
                if gap < 2 * tol:
                    log(f"  image {b}: the JAX top-2 gap is below the tolerance; "
                        "either token is right, comparison stops here")
                    break
                raise AssertionError("greedy token disagrees with the JAX fixture")
    del model
    torch.cuda.empty_cache()


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
                         "fixture_ms": fixture_ms}


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
    for name, text in BUILD_LOG.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
                log(f"  nvcc {name}: {line.strip()}")
    results = {}
    if "kernels" in phases:
        phase_kernels(torch, results)
    if "parity" in phases:
        phase_parity(torch)
    if "paths" in phases:
        phase_paths(torch, results)
    if "ops" in phases:
        phase_ops(torch, results)
    if "demo" in phases:
        phase_demo(torch)
    if "beam" in phases:
        phase_beam(torch)
    if "rerank" in phases:
        phase_rerank(torch, results, card)
    if "timing" in phases:
        phase_timing(torch, results, card)
    log(f"all phases ({','.join(phases)}) passed in {time.perf_counter() - t0:.1f} s")
    print(kernels_line(results))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
