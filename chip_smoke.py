#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``molnextr_tpu_torch``) on one Hopper card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the hand-written kernels of ``molnextr_tpu_torch/ops/csrc`` with
``nvcc`` (one process per source, in parallel), then runs, raising on any
failure:

1. setup: the card, its power limit, compute capability 9.x, build seconds;
2. kernels: K1/K2/K3 against their plain PyTorch versions at the main
   path's full-width shapes, each error beside its tolerance;
3. parity: ``Config()`` (Swin-B 384 + 6x256x8 decoder) in float32 with
   ``seeded_flax_params(seed=0)`` against the JAX package's memory bank and
   first greedy steps stored in ``molnextr_tpu_torch/fixtures``;
4. paths: the serving path through the public API at full width (seeded
   weights, bf16, int8 KV cache) and its dense-cache form
   (``MOLNEXTR_KV_INT8=0``), each with the launch counters zeroed before
   and read after;
5. demo: the trained demo bundle through the public API, hits against gold
   and agreement with the JAX package's SMILES, and ``get_predictions`` on
   a PNG file;
6. timing: batch 32, bf16, int8 cache, 480 forced decode steps, the edge
   head on all 128 atom slots; then each kernel's time over one batch's
   launches beside its bound, its plain version and a library call.

The last three lines are the kernels line, the card line and the device
line.  ``--phases`` runs a subset (for development); the contract run uses
every phase.  Exits non-zero, printing no result, without a CUDA card or
outside a checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("kernels", "parity", "paths", "demo", "timing")

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
WS = 12
BATCH = 32
DEC_L, DEC_H, DEC_T, DEC_D, DEC_STEPS = 6, 8, 512, 32, 480
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


def cache_inputs(torch, gen, dtype, q8):
    from molnextr_tpu_torch.ops.decode_attention import quantize_per_token

    shape = (DEC_L, BATCH, DEC_H, DEC_T, DEC_D)
    q = torch.randn(BATCH, DEC_H, DEC_D, generator=gen, device=DEVICE).to(dtype)
    k = torch.randn(*shape, generator=gen, device=DEVICE)
    v = torch.randn(*shape, generator=gen, device=DEVICE)
    if q8:
        kq, ks = quantize_per_token(k)
        vq, vs = quantize_per_token(v)
        return q, kq, ks, vq, vs
    return q, k.to(dtype), v.to(dtype)


def phase_kernels(torch, results):
    from molnextr_tpu_torch.ops import decode_attention as da
    from molnextr_tpu_torch.ops import swin_fused as sf

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    errs = {k: 0.0 for k in ("fused_window_attention", "fused_ln_mlp",
                             "decode_attention_layered_q8", "decode_attention_layered")}
    log("phase kernels: each kernel against its plain version")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        cases = [(BATCH, res, c, heads, WS, shifted)
                 for res, c, heads, _ in STAGES
                 for shifted in ((False, True) if res > WS else (False,))]
        cases += [(BATCH, 32, 48, 3, 4, False), (BATCH, 32, 48, 3, 4, True)]  # demo stage 0, hd 16
        for b, res, c, heads, ws, shifted in cases:
            args = window_inputs(torch, gen, b, res, c, heads, ws, shifted, dtype)
            got = sf.fused_window_attention(*args)
            want = sf.window_attention_reference(*args)
            torch.cuda.synchronize()
            name = f"K1 {dn} res {res} C {c} heads {heads} ws {ws} {'shifted' if shifted else 'unshifted'}"
            errs["fused_window_attention"] = max(
                errs["fused_window_attention"], check_close(name, got, want, torch, dtype))
            del args, got, want
        for res, c, _, _ in STAGES:
            args = mlp_inputs(torch, gen, BATCH * res * res, c, dtype)
            got = sf.fused_ln_mlp(*args)
            want = sf.ln_mlp_reference(*args)
            torch.cuda.synchronize()
            errs["fused_ln_mlp"] = max(errs["fused_ln_mlp"], check_close(
                f"K2 {dn} T {BATCH * res * res} C {c}", got, want, torch, dtype))
            del args, got, want
        for q8 in (True, False):
            ins = cache_inputs(torch, gen, dtype, q8)
            for pos in (0, 127, 128, 300, 479):
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


def drive_api(torch, api, images, label):
    """One run of the serving path through MolNexTR.predict_images with the
    launch counters zeroed before and read after."""
    from molnextr_tpu_torch.ops import LAUNCHES, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    out = api.predict_images(images, return_atoms_bonds=True, return_confidence=True)
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
    need = {"int8": ("fused_window_attention", "fused_ln_mlp", "decode_attention_layered_q8"),
            "dense": ("fused_window_attention", "fused_ln_mlp", "decode_attention_layered")}
    for path, names in need.items():
        for name in names:
            if paths[path][name] == 0:
                raise AssertionError(f"{path} path never launched {name}")
    if paths["int8"]["decode_attention_layered"] or paths["dense"]["decode_attention_layered_q8"]:
        raise AssertionError("a path launched the other cache form's kernel")
    results["paths"] = paths


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


def phase_timing(torch, results, card):
    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.data.transforms import device_normalize
    from molnextr_tpu_torch.decoding.greedy import greedy_decode
    from molnextr_tpu_torch.inference import InferenceEngine
    from molnextr_tpu_torch.models.model import MolNexTRModel
    from molnextr_tpu_torch.ops import decode_attention as da
    from molnextr_tpu_torch.ops import swin_fused as sf
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.weights import load_flax_params, seeded_flax_params

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
    del model, eng, memory, hiddens, seq, cls
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

    # K3: every launch of one forced decode, pos 0..479 in each of 6 layers,
    # timed from one CUDA graph per position so host launch overhead is left
    # out (a graph of the whole decode would keep every call's temporaries)
    steps = range(DEC_STEPS)
    for q8, name in ((True, "decode_attention_layered_q8"), (False, "decode_attention_layered")):
        ins = cache_inputs(torch, gen, bf, q8)
        bound = Bound()
        for pos in steps:
            bound.add(*k3_work(BATCH, DEC_H, DEC_D, pos, es, q8), "bfloat16", DEC_L)
        if q8:
            kfn, pfn = da.decode_attention_layered_q8, da.decode_attention_layered_q8_reference
        else:
            kfn, pfn = da.decode_attention_layered, da.decode_attention_layered_reference

        def per_step(fn, pos):
            for layer in range(DEC_L):
                fn(*ins, pos, layer)

        t_k = sum(tm.ms(lambda p=p: per_step(kfn, p), reps=1, graph=True) for p in steps)
        t_p = sum(tm.ms(lambda p=p: per_step(pfn, p), reps=1, graph=True) for p in steps)
        lib = None
        if not q8:
            q, kc, vc = ins
            t_idx = torch.arange(DEC_T, device=DEVICE)

            def sdpa(pos):
                mask = (t_idx <= pos)[None, None, None]
                for layer in range(DEC_L):
                    torch.nn.functional.scaled_dot_product_attention(
                        q[:, :, None], kc[layer], vc[layer], attn_mask=mask)

            lib = sum(tm.ms(lambda p=p: sdpa(p), reps=1, graph=True) for p in steps)
        kern[name] = {"ms": t_k, "plain_ms": t_p, "bound": bound, "library_ms": lib}
        log(f"    K3 {'int8' if q8 else 'dense'}: {t_k:.3f} ms per decode (plain {t_p:.3f} ms"
            + (f", SDPA {lib:.3f} ms" if lib is not None else "") + ")")
        del ins
    results["timing"] = kern
    log(f"  per-kernel times on {card}")


SOURCES = {
    "fused_window_attention": ("molnextr_tpu_torch/ops/csrc/swin_fused.cu",
                               "molnextr_tpu/ops/swin_fused.py:127"),
    "fused_ln_mlp": ("molnextr_tpu_torch/ops/csrc/swin_fused.cu",
                     "molnextr_tpu/ops/swin_fused.py:277"),
    "decode_attention_layered_q8": ("molnextr_tpu_torch/ops/csrc/decode_attention.cu",
                                    "molnextr_tpu/ops/decode_attention.py:177"),
    "decode_attention_layered": ("molnextr_tpu_torch/ops/csrc/decode_attention.cu",
                                 "molnextr_tpu/ops/decode_attention.py:177"),
}


def kernels_line(results):
    paths = results.get("paths", {})
    timing = results.get("timing", {})
    out = []
    for name, (src, replaces) in SOURCES.items():
        t = timing.get(name)
        path = "dense" if name == "decode_attention_layered" else "int8"
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": paths.get(path, {}).get(name),
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
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  nvcc {name}: {line.strip()}")
    results = {}
    if "kernels" in phases:
        phase_kernels(torch, results)
    if "parity" in phases:
        phase_parity(torch)
    if "paths" in phases:
        phase_paths(torch, results)
    if "demo" in phases:
        phase_demo(torch)
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
