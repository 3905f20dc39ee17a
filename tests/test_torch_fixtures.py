"""The port's committed fixtures, regenerated from the JAX package.

``molnextr_tpu_torch/fixtures`` holds what ``chip_smoke.py`` holds the port
against on the card, where neither JAX nor OpenCV is installed:

* ``demo.npz`` — the six renders of ``tests/test_pretrained_demo.py``
  (``random.seed(5)``, default style, 128 px) and, in ``meta``, their gold
  SMILES and the JAX package's token sequences and SMILES for the demo
  bundle in float32 and in bfloat16 (the bundle's own dtype), and its
  beam-4 n-best lists (SMILES and scores) in both;
* ``demo_0.png`` — the first render, written with ``cv2.imwrite``;
* ``full_width.npz`` — two 384 px renders after the inference transforms
  (grey, uint8) and, for ``Config()`` in float32 with
  ``seeded_flax_params(seed=0)``: the JAX memory bank, the log-probs of the
  first 8 greedy steps, their tokens, and the top-2 gap of each step's
  constrained log-probs (a step whose gap is below the comparison's
  tolerance may pick either token); and a beam-4 search of up to 12 steps
  (``beam_*``): every step's gap between the 4th and 5th candidate, and
  the n-best sequences and scores of the search cut before the first step
  whose gap is below twice what the candidates may differ by there;
* ``train.npz`` — the training parity of ``chip_smoke.py`` phase train
  (:func:`build_train`): for ``Config()`` in float32 with
  ``seeded_flax_params(seed=0)``, dropout and drop-path rates 0 and remat
  on, a batch of two 384 px renders on the wire (``TrainDataset`` without
  augmentation, ``pad_batch``), the JAX package's loss terms and
  accuracies, each group's gradient global norm, a few gradient leaves, and
  the same leaves after the optimizer's first two updates on that gradient
  (``make_optimizer`` at ``TRAIN_TOTAL_STEPS``: the first update's learning
  rate is 0 under the warmup from 0, the second's is the peak);
* ``rerank.npz`` — the round-trip rerank cases of :func:`_rerank_cases`
  (input images drawn by the JAX package, candidate lists) with the JAX
  package's ``roundtrip_rerank`` winner and scores;
* ``convnext.npz`` — as ``full_width.npz`` without the beam, for
  ``Config()`` with ``encoder.name = "convnext_base"`` (ConvNeXt-B at its
  config defaults: depths 3/3/27/3, dims 128-1024, 384 px; the 6x256x8
  decoder) in float32 with ``seeded_flax_params(seed=0)`` (every block's
  ``gamma`` drawn from U(0.5, 1.5)): two 384 px renders, the JAX memory
  bank, the log-probs of the first 8 greedy steps, their tokens and top-2
  gaps (:func:`build_convnext`);
* ``demo_0_<form>.png`` — ``demo_0.png`` in every PNG form that holds its
  119 grey levels without loss (grey, grey+alpha, RGB, RGBA at 8 and 16
  bits, an 8-bit palette with and without ``tRNS``; several Adam7
  interlaced), written by ``test_torch_png.encode_png`` with each row
  filter in turn (:func:`build_png_forms`); ``chip_smoke.py`` phase cli
  reads them all through the predict CLI;

* ``forms/`` — ``demo_0.png`` as JPEG (4:2:0, 4:2:2, 4:4:4, 4:1:1,
  progressive, restart markers, grey, EXIF orientation 6) and TIFF (LZW
  with predictor 2, Deflate, PackBits, tiled, 16-bit, bilevel G4) and a PNG
  with an ``eXIf`` orientation, written by ``cv2.imwrite``, PIL and the
  hand encoders of ``torch_image_writers``; four 1024 x 1024 files
  (``big_*``: JPEG 4:2:0 and progressive, TIFF LZW and G4) for the reader
  timings; and ``arrays.npz``: the array ``cv2.imread`` reads each file to,
  and in ``meta`` the JAX package's bf16 tokens and SMILES for the demo
  bundle on each ``demo_0_*`` form (:func:`build_image_forms`);
  ``chip_smoke.py`` phase cli reads, predicts and times them;
* ``reaction.npz`` — the JAX package's ``generate_reaction_image`` on
  ``REACTIONS`` (:func:`build_reaction`), which ``chip_smoke.py`` phase
  rerank holds the port's drawings to;

and ``molnextr_tpu_torch/chem/glyphs.npz`` is the text renderer's glyph
table, read from the installed OpenCV (:func:`build_glyphs`).

Regenerate them all with ``JAX_PLATFORMS=cpu python tests/test_torch_fixtures.py``
(``--forms-only``: ``forms/`` and ``reaction.npz`` alone).
The full-width fixtures run Swin-B and ConvNeXt-B in float32 on the CPU
(a minute or more each), so their regeneration tests are marked slow.
"""

import json
import os
import random
import sys
import zlib

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

FIXTURES = os.path.join(ROOT, "molnextr_tpu_torch", "fixtures")
BUNDLE = os.path.join(ROOT, "examples", "demo_model")
DEMO_SMILES = ["CC(C)O", "c1ccccc1", "CC(=O)O", "C1CCCCC1", "CCOC", "CC=O"]
FULL_SMILES = ["CC(=O)Oc1ccccc1C(=O)O", "CN1C=NC2=C1C(=O)N(C)C(=O)N2C"]
GLYPHS = os.path.join(ROOT, "molnextr_tpu_torch", "chem", "glyphs.npz")
# text pixel sizes the renderer's options reach (scale 0.45-0.8 is 12-22 px
# for font ids 0/2/3/4 and 7-12 px for id 1), with a margin either side
GLYPH_SIZES = range(6, 25)
# (weight, font, thickness, pixel size) that data/reaction.py draws: its "+"
# at FONT_HERSHEY_SIMPLEX, scale 1.0, thickness 2
REACTION_GLYPHS = [(600, 0, 2, 27)]
# (reaction SMILES, mol_augment) of reaction.npz: a reagent over the arrow,
# two reactants, three reactants, a product with superatom candidates, and
# one augmented
REACTIONS = [("CCO.CC(=O)O>[H+]>CCOC(C)=O", False),
             ("c1ccccc1Br.OB(O)c1ccccc1>>c1ccc(cc1)-c1ccccc1", False),
             ("CC(=O)Cl.NCC.CCN(CC)CC>>CC(=O)NCC", False),
             ("OC(=O)c1ccccc1O.CC(=O)OC(C)=O>>CC(=O)Oc1ccccc1C(=O)O", False),
             ("CC(C)(C)OC(=O)NC1CCNCC1.CS(=O)(=O)Cl>>CC(C)(C)OC(=O)NC1CCN(CC1)S(C)(=O)=O",
              True)]
IMAGE_FORMS = os.path.join(FIXTURES, "forms")
RERANK_CORPUS = 9
RERANK_SEED = 1000
ASPIRIN = "CC(=O)Oc1ccccc1C(=O)O"
IBUPROFEN = "CC(C)Cc1ccc(cc1)C(C)C(=O)O"
CAFFEINE = "Cn1cnc2c1c(=O)n(C)c(=O)n2C"
ASPIRIN_REORDERED = "O=C(O)c1ccccc1OC(C)=O"  # aspirin from another start atom
FULL_STEPS = 8
# convnext.npz: ConvNeXt-B's memory bank passes 39 convolution blocks;
# the card's float32 run (cuDNN convolutions, TF32 off) is held to these.
# The log-probs get more room than full_width.npz's: a memory bank a few
# 1e-6 off JAX's moves the int8 cross-attention cache entries that sit on
# a rounding boundary by one step, and the log-probs by more than
# full_width.npz's 2e-4 (tests/test_torch_convnext.py holds the CPU)
CONVNEXT_MEMORY_TOL = 1e-4
CONVNEXT_LOGP_TOL = 1e-3
# the PNG forms of demo_0.png: name -> (colour type, bit depth, Adam7)
PNG_FORMS = {"grey8": (0, 8, False), "grey8_adam7": (0, 8, True), "grey16": (0, 16, False),
             "ga8": (4, 8, False), "ga16_adam7": (4, 16, True), "rgb16": (2, 16, False),
             "rgb8_adam7": (2, 8, True), "rgba8": (6, 8, False), "rgba16_adam7": (6, 16, True),
             "palette8": (3, 8, False), "palette8_trns_adam7": (3, 8, True)}
BEAM, BEAM_STEPS = 4, 12
# what chip_smoke.py allows between the card's float32 run and these
# numbers: the memory bank passes 24 Swin blocks and the decoder 6 layers,
# each summing in another order than XLA on the CPU
FULL_MEMORY_TOL = 1e-4
FULL_LOGP_TOL = 2e-4
# training parity: leaves checked on the card, chosen across the model and
# with gradients well away from zero (the Adam step's direction is the
# gradient's sign there); the tolerances the card's float32 run is held to
TRAIN_SMILES = ["CC(=O)Oc1ccccc1C(=O)O", "CN1C=NC2=C1C(=O)N(C)C(=O)N2C"]
TRAIN_LEAVES = [
    "encoder/patch_embed/bias",
    "encoder/stage0_block0/norm1/scale",
    "encoder/stage2_block17/norm2/bias",
    "encoder/stage3_block1/fc2/bias",
    "enc_trans/bias",
    "decoders_chartok_coords/final_ln/scale",
    "edges_head/mlp2/bias",
    "heatmap_head/out/bias",
]
TRAIN_TOTAL_STEPS = 10
TRAIN_TOLS = {"loss_rtol": 1e-4, "grad_norm_rtol": 1e-3, "grad_rtol": 1e-3,
              "param_atol": 1e-6}

torch.set_num_threads(2)


def _demo_renders():
    from molnextr_tpu.data.synthetic import generate_synthetic_image

    random.seed(5)
    imgs, golds = [], []
    for smi in DEMO_SMILES:
        img, gold, _, ok = generate_synthetic_image(
            smi, mol_augment=False, default_option=True, size=128
        )
        assert ok, smi
        imgs.append(img)
        golds.append(gold)
    return np.stack(imgs), golds


def _jax_demo_run(images, bf16: bool):
    """The JAX package's tokens and SMILES for the demo bundle."""
    from molnextr_tpu.api import MolNexTR
    from molnextr_tpu.checkpoint import load_model

    cfg, params = load_model(BUNDLE)
    cfg.train.bf16 = bf16
    model = MolNexTR(cfg=cfg, params=params, num_workers=1)
    batch = np.stack([model.transform(image=im)["image"][..., :1] for im in images])
    seq = model.engine.predict_images_raw(batch)["seq"]
    smiles = [p["predicted_smiles"] for p in model.predict_images(list(images), batch_size=8)]
    return {"tokens": seq.tolist(), "smiles": smiles}


def _jax_demo_beams(images, bf16: bool):
    """The JAX engine's beam-4 n-best lists for the demo bundle."""
    from molnextr_tpu.api import MolNexTR
    from molnextr_tpu.checkpoint import load_model

    cfg, params = load_model(BUNDLE)
    cfg.train.bf16 = bf16
    cfg.decode.beam_size = cfg.decode.n_best = BEAM
    model = MolNexTR(cfg=cfg, params=params, num_workers=1)
    batch = np.stack([model.transform(image=im)["image"][..., :1] for im in images])
    preds = model.engine.predict_images(batch)
    return {"smiles": [[b["smiles"] for b in p["beams"]] for p in preds],
            "scores": [[b["score"] for b in p["beams"]] for p in preds]}


def build_demo():
    images, golds = _demo_renders()
    meta = {
        "inputs": DEMO_SMILES,
        "gold": golds,
        "jax_f32": _jax_demo_run(images, bf16=False),
        "jax_bf16": _jax_demo_run(images, bf16=True),
        "jax_f32_beam4": _jax_demo_beams(images, bf16=False),
        "jax_bf16_beam4": _jax_demo_beams(images, bf16=True),
    }
    return images, meta


def _beam_gaps(step, cache, tc, cm, b, min_len):
    """Replay the beam search on the JAX decode step -> (all_seq (B, K,
    BEAM_STEPS) before the final sort, gaps (B, BEAM_STEPS)): each step's
    gap between the K-th and (K+1)-th of the (B, K*V) candidates."""
    import jax
    import jax.numpy as jnp

    from molnextr_tpu.tokenization import EOS_ID, PAD_ID

    k = BEAM
    tokens = np.full((b * k,), 1, np.int32)
    lps = np.tile(np.asarray([0.0] + [-1e9] * (k - 1), np.float32), (b, 1))
    finished = np.zeros((b, k), bool)
    seq = np.full((b, k, BEAM_STEPS), PAD_ID, np.int32)
    gaps = []
    for pos in range(BEAM_STEPS):
        logits, _, cache = step(jnp.asarray(tokens), jnp.asarray(pos), cache)
        logp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1))
        v = logp.shape[-1]
        logp = np.where(cm[tc[tokens]], logp - 10000.0, logp)
        if pos < min_len:
            logp[:, EOS_ID] = -1e9
        pad_row = np.where(np.arange(v) == PAD_ID, 0.0, -1e9).astype(np.float32)
        logp = np.where(finished[..., None], pad_row, logp.reshape(b, k, v))
        cand = (lps[..., None] + logp).reshape(b, k * v)
        order = np.argsort(-cand, axis=1, kind="stable")  # lax.top_k's order
        rows = np.arange(b)[:, None]
        gaps.append(cand[rows[:, 0], order[:, k - 1]] - cand[rows[:, 0], order[:, k]])
        top = order[:, :k]
        beam_idx, tok = top // v, (top % v).astype(np.int32)
        flat = (rows * k + beam_idx).reshape(-1)
        cache = jax.tree_util.tree_map(
            lambda x: jnp.take(x, flat, axis=1) if x.ndim > 1 else x, cache)
        seq, finished = seq[rows, beam_idx], finished[rows, beam_idx]
        seq[:, :, pos] = tok
        lps = cand[rows, top]
        finished = finished | (tok == EOS_ID)
        tokens = tok.reshape(-1)
    return seq, np.stack(gaps, 1).astype(np.float32)


def build_full_width():
    import jax
    import jax.numpy as jnp

    from molnextr_tpu.config import Config as JConfig
    from molnextr_tpu.decoding.beam import beam_decode
    from molnextr_tpu.models.model import MolNexTRModel
    from molnextr_tpu.tokenization import get_tokenizer
    from molnextr_tpu.train.wire import as_model_images
    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.weights import seeded_flax_params

    cfg = JConfig()
    images = _full_width_renders(cfg.data.input_size)

    toks = get_tokenizer(cfg.data)
    vocab = {f: len(t) for f, t in toks.items()}
    fmt = "chartok_coords"
    params = seeded_flax_params(Config.from_dict(cfg.to_dict()), vocab, 0)
    model = MolNexTRModel(cfg, vocab, dtype=jnp.float32)
    memory = jax.jit(
        lambda p, x: model.apply(p, as_model_images(x), method=MolNexTRModel.encode)
    )(params, jnp.asarray(images))

    tc, cm = toks[fmt].constraint_tables()
    step = jax.jit(
        lambda p, t, pos, c: model.apply(p, fmt, t, pos, c, method=MolNexTRModel.decode_step)
    )

    def step_p(t, pos, c):
        return step(params, t, pos, c)

    logps, picks, gaps = _greedy_record(cfg, model, params, memory, toks, fmt)

    def beam(steps):
        return beam_decode(
            lambda t, p, c: model.apply(params, fmt, t, p, c, method=MolNexTRModel.decode_step),
            lambda m: model.apply(params, fmt, m, method=MolNexTRModel.init_cache),
            memory, jnp.asarray(tc), jnp.asarray(cm), steps, cfg.decoder.hidden_size,
            beam_size=BEAM, min_len=cfg.decode.min_length, return_all=True,
        )

    min_len = cfg.decode.min_length
    beam_cache = model.apply(params, fmt, jnp.repeat(memory, BEAM, axis=0),
                             method=MolNexTRModel.init_cache)
    replay, beam_gap = _beam_gaps(step_p, beam_cache, tc, cm, len(images), min_len)
    full = beam(BEAM_STEPS)
    final = np.asarray(full[4])
    for b in range(len(images)):  # the replay found the same hypotheses
        assert sorted(map(tuple, final[b])) == sorted(map(tuple, replay[b]))
    # the candidates' sums at step s may differ by (s + 1) * FULL_LOGP_TOL
    small = [s for s in range(BEAM_STEPS)
             if beam_gap[:, s].min() < 2 * (s + 1) * FULL_LOGP_TOL]
    beam_steps = small[0] if small else BEAM_STEPS
    cut = full if beam_steps == BEAM_STEPS else beam(beam_steps)
    meta = {"seed": 0, "format": fmt, "smiles": FULL_SMILES,
            "memory_tol": FULL_MEMORY_TOL, "logp_tol": FULL_LOGP_TOL,
            "beam_size": BEAM, "beam_max_len": BEAM_STEPS, "beam_steps": beam_steps,
            "beam_score_tol": FULL_LOGP_TOL}
    return {
        "beam_seq": np.asarray(cut[4]).astype(np.int32),
        "beam_scores": np.asarray(cut[5]).astype(np.float32),
        "beam_gap": beam_gap,
        "images": images,
        "memory": np.asarray(memory, np.float32),
        "logp": logps,
        "tokens": picks,
        "gap": gaps,
        "meta": np.array(json.dumps(meta)),
    }


def _full_width_renders(size):
    """The two FULL_SMILES renders after the inference transforms, (2, S, S, 1)."""
    from molnextr_tpu.data.synthetic import generate_synthetic_image
    from molnextr_tpu.data.transforms import get_transforms

    random.seed(7)
    transform = get_transforms(size, augment=False, rotate=False, normalize=False)
    images = []
    for smi in FULL_SMILES:
        img, _, _, ok = generate_synthetic_image(smi, mol_augment=False, default_option=True,
                                                 size=size)
        assert ok, smi
        images.append(transform(image=img)["image"][..., :1])
    return np.stack(images)


def _greedy_record(cfg, model, params, memory, toks, fmt):
    """FULL_STEPS greedy steps of the JAX model, recording each step's
    log-probs, its pick and the top-2 gap of its constrained log-probs;
    checked against ``greedy_decode``."""
    import jax
    import jax.numpy as jnp

    from molnextr_tpu.decoding.greedy import greedy_decode
    from molnextr_tpu.models.model import MolNexTRModel
    from molnextr_tpu.tokenization import EOS_ID

    tc, cm = toks[fmt].constraint_tables()
    step = jax.jit(
        lambda p, t, pos, c: model.apply(p, fmt, t, pos, c, method=MolNexTRModel.decode_step)
    )
    cache = model.apply(params, fmt, memory, method=MolNexTRModel.init_cache)
    tokens = np.full((memory.shape[0],), 1, np.int32)
    logps, picks, gaps = [], [], []
    for pos in range(FULL_STEPS):
        logits, _, cache = step(params, jnp.asarray(tokens), jnp.asarray(pos), cache)
        logp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1))
        con = np.where(cm[tc[tokens]], logp - 10000.0, logp)
        if pos < cfg.decode.min_length:
            con[:, EOS_ID] = -1e20
        top2 = np.sort(con, axis=-1)[:, -2:]
        tokens = con.argmax(-1).astype(np.int32)
        logps.append(logp)
        picks.append(tokens)
        gaps.append(top2[:, 1] - top2[:, 0])
    picks = np.stack(picks, 1)
    seq, _, _, _ = greedy_decode(
        lambda t, p, c: model.apply(params, fmt, t, p, c, method=MolNexTRModel.decode_step),
        lambda m: model.apply(params, fmt, m, method=MolNexTRModel.init_cache),
        memory, jnp.asarray(tc), jnp.asarray(cm), FULL_STEPS, cfg.decoder.hidden_size,
    )
    np.testing.assert_array_equal(np.asarray(seq), picks)
    return (np.stack(logps, 1).astype(np.float32), picks,
            np.stack(gaps, 1).astype(np.float32))


def build_convnext():
    import jax
    import jax.numpy as jnp

    from molnextr_tpu.config import Config as JConfig
    from molnextr_tpu.models.model import MolNexTRModel
    from molnextr_tpu.tokenization import get_tokenizer
    from molnextr_tpu.train.wire import as_model_images
    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.weights import seeded_flax_params

    cfg = JConfig()
    cfg.encoder.name = "convnext_base"
    images = _full_width_renders(cfg.data.input_size)
    toks = get_tokenizer(cfg.data)
    vocab = {f: len(t) for f, t in toks.items()}
    fmt = "chartok_coords"
    params = seeded_flax_params(Config.from_dict(cfg.to_dict()), vocab, 0)
    model = MolNexTRModel(cfg, vocab, dtype=jnp.float32)
    memory = jax.jit(
        lambda p, x: model.apply(p, as_model_images(x), method=MolNexTRModel.encode)
    )(params, jnp.asarray(images))
    logps, picks, gaps = _greedy_record(cfg, model, params, memory, toks, fmt)
    meta = {"seed": 0, "format": fmt, "smiles": FULL_SMILES, "encoder": cfg.encoder.name,
            "memory_tol": CONVNEXT_MEMORY_TOL, "logp_tol": CONVNEXT_LOGP_TOL}
    return {"images": images, "memory": np.asarray(memory, np.float32), "logp": logps,
            "tokens": picks, "gap": gaps, "meta": np.array(json.dumps(meta))}


def build_png_forms():
    """name -> PNG bytes of demo_0.png in each of PNG_FORMS (module doc)."""
    from test_torch_png import encode_png

    from molnextr_tpu_torch.data.png import read_png

    grey = read_png(os.path.join(FIXTURES, "demo_0.png"))[..., :1].astype(np.int64)
    rng = np.random.RandomState(8)
    out = {}
    for name, (color, depth, adam7) in PNG_FORMS.items():
        scale = 257 if depth == 16 else 1  # 16-bit samples whose high byte is the grey
        plte = trns = b""
        if color == 3:
            levels, samples = np.unique(grey, return_inverse=True)
            samples = samples.reshape(grey.shape)
            plte = np.repeat(levels.astype(np.uint8), 3).tobytes()
            if "trns" in name:
                trns = rng.randint(0, 256, len(levels)).astype(np.uint8).tobytes()
        else:
            colour = grey * scale if color in (0, 4) else np.repeat(grey * scale, 3, axis=2)
            yy, xx = np.indices(grey.shape[:2])
            alpha = ((3 * xx + yy) % 256 * scale)[..., None]  # a ramp: dropped on reading
            samples = np.concatenate([colour, alpha], axis=2) if color in (4, 6) else colour
        out[name] = encode_png(samples, color, depth, adam7, plte=plte, trns=trns)
    return out


def build_image_forms():
    """name -> bytes of ``demo_0.png`` in the JPEG and TIFF forms (and a PNG
    with an ``eXIf`` orientation) that ``chip_smoke.py`` phase cli reads, and
    the array ``cv2.imread`` reads each to (RGB).  An oriented file stores
    the picture turned the other way, so it reads upright."""
    import io
    import tempfile

    import cv2
    from PIL import Image
    from torch_image_writers import encode_tiff, with_jpeg_exif, with_png_exif

    bgr = cv2.imread(os.path.join(FIXTURES, "demo_0.png"))
    grey = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    turned = np.ascontiguousarray(np.rot90(bgr, 1))  # orientation 6 turns it back
    jpeg = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
    files = {}
    for name, factor in jpeg.items():
        files[f"demo_0_{name}.jpg"] = cv2.imencode(
            ".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                          factor])[1].tobytes()
    files["demo_0_progressive.jpg"] = cv2.imencode(
        ".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    files["demo_0_restart.jpg"] = cv2.imencode(
        ".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_RST_INTERVAL, 3])[1].tobytes()
    files["demo_0_grey.jpg"] = cv2.imencode(".jpg", grey, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()
    files["demo_0_exif6.jpg"] = with_jpeg_exif(
        cv2.imencode(".jpg", turned, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes(), 6)
    files["demo_0_exif6.png"] = with_png_exif(cv2.imencode(".png", turned)[1].tobytes(), 6)
    tiff = {"lzw_pred2": [cv2.IMWRITE_TIFF_COMPRESSION, 5, cv2.IMWRITE_TIFF_PREDICTOR, 2],
            "deflate": [cv2.IMWRITE_TIFF_COMPRESSION, 8],
            "packbits": [cv2.IMWRITE_TIFF_COMPRESSION, 32773]}
    for name, params in tiff.items():
        files[f"demo_0_{name}.tif"] = cv2.imencode(".tiff", bgr, params)[1].tobytes()
    files["demo_0_16bit.tif"] = cv2.imencode(".tiff", bgr.astype(np.uint16) * 257,
                                             [cv2.IMWRITE_TIFF_COMPRESSION, 1])[1].tobytes()
    rgb, tile = bgr[..., ::-1], 48
    tiles = []
    for ty in range(0, rgb.shape[0], tile):
        for tx in range(0, rgb.shape[1], tile):
            block = np.zeros((tile, tile, 3), np.uint8)
            part = rgb[ty : ty + tile, tx : tx + tile]
            block[: part.shape[0], : part.shape[1]] = part
            tiles.append(zlib.compress(block.tobytes()))
    files["demo_0_tiled.tif"] = encode_tiff(
        tiles, rgb.shape[1], rgb.shape[0],
        {258: (3, [8, 8, 8]), 259: (3, [8]), 262: (3, [2]), 277: (3, [3]), 284: (3, [1]),
         322: (3, [tile]), 323: (3, [tile])})
    def g4(bits):
        buf = io.BytesIO()
        Image.fromarray(bits).convert("1").save(buf, "TIFF", compression="group4")
        return buf.getvalue()

    files["demo_0_g4.tif"] = g4(grey >= 128)
    big = cv2.cvtColor(_big_render(), cv2.COLOR_RGB2BGR)  # the reader timings' 1024 x 1024
    files["big_420.jpg"] = cv2.imencode(".jpg", big)[1].tobytes()
    files["big_progressive.jpg"] = cv2.imencode(".jpg", big, [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                                               1])[1].tobytes()
    files["big_lzw.tif"] = cv2.imencode(".tiff", big, [cv2.IMWRITE_TIFF_COMPRESSION, 5])[1].tobytes()
    files["big_g4.tif"] = g4(cv2.cvtColor(big, cv2.COLOR_BGR2GRAY) >= 128)
    arrays = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in files.items():
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            arrays[name] = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    demo = sorted(n for n in files if n.startswith("demo_0_"))
    meta = {"names": demo, "jax_bf16": _jax_demo_run([arrays[n] for n in demo], bf16=True)}
    arrays["meta"] = np.array(json.dumps(meta))
    return files, arrays


def _big_render():
    """A 1024 x 1024 drawing of a drug-like molecule by the JAX renderer."""
    from molnextr_tpu.data.synthetic import generate_synthetic_image

    random.seed(0)
    np.random.seed(0)
    img, _, _, ok = generate_synthetic_image(FULL_SMILES[1], mol_augment=False,
                                             default_option=True, size=1024)
    assert ok and img.shape == (1024, 1024, 3)
    return img


def build_reaction():
    """``reaction.npz``: the JAX package's ``generate_reaction_image`` on
    ``REACTIONS`` (each drawn after ``random.seed(k)`` and
    ``np.random.seed(k)``): image ``image_<k>``, edge matrix ``edges_<k>``,
    and in ``meta`` the reactions, labels, symbols, coordinates and success."""
    from molnextr_tpu.data.reaction import generate_reaction_image

    arrays, rows = {}, []
    for k, (reaction, augment) in enumerate(REACTIONS):
        random.seed(k)
        np.random.seed(k)
        image, label, graph, ok = generate_reaction_image(reaction, mol_augment=augment)
        arrays[f"image_{k}"] = image
        arrays[f"edges_{k}"] = np.asarray(graph.get("edges", np.zeros((0, 0))), np.int8)
        rows.append({"reaction": reaction, "mol_augment": augment, "label": label, "ok": ok,
                     "symbols": graph.get("symbols", []),
                     "coords": [[float(v) for v in c] for c in graph.get("coords", [])]})
    arrays["meta"] = np.array(json.dumps(rows))
    return arrays


def build_train():
    import jax
    import jax.numpy as jnp

    from molnextr_tpu.config import Config as JConfig
    from molnextr_tpu.data.dataset import Sample, TrainDataset, pad_batch
    from molnextr_tpu.models.model import MolNexTRModel
    from molnextr_tpu.tokenization import get_tokenizer
    from molnextr_tpu.train.losses import Criterion
    from molnextr_tpu.train.state import make_optimizer
    from molnextr_tpu.train.wire import as_model_images, as_model_refs
    from molnextr_tpu.utils import FORMAT_INFO
    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.weights import _flatten, seeded_flax_params

    cfg = JConfig()
    cfg.encoder.drop_path_rate = 0.0
    cfg.decoder.hidden_dropout = cfg.decoder.attn_dropout = 0.0
    cfg.encoder.use_remat = cfg.decoder.use_remat = True
    cfg.data.augment = cfg.data.mol_augment = False
    cfg.data.default_style = True
    toks = get_tokenizer(cfg.data)
    vocab = {f: len(t) for f, t in toks.items()}
    fmt = "chartok_coords"
    random.seed(11)
    np.random.seed(11)
    ds = TrainDataset(cfg, [Sample(s) for s in TRAIN_SMILES], toks)
    items = [ds[i] for i in range(len(TRAIN_SMILES))]
    assert all(it is not None for it in items)
    max_len = min(FORMAT_INFO[fmt]["max_len"], cfg.decoder.max_len)
    batch = pad_batch(items, cfg.data.formats, max_len, cfg.data.max_atoms)
    batch.pop("smiles")
    batch["refs"].pop("num_atoms")
    tok = toks[fmt]
    criterion = Criterion(cfg.data.formats, cfg.train.label_smoothing,
                          (tok.offset, tok.maxx, tok.maxy, tok.sep_xy),
                          cfg.train.aux_heatmap_weight)
    model = MolNexTRModel(cfg, vocab, dtype=jnp.float32)
    params = seeded_flax_params(Config.from_dict(cfg.to_dict()), vocab, 0)
    dev_batch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        refs = as_model_refs(dev_batch["refs"])
        out = model.apply(p, as_model_images(dev_batch["images"]), refs, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        total, losses = criterion(out, refs)
        return total, losses

    (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = make_optimizer(cfg, TRAIN_TOTAL_STEPS)

    @jax.jit
    def two_updates(g, p):
        import optax

        state = tx.init(p)
        for _ in range(2):
            u, state = tx.update(g, state, p)
            p = optax.apply_updates(p, u)
        return p

    after = two_updates(grads, jax.tree_util.tree_map(jnp.asarray, params))
    flat_g = _flatten(jax.tree_util.tree_map(np.asarray, grads))
    flat_a = _flatten(jax.tree_util.tree_map(np.asarray, after))
    norms = {}
    for group in ("encoder", "decoder"):
        sel = [v for k, v in flat_g.items() if (k.split("/")[1] == "encoder") == (group == "encoder")]
        norms[group] = float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in sel)))
    arrays = {"images": batch["images"]}
    for key, value in batch["refs"].items():
        arrays[f"ref_{key}"] = value
    for i, leaf in enumerate(TRAIN_LEAVES):
        g = flat_g[f"params/{leaf}"]
        assert np.abs(g).min() > 1e-4 * np.abs(g).max(), (leaf, np.abs(g).min(), np.abs(g).max())
        arrays[f"grad_{i}"] = g.astype(np.float32)
        arrays[f"after_{i}"] = flat_a[f"params/{leaf}"].astype(np.float32)
    meta = {"seed": 0, "format": fmt, "smiles": TRAIN_SMILES, "leaves": TRAIN_LEAVES,
            "total_steps": TRAIN_TOTAL_STEPS, "updates": 2, "tols": TRAIN_TOLS,
            "losses": {"loss": float(total), **{k: float(v) for k, v in losses.items()}},
            "grad_norms": norms}
    arrays["meta"] = np.array(json.dumps(meta))
    return arrays


def build_glyphs():
    """The text renderer's glyph table from the installed OpenCV: for each
    weight (400: font ids 0/1/3, 600: ids 2/4), pixel size in
    ``GLYPH_SIZES`` and printable ASCII character, its coverage (255 minus
    the grey of black text drawn on white) cropped to its ink, the crop's
    offset from the text origin, and its advance (``getTextSize`` width
    minus one); and the (weight, size) pairs of ``REACTION_GLYPHS``, drawn
    with the font and thickness the reaction drawing uses."""
    import cv2

    styles = [(400, cv2.FONT_HERSHEY_SIMPLEX, 1, size) for size in GLYPH_SIZES]
    styles += [(600, cv2.FONT_HERSHEY_DUPLEX, 1, size) for size in GLYPH_SIZES]
    styles += REACTION_GLYPHS
    rows, pixels, offset = [], [], 0
    for weight, font, thickness, size in styles:
        scale = size * 0.037
        for code in range(32, 127):
            ch = chr(code)
            canvas = np.full((4 * size, 4 * size, 3), 255, np.uint8)
            org = (size, 3 * size)
            cv2.putText(canvas, ch, org, font, scale, (0, 0, 0), thickness, cv2.LINE_AA)
            cov = 255 - canvas[..., 0]
            assert (cov[0] == 0).all() and (cov[:, 0] == 0).all() and (cov[-1] == 0).all()
            ys, xs = np.nonzero(cov)
            if len(ys):
                cov = cov[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
                x0, y0 = int(xs.min()) - org[0], int(ys.min()) - org[1]
            else:
                cov, x0, y0 = cov[:0, :0], 0, 0
            adv = cv2.getTextSize(ch, font, scale, thickness)[0][0] - 1
            rows.append((weight, size, code, adv, x0, y0, cov.shape[0], cov.shape[1], offset))
            pixels.append(cov.reshape(-1))
            offset += cov.size
    return {"index": np.asarray(rows, np.int32), "pixels": np.concatenate(pixels)}


def _rerank_cases():
    """(name, image, candidates) of the rerank fixture, drawn by the JAX
    package: a challenger that wins, rank 0 standing, duplicates that
    collapse on canonicalisation, unrenderable candidates, a cluttered
    input that leaves rerank inert, a grey 2-D input, and corpus molecules
    at sizes 128-256 with their true structure at rank 0 or later."""
    from molnextr_tpu.data.corpus import generate_corpus
    from molnextr_tpu.data.synthetic import generate_synthetic_image
    from molnextr_tpu.data.transforms import (
        IMAGENET_MEAN, IMAGENET_STD, get_perturbation_transforms,
    )

    def draw(smi, size):
        img, _, _, ok = generate_synthetic_image(
            smi, mol_augment=False, default_option=True, size=size)
        assert ok, smi
        return img

    aspirin = draw(ASPIRIN, 192)
    cases = [
        ("challenger_wins", aspirin, [IBUPROFEN, ASPIRIN_REORDERED]),
        ("true_candidate_wins", aspirin, [IBUPROFEN, ASPIRIN, CAFFEINE]),
        ("rank0_stands", aspirin, [ASPIRIN, IBUPROFEN, CAFFEINE]),
        ("duplicates_collapse", aspirin, [ASPIRIN, ASPIRIN_REORDERED, "OC(=O)c1ccccc1OC(C)=O"]),
        # "1/[O-]" fails to canonicalise, stays as written and cannot be drawn
        # (score -1); "" and "][" are dropped before drawing
        ("unrenderable", aspirin, [CAFFEINE, "not-a-smiles", "", "][", "1/[O-]", ASPIRIN]),
        ("grey_input", draw(CAFFEINE, 160)[..., 0], [ASPIRIN, CAFFEINE]),
    ]
    random.seed(0)
    noisy = get_perturbation_transforms(192)(image=aspirin)["image"]
    noisy = np.clip((noisy * IMAGENET_STD + IMAGENET_MEAN) * 255, 0, 255).astype(np.uint8)
    cases.append(("clutter_inert", noisy, [IBUPROFEN, ASPIRIN, CAFFEINE]))
    corpus = generate_corpus(2 * RERANK_CORPUS, seed=11)
    for k in range(RERANK_CORPUS):
        true, other, third = corpus[k], corpus[k + RERANK_CORPUS], corpus[(k + 1) % RERANK_CORPUS]
        cands = [other, true, third] if k % 2 == 0 else [true, other, third]
        cases.append((f"corpus_{k}", draw(true, 128 + 32 * (k % 5)), cands))
    return cases


def build_rerank():
    """The rerank fixture: each case's input image, its candidates and the
    JAX package's ``roundtrip_rerank`` winner (None: rank 0 stands) and
    scores, with ``random.seed(RERANK_SEED + k)`` before case k (the layout
    draws from ``random`` when atoms coincide)."""
    from molnextr_tpu.rerank import roundtrip_rerank

    arrays, meta = {}, []
    for k, (name, image, cands) in enumerate(_rerank_cases()):
        random.seed(RERANK_SEED + k)
        winner, scores = roundtrip_rerank(image, cands)
        arrays[f"image_{k}"] = image
        meta.append({"name": name, "candidates": cands, "winner": winner,
                     "scores": [float(x) for x in scores]})
    arrays["meta"] = np.array(json.dumps({"seed": RERANK_SEED, "cases": meta}))
    return arrays


def write_fixtures(full_width: bool = True):
    import cv2

    images, meta = build_demo()
    np.savez_compressed(os.path.join(FIXTURES, "demo.npz"), images=images,
                        meta=np.array(json.dumps(meta)))
    cv2.imwrite(os.path.join(FIXTURES, "demo_0.png"), cv2.cvtColor(images[0], cv2.COLOR_RGB2BGR))
    np.savez_compressed(os.path.join(FIXTURES, "rerank.npz"), **build_rerank())
    np.savez_compressed(GLYPHS, **build_glyphs())
    for name, data in build_png_forms().items():
        with open(os.path.join(FIXTURES, f"demo_0_{name}.png"), "wb") as f:
            f.write(data)
    write_image_forms()
    np.savez_compressed(os.path.join(FIXTURES, "reaction.npz"), **build_reaction())
    if full_width:
        np.savez_compressed(os.path.join(FIXTURES, "full_width.npz"), **build_full_width())
        np.savez_compressed(os.path.join(FIXTURES, "train.npz"), **build_train())
        np.savez_compressed(os.path.join(FIXTURES, "convnext.npz"), **build_convnext())


def write_image_forms():
    files, arrays = build_image_forms()
    os.makedirs(IMAGE_FORMS, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(IMAGE_FORMS, name), "wb") as f:
            f.write(data)
    np.savez_compressed(os.path.join(IMAGE_FORMS, "arrays.npz"), **arrays)


def _load(name):
    with np.load(os.path.join(FIXTURES, name)) as f:
        out = {k: f[k] for k in f.files}
    out["meta"] = json.loads(str(out["meta"]))
    return out


def test_demo_fixture_regenerates():
    images, meta = build_demo()
    committed = _load("demo.npz")
    np.testing.assert_array_equal(images, committed["images"])
    assert meta == committed["meta"]


def test_demo_png_matches_render():
    import cv2

    from molnextr_tpu_torch.data.png import read_png

    png = os.path.join(FIXTURES, "demo_0.png")
    want = cv2.cvtColor(cv2.imread(png), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(want, _load("demo.npz")["images"][0])
    np.testing.assert_array_equal(read_png(png), want)


def test_rerank_fixture_regenerates():
    got = build_rerank()
    committed = _load("rerank.npz")
    assert json.loads(str(got.pop("meta"))) == committed.pop("meta")
    assert sorted(got) == sorted(committed)
    for key, image in got.items():
        np.testing.assert_array_equal(image, committed[key])


def test_glyph_table_regenerates():
    got = build_glyphs()
    with np.load(GLYPHS) as f:
        np.testing.assert_array_equal(got["index"], f["index"])
        np.testing.assert_array_equal(got["pixels"], f["pixels"])


def test_train_fixture_is_what_chip_smoke_reads():
    """``chip_smoke.py`` phase train reads ``train.npz`` with
    ``read_train_fixture``: a ``Config()`` batch on the wire, the leaves'
    shapes, and every number it compares."""
    import chip_smoke

    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.tokenization import get_tokenizer
    from molnextr_tpu_torch.weights import param_shapes

    cfg = Config()
    batch, grads, after, meta = chip_smoke.read_train_fixture(os.path.join(FIXTURES, "train.npz"))
    s, k, n = cfg.data.input_size, cfg.data.max_atoms, len(TRAIN_SMILES)
    g = s // cfg.train.aux_heatmap_stride
    assert batch["images"].shape == (n, s, s, 1) and batch["images"].dtype == np.uint8
    shapes = {"chartok_coords": (n, cfg.decoder.max_len), "atom_indices": (n, k),
              "edges": (n, k, k), "atom_grid": (n, g, g)}
    assert {key: v.shape for key, v in batch["refs"].items()} == shapes
    assert meta["leaves"] == TRAIN_LEAVES and meta["tols"] == TRAIN_TOLS
    assert meta["total_steps"] == TRAIN_TOTAL_STEPS and meta["updates"] == 2
    vocab = {f: len(t) for f, t in get_tokenizer(cfg.data).items()}
    want = param_shapes(cfg, vocab)
    for leaf, gr, af, name in zip(TRAIN_LEAVES, grads, after,
                                  chip_smoke._leaf_names(TRAIN_LEAVES)):
        assert gr.shape == af.shape == want[leaf] and gr.dtype == np.float32
        assert name.replace(".", "/").replace("decoders/", "decoders_") == leaf
    assert set(meta["losses"]) == {"loss", "chartok_coords", "edges", "heatmap", "acc_sym",
                                   "acc_x", "acc_y", "acc_edge", "acc_bond", "acc_heat"}
    assert set(meta["grad_norms"]) == {"encoder", "decoder"}


def test_png_forms_regenerate_and_read_as_demo_0():
    """Every committed ``demo_0_<form>.png`` is what :func:`build_png_forms`
    writes, and reads (port and cv2) to ``demo_0.png``'s pixels, as
    ``chip_smoke.py`` phase cli requires of the forms it finds."""
    import cv2

    from molnextr_tpu_torch.data.png import read_png

    want = read_png(os.path.join(FIXTURES, "demo_0.png"))
    forms = build_png_forms()
    committed = sorted(f for f in os.listdir(FIXTURES) if f.startswith("demo_0_"))
    assert committed == sorted(f"demo_0_{name}.png" for name in forms)
    for name, data in forms.items():
        path = os.path.join(FIXTURES, f"demo_0_{name}.png")
        with open(path, "rb") as f:
            assert f.read() == data, name
        np.testing.assert_array_equal(read_png(path), want, err_msg=name)
        np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB), want,
                                      err_msg=name)


def test_image_forms_regenerate_and_read_as_cv2_reads_them():
    """Every file under ``fixtures/forms`` is what :func:`build_image_forms`
    writes; ``arrays.npz`` holds what cv2 reads each to, and the port reads
    each to the same array, as ``chip_smoke.py`` phase cli requires."""
    from molnextr_tpu_torch.data.image import imread

    files, arrays = build_image_forms()
    committed = sorted(f for f in os.listdir(IMAGE_FORMS) if f != "arrays.npz")
    assert committed == sorted(files)
    with np.load(os.path.join(IMAGE_FORMS, "arrays.npz")) as f:
        stored = {k: f[k] for k in f.files}
    assert sorted(stored) == sorted(files) + ["meta"]
    assert json.loads(str(stored["meta"])) == json.loads(str(arrays["meta"]))
    for name, data in files.items():
        path = os.path.join(IMAGE_FORMS, name)
        with open(path, "rb") as f:
            assert f.read() == data, name
        np.testing.assert_array_equal(stored[name], arrays[name], err_msg=name)
        np.testing.assert_array_equal(imread(path), arrays[name], err_msg=name)


def test_reaction_fixture_regenerates():
    got, want = build_reaction(), _load("reaction.npz")
    assert sorted(got) == sorted(want)
    assert json.loads(str(got["meta"])) == want["meta"]
    for key in got:
        if key != "meta":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_convnext_fixture_is_what_chip_smoke_reads():
    """``chip_smoke.py`` phase convnext holds ``convnext_config()`` in float32
    against ``convnext.npz`` through ``model_parity``: two grey 384 px
    renders, the memory bank, FULL_STEPS steps of log-probs, tokens and
    gaps, the tolerances, and no step whose gap is below twice the log-prob
    tolerance (a token that could flip)."""
    import chip_smoke

    from molnextr_tpu_torch.tokenization import get_tokenizer

    cfg = chip_smoke.convnext_config()
    assert cfg.encoder.name == "convnext_base"
    assert cfg.encoder.convnext_depths == (3, 3, 27, 3)
    assert tuple(cfg.encoder.convnext_dims) == (128, 256, 512, 1024)
    fx = _load("convnext.npz")
    meta = fx["meta"]
    s, n = cfg.data.input_size, len(FULL_SMILES)
    v = len(get_tokenizer(cfg.data)[meta["format"]])
    assert fx["images"].shape == (n, s, s, 1) and fx["images"].dtype == np.uint8
    assert fx["memory"].shape == (n, (s // 32) ** 2, cfg.decoder.hidden_size)
    assert fx["logp"].shape == (n, FULL_STEPS, v) and fx["tokens"].shape == (n, FULL_STEPS)
    assert fx["gap"].shape == (n, FULL_STEPS) and fx["gap"].min() > 2 * CONVNEXT_LOGP_TOL
    assert meta == {"seed": 0, "format": "chartok_coords", "smiles": FULL_SMILES,
                    "encoder": "convnext_base", "memory_tol": CONVNEXT_MEMORY_TOL,
                    "logp_tol": CONVNEXT_LOGP_TOL}
    np.testing.assert_array_equal(fx["images"], _load("full_width.npz")["images"])


@pytest.mark.slow
def test_convnext_fixture_regenerates():
    got = build_convnext()
    committed = _load("convnext.npz")
    assert json.loads(str(got.pop("meta"))) == committed.pop("meta")
    for key in ("images", "tokens"):
        np.testing.assert_array_equal(got[key], committed[key])
    for key in ("memory", "logp", "gap"):
        np.testing.assert_allclose(got[key], committed[key], rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_train_fixture_regenerates():
    got = build_train()
    committed = _load("train.npz")
    assert json.loads(str(got.pop("meta"))) == committed.pop("meta")
    for key, value in got.items():
        np.testing.assert_allclose(value, committed[key], rtol=1e-5, atol=1e-7)


@pytest.mark.slow
def test_full_width_fixture_regenerates():
    got = build_full_width()
    committed = _load("full_width.npz")
    assert json.loads(str(got.pop("meta"))) == committed.pop("meta")
    for key in ("images", "tokens", "beam_seq"):
        np.testing.assert_array_equal(got[key], committed[key])
    for key in ("memory", "logp", "gap", "beam_scores", "beam_gap"):
        np.testing.assert_allclose(got[key], committed[key], rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "--train-only" in sys.argv:
        np.savez_compressed(os.path.join(FIXTURES, "train.npz"), **build_train())
    elif "--convnext-only" in sys.argv:
        np.savez_compressed(os.path.join(FIXTURES, "convnext.npz"), **build_convnext())
    elif "--forms-only" in sys.argv:
        write_image_forms()
        np.savez_compressed(os.path.join(FIXTURES, "reaction.npz"), **build_reaction())
    else:
        write_fixtures(full_width="--demo-only" not in sys.argv)
