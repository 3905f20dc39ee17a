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
* ``rerank.npz`` — the round-trip rerank cases of :func:`_rerank_cases`
  (input images drawn by the JAX package, candidate lists) with the JAX
  package's ``roundtrip_rerank`` winner and scores;

and ``molnextr_tpu_torch/chem/glyphs.npz`` is the text renderer's glyph
table, read from the installed OpenCV (:func:`build_glyphs`).

Regenerate them all with ``JAX_PLATFORMS=cpu python tests/test_torch_fixtures.py``.
The full-width fixture runs Swin-B in float32 on the CPU (about a minute),
so its regeneration test is marked slow.
"""

import json
import os
import random
import sys

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
RERANK_CORPUS = 9
RERANK_SEED = 1000
ASPIRIN = "CC(=O)Oc1ccccc1C(=O)O"
IBUPROFEN = "CC(C)Cc1ccc(cc1)C(C)C(=O)O"
CAFFEINE = "Cn1cnc2c1c(=O)n(C)c(=O)n2C"
ASPIRIN_REORDERED = "O=C(O)c1ccccc1OC(C)=O"  # aspirin from another start atom
FULL_STEPS = 8
BEAM, BEAM_STEPS = 4, 12
# what chip_smoke.py allows between the card's float32 run and these
# numbers: the memory bank passes 24 Swin blocks and the decoder 6 layers,
# each summing in another order than XLA on the CPU
FULL_MEMORY_TOL = 1e-4
FULL_LOGP_TOL = 2e-4

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
    from molnextr_tpu.data.synthetic import generate_synthetic_image
    from molnextr_tpu.data.transforms import get_transforms
    from molnextr_tpu.decoding.beam import beam_decode
    from molnextr_tpu.decoding.greedy import greedy_decode
    from molnextr_tpu.models.model import MolNexTRModel
    from molnextr_tpu.tokenization import EOS_ID, get_tokenizer
    from molnextr_tpu.train.wire import as_model_images
    from molnextr_tpu_torch.config import Config
    from molnextr_tpu_torch.weights import seeded_flax_params

    cfg = JConfig()
    random.seed(7)
    transform = get_transforms(cfg.data.input_size, augment=False, rotate=False, normalize=False)
    images = []
    for smi in FULL_SMILES:
        img, _, _, ok = generate_synthetic_image(
            smi, mol_augment=False, default_option=True, size=cfg.data.input_size
        )
        assert ok, smi
        images.append(transform(image=img)["image"][..., :1])
    images = np.stack(images)

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

    cache = model.apply(params, fmt, memory, method=MolNexTRModel.init_cache)
    tokens = np.full((2,), 1, np.int32)
    logps, picks, gaps = [], [], []
    for pos in range(FULL_STEPS):  # the greedy step, recording its log-probs
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
        "logp": np.stack(logps, 1).astype(np.float32),
        "tokens": picks,
        "gap": np.stack(gaps, 1).astype(np.float32),
        "meta": np.array(json.dumps(meta)),
    }


def build_glyphs():
    """The text renderer's glyph table from the installed OpenCV: for each
    weight (400: font ids 0/1/3, 600: ids 2/4), pixel size in
    ``GLYPH_SIZES`` and printable ASCII character, its coverage (255 minus
    the grey of black text drawn on white) cropped to its ink, the crop's
    offset from the text origin, and its advance (``getTextSize`` width
    minus one)."""
    import cv2

    rows, pixels, offset = [], [], 0
    for weight, font in ((400, cv2.FONT_HERSHEY_SIMPLEX), (600, cv2.FONT_HERSHEY_DUPLEX)):
        for size in GLYPH_SIZES:
            scale = size * 0.037
            for code in range(32, 127):
                ch = chr(code)
                canvas = np.full((4 * size, 4 * size, 3), 255, np.uint8)
                org = (size, 3 * size)
                cv2.putText(canvas, ch, org, font, scale, (0, 0, 0), 1, cv2.LINE_AA)
                cov = 255 - canvas[..., 0]
                assert (cov[0] == 0).all() and (cov[:, 0] == 0).all() and (cov[-1] == 0).all()
                ys, xs = np.nonzero(cov)
                if len(ys):
                    cov = cov[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
                    x0, y0 = int(xs.min()) - org[0], int(ys.min()) - org[1]
                else:
                    cov, x0, y0 = cov[:0, :0], 0, 0
                adv = cv2.getTextSize(ch, font, scale, 1)[0][0] - 1
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
    if full_width:
        np.savez_compressed(os.path.join(FIXTURES, "full_width.npz"), **build_full_width())


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
    write_fixtures(full_width="--demo-only" not in sys.argv)
