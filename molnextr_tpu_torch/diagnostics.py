"""Diagnostics of a trained bundle: the ports of ``scripts/ab_int8_suites.py``,
``scripts/diagnose_errors.py`` and ``scripts/diagnose_chirality.py``.

Each takes the JAX script's flags and defaults plus ``--device`` (default
``cuda``; ``cpu`` only when asked), prints what the JAX script prints and
returns its report as a dict:

* :func:`ab_int8` runs the batch suite (``benchmarks.suite_batch_inference``)
  on one bundle with the dense KV cache (``"bf16"``) and with the int8 cache
  (``"int8"``) and reports both score dicts and the per-sample SMILES
  agreement, the gate on which the int8 cache became the default;
* :func:`diagnose_errors` splits held-out exact match into the graph view
  (the reported prediction) and the token view (the decoded string), counts
  invalid predictions and, with ``--beam``, the beam's oracle at k;
* :func:`diagnose_chirality` follows the stereo signal from the labels
  (stage A, the oracle), through the model's tokens and edges on its own
  training molecules (B and C), to the whole pipeline (D).

Run them as ``python scripts/ab_int8_suites_torch.py --model_path
examples/demo_model``, ``python scripts/diagnose_errors_torch.py
--model_path ... --beam 4`` and ``python scripts/diagnose_chirality_torch.py
--bundle output/chiral_proof/ckpt_best --corpus
output/chiral_proof/corpus_valid.txt``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import time

import numpy as np

from molnextr_tpu_torch import benchmarks


def _device_flag(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def ab_int8_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="A/B the int8 KV-cache decode against the dense "
                                            "cache on a trained bundle (the PyTorch port)")
    p.add_argument("--model_path", required=True)
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--output", default=None)
    return _device_flag(p)


def ab_int8(argv=None) -> dict:
    """``{"bf16": suite, "int8": suite, "smiles_agreement": x}``: the batch
    suite with the dense and with the int8 cache on the same parameters."""
    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.checkpoint import load_model

    args = ab_int8_parser().parse_args(argv)
    cfg, params = load_model(args.model_path)
    report = {}
    smiles = {}
    for tag, int8 in (("bf16", False), ("int8", True)):
        c = dataclasses.replace(cfg)
        c.decoder = dataclasses.replace(cfg.decoder, kv_int8=int8)
        model = MolNexTR(cfg=c, params=params, num_workers=0, device=args.device)
        suite = benchmarks.suite_batch_inference(c, model, n=args.n, device=args.device)
        report[tag] = suite
        smiles[tag] = suite.pop("_smiles", None)
        print(tag, json.dumps(suite, default=float), flush=True)
    if smiles["bf16"] is not None and smiles["int8"] is not None:
        agree = sum(a == b for a, b in zip(smiles["bf16"], smiles["int8"]))
        report["smiles_agreement"] = agree / max(len(smiles["bf16"]), 1)
        print(f"per-sample SMILES agreement: {report['smiles_agreement']:.4f}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2, default=float)
        print(f"wrote {args.output}")
    return report


def diagnose_errors_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Error modes of a trained bundle: graph against "
                                            "token SMILES, validity, beam oracle "
                                            "(the PyTorch port)")
    p.add_argument("--model_path", required=True)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--beam", type=int, default=0,
                   help="if >0, also run beam at this width with n_best=beam")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default=None)
    return _device_flag(p)


def _engine_predictions(model, images, bs):
    """``model.engine.predict_images`` over the transformed images, in
    batches of ``bs``."""
    from molnextr_tpu_torch.data.transforms import stack_gray_batch

    preds = []
    for start in range(0, len(images), bs):
        preds += model.engine.predict_images(
            stack_gray_batch(images[start:start + bs], model.transform))
    return preds


def diagnose_errors(argv=None) -> dict:
    """Graph- and token-view exact match, invalid shares, up to 8 examples
    where the views disagree and, with ``--beam``, the beam's top-1, oracle
    and first-hit ranks on the token view."""
    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.chem.graph import convert_graph_to_smiles
    from molnextr_tpu_torch.checkpoint import load_model
    from molnextr_tpu_torch.evaluation import convert_smiles_to_canonsmiles

    args = diagnose_errors_parser().parse_args(argv)
    cfg, params = load_model(args.model_path)
    model = MolNexTR(cfg=cfg, params=params, num_workers=0, device=args.device)
    images, golds = benchmarks._synthetic_eval_set(args.n, seed=args.seed,
                                                   size=cfg.data.input_size)
    gold_canon, _ = convert_smiles_to_canonsmiles(golds, ignore_chiral=False)

    def canon1(s):
        out, _ = convert_smiles_to_canonsmiles([s], ignore_chiral=False)
        return out[0]

    # greedy, keeping both SMILES views
    fmt = model.engine.fmt
    bs = cfg.decode.batch_size
    t0 = time.perf_counter()
    preds = _engine_predictions(model, images, bs)
    benchmarks._sync(args.device)
    dt = time.perf_counter() - t0

    graph_smiles, _, _ = convert_graph_to_smiles(
        [p[fmt]["coords"] for p in preds], [p[fmt]["symbols"] for p in preds],
        [p["edges"] for p in preds], images=images, num_workers=0)
    token_smiles = [p[fmt]["smiles"] for p in preds]

    n = len(golds)
    g_ok = t_ok = either = both = invalid_g = invalid_t = 0
    disagree_examples = []
    for i in range(n):
        gc = canon1(graph_smiles[i])
        tc = canon1(token_smiles[i])
        g = gc == gold_canon[i] and gc != ""
        t = tc == gold_canon[i] and tc != ""
        g_ok += g
        t_ok += t
        either += g or t
        both += g and t
        invalid_g += gc == ""
        invalid_t += tc == ""
        if g != t and len(disagree_examples) < 8:
            disagree_examples.append({"gold": gold_canon[i], "graph": gc, "token": tc,
                                      "graph_right": bool(g)})

    report = {
        "n": n,
        "img_per_s_greedy": round(n / dt, 2),
        "graph_exact": round(g_ok / n, 4),
        "token_exact": round(t_ok / n, 4),
        "either_exact": round(either / n, 4),
        "both_exact": round(both / n, 4),
        "graph_invalid": round(invalid_g / n, 4),
        "token_invalid": round(invalid_t / n, 4),
        "disagree_examples": disagree_examples,
    }

    # beam oracle at k
    if args.beam > 1:
        cfg_b = copy.deepcopy(cfg)
        cfg_b.decode.beam_size = args.beam
        cfg_b.decode.n_best = args.beam
        model_b = MolNexTR(cfg=cfg_b, params=params, num_workers=0, device=args.device)
        preds_b = _engine_predictions(model_b, images, bs)
        top1 = oracle = 0
        rank_hist = [0] * args.beam
        for i in range(n):
            hits = [k for k, b in enumerate(preds_b[i].get("beams", []))
                    if canon1(b["smiles"]) == gold_canon[i]]
            if hits and hits[0] == 0:
                top1 += 1
            if hits:
                oracle += 1
                rank_hist[hits[0]] += 1
        report["beam"] = args.beam
        report["beam_token_top1"] = round(top1 / n, 4)
        report["beam_token_oracle"] = round(oracle / n, 4)
        report["beam_first_hit_rank_hist"] = rank_hist

    text = json.dumps(report, indent=2)
    print(text)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    return report


def diagnose_chirality_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Where the stereo signal drops, stage by stage "
                                            "(the PyTorch port)")
    p.add_argument("--bundle", default="output/overfit3/ckpt_best")
    p.add_argument("--corpus", default="output/overfit3/corpus_valid.txt")
    p.add_argument("--only-chiral", action="store_true", default=False)
    return _device_flag(p)


def _scores(ev, smiles):
    return {k: round(v, 3) for k, v in ev.evaluate(smiles).items() if not k.startswith("_")}


def diagnose_chirality(argv=None) -> dict:
    """Stages A-D on the bundle's own corpus: ``{"stage_a": scores,
    "stage_d": scores, "rows": [{"gold", "chiral", "tokens_match",
    "edges_match", "oracle", "pred"}, ...]}`` (the scores rounded as
    printed)."""
    from molnextr_tpu_torch.api import MolNexTR
    from molnextr_tpu_torch.chem.graph import convert_graph_to_smiles
    from molnextr_tpu_torch.data.synthetic import generate_synthetic_image
    from molnextr_tpu_torch.data.transforms import stack_gray_batch
    from molnextr_tpu_torch.evaluation import SmilesEvaluator
    from molnextr_tpu_torch.tokenization import get_tokenizer

    args = diagnose_chirality_parser().parse_args(argv)
    with open(args.corpus) as f:
        smiles_all = [s.strip() for s in f if s.strip()]
    m = MolNexTR(args.bundle, device=args.device)
    cfg = m.cfg
    tok = get_tokenizer(cfg.data)["chartok_coords"]
    size = cfg.data.input_size

    rows = []
    for s in smiles_all:
        img, gold, graph, ok = generate_synthetic_image(s, mol_augment=False,
                                                        default_option=True, size=size)
        if not ok or not graph:
            print(f"RENDER FAIL: {s}")
            continue
        chiral = "@" in gold
        if args.only_chiral and not chiral:
            continue
        c = np.asarray(graph["coords"], np.float64)
        h, w = img.shape[:2]
        c[:, 0] = np.clip(c[:, 0] / w, 0, 1)
        c[:, 1] = np.clip(c[:, 1] / h, 0, 1)
        labels, _ = tok.smiles_to_sequence(gold, c, mask_ratio=0.0)
        rows.append(dict(smiles=s, gold=gold, img=img, graph=graph, labels=list(labels),
                         chiral=chiral))

    # stage A: the oracle
    coords, symbols, edges, golds = [], [], [], []
    for r in rows:
        parsed = tok.sequence_to_smiles(r["labels"])
        k = len(parsed["indices"])
        coords.append(parsed["coords"])
        symbols.append(parsed["symbols"])
        edges.append(np.asarray(r["graph"]["edges"], np.int32)[:k, :k].tolist())
        golds.append(r["gold"])
    oracle_smiles, _, _ = convert_graph_to_smiles(coords, symbols, edges, num_workers=1)
    ev = SmilesEvaluator(golds, num_workers=1)
    stage_a = _scores(ev, oracle_smiles)
    print("stage A (oracle):", stage_a)
    for r, osm in zip(rows, oracle_smiles):
        if r["chiral"]:
            print(f"  A chiral: gold={r['gold']}\n            orac={osm}")

    # stages B/C: the model's raw prediction on its training set
    raw = m.engine.predict_images_raw(stack_gray_batch([r["img"] for r in rows], m.transform))
    seq_np, edge_np = raw["seq"], raw["edges"]

    pc, ps, pe, flags = [], [], [], []
    for i, r in enumerate(rows):
        parsed = tok.sequence_to_smiles(seq_np[i].tolist())
        k = len(parsed["indices"])
        pc.append(parsed["coords"])
        ps.append(parsed["symbols"])
        pe.append(edge_np[i][:k, :k].tolist())

        gold_parsed = tok.sequence_to_smiles(r["labels"])
        tok_match = parsed["smiles"] == gold_parsed["smiles"]
        gk = len(gold_parsed["indices"])
        ge = np.asarray(r["graph"]["edges"], np.int32)[:gk, :gk]
        if k == gk:
            edge_match = int((np.asarray(pe[-1]) == ge).all())
            gold_wedge = set(zip(*np.where((ge == 5) | (ge == 6))))
            pred_arr = np.asarray(pe[-1])
            pred_wedge = set(zip(*np.where((pred_arr == 5) | (pred_arr == 6))))
            wedge_note = (f"gold_wedges={sorted(gold_wedge)} "
                          f"pred_wedges={sorted(pred_wedge)}")
            details = {t: (int(ge[t]), int(pred_arr[t]))
                       for t in sorted(gold_wedge | pred_wedge)}  # per wedge cell
        else:
            edge_match, wedge_note, details = 0, f"atom count {k} vs {gk}", {}
        flags.append((tok_match, bool(edge_match)))
        tag = "CHIRAL" if r["chiral"] else "      "
        print(f"{tag} tokens={'OK ' if tok_match else 'DIFF'} edges="
              f"{'OK ' if edge_match else 'DIFF'} {r['gold'][:46]}")
        if r["chiral"] or not edge_match:
            print(f"       {wedge_note}")
            if details:
                print(f"       wedge cells (gold,pred): {details}")
        if r["chiral"] and not tok_match:
            print(f"       gold toks: {gold_parsed['smiles']}")
            print(f"       pred toks: {parsed['smiles']}")

    # stage D: the whole pipeline
    pred_smiles, _, _ = convert_graph_to_smiles(pc, ps, pe, num_workers=1)
    stage_d = _scores(ev, pred_smiles)
    print("stage D (model):", stage_d)
    for r, psm in zip(rows, pred_smiles):
        if r["chiral"]:
            print(f"  D chiral: gold={r['gold']}\n            pred={psm}")
    return {"stage_a": stage_a, "stage_d": stage_d,
            "rows": [{"gold": r["gold"], "chiral": r["chiral"], "tokens_match": t,
                      "edges_match": e, "oracle": o, "pred": p}
                     for r, (t, e), o, p in zip(rows, flags, oracle_smiles, pred_smiles)]}
