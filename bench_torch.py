#!/usr/bin/env python3
"""Benchmark: end-to-end inference throughput of the PyTorch port on one card.

Port of ``bench.py``: the full serving device path of ``Config()`` (Swin-B
encode through the hand-written K1 and K2 kernels, the KV-cached
grammar-constrained greedy decode through K3, the pairwise edge head) at
batch 256 in bf16, with seeded random weights.  The decode is forced to
all ``--decode-len`` steps (``min_len = max_len``) and the edge head runs
on all ``max_atoms`` slots, so the number is a worst case independent of
the weights.  Each iteration draws distinct inputs on the device; one
warm-up run comes first, then ``--iters`` timed runs, timed on the wall
clock over the loop and ended by a device sync.

The encode and decode are the serving engine's own
(``InferenceEngine.decode``), which syncs with the host every
``cfg.decode.unroll`` steps (the early-exit check; at a forced length it
never exits).  Earlier lines give CUDA-event times of the three device
phases of the last timed run and the peak device memory; the last line is one JSON
object: ``metric``, ``value``, ``unit`` as ``bench.py`` prints them, with
the batch, the KV-cache form and the card (``nvidia-smi``'s name and power
limit).

Usage::

    python3 bench_torch.py [--batch 256] [--iters 3] [--decode-len 480]
                           [--kv-int8 | --no-kv-int8] [--device cuda]

``MOLNEXTR_KV_INT8=1`` or no flag keeps the config's int8 cache.
``--device cpu`` runs the plain PyTorch versions of the kernels on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
from typing import Callable, Optional

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from molnextr_tpu_torch.benchmarks import _sync as sync  # noqa: E402
from molnextr_tpu_torch.config import Config  # noqa: E402
from molnextr_tpu_torch.inference import InferenceEngine, resolve_device  # noqa: E402
from molnextr_tpu_torch.models.model import MolNexTRModel  # noqa: E402
from molnextr_tpu_torch.tokenization import get_tokenizer  # noqa: E402
from molnextr_tpu_torch.weights import load_flax_params, seeded_flax_params  # noqa: E402

METRIC = "inference_images_per_sec_per_chip"


def card_line(device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card; None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_engine(cfg: Config, device, dtype=torch.bfloat16) -> InferenceEngine:
    """``cfg``'s model with ``seeded_flax_params(seed=0)`` in ``dtype``, in
    an engine on ``device`` (which must be the CPU or a Hopper card)."""
    device = resolve_device(device)
    toks = get_tokenizer(cfg.data)
    vocab = {f: len(t) for f, t in toks.items()}
    model = load_flax_params(MolNexTRModel(cfg, vocab), seeded_flax_params(cfg, vocab, 0))
    model.to_dtype(dtype)
    return InferenceEngine(cfg, toks, model, device=device)


def random_images(cfg: Config, batch: int, device) -> Callable[[int], torch.Tensor]:
    """Seed -> a float32 ``(batch, S, S, 3)`` standard normal batch drawn on
    ``device`` from a ``torch.Generator`` seeded so."""
    s = cfg.data.input_size

    def draw(seed: int) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randn((batch, s, s, 3), generator=gen, device=device, dtype=torch.float32)

    return draw


def bench_config(cfg: Config, decode_len: int, kv_int8: Optional[bool]) -> Config:
    """A copy of ``cfg`` with the decode length and, unless None, the cache form."""
    cfg = copy.deepcopy(cfg)
    cfg.decoder.max_len = decode_len
    if kv_int8 is not None:
        cfg.decoder.kv_int8 = kv_int8
    return cfg


@torch.no_grad()
def run(cfg: Config, batch: int = 256, iters: int = 3, decode_len: int = 480,
        kv_int8: Optional[bool] = None, device="cuda", dtype=torch.bfloat16,
        draw: Optional[Callable[[int], torch.Tensor]] = None) -> dict:
    """One warm-up run on ``draw(0)``, then ``iters`` timed runs on
    ``draw(1..iters)`` (default: :func:`random_images`).  A run is the
    engine's decode (``InferenceEngine.decode``, forced to its full length),
    then the edge head on all ``max_atoms`` slots.

    Returns ``outputs``: (seq (B, T), avg (B,), edge logits (B, 7, K, K)) of
    the last run; ``seconds_per_batch`` and ``images_per_s`` from the wall
    clock over the timed loop; on a card also ``split`` (CUDA events of the
    last run: the Swin encoder's ms, the rest of the decode in ms per step,
    which holds the memory projection, and the edge head's ms) and
    ``peak_memory_bytes``."""
    cfg = bench_config(cfg, decode_len, kv_int8)
    engine = build_engine(cfg, device, dtype)
    dev, model = engine.device, engine.model
    draw = draw or random_images(cfg, batch, dev)
    indices = torch.arange(cfg.data.max_atoms, device=dev)[None].repeat(batch, 1)
    on_card = dev.type == "cuda"
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if on_card else None

    def infer(images):
        seq, avg, _, hiddens = engine.decode(images, min_len=engine.max_len)
        if events is not None:
            events[2].record()
        edges = model.predict_edges(hiddens, indices)["edges"]
        if events is not None:
            events[3].record()
        return seq, avg, edges

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    out = infer(draw(0))  # warm-up
    sync(dev)
    hooks = () if events is None else (  # the encoder's ends in every timed run
        model.encoder.register_forward_pre_hook(lambda *_: events[0].record()),
        model.encoder.register_forward_hook(lambda *_: events[1].record()))
    t0 = time.perf_counter()
    for i in range(iters):
        out = infer(draw(i + 1))
    sync(dev)
    dt = (time.perf_counter() - t0) / iters
    for hook in hooks:
        hook.remove()
    result = {"outputs": out, "batch": batch, "iters": iters, "decode_steps": engine.max_len,
              "kv_cache": "int8" if cfg.decoder.kv_int8 else "dense",
              "seconds_per_batch": dt, "images_per_s": batch / dt,
              "split": None, "peak_memory_bytes": None}
    if on_card:
        enc, dec, edg = (events[j].elapsed_time(events[j + 1]) for j in range(3))
        result["split"] = {"encode_ms": enc, "decode_ms_per_step": dec / engine.max_len,
                           "edges_ms": edg}
        result["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    return result


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--decode-len", type=int, default=480)
    p.add_argument(
        "--kv-int8", action=argparse.BooleanOptionalAction,
        default=(os.environ.get("MOLNEXTR_KV_INT8", "") == "1") or None,
        help="int8 KV caches in the decode loop; unset = DecoderConfig.kv_int8's default (on)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    res = run(Config(), args.batch, args.iters, args.decode_len, args.kv_int8, device)
    card = card_line(device)
    if res["split"] is not None:
        print(json.dumps(dict(res["split"], peak_memory_gb=res["peak_memory_bytes"] / 1e9,
                              card=card)))
    print(json.dumps({"metric": METRIC, "value": res["images_per_s"], "unit": "img/s",
                      "batch": res["batch"], "kv_cache": res["kv_cache"],
                      "decode_steps": res["decode_steps"], "iters": res["iters"],
                      "device": device.type, "card": card}))
    return res


if __name__ == "__main__":
    main()
