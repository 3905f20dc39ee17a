#!/usr/bin/env python3
"""Decode-step micro-benchmark of the PyTorch port: the greedy decode's
``unroll`` swept on the card.

Port of ``scripts/bench_decode.py``: ``Config()`` with seeded weights in
bf16 at batch 256.  In the port ``cfg.decode.unroll`` is the number of
decode steps between the host's ``finished.all()`` checks
(``molnextr_tpu_torch/decoding/greedy.py``), the loop's only host sync.
The encode leg is timed alone first (best of ``--iters`` after one
warm-up); then, for each unroll, an ``InferenceEngine`` decodes one
warm-up batch and ``--iters`` timed batches of distinct inputs
(``engine.decode``: encode and decode, ``cfg.decode.min_length`` kept),
and ms per step is ``(best - encode) / max_len``, as
``scripts/bench_decode.py`` reports it.  Each timing ends with a device
sync.  A line per unroll also gives the steps the last decode ran (random
weights may end it early) and ``(best - encode) / steps``; the last line is
``BEST: unroll=... at ... ms/step`` with the card's name and power limit.

Usage::

    python3 scripts/bench_decode_torch.py [--batch 256] [--iters 3] [--unrolls 1,2,4]
                                          [--device cuda]
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time
from typing import Callable, Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from bench_torch import build_engine, card_line, random_images  # noqa: E402
from molnextr_tpu_torch.benchmarks import _sync as sync  # noqa: E402
from molnextr_tpu_torch.config import Config  # noqa: E402
from molnextr_tpu_torch.inference import InferenceEngine, resolve_device  # noqa: E402
from molnextr_tpu_torch.tokenization import EOS_ID  # noqa: E402


def steps_run(seq: torch.Tensor, unroll: int, max_len: int) -> int:
    """The steps a greedy decode ran: it stops at the first multiple of
    ``unroll`` after every row has emitted EOS, or at ``max_len``."""
    eos = seq == EOS_ID
    if not bool(eos.any(dim=1).all()):
        return max_len
    last = int(eos.float().argmax(dim=1).max())
    return min(max_len, unroll * (last // unroll + 1))


@torch.no_grad()
def run(cfg: Config, batch: int = 256, iters: int = 3, unrolls: Sequence[int] = (1, 2, 4),
        device="cuda", dtype=torch.bfloat16,
        draw: Optional[Callable[[int], torch.Tensor]] = None, log=print) -> dict:
    """Returns ``encode_s`` (the best encode), ``max_len`` and, per unroll,
    the best decode's seconds, its ms per step over ``max_len``, the steps
    the last batch ran, the ms per step over those and the tokens of the
    last batch; ``best``: the unroll of the fewest ms per
    step.  ``draw(seed)`` makes each batch (default :func:`random_images`)."""
    cfg = copy.deepcopy(cfg)
    base = build_engine(cfg, device, dtype)
    dev, model, toks = base.device, base.model, {base.fmt: base.tokenizer}
    max_len = base.max_len
    draw = draw or random_images(cfg, batch, dev)
    seeds = iter(range(1, 1000))
    log(f"config: batch {batch}, input {cfg.data.input_size}, max_len {max_len}")

    def timed(fn):
        images = draw(next(seeds))
        sync(dev)
        t0 = time.perf_counter()
        out = fn(images)
        sync(dev)
        return time.perf_counter() - t0, out

    enc_times = [timed(model.encode)[0] for _ in range(iters + 1)]
    enc = min(enc_times[1:] or enc_times)
    log(f"encode leg: {enc:.3f}s/batch")

    results = {}
    for unroll in unrolls:
        cfg.decode.unroll = unroll
        engine = InferenceEngine(cfg, toks, model, device=dev)
        first, _ = timed(engine.decode)
        times, seq = [], None
        for _ in range(iters):
            t, out = timed(engine.decode)
            times.append(t)
            seq = out[0]
        best = min(times)
        ms_step = (best - enc) * 1000.0 / max_len
        steps = steps_run(seq, unroll, max_len)
        ms_run = (best - enc) * 1000.0 / steps
        results[unroll] = {"seconds": best, "ms_per_step": ms_step, "steps": steps,
                           "ms_per_step_run": ms_run, "seq": seq}
        log(f"unroll={unroll}: total {best:.3f}s -> {ms_step:.3f} ms/step "
            f"[first run {first:.1f}s; the last batch ran {steps} of {max_len} steps, "
            f"{ms_run:.3f} ms a step run]")
    best = min(results, key=lambda u: results[u]["ms_per_step"])
    return {"encode_s": enc, "max_len": max_len, "unrolls": results, "best": best}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--unrolls", type=str, default="1,2,4")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    res = run(Config(), args.batch, args.iters, [int(u) for u in args.unrolls.split(",")],
              device)
    best = res["best"]
    print(f"BEST: unroll={best} at {res['unrolls'][best]['ms_per_step']:.3f} ms/step "
          f"({card_line(device) or 'cpu'})")
    return res


if __name__ == "__main__":
    main()
