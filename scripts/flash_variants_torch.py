#!/usr/bin/env python3
"""K7, K8 and K9 of ``flash_attention.cu`` builds timed against each other
on the card: each variant is a source directory (holding
``flash_attention.cu`` and ``common.cuh``, e.g. a ``git archive`` of
another commit) and optional ``nvcc`` flags (``-D...``); all are built at
once, then timed in turns (each variant, then each in reverse order, ``--reps``
times) at B 256, H 8, T 256, bf16, q, k and v strided head views of one
projection, 20 launches in a CUDA graph a timing; SDPA's causal forward is
timed beside them.  ``--check`` prints each variant's K7 error against the
plain version.  Prints the card's name and power limit and one line per
(width, kernel, variant) with its times; writes them, and each build's
``-Xptxas -v`` report, to ``--out``.

Usage::

    python3 scripts/flash_variants_torch.py NAME=SRC_DIR[:FLAG,FLAG...] ... \\
        [--widths 256] [--kernels fwd,dkv,dq] [--reps 2] [--check] [--out output/flash_variants]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def graph_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def build(variants, out, tmp):
    """One nvcc a variant, all at once; returns {name: ctypes library}."""
    from molnextr_tpu_torch.ops import _build

    procs = {}
    for spec in variants:
        name, rest = spec.split("=", 1)
        src, *flags = rest.split(":")
        flags = [f for f in ",".join(flags).split(",") if f]
        so = os.path.join(tmp, f"{name}.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-o", so,
               os.path.join(src, "flash_attention.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(out, f"{name}.ptxas.log"), "w") as f:
            f.write(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in _build.SIGNATURES["flash_attention"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", help="NAME=SRC_DIR[:FLAG,FLAG...]")
    ap.add_argument("--widths", default="256")
    ap.add_argument("--kernels", default="fwd", help="of fwd, dkv, dq")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", default=os.path.join("output", "flash_variants"))
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_variants_torch: no CUDA device", file=sys.stderr)
        return 2
    fl = importlib.import_module("molnextr_tpu_torch.ops.flash_attention")
    os.makedirs(a.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(a.variants, a.out, tmp)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip())
        res = {}
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for d in (int(x) for x in a.widths.split(",")):
            gen = torch.Generator(device="cuda").manual_seed(5)
            b, h, t = 256, 8, 256
            qkv = torch.randn(b, t, 3 * h * d, generator=gen, device="cuda").bfloat16()
            q, k, v = (x.reshape(b, t, h, d).transpose(1, 2) for x in qkv.split(h * d, dim=-1))
            do = torch.randn(b, h, t, d, generator=gen, device="cuda").bfloat16()
            sc = d ** -0.5
            ref = fl.flash_attention_reference(q, k, v, sc) if a.check else None
            di = None
            for rep in range(a.reps):
                for name in list(libs) + list(libs)[::-1]:
                    fl.load_library = lambda _, lib=libs[name]: lib
                    o, lse = fl.flash_attention_fwd(q, k, v, sc)
                    if di is None:
                        di = (o.float() * do.float()).sum(-1)
                    if ref is not None and rep == 0:
                        rows = ((o.float() - ref[0].float()).norm(dim=-1)
                                / ref[0].float().norm(dim=-1).clamp_min(1e-6)).max().item()
                        print(f"  d {d} {name}: o max err "
                              f"{(o.float() - ref[0].float()).abs().max().item():.3e}, rows "
                              f"{rows:.3e}, lse {(lse - ref[1]).abs().max().item():.3e}")
                    runs = {"fwd": lambda: fl.flash_attention_fwd(q, k, v, sc),
                            "dkv": lambda: fl.flash_attention_bwd_dkv(q, k, v, do, lse, di, sc),
                            "dq": lambda: fl.flash_attention_bwd_dq(q, k, v, do, lse, di, sc)}
                    for kernel in a.kernels.split(","):
                        res.setdefault(f"d{d} {kernel} {name}", []).append(
                            round(graph_ms(torch, runs[kernel]), 4))
            res[f"d{d} sdpa_fwd"] = [round(graph_ms(torch, lambda: sdpa(q, k, v, is_causal=True)), 4)
                                     for _ in range(3)]
            del q, k, v, do, qkv, ref
            torch.cuda.empty_cache()
    for key, times in res.items():
        print(key, times)
    with open(os.path.join(a.out, "times.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
