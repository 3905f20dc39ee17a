#!/usr/bin/env python3
"""Where a K7 launch spends its time: ``clock64`` counters in an
instrumented copy of K7's bf16 kernel (``flash_fwd_hopper``) in the form
whose two consumer warpgroups split each d-256 tile's columns (a ``git
archive`` of a commit that has it; the patch raises if the source differs).
The copy is written to ``--out``, outside the committed tree, built with
``nvcc`` and run at B 256, H 8, T 256, bf16, q, k and v strided head views
of one projection, 20 launches after a warm-up.  Per consumer warp, summed
over warps by atomics: the wait for the own Q slot, the ring waits, the S
products, the softmax, the P V products, the epilogue (barrier, staging,
stores) and the whole loop; printed as shares of the loop, with cycles a
step and the instrumented launch's ms (the counters slow it), beside the
card's name and power limit.

Usage::

    python3 scripts/flash_probe_torch.py SRC_DIR [--widths 256,128] [--out output/flash_probe]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NAMES = ("own_wait", "ring_wait", "s_products", "softmax", "pv_products", "epilogue")


# (anchor, replacement) pairs of the instrumented copy: K7's consumer loop
# and fwd_step, counters 0 own-slot wait, 1 ring waits, 2 S products, 3
# softmax, 4 P V products, 5 epilogue, 6 whole loop, 7 steps
PATCHES = (
    ('namespace mnx {\n\nconstexpr int kFlashTile',
     'namespace mnx {\n__device__ unsigned long long g_prof[8];\n\nconstexpr int kFlashTile'),
    ('                                         FwdTile<N>& ta, FwdTile<N>& tb, float scale_log2, int row,\n                                         int t4) {\n  using L = Tile<D>;\n  float sa[32], sb[32];\n  uint32_t pa[4][4], pb[4][4];\n  wgmma_fence();',
     '                                         FwdTile<N>& ta, FwdTile<N>& tb, float scale_log2, int row,\n                                         int t4, long long (&acc)[8]) {\n  using L = Tile<D>;\n  float sa[32], sb[32];\n  uint32_t pa[4][4], pb[4][4];\n  const long long c0 = clock64();\n  wgmma_fence();'),
    ('  hold(sa);\n  if constexpr (BOTH) hold(sb);\n  ta.update(sa, pa, diag_a, scale_log2, row, t4);\n  if constexpr (BOTH) tb.update(sb, pb, diag_b, scale_log2, row, t4);\n  wgmma_fence();',
     '  hold(sa);\n  if constexpr (BOTH) hold(sb);\n  const long long c1 = clock64();\n  ta.update(sa, pa, diag_a, scale_log2, row, t4);\n  if constexpr (BOTH) tb.update(sb, pb, diag_b, scale_log2, row, t4);\n  hold(pa);\n  const long long c2 = clock64();\n  wgmma_fence();'),
    ('  hold(ta.o);\n  hold(pa);\n  if constexpr (BOTH) {\n    hold(tb.o);\n    hold(pb);\n  }\n}',
     '  hold(ta.o);\n  hold(pa);\n  if constexpr (BOTH) {\n    hold(tb.o);\n    hold(pb);\n  }\n  const long long c3 = clock64();\n  acc[2] += c1 - c0;\n  acc[3] += c2 - c1;\n  acc[4] += c3 - c2;\n  acc[7] += 1;\n}'),
    ('  int it = 0, n = 0;\n  for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {\n    const int b = bh / H, h = bh % H;\n    for (int r = 0; r < rounds; ++r)\n      for (int pass = 0; pass < kPasses; ++pass) {\n        const Job j = job<C, false>(nt, r, g, pass);\n        const int len = key_tiles<C>(nt, r, pass);\n        uint8_t* qs = j.a >= 0 ? own + (og * C::kSlots + bars.own_wait(og, n)) * C::kSlot : nullptr;',
     '  int it = 0, n = 0;\n  long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  const long long cstart = clock64();\n  for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {\n    const int b = bh / H, h = bh % H;\n    for (int r = 0; r < rounds; ++r)\n      for (int pass = 0; pass < kPasses; ++pass) {\n        const Job j = job<C, false>(nt, r, g, pass);\n        const int len = key_tiles<C>(nt, r, pass);\n        long long cw = clock64();\n        uint8_t* qs = j.a >= 0 ? own + (og * C::kSlots + bars.own_wait(og, n)) * C::kSlot : nullptr;\n        acc[0] += clock64() - cw;'),
    ('        for (int kt = 0; kt < len; ++kt, ++it) {\n          const uint8_t* st = ring + stream.wait(it) * C::kStage;\n          if constexpr (C::kPair) {\n            if (j.b >= 0 && kt <= j.b)\n              fwd_step<D, C::kCols, true>(qs, qs + L::kBytes, st, st + L::kBytes, kt == j.a,\n                                          kt == j.b, ta, tb, scale_log2, row, t4);\n            else if (j.a >= 0 && kt <= j.a)\n              fwd_step<D, C::kCols, false>(qs, nullptr, st, st + L::kBytes, kt == j.a, false, ta,\n                                           tb, scale_log2, row, t4);\n          } else {\n            if (j.a >= 0 && kt <= j.a)\n              fwd_step<D, C::kCols, false>(qs, nullptr, st, st + L::kBytes + off, kt == j.a, false,\n                                           ta, tb, scale_log2, row, t4);\n          }',
     '        for (int kt = 0; kt < len; ++kt, ++it) {\n          cw = clock64();\n          const uint8_t* st = ring + stream.wait(it) * C::kStage;\n          acc[1] += clock64() - cw;\n          if constexpr (C::kPair) {\n            if (j.b >= 0 && kt <= j.b)\n              fwd_step<D, C::kCols, true>(qs, qs + L::kBytes, st, st + L::kBytes, kt == j.a,\n                                          kt == j.b, ta, tb, scale_log2, row, t4, acc);\n            else if (j.a >= 0 && kt <= j.a)\n              fwd_step<D, C::kCols, false>(qs, nullptr, st, st + L::kBytes, kt == j.a, false, ta,\n                                           tb, scale_log2, row, t4, acc);\n          } else {\n            if (j.a >= 0 && kt <= j.a)\n              fwd_step<D, C::kCols, false>(qs, nullptr, st, st + L::kBytes + off, kt == j.a, false,\n                                           ta, tb, scale_log2, row, t4, acc);\n          }'),
    ('        if (j.a < 0) continue;\n        float* lh = lse + (long long)bh * T;\n        bf16* oh = head_ptr(o, lay, 3, b, h);',
     '        if (j.a < 0) continue;\n        cw = clock64();\n        float* lh = lse + (long long)bh * T;\n        bf16* oh = head_ptr(o, lay, 3, b, h);'),
    ('          write_rows<D, C::kCols>(oh, lay.s[3][2], j.b * kFlashTile, qs + L::kBytes, w, lane, col0);\n        bars.own_release(og, n++, lane);\n      }\n  }\n}',
     '          write_rows<D, C::kCols>(oh, lay.s[3][2], j.b * kFlashTile, qs + L::kBytes, w, lane, col0);\n        bars.own_release(og, n++, lane);\n        acc[5] += clock64() - cw;\n      }\n  }\n  acc[6] += clock64() - cstart;\n  if (lane == 0)\n    for (int i = 0; i < 8; ++i) atomicAdd(&g_prof[i], (unsigned long long)acc[i]);\n}'),
)
READOUT = '\nextern "C" int mnx_probe_reset() {\n  unsigned long long z[8] = {};\n  return cudaMemcpyToSymbol(mnx::g_prof, z, sizeof(z));\n}\nextern "C" int mnx_probe_read(unsigned long long* out) {\n  return cudaMemcpyFromSymbol(out, mnx::g_prof, 8 * sizeof(unsigned long long));\n}\n'


def instrument(src: str) -> str:
    """The source with the counters; raises where an anchor is missing."""
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise ValueError("the source is not the column-split K7 this probe instruments")
        src = src.replace(old, new)
    return src + READOUT


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="a directory holding flash_attention.cu and common.cuh")
    ap.add_argument("--widths", default="256,128")
    ap.add_argument("--out", default=os.path.join("output", "flash_probe"))
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_probe_torch: no CUDA device", file=sys.stderr)
        return 2
    from molnextr_tpu_torch.ops import _build

    fl = importlib.import_module("molnextr_tpu_torch.ops.flash_attention")
    os.makedirs(a.out, exist_ok=True)
    shutil.copy(os.path.join(a.src, "common.cuh"), a.out)
    cu = os.path.join(a.out, "probe.cu")
    with open(os.path.join(a.src, "flash_attention.cu")) as f:
        text = instrument(f.read())
    with open(cu, "w") as f:
        f.write(text)
    so = os.path.join(a.out, "probe.so")
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, cu], capture_output=True,
                       text=True)
    with open(os.path.join(a.out, "probe.ptxas.log"), "w") as f:
        f.write(r.stdout + r.stderr)
    if r.returncode:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    for fn, argtypes in _build.SIGNATURES["flash_attention"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.mnx_probe_read.argtypes = [ctypes.c_void_p]
    fl.load_library = lambda _: lib
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True)
    print(card.stdout.strip())
    for d in (int(x) for x in a.widths.split(",")):
        gen = torch.Generator(device="cuda").manual_seed(1)
        b, h, t = 256, 8, 256
        qkv = torch.randn(b, t, 3 * h * d, generator=gen, device="cuda").bfloat16()
        q, k, v = (x.reshape(b, t, h, d).transpose(1, 2) for x in qkv.split(h * d, dim=-1))
        sc = d ** -0.5
        for _ in range(3):
            fl.flash_attention_fwd(q, k, v, sc)
        torch.cuda.synchronize()
        lib.mnx_probe_reset()
        reps = 20
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fl.flash_attention_fwd(q, k, v, sc)
        e1.record()
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * 8)()
        lib.mnx_probe_read(out)
        vals = list(out)
        res = {name: round(vals[i] / vals[6], 4) for i, name in enumerate(NAMES)}
        res["cycles_a_step"] = {name: round(vals[i] / max(vals[7], 1), 1)
                                for i, name in ((2, "s"), (3, "softmax"), (4, "pv"))}
        res["ms_a_launch_instrumented"] = round(e0.elapsed_time(e1) / reps, 4)
        print(f"d {d}", json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
