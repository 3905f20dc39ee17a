#!/usr/bin/env python3
"""Where the port's kernels spend their time, on one Hopper card: a launch
of the decode-attention kernels, and the device kernels inside the Swin
encoder's K1 and K2.  Run from the root of a checkout::

    python3 chip_probe.py [--parts sweep,barriers,trace,encoder]

* sweep: time per launch (a CUDA graph of 50 launches, CUDA events) at
  positions 0, 60, 240 and 479 of the full-width decode (B 32, H 8, T 512,
  d 32, bf16): the decode kernel (K3) dense and int8 at every cluster size
  1, 2, 4 and 8, K5 with its plan, SDPA on the same cache, and an empty
  PyTorch kernel (the graph's launch floor);
* barriers: empty kernels of the decode kernel's grid shapes, timed the same
  way, with 1, 3 or 10 cluster barriers, 8 distributed shared-memory reads,
  10 block barriers or 1 and 4 dependent global loads;
* trace: ``%globaltimer`` stamps at the phases of copies of the two kernels
  built with marks, per CTA; prints the spread of the CTAs' start times and
  the median and largest time of each phase over the CTAs, in ns;
* encoder: the device kernels inside one call of K1 (QKV GEMM, window
  attention, projection GEMM) and K2 (fc1 and fc2, or the one fused
  kernel) at the four Swin-B stage shapes, batch 32, bf16, from
  ``torch.profiler``'s CUDA activity, and their sums over one encode.

A development tool beside ``chip_smoke.py``, which is the contract check.
It builds into ``build/probe`` and exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "probe")
CSRC = os.path.join(HERE, "molnextr_tpu_torch", "ops", "csrc")
NVCC = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-w",
        "-Xcompiler", "-fPIC"]
POSITIONS = (0, 60, 240, 479)

BARRIER_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void k_empty(const float* q, float* out, int n) {
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1.f;
}
__global__ void k_csync(const float* q, float* out, int n) {
  cg::cluster_group c = cg::this_cluster();
  for (int i = 0; i < n; ++i) c.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1.f;
}
__global__ void k_dsmem(const float* q, float* out, int n) {
  extern __shared__ float sm[];
  cg::cluster_group c = cg::this_cluster();
  sm[threadIdx.x] = threadIdx.x;
  c.sync();
  float s = 0.f;
  for (int i = 0; i < n; ++i)
    s += c.map_shared_rank(sm, (c.block_rank() + i) % c.num_blocks())[threadIdx.x];
  c.sync();
  if (s == -1.f) out[0] = s;
}
__global__ void k_bsync(const float* q, float* out, int n) {
  for (int i = 0; i < n; ++i) __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1.f;
}
__global__ void k_chain(const float* q, float* out, int n) {
  int idx = (blockIdx.x * blockDim.x + threadIdx.x) & 1023;
  float x = 0.f;
  for (int i = 0; i < n; ++i) {
    x += q[idx];
    idx = ((int)x + idx + 1) & 1023;
  }
  if (x == -1.f) out[0] = x;
}
extern "C" int launch(int which, int grid, int block, int cluster, int smem, int n,
                      const float* q, float* out, void* stream) {
  void (*ks[])(const float*, float*, int) = {k_empty, k_csync, k_dsmem, k_bsync, k_chain};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  cudaLaunchKernelEx(&cfg, ks[which], q, out, n);
  return (int)cudaGetLastError();
}
"""

TRACE_HEADER = r"""
__device__ unsigned long long g_trace[1 << 16];
#define MARK(i) if (threadIdx.x == 0 && blockIdx.x < 4096) {                  \
    unsigned long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
    g_trace[blockIdx.x * 16 + (i)] = t_; }
extern "C" int read_trace(unsigned long long* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)); }
extern "C" int clear_trace() {
  static unsigned long long z[1 << 16];
  return (int)cudaMemcpyToSymbol(g_trace, z, sizeof(z)); }
namespace mnx {"""

# (anchor in the source, mark inserted after it or, with False, before it)
DECODE_MARKS = [
    ("  cluster_arrive_after_init();\n", "MARK(0)\n", True),
    ("  qs[tid] = qv;\n", "MARK(1)\n", True),
    ("      cp_async_wait_upto(nparts - p);  // K parts p + 1 .. and V may be in flight\n"
     "      __syncthreads();\n", "if (p == 0) { MARK(2) }\n", True),
    ("  cluster_wait();  // every peer", "MARK(3)\n", False),
    ("  mbar_wait(bar_ml, 0);\n", "MARK(4)\n", True),
    ("  // 4. warp 0 sends", "MARK(5)\n", False),
    ("    mbar_arrive_remote(bar_ctx, 0);\n  }\n", "MARK(6)\n", True),
    ("    mbar_wait(bar_ctx, 0);\n", "MARK(7)\n", True),
    ("  // A CTA of rank r > 0 leaves", "MARK(8)\n", False),
]
DECODE_PHASES = ("start+q", "K part 0", "scores+(m,l)", "exchange", "PV", "push", "wait", "out")
FOLDED_MARKS = [
    ("  cluster_arrive_after_init();\n", "MARK(0)\n", True),
    ("    for (int e = 0; e < V; ++e) acc[i][e] = 0.f;\n  }\n", "MARK(1)\n", True),
    ("      cp_async_wait_upto(kParts - p);  // K parts p + 1 .. and V may be in flight\n"
     "      __syncthreads();\n", "if (p == 0) { MARK(2) }\n", True),
    ("    cp_async_wait<0>();\n    __syncthreads();\n", "MARK(3)\n", True),
    ("  cluster_wait();  // every peer's mbarrier", "MARK(4)\n", False),
    ("    mbar_arrive_remote(bar, 0);\n  }\n", "MARK(5)\n", True),
    ("    mbar_wait(bar, 0);\n", "MARK(6)\n", True),
    ("  // A CTA of rank r > 0 leaves", "MARK(7)\n", False),
]
FOLDED_PHASES = ("start+q", "K part 0", "scores+stats", "PV", "push", "wait", "out")


def build(name: str, source: str) -> ctypes.CDLL:
    from molnextr_tpu_torch.ops._build import find_nvcc

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, f"{name}.cu")
    with open(src, "w") as f:
        f.write(source)
    lib = os.path.join(OUT, f"lib{name}.so")
    subprocess.run([find_nvcc(), *NVCC, "-I", CSRC, "-o", lib, src], check=True)
    return ctypes.CDLL(lib)


def part_sweep(torch, cs, tm):
    from molnextr_tpu_torch.ops import folded_attention as fa

    da = importlib.import_module("molnextr_tpu_torch.ops.decode_attention")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    q, kc, vc = cs.cache_inputs(torch, gen, bf, False)
    q8 = cs.cache_inputs(torch, gen, bf, True)
    qf, kf, vf = cs.folded_inputs(torch, gen, bf)
    t_idx = torch.arange(cs.DEC_T, device="cuda")
    print("sweep: us per launch (graph of 50), B 32, H 8, T 512, d 32, bf16, layer 3")
    for pos in POSITIONS:
        row = [f"  pos {pos:3d}"]
        for form in ("dense", "int8"):
            for cl in (1, 2, 4, 8):
                if form == "dense":
                    fn = lambda: da._launch_k3("decode_attention_layered", q, kc, vc,  # noqa: E731
                                               None, None, pos, 3, cluster=cl)
                else:
                    fn = lambda: da._launch_k3("decode_attention_layered_q8", q8[0], q8[1],  # noqa: E731
                                               q8[3], q8[2], q8[4], pos, 3, cluster=cl)
                row.append(f"{form} c{cl} {tm.ms(fn, reps=50, graph=True) * 1e3:.2f}")
        others = {
            "K5": lambda: fa.folded_decode_attention(qf, kf, vf, pos, 3, cs.DEC_H),
            "SDPA": lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kc[3], vc[3], attn_mask=(t_idx <= pos)[None, None, None]),
            "empty": lambda: torch.empty(1, device="cuda").zero_(),
        }
        row += [f"{k} {tm.ms(fn, reps=50, graph=True) * 1e3:.2f}" for k, fn in others.items()]
        print(" ".join(row), flush=True)


def part_barriers(torch, tm):
    lib = build("barriers", BARRIER_SRC)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.launch.argtypes = [I] * 6 + [P, P, P]
    q = torch.rand(1024, device="cuda") * 0.5
    out = torch.zeros(4, device="cuda")

    def us(which, grid, cluster, n):
        def fn():
            e = lib.launch(which, grid, 128, cluster, 12288, n, q.data_ptr(), out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
            assert e == 0, e

        return tm.ms(fn, reps=50, graph=True) * 1e3

    print("barriers: us per launch (graph of 50) of empty 128-thread kernels, 12 KB shared memory")
    for grid, cluster in ((256, 0), (2048, 0), (256, 1), (512, 2), (1024, 4), (2048, 8)):
        row = [f"  grid {grid} cluster {cluster}: empty {us(0, grid, cluster, 0):.2f}"]
        if cluster:
            row += [f"cluster.sync x{n} {us(1, grid, cluster, n):.2f}" for n in (1, 3, 10)]
            row.append(f"8 DSMEM reads {us(2, grid, cluster, 8):.2f}")
        row.append(f"__syncthreads x10 {us(3, grid, cluster, 10):.2f}")
        row += [f"{n} dependent loads {us(4, grid, cluster, n):.2f}" for n in (1, 4)]
        print(" ".join(row), flush=True)


def instrumented(name: str, marks) -> ctypes.CDLL:
    with open(os.path.join(CSRC, "common.cuh")) as f:
        common = f.read().replace("namespace mnx {", TRACE_HEADER, 1)
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        src = f.read().replace('#include "common.cuh"', "")
    for anchor, mark, after in marks:
        if src.count(anchor) != 1:
            raise RuntimeError(f"{name}.cu: trace anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + mark if after else mark + anchor)
    lib = build(f"trace_{name}", common + src)
    lib.read_trace.argtypes = [ctypes.c_void_p]
    return lib


def part_trace(torch, cs):
    import numpy as np

    from molnextr_tpu_torch.ops._build import SIGNATURES
    from molnextr_tpu_torch.ops._launch import split_plan

    da = importlib.import_module("molnextr_tpu_torch.ops.decode_attention")
    fa = importlib.import_module("molnextr_tpu_torch.ops.folded_attention")
    libs = {"decode": instrumented("decode_attention", DECODE_MARKS),
            "folded": instrumented("folded_attention", FOLDED_MARKS)}
    libs["decode"].mnx_decode_attention_layered.argtypes = \
        SIGNATURES["decode_attention"]["mnx_decode_attention_layered"]
    libs["folded"].mnx_folded_decode_attention.argtypes = \
        SIGNATURES["folded_attention"]["mnx_folded_decode_attention"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    q, kc, vc = cs.cache_inputs(torch, gen, bf, False)
    qf, kf, vf = cs.folded_inputs(torch, gen, bf)
    bh, d, dm = cs.BATCH * cs.DEC_H, cs.DEC_D, cs.DEC_H * cs.DEC_D
    buf = np.zeros(1 << 16, np.uint64)
    print("trace: ns from the first CTA's start; phase times median/max over CTAs")
    for kind, phases in (("decode", DECODE_PHASES), ("folded", FOLDED_PHASES)):
        for pos in (0, 479):
            for cl in ((1, 2, 4) if kind == "decode" else (None,)):
                lib = libs[kind]
                for _ in range(3):  # the last of three launches
                    lib.clear_trace()
                    st = torch.cuda.current_stream().cuda_stream
                    if kind == "decode":
                        plan = split_plan(pos, bh, 2 * d, da.CHUNK_BYTES, cl)
                        out = torch.empty_like(q)
                        e = lib.mnx_decode_attention_layered(
                            1, 0, q.data_ptr(), kc.data_ptr(), vc.data_ptr(), None, None,
                            out.data_ptr(), cs.BATCH, cs.DEC_H, cs.DEC_T, d, pos, 3, *plan, st)
                        groups = bh
                    else:
                        plan = split_plan(pos, cs.BATCH, 2 * dm, fa.CHUNK_BYTES)
                        out = torch.empty_like(qf)
                        e = lib.mnx_folded_decode_attention(
                            1, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
                            cs.BATCH, cs.DEC_T, dm, cs.DEC_H, pos, 3, *plan, st)
                        groups = cs.BATCH
                    assert e == 0, e
                    torch.cuda.synchronize()
                lib.read_trace(buf.ctypes.data)
                n = groups * plan.cluster
                tr = buf[: n * 16].reshape(n, 16).astype(np.int64)
                rel = tr - tr[:, 0].min()
                rank0 = np.arange(n) % plan.cluster == 0
                row = [f"  {kind} pos {pos} cluster {plan.cluster} ({n} CTAs): start median "
                       f"{np.median(rel[:, 0]):.0f} max {rel[:, 0].max()}"]
                for i, name in enumerate(phases):
                    sel = (tr[:, i] > 0) & (tr[:, i + 1] > 0)
                    if i + 1 >= len(phases) - 1:  # rank 0's wait and its write
                        sel &= rank0
                    if sel.any():
                        dur = rel[sel, i + 1] - rel[sel, i]
                        row.append(f"{name} {np.median(dur):.0f}/{dur.max()}")
                row.append(f"end {rel[rank0, len(phases)].max()}")
                print(" ".join(row), flush=True)


ENCODER_CALLS = 3  # profiled calls of each kernel at each shape, after one warm-up
# the kernels of one call, in launch order, by their number
ENCODER_PARTS = {"K1": {3: ("qkv", "attention", "proj")},
                 "K2": {1: ("fused",), 2: ("fc1", "fc2")}}


def device_kernels(torch, fn, calls):
    """The device kernels of ``calls`` calls of ``fn``, from
    ``torch.profiler``'s CUDA activity: one list of (name, us) per call,
    in launch order, and the calls' mean CUDA-event time in us."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    if not kern or len(kern) % calls:
        raise RuntimeError(f"profiler saw {len(kern)} device kernels in {calls} calls")
    per = len(kern) // calls
    runs = [[(e.name, e.time_range.elapsed_us()) for e in kern[i * per:(i + 1) * per]]
            for i in range(calls)]
    return runs, start.elapsed_time(end) * 1e3 / calls


def part_encoder(torch, cs):
    """Each device kernel inside one K1 and one K2 call at the four Swin-B
    stage shapes, batch 32, bf16, labelled by its place in the call (K2 is
    one fused kernel or two GEMMs, by ``encoder_plan``)."""
    from molnextr_tpu_torch.ops import swin_fused as sf

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    print(f"encoder: us per kernel (mean of {ENCODER_CALLS} profiled calls), batch {cs.BATCH}, "
          "bf16; per encode = x launches of one encode")
    total = {}
    for res, c, heads, depth in cs.STAGES:
        t = cs.BATCH * res * res
        variants = ((False, depth // 2), (True, depth - depth // 2)) if res > cs.WS else ((False, depth),)
        calls = []
        for shifted, count in variants:
            args = cs.window_inputs(torch, gen, cs.BATCH, res, c, heads, cs.WS, shifted, bf)
            calls.append((f"K1 res {res} C {c} {'shifted' if shifted else 'unshifted'}", count,
                          lambda a=args: sf.fused_window_attention(*a)))
        args = cs.mlp_inputs(torch, gen, t, c, bf)
        calls.append((f"K2 T {t} C {c}", depth, lambda a=args: sf.fused_ln_mlp(*a)))
        for label, count, fn in calls:
            runs, call_us = device_kernels(torch, fn, ENCODER_CALLS)
            kind = label.split()[0]
            parts = ENCODER_PARTS[kind].get(len(runs[0]))
            if parts is None:
                raise RuntimeError(f"{label}: {len(runs[0])} kernels a call")
            row = [f"  {label} x {count}: call {call_us:.1f}"]
            for i, part in enumerate(parts):
                us = sum(r[i][1] for r in runs) / len(runs)
                key = f"{kind} {part}"
                total[key] = total.get(key, 0.0) + count * us
                row.append(f"{part} {us:.1f} [{runs[0][i][0][:60]}]")
            print(" ".join(row), flush=True)
        del calls, args
        torch.cuda.empty_cache()
    print("  per encode (ms): " + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in total.items()),
          flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parts", default="sweep,barriers,trace,encoder")
    parts = p.parse_args().parts.split(",")
    import torch

    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    tm = cs.Timer(torch)
    if "sweep" in parts:
        part_sweep(torch, cs, tm)
    if "barriers" in parts:
        part_barriers(torch, tm)
    if "trace" in parts:
        part_trace(torch, cs)
    if "encoder" in parts:
        part_encoder(torch, cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
