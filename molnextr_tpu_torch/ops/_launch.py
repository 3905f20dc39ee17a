"""Launch counters, operand checks and the decode-attention kernels' split
plan, shared by the kernel wrappers.

Kept apart from ``ops/__init__.py`` so that the wrapper modules can import
it while the package, which re-exports their entry points, is still
loading.
"""

from typing import Dict, List, NamedTuple, Optional, Tuple

LAUNCHES: Dict[str, int] = {
    "fused_window_attention": 0,
    "fused_ln_mlp": 0,
    "decode_attention_layered_q8": 0,
    "decode_attention_layered": 0,
    "decode_attention": 0,
    "folded_decode_attention": 0,
    "folded_decode_attention_bb": 0,
}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(t) -> int:
    """The kernels' dtype code for a float32 or bfloat16 tensor."""
    try:
        return DTYPE_CODES[str(t.dtype)]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}") from None


CLUSTER_MAX = 8  # the portable thread-block cluster size
WAVE_CTAS = 4 * 132  # CTAs of 256 threads resident at once on an H100: 4 on each SM
MAX_CHUNK_ROWS = 512


class SplitPlan(NamedTuple):
    """How the decode-attention kernels split the positions ``0..pos`` of
    each (batch row, head) group: ``cluster`` CTAs per group, one
    thread-block cluster, each taking ``slice_rows`` positions and staging
    them ``chunk_rows`` rows at a time."""

    cluster: int
    slice_rows: int
    chunk_rows: int


def split_plan(pos: int, groups: int, row_bytes: int, chunk_bytes: int,
               cluster: Optional[int] = None) -> SplitPlan:
    """The split for ``groups`` independent (b, h) groups (or batch rows) of
    ``pos + 1`` positions, rows of ``row_bytes`` bytes, at most
    ``chunk_bytes`` bytes of a cache staged at once.  The cluster size is
    the largest power of two, up to 8, whose grid of ``groups * cluster``
    CTAs still runs in one wave (``WAVE_CTAS``); at least 1.  It depends on
    ``groups`` only, so every position of a decode launches the same grid.
    ``cluster`` overrides it (1 to 8)."""
    if cluster is None:
        cluster = 1
        while cluster < CLUSTER_MAX and groups * cluster * 2 <= WAVE_CTAS:
            cluster *= 2
    if not 1 <= cluster <= CLUSTER_MAX:
        raise ValueError(f"cluster size {cluster} is not in 1..{CLUSTER_MAX}")
    slice_rows = -(-(pos + 1) // cluster)
    chunk_rows = max(1, min(slice_rows, chunk_bytes // row_bytes, MAX_CHUNK_ROWS))
    return SplitPlan(cluster, slice_rows, chunk_rows)


def slices(plan: SplitPlan, pos: int) -> List[Tuple[int, int]]:
    """``(start, stop)`` of each CTA's positions, by cluster rank: the
    kernels' ``slice_bounds``.  A slice that would start past ``pos`` is
    empty and starts at ``pos``."""
    out = []
    for rank in range(plan.cluster):
        raw = rank * plan.slice_rows
        if raw <= pos:
            out.append((raw, min(raw + plan.slice_rows, pos + 1)))
        else:
            out.append((pos, pos))
    return out


def require_cuda(name: str, *tensors) -> int:
    """Check that every tensor is a contiguous CUDA tensor on the current
    device; returns that device's current stream handle for the launch."""
    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: every operand must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return torch.cuda.current_stream(dev).cuda_stream
