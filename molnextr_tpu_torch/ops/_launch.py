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


SMEM_LIMIT = 232448  # dynamic shared memory one block may take on an H100 (227 KB)
SMEM_TWO_BLOCKS = 110 * 1024  # at most this each (and their barriers), two blocks share an SM
STATIC_SMEM = 1024  # room left for the kernels' static shared memory (mbarriers, LN statistics)
SMS = 132
GEMM_BM, GEMM_BN, GEMM_BK = 64, 128, 64  # the bf16 GEMMs' tile: 2 warpgroups x 64 columns
LN_GEMM_MIN_BLOCKS = 4 * SMS  # LN GEMM blocks wanted: split the columns until there are
MLP_FUSED_MAX_C = 128  # widths the fused K2 kernel takes: one accumulator slab a warpgroup
ATTN_KEY_TILES = (1, 2, 4, 9, 16)  # 16-key tiles the attention kernel is built for
ATTN_HD_TILES = (1, 2, 4, 8)  # 16-wide head-dim tiles
ATTN_MAX_HD, ATTN_MAX_N = 128, 256
# windows of one head and position a block walks: the most, up to 16, that
# still leaves about a block for each SM (a 9-warp block at 168 registers has
# its SM alone); the more windows a block walks, the fewer times the grid
# reads the bias and mask
ATTN_MAX_WINDOWS, ATTN_MIN_BLOCKS = 16, 128


# how the LN GEMMs (QKV, fc1) get their LayerNormed A operand; the C
# launchers' LnForm
LN_RESIDENT = 0  # the block's 64 rows normalised once into shared memory, where they stay
LN_PINGPONG = 1  # the same, with the two warpgroups taking turns on whole tiles
LN_APART = 2  # rows too wide to stay: LayerNormed into scratch, streamed by the plain GEMM


class EncoderPlan(NamedTuple):
    """How the bf16 kernels of K1 and K2 run one call (``encoder_plan``).

    ``gemm_stages`` / ``ln_gemm_stages``: depth of the TMA ring of the GEMMs
    whose A operand streams (projection, fc2) / is the block's LayerNormed
    rows kept in shared memory (QKV, fc1; per warpgroup with
    ``LN_PINGPONG``).  ``ln_form``: ``LN_RESIDENT``, ``LN_PINGPONG`` (where
    two blocks cannot share an SM but each warpgroup's ring still gets 3
    stages, C = 512) or ``LN_APART`` (where 64 rows and a ring of 2 stages
    do not fit a block, C > 1408).  ``qkv_tiles`` / ``fc1_tiles``:
    128-wide column tiles each LN-GEMM block walks with its rows normalised
    once.  ``mlp_fused``: K2 as one kernel with the 4C intermediate on chip
    rather than two GEMMs (C <= ``MLP_FUSED_MAX_C``); ``mlp_stages``: that
    kernel's ring depth, 0 where it does not run.
    ``attn_key_tiles`` / ``attn_hd_tiles``: the window attention's 16-key
    and 16-wide head-dim tiles (padded up to a built variant),
    ``attn_windows`` windows of one head and window position per block,
    ``attn_buffers`` 1 or 2 (double-buffered staging).  ``smem``: bytes of
    dynamic shared memory per kernel, as the C launchers compute them."""

    gemm_stages: int
    ln_gemm_stages: int
    ln_form: int
    qkv_tiles: int
    fc1_tiles: int
    mlp_fused: bool
    mlp_stages: int
    attn_key_tiles: int
    attn_hd_tiles: int
    attn_windows: int
    attn_buffers: int
    smem: Dict[str, int]


def _tiles(n: int, built) -> int:
    need = -(-n // 16)
    return min(t for t in built if t >= need)


def _stages(fixed: int, per_stage: int, most: int, two_blocks: bool = True, least: int = 2) -> int:
    """The ring depth, at most ``most`` stages beside ``fixed`` bytes: the
    deepest of at least 3 that lets two blocks share an SM, if there is
    one (and ``two_blocks``); else the deepest that fits one block, at
    least ``least``.  Two blocks an SM outrun one block with a deeper ring:
    each overlaps its prologue, epilogue and waits with the other's
    products."""
    if two_blocks:
        for s in range(most, 2, -1):
            if fixed + s * per_stage <= SMEM_TWO_BLOCKS:
                return s
    s = most
    while s > least and fixed + s * per_stage > SMEM_LIMIT - STATIC_SMEM:
        s -= 1
    return s


def _column_tiles(rows: int, n: int) -> int:
    """128-wide column tiles per block of an LN GEMM over ``rows`` rows and
    ``n`` columns: all of them, unless the grid would have fewer than
    ``LN_GEMM_MIN_BLOCKS`` blocks; then the columns are split that many
    more ways (each split normalises the rows again)."""
    row_blocks, col_tiles = -(-rows // GEMM_BM), -(-n // GEMM_BN)
    splits = min(col_tiles, -(-LN_GEMM_MIN_BLOCKS // row_blocks))
    return -(-col_tiles // splits)


def encoder_plan(c: int, tokens: int, num_heads: Optional[int] = None, ws: int = 1,
                 batch: int = 1) -> EncoderPlan:
    """The launch plan of the bf16 K1 (``fused_window_attention`` on
    ``tokens`` = ``batch`` x Hres x Wres tokens of width ``c``, ``num_heads``
    heads, window ``ws``) and K2 (``fused_ln_mlp`` on ``tokens`` rows of
    width ``c``, with ``num_heads`` None: the attention fields then
    describe a window of one token).  Raises ``ValueError`` for a head width
    above 128 or a window of more than 256 tokens, on either device."""
    hd, n = (c // num_heads if num_heads else 1), ws * ws
    if hd > ATTN_MAX_HD or n > ATTN_MAX_N:
        raise ValueError(f"window attention takes head width <= {ATTN_MAX_HD} and <= "
                         f"{ATTN_MAX_N} tokens a window, got {hd} and {n}")
    kb = -(-c // GEMM_BK)  # 64-wide blocks of a row of C
    box = GEMM_BK * 128  # one 64 x 64 bf16 tile, 128-byte swizzled
    stage_out = 2 * box  # the epilogue's staging of a 64 x 128 output tile
    gemm_stages = _stages(1024 + stage_out, 3 * box, 4)
    gemm_smem = 1024 + stage_out + gemm_stages * 3 * box
    ln_fixed = 1024 + kb * box + stage_out  # the block's normalised rows stay resident
    # where two blocks cannot share an SM at 3 stages, the LN GEMM runs
    # ping-pong (each warpgroup a whole tile from a ring of its own) if each
    # ring still gets 3 stages (C = 512; at C = 1024 it lost to one ring of
    # 4 stages on the H100); where not even 2 stages fit beside the rows,
    # LayerNorm runs apart (swin_fused.cu passes K1's ctx or K2's out as
    # the scratch of its rows)
    pp_fixed = 1024 + kb * box + 2 * stage_out
    if (ln_fixed + 3 * 2 * box > SMEM_TWO_BLOCKS
            and pp_fixed + 3 * 4 * box <= SMEM_LIMIT - STATIC_SMEM):
        ln_form = LN_PINGPONG
        ln_gemm_stages = _stages(pp_fixed, 4 * box, 4, two_blocks=False)
        ln_smem = pp_fixed + ln_gemm_stages * 4 * box
    elif ln_fixed + 2 * 2 * box <= SMEM_LIMIT - STATIC_SMEM:
        ln_form = LN_RESIDENT
        ln_gemm_stages = _stages(ln_fixed, 2 * box, 4)
        ln_smem = ln_fixed + ln_gemm_stages * 2 * box
    else:
        ln_form, ln_gemm_stages, ln_smem = LN_APART, gemm_stages, gemm_smem
    # K2 is the fused kernel where two of its blocks share an SM (one
    # accumulator slab a warpgroup, C <= 128); with one block an SM (C 256
    # and 512) two GEMMs measured faster on the H100 (PERF.md).  Its
    # ring needs 3 stages: each warpgroup may hold two slots.
    mlp_fused = c <= MLP_FUSED_MAX_C
    mlp_fixed = 1024 + kb * box + 4 * box  # xn (later the output), h double-buffered
    mlp_stages = _stages(mlp_fixed, 2 * box, 6, least=3) if mlp_fused else 0
    kt, ht = _tiles(n, ATTN_KEY_TILES), _tiles(hd, ATTN_HD_TILES)
    buf = 3 * kt * 16 * (ht * 16 + 8) * 2  # q, k and v of one window, rows padded by 16 bytes
    n_windows = tokens // (batch * n)
    windows = ATTN_MAX_WINDOWS
    while windows > 1 and n_windows * -(-batch // windows) * (num_heads or 1) < ATTN_MIN_BLOCKS:
        windows //= 2
    buffers = 2 if 2 * buf <= SMEM_LIMIT else 1
    smem = {"gemm": gemm_smem, "ln_gemm": ln_smem, "attention": buffers * buf}
    if mlp_fused:
        smem["mlp"] = mlp_fixed + mlp_stages * 2 * box
    return EncoderPlan(gemm_stages, ln_gemm_stages, ln_form, _column_tiles(tokens, 3 * c),
                       _column_tiles(tokens, 4 * c), mlp_fused, mlp_stages, kt, ht, windows,
                       buffers, smem)


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
