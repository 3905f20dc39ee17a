"""Launch counters and operand checks shared by every kernel wrapper.

Kept apart from ``ops/__init__.py`` so that the wrapper modules can import
it while the package, which re-exports their entry points, is still
loading.
"""

from typing import Dict

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
