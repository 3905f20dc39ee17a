"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper dispatches on the device of the tensor it is given: a CPU
tensor goes to the plain version, a CUDA tensor launches the kernel (or
raises).  The device thus does the job of the JAX package's ``use_pallas``,
which has no counterpart here: the ``cached_*`` dispatchers launch the
kernel for every CUDA tensor.  ``LAUNCHES`` counts kernel launches per
wrapper, so a run can show that its path went through the kernels.

The names below are those of ``molnextr_tpu.ops`` (without ``use_pallas``
and the kernels' ``interpret`` argument), plus ``folded_decode_attention_bb``
and the causal flash attention of the decoder's teacher-forced pass
(``flash_attention``: K7, K8 and K9, the port of JAX's library kernel).
``decode_attention`` names the K4 function, as in the JAX package: reach
the module of that name through :func:`importlib.import_module`.
"""

from molnextr_tpu_torch.ops._launch import (
    LAUNCHES,
    dtype_code,
    require_cuda,
    reset_launch_counts,
)
from molnextr_tpu_torch.ops.decode_attention import (
    cached_decode_attention,
    cached_decode_attention_layered,
    decode_attention,
    decode_attention_layered,
    decode_attention_reference,
)
from molnextr_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference,
    flash_attention_fwd,
    flash_attention_reference,
)
from molnextr_tpu_torch.ops.folded_attention import (
    cached_folded_attention,
    folded_decode_attention,
    folded_decode_attention_bb,
    folded_decode_attention_reference,
)

__all__ = [
    "LAUNCHES",
    "dtype_code",
    "require_cuda",
    "reset_launch_counts",
    "cached_decode_attention",
    "cached_decode_attention_layered",
    "decode_attention",
    "decode_attention_layered",
    "decode_attention_reference",
    "cached_folded_attention",
    "folded_decode_attention",
    "folded_decode_attention_bb",
    "folded_decode_attention_reference",
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "flash_attention_reference",
    "flash_attention_bwd_dkv_reference",
    "flash_attention_bwd_dq_reference",
]
