"""molnextr_tpu_torch: the PyTorch/CUDA port of molnextr_tpu.

Image -> Swin (or ConvNeXt) encoder -> grammar-constrained greedy or beam
decode over an int8 KV cache -> bond head -> SMILES, with the encoder's and
the decode loop's hot operations in hand-written CUDA kernels for Hopper
(``ops/csrc``).  The public surface is :mod:`molnextr_tpu_torch.api` and the
console entry points ``predict``, ``evaluate_cli``, ``train.main`` and
``benchmarks``.  The package imports nothing of JAX or of ``molnextr_tpu``.

The root exports what the JAX package's root exports; ``get_predictions``
and ``MolNexTR`` import :mod:`~molnextr_tpu_torch.api` (and torch) only when
called, and take its ``device`` keyword (``"cuda"`` unless the caller asks
for ``"cpu"``)::

    from molnextr_tpu_torch import get_predictions
    result = get_predictions("mol.png", atoms_bonds=True, device="cpu")
"""

__version__ = "0.1.0"

from molnextr_tpu_torch.config import Config  # noqa: F401


def get_predictions(*args, **kwargs):
    from molnextr_tpu_torch.api import get_predictions as _gp

    return _gp(*args, **kwargs)


def MolNexTR(*args, **kwargs):
    from molnextr_tpu_torch.api import MolNexTR as _M

    return _M(*args, **kwargs)
