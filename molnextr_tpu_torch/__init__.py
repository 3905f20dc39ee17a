"""molnextr_tpu_torch: the PyTorch/CUDA port of molnextr_tpu.

Image -> Swin (or ConvNeXt) encoder -> grammar-constrained greedy or beam
decode over an int8 KV cache -> bond head -> SMILES, with the encoder's and
the decode loop's hot operations in hand-written CUDA kernels for Hopper
(``ops/csrc``).  The public surface is :mod:`molnextr_tpu_torch.api` and the
console entry points ``predict``, ``evaluate_cli``, ``train.main`` and
``benchmarks``.  The package imports nothing of JAX or of ``molnextr_tpu``.
"""

__version__ = "0.1.0"
