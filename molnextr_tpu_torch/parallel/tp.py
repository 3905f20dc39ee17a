"""The decoder's tensor-parallel split over a ``model`` mesh axis.

Port of ``molnextr_tpu/parallel/tp.py``.  The JAX package states shardings
(column-parallel ``ffn/w1`` and the vocabulary projection ``output``,
row-parallel ``ffn/w2``: the Megatron pattern) and lets XLA insert the
collectives.  The port's :class:`~molnextr_tpu_torch.models.layers.Dense`
keeps flax's ``(in, out)`` kernel and is no ``nn.Linear``, so
``parallelize_module``'s styles do not apply: :func:`shard_params` cuts the
leaves by hand and gives each split layer its collectives over the
``model`` group:

* column-parallel (``ffn.w1``, ``output``): the input passes through
  :class:`_CopyToModel` (identity forward, all-reduce of the gradient
  backward: each rank's product sees only its columns), the product is
  local, ``output``'s column-sharded logits are all-gathered
  (:class:`_GatherFromModel`; backward keeps the rank's slice), then the
  bias is added (``w1``'s is sharded with its columns, ``output``'s is
  replicated, as the JAX rules leave it);
* row-parallel (``ffn.w2``): the local product of the rank's input shard is
  all-reduced (:class:`_ReduceFromModel`; backward is the identity: the
  gradient arriving there is replicated, not partial) before the
  replicated bias.

``torch.distributed.nn.functional``'s all-reduce sums the gradient in its
backward as well, which counts a replicated gradient once per rank; these
three functions are the pairs the split needs.  Every replicated leaf then
gets the same gradient on every ``model`` rank, so the data-parallel step
reduces gradients over ``data`` alone.  A dim the ``model`` axis does not
divide stays replicated (the chartok vocabulary, V = 229).  The FFN's
hidden dropout draws per shard (the ``model`` rank folded into its seed).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
from torch import nn

from molnextr_tpu_torch.models.decoder import FeedForward
from molnextr_tpu_torch.models.layers import Dense, Dropout, fold_in
from molnextr_tpu_torch.parallel.mesh import (
    Sharding, axis_group, axis_rank, axis_size, replicated,
)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(n, dim=-1)[r].contiguous(), None


class ColumnParallelDense(Dense):
    """A :class:`Dense` holding a block of its kernel's columns; ``gather``
    all-gathers the output's columns before the (replicated) bias."""

    def __init__(self, dense: Dense, group, gather: bool):
        nn.Module.__init__(self)
        self.kernel, self.bias, self.f32_bias = dense.kernel, dense.bias, dense.f32_bias
        self.group, self.gather = group, gather

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _CopyToModel.apply(x, self.group).to(self.kernel.dtype) @ self.kernel
        if self.gather:
            y = _GatherFromModel.apply(y, self.group)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class RowParallelDense(Dense):
    """A :class:`Dense` holding a block of its kernel's rows: the partial
    products are summed over the group before the replicated bias."""

    def __init__(self, dense: Dense, group):
        nn.Module.__init__(self)
        self.kernel, self.bias, self.f32_bias = dense.kernel, dense.bias, dense.f32_bias
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _ReduceFromModel.apply(x.to(self.kernel.dtype) @ self.kernel, self.group)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class ShardDropout(Dropout):
    """Dropout on a sharded activation: the ``model`` rank is folded into
    the seed, so the shards draw different masks."""

    def __init__(self, drop: Dropout, shard: int):
        super().__init__(drop.rate, drop.drop_path)
        self.site, self.shard = drop.site, shard

    def forward(self, x: torch.Tensor, seed) -> torch.Tensor:
        return super().forward(x, None if seed is None else fold_in(seed, self.shard))


def decoder_tp_shardings(model: nn.Module, mesh) -> Dict[str, Sharding]:
    """Parameter name -> :class:`Sharding`.  Names ending in
    ``ffn.w1.kernel`` and ``output.kernel`` split their output (last) dim
    over ``model``, ``ffn.w2.kernel`` its input dim, ``ffn.w1.bias`` its
    only dim; every other leaf, and any dim the axis does not divide, is
    replicated."""
    n = axis_size(mesh, "model")
    out = {}
    for name, p in model.named_parameters():
        spec = [None] * p.dim()
        if "model" in mesh.mesh_dim_names:
            if name.endswith(("ffn.w1.kernel", "output.kernel", "ffn.w1.bias")):
                axis = -1
            elif name.endswith("ffn.w2.kernel"):
                axis = -2
            else:
                axis = None
            if axis is not None and p.dim() >= -axis and p.shape[axis] % n == 0:
                spec[axis] = "model"
        out[name] = Sharding(mesh, tuple(spec)) if "model" in spec else replicated(mesh)
    return out


def shard_params(state, mesh):
    """Cut ``state``'s model to this rank's shards under the rules of
    :func:`decoder_tp_shardings`, in place, before its first step: each
    split leaf keeps its block (and so do its optimizer moments), the split
    layers become :class:`ColumnParallelDense`/:class:`RowParallelDense`,
    and the optimizer's clip sums the shards' squares over the ``model``
    group.  Returns ``state``; a mesh with one ``model`` rank leaves it as
    it was.  Evaluation and checkpoints read whole leaves, so a sharded
    state is trained, not served."""
    n = axis_size(mesh, "model")
    if n == 1:
        return state
    r, group = axis_rank(mesh, "model"), axis_group(mesh, "model")
    model, opt = state.model, state.optimizer
    shardings = decoder_tp_shardings(model, mesh)
    where = {name: (g, i) for g, names in opt.names.items() for i, name in enumerate(names)}
    split = set()
    for name, p in model.named_parameters():
        d = shardings[name].dim_of("model")
        if d is None:
            continue
        cut = lambda t: t.chunk(n, dim=d)[r].clone()  # noqa: E731
        p.data = cut(p.data)
        g, i = where[name]
        for moments in (opt.mu, opt.nu) + ((opt.acc,) if opt.acc is not None else ()):
            moments[g][i] = cut(moments[g][i])
        opt.sharded[g][i] = True
        split.add(name)
    opt.shard_group = group
    for prefix, module in list(model.named_modules()):
        if isinstance(module, FeedForward) and f"{prefix}.w1.kernel" in split:
            module.w1 = ColumnParallelDense(module.w1, group, gather=False)
            module.drop1 = ShardDropout(module.drop1, r)
            module.w2 = RowParallelDense(module.w2, group)
        elif isinstance(getattr(module, "output", None), Dense) and \
                f"{prefix}.output.kernel" in split:
            module.output = ColumnParallelDense(module.output, group, gather=True)
    return state
