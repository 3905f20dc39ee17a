"""Train and eval steps.

Port of ``molnextr_tpu/train/step.py``: one train step is the teacher-forced
forward of every format, the loss, the backward pass and the optimizer
update of both groups (``state.TwoGroupAdamW``).  Parameters and optimizer
state stay float32; with ``train.bf16`` the forward runs under
``torch.autocast(bfloat16)`` on the batch's device, and the losses are
float32.  The step's dropout seed is ``fold_in(seed, state.step)``, as the
JAX step folds ``state.step`` into its key.  ``dispatch_steps`` (the JAX
package's ``lax.scan`` over K stacked batches) is a loop over K batches
whose metrics are averaged.  The eval step runs in eval mode under
``torch.no_grad()``, so on the card its encoder runs K1 and K2.

What a rank computes.  With no process group (``state.mesh`` a
``TrivialMesh``) the step is the single-device step on the batch it is given.
On a mesh, ``batch`` is this rank's rows of the global batch
(``parallel.mesh.shard_batch`` or the sharded ``DataLoader``) and the step
computes exactly the JAX step on the global batch, as ``jit`` over a
``data`` axis does:

1. the weight sums of every mean (``Criterion.denominators``) are summed
   over the data ranks from the labels, before the forward pass, in one
   small all-reduce;
2. each rank's loss is its weighted sum over those global sums, so the sum
   over ranks of the losses, and of their gradients, is the global mean's;
3. after backward the gradients are summed over the data axis in flat
   buckets (``reduce_gradients``: an explicit SUM, not DDP's average, which
   would need a rescale by the world size), so the optimizer's clip sees
   the global gradient and every rank applies the same update;
4. the metrics are summed over the data ranks, so every rank returns the
   global batch's loss and accuracies.

At more than one data rank the dropout seed folds in the data rank, so the
ranks draw different masks over their own rows.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict, Sequence

import torch

from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.models.layers import fold_in
from molnextr_tpu_torch.parallel.distributed import all_reduce_sum_
from molnextr_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size
from molnextr_tpu_torch.train.losses import Criterion
from molnextr_tpu_torch.train.state import TrainState
from molnextr_tpu_torch.train.wire import as_model_images, as_model_refs


def _autocast(cfg: Config, device: torch.device):
    if cfg.train.bf16:
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return nullcontext()


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def data_group(state: TrainState):
    """The process group of the state's ``data`` axis, or None with no
    process group (the single-device step)."""
    return axis_group(state.mesh, "data")


def dropout_seed(state: TrainState, seed: int) -> int:
    """``fold_in(seed, state.step)``, and the data rank folded in when the
    data axis has more than one rank."""
    s = fold_in(seed, state.step)
    if axis_size(state.mesh, "data") > 1:
        s = fold_in(s, axis_rank(state.mesh, "data"))
    return s


def global_denominators(criterion: Criterion, refs: Dict[str, torch.Tensor],
                        group) -> Dict[str, torch.Tensor]:
    """``criterion``'s weight sums over the data ranks: one all-reduce of
    one float64 vector (exact for counts below 2**53), each sum back in
    its own dtype."""
    local = criterion.denominators(refs)
    vec = torch.stack([v.double() for v in local.values()])
    all_reduce_sum_([vec], group)
    return {k: vec[i].to(v.dtype) for i, (k, v) in enumerate(local.items())}


def reduce_gradients(model: torch.nn.Module, group) -> None:
    """Sum every parameter's gradient over ``group`` in place; a parameter
    the step left without one (a head the formats do not use) gets zeros,
    so every rank sends the same buckets."""
    grads = []
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    all_reduce_sum_(grads, group)


def train_step(cfg: Config, criterion: Criterion, state: TrainState, batch: Dict[str, Any],
               seed: int) -> Dict[str, torch.Tensor]:
    """One micro-step on ``batch`` ({"images", "refs"}, numpy or tensors;
    this rank's rows on a mesh); updates ``state`` in place and returns the
    step's metrics (device scalars, detached; the global batch's on a
    mesh)."""
    model = state.model
    dev = _device(model)
    model.train()
    refs = as_model_refs(batch["refs"], dev)
    images = as_model_images(batch["images"], dev)
    for p in model.parameters():
        p.grad = None
    group = data_group(state)
    denoms = None if group is None else global_denominators(criterion, refs, group)
    with _autocast(cfg, dev):
        outputs = model(images, refs, dropout_seed=dropout_seed(state, seed))
    total, losses = criterion(outputs, refs, denoms)
    total.backward()
    if group is not None:
        reduce_gradients(model, group)
    state.optimizer.step()
    state.step += 1
    metrics = {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}
    if group is not None:
        vec = torch.stack([v.float() for v in metrics.values()])
        all_reduce_sum_([vec], group)
        metrics = dict(zip(metrics, vec.unbind()))
    return metrics


def multi_train_step(cfg: Config, criterion: Criterion, state: TrainState,
                     batches: Sequence[Dict[str, Any]], seed: int) -> Dict[str, torch.Tensor]:
    """``len(batches)`` train steps, their metrics averaged."""
    runs = [train_step(cfg, criterion, state, b, seed) for b in batches]
    return {k: torch.stack([r[k].float() for r in runs]).mean() for k in runs[0]}


@torch.no_grad()
def eval_step(cfg: Config, criterion: Criterion, model: torch.nn.Module,
              batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Teacher-forced validation loss, no update; leaves ``model`` in the
    mode it found it in."""
    dev = _device(model)
    was_training = model.training
    model.eval()
    try:
        refs = as_model_refs(batch["refs"], dev)
        with _autocast(cfg, dev):
            outputs = model(as_model_images(batch["images"], dev), refs)
        total, losses = criterion(outputs, refs)
    finally:
        model.train(was_training)
    return {"loss": total, **losses}
