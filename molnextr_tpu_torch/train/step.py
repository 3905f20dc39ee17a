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
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict, Sequence

import torch

from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.models.layers import fold_in
from molnextr_tpu_torch.train.losses import Criterion
from molnextr_tpu_torch.train.state import TrainState
from molnextr_tpu_torch.train.wire import as_model_images, as_model_refs


def _autocast(cfg: Config, device: torch.device):
    if cfg.train.bf16:
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return nullcontext()


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def train_step(cfg: Config, criterion: Criterion, state: TrainState, batch: Dict[str, Any],
               seed: int) -> Dict[str, torch.Tensor]:
    """One micro-step on ``batch`` ({"images", "refs"}, numpy or tensors);
    updates ``state`` in place and returns the step's metrics (device
    scalars, detached)."""
    model = state.model
    dev = _device(model)
    model.train()
    refs = as_model_refs(batch["refs"], dev)
    images = as_model_images(batch["images"], dev)
    for p in model.parameters():
        p.grad = None
    with _autocast(cfg, dev):
        outputs = model(images, refs, dropout_seed=fold_in(seed, state.step))
    total, losses = criterion(outputs, refs)
    total.backward()
    state.optimizer.step()
    state.step += 1
    return {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}


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
