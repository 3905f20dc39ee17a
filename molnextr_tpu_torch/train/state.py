"""Train state: two-group AdamW with per-group clipping and LR schedules.

Port of ``molnextr_tpu/train/state.py``.  The ``encoder`` subtree is one
group; everything else (``enc_trans``, the decoders, the edge and heatmap
heads) is the other.  Each group is ``optax.chain(clip_by_global_norm,
adamw(schedule))`` written out on tensors, so a step gives optax's values:

* the schedule: ``warmup_cosine_decay_schedule`` (linear warmup from 0 over
  ``max(int(total * warmup_ratio), 1)`` updates, then cosine to 0) or
  linear warmup then constant, evaluated in float32 at the update count;
* the clip: ``g * max_norm / ||g||`` when ``||g|| >= max_norm`` (no epsilon
  in the norm, unlike ``torch.nn.utils.clip_grad_norm_``);
* AdamW: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
  correction by ``1 - b**t``, then ``+ weight_decay * p`` on every leaf,
  then ``* -lr``.

``grad_accum_steps = k > 1`` is ``optax.MultiSteps``: the gradient mean
over k micro-steps is clipped and applied once, and only those real updates
advance the schedule and the Adam count.  Parameters and optimizer state
stay float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from molnextr_tpu_torch.config import Config

B1, B2, EPS = 0.9, 0.999, 1e-8
GROUPS = ("encoder", "decoder")


def make_schedules(cfg: Config, total_steps: int) -> Tuple[Callable[[int], float], ...]:
    """(encoder, decoder) schedules: update count -> learning rate, with
    optax's float32 arithmetic."""
    warmup = max(int(total_steps * cfg.train.warmup_ratio), 1)
    decay = max(total_steps, warmup + 1) - warmup
    f32 = np.float32

    def build(lr: float) -> Callable[[int], float]:
        def schedule(count: int) -> float:
            if count < warmup:
                frac = f32(1) - f32(min(count, warmup)) / f32(warmup)
                return float(f32(-lr) * frac + f32(lr))
            if cfg.train.scheduler != "cosine":
                return float(f32(lr))
            c = f32(min(count - warmup, decay))
            cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
            return float(f32(lr) * cosine)

        return schedule

    return build(cfg.train.encoder_lr), build(cfg.train.decoder_lr)


def group_of(name: str) -> str:
    """'encoder' for the encoder subtree, 'decoder' for every other parameter."""
    return "encoder" if name.split(".")[0] == "encoder" else "decoder"


class TwoGroupAdamW:
    """The JAX package's ``make_optimizer`` on a port model's parameters."""

    def __init__(self, cfg: Config, model: nn.Module, total_steps: int):
        self.schedules = dict(zip(GROUPS, make_schedules(cfg, total_steps)))
        self.max_norm = cfg.train.max_grad_norm
        self.weight_decay = cfg.train.weight_decay
        self.accum = max(cfg.train.grad_accum_steps, 1)
        self.params: Dict[str, List[torch.Tensor]] = {g: [] for g in GROUPS}
        self.names: Dict[str, List[str]] = {g: [] for g in GROUPS}
        for name, p in model.named_parameters():
            self.params[group_of(name)].append(p)
            self.names[group_of(name)].append(name)
        self.mu = {g: [torch.zeros_like(p) for p in ps] for g, ps in self.params.items()}
        self.nu = {g: [torch.zeros_like(p) for p in ps] for g, ps in self.params.items()}
        self.acc = ({g: [torch.zeros_like(p) for p in ps] for g, ps in self.params.items()}
                    if self.accum > 1 else None)
        self.count = 0  # real updates applied (the schedules' and Adam's count)
        self.mini_step = 0

    def group_norms(self) -> Dict[str, torch.Tensor]:
        """Global norm of each group's current ``.grad``."""
        return {g: _global_norm([p.grad for p in ps]) for g, ps in self.params.items()}

    @torch.no_grad()
    def step(self) -> bool:
        """One micro-step on the parameters' ``.grad``; returns whether the
        parameters were updated (every ``grad_accum_steps``-th call)."""
        grads = {g: [p.grad.float() for p in ps] for g, ps in self.params.items()}
        if self.acc is not None:
            n = self.mini_step
            for g in GROUPS:  # running mean, optax.MultiSteps' form
                for a, gr in zip(self.acc[g], grads[g]):
                    a.copy_((gr + n * a) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.accum:
                return False
            grads = {g: [a.clone() for a in self.acc[g]] for g in GROUPS}
            for g in GROUPS:
                for a in self.acc[g]:
                    a.zero_()
            self.mini_step = 0
        t = self.count + 1
        for g in GROUPS:
            gs, ps = grads[g], self.params[g]
            if not gs:
                continue
            # optax: where(norm < max_norm, g, (g / norm) * max_norm), on the
            # device (dividing and multiplying by 1 are exact)
            norm = _global_norm(gs)
            clip = norm >= self.max_norm
            gs = torch._foreach_div(gs, torch.where(clip, norm, 1.0))
            torch._foreach_mul_(gs, torch.where(clip, self.max_norm, 1.0))
            lr = self.schedules[g](self.count)
            c1 = float(np.float32(1) - np.float32(B1) ** np.float32(t))
            c2 = float(np.float32(1) - np.float32(B2) ** np.float32(t))
            torch._foreach_mul_(self.mu[g], B1)
            torch._foreach_add_(self.mu[g], gs, alpha=1 - B1)
            torch._foreach_mul_(self.nu[g], B2)
            torch._foreach_addcmul_(self.nu[g], gs, gs, value=1 - B2)
            denom = torch._foreach_div(self.nu[g], c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, EPS)
            upd = torch._foreach_div(self.mu[g], c1)
            torch._foreach_div_(upd, denom)
            torch._foreach_add_(upd, ps, alpha=self.weight_decay)
            torch._foreach_add_(ps, upd, alpha=-lr)
        self.count = t
        return True

    # -- resume ---------------------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        out: Dict[str, object] = {"count": self.count, "mini_step": self.mini_step}
        for g in GROUPS:
            for i, name in enumerate(self.names[g]):
                out[f"mu/{name}"] = self.mu[g][i]
                out[f"nu/{name}"] = self.nu[g][i]
                if self.acc is not None:
                    out[f"acc/{name}"] = self.acc[g][i]
        return out

    def check_state_dict(self, state: Dict[str, object]) -> None:
        """Raise unless ``state`` holds every key of this optimizer's own
        ``state_dict()`` with the same shapes."""
        own = self.state_dict()
        missing = sorted(set(own) - set(state))
        if missing:
            raise KeyError(f"optimizer state lacks {missing[:8]}")
        for k, v in own.items():
            if isinstance(v, torch.Tensor) and tuple(state[k].shape) != tuple(v.shape):
                raise ValueError(f"{k}: shape {tuple(state[k].shape)} != {tuple(v.shape)}")

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.check_state_dict(state)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for g in GROUPS:
            for i, name in enumerate(self.names[g]):
                self.mu[g][i].copy_(state[f"mu/{name}"])
                self.nu[g][i].copy_(state[f"nu/{name}"])
                if self.acc is not None:
                    self.acc[g][i].copy_(state[f"acc/{name}"])


def _global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(tensors)).square().sum().sqrt()


@dataclass
class TrainState:
    """The model (float32 masters), its optimizer and the micro-step count
    (``TrainState.step`` of the JAX package: it counts every call of the
    train step, accumulation micro-steps included)."""

    model: nn.Module
    optimizer: TwoGroupAdamW
    step: int = 0


def create_train_state(cfg: Config, model: nn.Module, total_steps: int, seed: int = 0,
                       device="cuda") -> TrainState:
    """Initialize ``model`` from ``weights.seeded_flax_params(seed)`` in
    float32 on ``device`` (CUDA unless the caller asks for the CPU) and wrap
    it with its optimizer."""
    from molnextr_tpu_torch.inference import resolve_device
    from molnextr_tpu_torch.weights import load_flax_params, seeded_flax_params

    dev = resolve_device(device)
    load_flax_params(model, seeded_flax_params(cfg, model.vocab_sizes, seed))
    model.to(device=dev, dtype=torch.float32).train()
    return TrainState(model, TwoGroupAdamW(cfg, model, total_steps))
