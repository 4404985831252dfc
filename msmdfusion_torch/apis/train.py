"""The train step: learning-rate schedule, optimizer and one update.

Counterpart of the JAX package's ``apis/train.py`` (``build_lr_schedule``,
``build_optimizer``, ``make_train_step``; reference tools/train.py and
mmcv's runner): the optax chain

    clip_by_global_norm -> scale_by_adam -> add_decayed_weights (masked)
    -> scale_by_learning_rate, frozen subtrees set to zero

written out as one ``torch.optim.Optimizer`` so that the arithmetic is
optax's, term for term (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to
the norm and ``torch.optim.AdamW`` decays the weights before the Adam
step; neither is what the JAX package computes). Frozen parameters (the
image branch in the reference's stage-2 recipe) get ``requires_grad``
False and no update; their batch norms stay in eval mode, so their
statistics never move (the JAX package's ``_keep_frozen_stats``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import torch
from torch import nn


def build_lr_schedule(lr_config: Dict[str, Any], base_lr: float,
                      total_steps: int, steps_per_epoch: int
                      ) -> Callable[[int], float]:
    """step -> learning rate, mmcv semantics: policy 'step' multiplies by
    0.1 from each epoch of ``lr_config['step']`` on, and ``warmup='linear'``
    ramps from ``warmup_ratio`` to 1 over ``warmup_iters`` steps."""
    del total_steps                   # read only by the cyclic policy
    policy = lr_config.get('policy', 'step')
    if policy != 'step':
        raise NotImplementedError(f'lr policy {policy!r}: only step is '
                                  'ported')
    boundaries = sorted({int(e * steps_per_epoch)
                         for e in lr_config.get('step', [])})
    warmup = lr_config.get('warmup')
    w_iters = lr_config.get('warmup_iters', 500)
    w_ratio = lr_config.get('warmup_ratio', 1.0 / 3)

    def schedule(step: int) -> float:
        lr = base_lr * 0.1 ** sum(step >= b for b in boundaries)
        if warmup == 'linear' and step < w_iters:
            lr *= w_ratio + (1 - w_ratio) * min(step / w_iters, 1.0)
        return lr
    return schedule


def _decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay applies to a parameter unless it is a norm's or a
    bias, or has one axis (the reference's ``norm`` decay_mult 0)."""
    name = name.lower()
    return not ('bn' in name or 'norm' in name or name.endswith('bias')
                or p.dim() <= 1)


class ClippedAdamW(torch.optim.Optimizer):
    """Global-norm clip, Adam, decoupled weight decay and the learning
    rate, in optax's order and arithmetic:

        g <- g * max_norm / |g|          where |g| >= max_norm (all grads)
        m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
        u <- m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) [+ wd * p]
        p <- p + (-lr(t - 1)) * u

    A trainable parameter without a gradient counts as a zero gradient,
    as in JAX (its weight still decays)."""

    def __init__(self, named_params: Iterable, lr_schedule: Callable,
                 weight_decay: float = 0.01, betas=(0.9, 0.999),
                 eps: float = 1e-8, max_norm: Optional[float] = None):
        named = list(named_params)
        groups = [
            dict(params=[p for n, p in named if _decays(n, p)],
                 weight_decay=weight_decay),
            dict(params=[p for n, p in named if not _decays(n, p)],
                 weight_decay=0.0)]
        super().__init__([g for g in groups if g['params']],
                         dict(betas=betas, eps=eps))
        self.lr_schedule = lr_schedule
        self.max_norm = max_norm
        self.count = 0

    @torch.no_grad()
    def grad_norm(self) -> torch.Tensor:
        grads = [p.grad for g in self.param_groups for p in g['params']
                 if p.grad is not None]
        if not grads:
            return torch.zeros(())
        return torch.sqrt(sum((x * x).sum() for x in grads))

    @torch.no_grad()
    def step(self, closure=None):
        del closure
        g_norm = self.grad_norm()
        clip = (self.max_norm is not None
                and not bool(g_norm < self.max_norm))
        lr = self.lr_schedule(self.count)
        self.count += 1
        for group in self.param_groups:
            b1, b2 = group['betas']
            for p in group['params']:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if clip:
                    g = (g / g_norm) * self.max_norm
                state = self.state[p]
                if not state:
                    state['mu'] = torch.zeros_like(p)
                    state['nu'] = torch.zeros_like(p)
                mu, nu = state['mu'], state['nu']
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                mu_hat = mu / (1 - b1 ** self.count)
                nu_hat = nu / (1 - b2 ** self.count)
                u = mu_hat / (torch.sqrt(nu_hat) + group['eps'])
                if group['weight_decay']:
                    u = u + group['weight_decay'] * p
                p.add_(-lr * u)
        return None


def build_optimizer(model: nn.Module, optimizer_cfg: Dict[str, Any],
                    optimizer_config: Optional[Dict[str, Any]],
                    lr_schedule: Callable[[int], float],
                    frozen_prefixes: Sequence[str] = ()) -> ClippedAdamW:
    """AdamW with the weight-decay mask and the global-norm clip of
    ``optimizer_config['grad_clip']``. Parameters under a module named in
    ``frozen_prefixes`` (e.g. ``img_backbone``) are frozen: they get
    ``requires_grad`` False and stay out of the optimizer; every other
    parameter gets ``requires_grad`` True (whatever an earlier optimizer
    froze) and is trained, as the JAX package's optax mask labels it."""
    trainable = []
    for name, p in model.named_parameters():
        frozen = any(name == f or name.startswith(f + '.')
                     for f in frozen_prefixes)
        p.requires_grad_(not frozen)
        if not frozen:
            trainable.append((name, p))
    clip = (optimizer_config or {}).get('grad_clip')
    return ClippedAdamW(trainable, lr_schedule,
                        weight_decay=optimizer_cfg.get('weight_decay', 0.01),
                        betas=optimizer_cfg.get('betas', (0.9, 0.999)),
                        max_norm=clip['max_norm'] if clip else None)


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The sum of the loss terms (every key naming a loss)."""
    return sum(v for k, v in losses.items() if 'loss' in k)


def dropout_generator(device, seed: int, step: int) -> torch.Generator:
    """The dropout source of step ``step``: a generator on ``device``
    seeded from (seed, step), the port's form of ``fold_in(key, step)``."""
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step)


def make_train_step(model: nn.Module, optimizer: ClippedAdamW,
                    seed: int = 0):
    """train_step(batch, step) -> metrics: a training-mode forward with
    the step's dropout generator, the losses, the backward and one
    optimizer update. ``batch``: dict(inputs=(points, points_mask, img,
    fg), gt_bboxes, gt_labels, gt_valid) on the model's device. Metrics:
    the loss dict, 'total_loss' and 'grad_norm' (before clipping), as
    tensors."""
    def train_step(batch: Dict[str, Any], step: int) -> Dict[str, Any]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        gen = dropout_generator(batch['gt_bboxes'].device, seed, step)
        preds = model(*batch['inputs'], generator=gen)
        losses = model.loss(preds, batch['gt_bboxes'], batch['gt_labels'],
                            batch['gt_valid'])
        total = total_loss(losses)
        total.backward()
        grad_norm = optimizer.grad_norm()
        optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics['total_loss'] = total.detach()
        metrics['grad_norm'] = grad_norm
        return metrics
    return train_step
