"""The train step: learning-rate schedule, optimizer and one update.

Counterpart of the JAX package's ``apis/train.py`` (``build_lr_schedule``,
``build_optimizer``, ``make_train_step``; reference tools/train.py and
mmcv's runner): the optax chain

    clip_by_global_norm -> scale_by_adam -> add_decayed_weights (masked)
    -> scale_by_learning_rate, frozen subtrees set to zero

written out as one ``torch.optim.Optimizer`` so that the arithmetic is
optax's, term for term (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to
the norm and ``torch.optim.AdamW`` decays the weights before the Adam
step; neither is what the JAX package computes).

Freezing is the JAX package's ``multi_transform`` with ``set_to_zero``:
parameters under a frozen prefix (``frozen_prefixes``: the image branch
of ``freeze_img``, the LiDAR voxel and middle encoders of the config's
``freeze_lidar_components``) stay out of the optimizer, so the clip's
global norm counts the trainable gradients only, and the step gives
their modules' norm statistics back as they were (``_keep_frozen_stats``)
although those norms take the batch's moments in training mode. Their
gradients are still computed: the step's ``grad_norm`` metric is the norm
of every gradient, as JAX's ``optax.global_norm(grads)``. The flagship's
image branch under ``freeze_img`` gets none, since that detector runs it
without autograd (its JAX ``stop_gradient``); TransFusion-LC's gets its
gradients and they count, as the JAX ``TransFusionDetector`` stops none.

Inside a process group (``parallel.distributed``) a step over the ranks'
shares of a global batch is the single-process step on the whole batch,
as the JAX step is over a batch-sharded mesh: the batch norms' moments and
the head's loss normalisers are global, so each rank's loss is its share
of the global loss and the ranks' gradients sum to its gradient
(``reduce_gradients``: after the backward, one all-reduce per bucket in a
fixed order, every gradient ``grad_norm`` reads included; not torch's
``DistributedDataParallel``, whose mean would need the loss scaled by the
ranks, and whose reductions, started by hooks as gradients come ready,
would interleave on one group with the norms' own all-reduces of the
backward); dropout draws the global batch's masks (``SharedGenerator``);
the metrics are the global batch's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.distributed import (SharedGenerator, all_sum, get_rank,
                                    get_world_size, grouped)

# the JAX package's tools/train.py:36-37 predicates, under the port's
# module names (a prefix rule: JAX's 'middle_encoder' substring does not
# reach its multimodal encoder, named 'mm_encoder' there, and
# ``multimodal_middle_encoder`` here must not be caught either)
FROZEN_LIDAR_PREFIXES = ('pts_voxel_encoder', 'pts_middle_encoder')
FROZEN_IMG_PREFIXES = ('img_backbone', 'img_neck')


def frozen_prefixes(cfg) -> Tuple[str, ...]:
    """The frozen module prefixes of a config, as JAX ``tools/train.py:
    110-114`` adds them: the LiDAR encoders where ``freeze_lidar_components``
    is set, the image branch where the model's ``freeze_img`` is."""
    out: Tuple[str, ...] = ()
    if cfg.get('freeze_lidar_components'):
        out += FROZEN_LIDAR_PREFIXES
    if cfg['model'].get('freeze_img'):
        out += FROZEN_IMG_PREFIXES
    return out


def _under(name: str, prefixes: Sequence[str]) -> bool:
    return any(name == f or name.startswith(f + '.') for f in prefixes)


def build_lr_schedule(lr_config: Dict[str, Any], base_lr: float,
                      total_steps: int, steps_per_epoch: int
                      ) -> Callable[[int], float]:
    """step -> learning rate, mmcv semantics as the JAX package builds
    them: policy 'step' multiplies by 0.1 from each epoch of
    ``lr_config['step']`` on; 'cyclic' ramps linearly from ``base_lr`` to
    ``base_lr * target_ratio[0]`` over ``int(total_steps *
    step_ratio_up)`` steps, then decays on a cosine to ``target_ratio[1]``
    of that peak over the rest (``optax.join_schedules`` of a
    ``linear_schedule`` and a ``cosine_decay_schedule``, the second counted
    from 0 at the boundary; no momentum cycling, as in the JAX package);
    ``warmup='linear'`` scales either from ``warmup_ratio`` to 1 over
    ``warmup_iters`` steps. The cyclic schedule and the warmup compute in
    float32 in optax's order of operations, as the JAX schedule does."""
    f32 = np.float32
    policy = lr_config.get('policy', 'step')
    if policy == 'step':
        boundaries = sorted({int(e * steps_per_epoch)
                             for e in lr_config.get('step', [])})

        def sched(step: int):
            return base_lr * 0.1 ** sum(step >= b for b in boundaries)
    elif policy == 'cyclic':
        up_ratio, down_target = lr_config.get('target_ratio', (10, 1e-4))
        up_steps = int(total_steps * lr_config.get('step_ratio_up', 0.4))
        decay_steps = max(total_steps - up_steps, 1)
        peak = base_lr * up_ratio

        def sched(step: int):
            if step < up_steps:          # optax.linear_schedule
                frac = f32(1) - f32(min(max(step, 0), up_steps)) \
                    / f32(up_steps)
                return f32(base_lr - peak) * frac + f32(peak)
            count = f32(min(step - up_steps, decay_steps))
            cosine = f32(0.5) * (f32(1) + np.cos(
                f32(np.pi) * count / f32(decay_steps)))
            return f32(peak) * (f32(1 - down_target) * cosine
                                 + f32(down_target))
    else:
        raise ValueError(policy)

    warmup = lr_config.get('warmup')
    w_iters = lr_config.get('warmup_iters', 500)
    w_ratio = lr_config.get('warmup_ratio', 1.0 / 3)

    def schedule(step: int) -> float:
        lr = sched(step)
        if warmup == 'linear' and step < w_iters:
            frac = min(f32(step) / f32(w_iters), f32(1))
            lr = f32(lr) * (f32(w_ratio) + f32(1 - w_ratio) * frac)
        return float(lr)
    return schedule


def _decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay applies to a parameter unless it is a norm's or a
    bias, or has one axis (the reference's ``norm`` decay_mult 0)."""
    name = name.lower()
    return not ('bn' in name or 'norm' in name or name.endswith('bias')
                or p.dim() <= 1)


def global_norm(tensors: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares of every given tensor (None skipped)."""
    norms = [(x * x).sum() for x in tensors if x is not None]
    if not norms:
        return torch.zeros(())
    return torch.sqrt(sum(norms))


class ClippedAdamW(torch.optim.Optimizer):
    """Global-norm clip, Adam, decoupled weight decay and the learning
    rate, in optax's order and arithmetic:

        g <- g * max_norm / |g|          where |g| >= max_norm (all grads)
        m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
        u <- m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) [+ wd * p]
        p <- p + (-lr(t - 1)) * u

    A trainable parameter without a gradient counts as a zero gradient,
    as in JAX (its weight still decays). ``frozen_prefixes``: the modules
    whose parameters were left out, for ``make_train_step``."""

    def __init__(self, named_params: Iterable, lr_schedule: Callable,
                 weight_decay: float = 0.01, betas=(0.9, 0.999),
                 eps: float = 1e-8, max_norm: Optional[float] = None,
                 frozen_prefixes: Sequence[str] = ()):
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
        self.frozen_prefixes = tuple(frozen_prefixes)
        self.count = 0

    def state_dict(self) -> Dict[str, Any]:
        """The Adam moments and groups, and the step ``count`` (the
        schedule's and the bias corrections' step, as optax's count)."""
        return dict(super().state_dict(), count=self.count)

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop('count'))
        super().load_state_dict(state_dict)

    @torch.no_grad()
    def grad_norm(self) -> torch.Tensor:
        """The global norm of the trainable gradients (the clip's)."""
        return global_norm(p.grad for g in self.param_groups
                           for p in g['params'])

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
    ``frozen_prefixes`` (``frozen_prefixes(cfg)``: e.g. ``img_backbone``,
    ``pts_middle_encoder``) are frozen: they stay out of the optimizer,
    as the JAX package's optax mask labels them. Every parameter gets
    ``requires_grad`` True (whatever an earlier optimizer or caller set),
    so that the step computes every gradient JAX's ``jax.grad`` does."""
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(True)
        if not _under(name, frozen_prefixes):
            trainable.append((name, p))
    clip = (optimizer_config or {}).get('grad_clip')
    return ClippedAdamW(trainable, lr_schedule,
                        weight_decay=optimizer_cfg.get('weight_decay', 0.01),
                        betas=optimizer_cfg.get('betas', (0.9, 0.999)),
                        max_norm=clip['max_norm'] if clip else None,
                        frozen_prefixes=frozen_prefixes)


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The sum of the loss terms (every key naming a loss)."""
    return sum(v for k, v in losses.items() if 'loss' in k)


def dropout_generator(device, seed: int, step: int) -> torch.Generator:
    """The dropout source of step ``step``: a generator on ``device``
    seeded from (seed, step), the port's form of ``fold_in(key, step)``."""
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step)


# gradients summed over the ranks in buckets of this many bytes (torch
# DistributedDataParallel's default bucket size)
BUCKET_BYTES = 25 * 2 ** 20


@torch.no_grad()
def reduce_gradients(params: Sequence[torch.Tensor]) -> None:
    """Each gradient of ``params`` replaced by its sum over the ranks of the
    group (a no-op without one), bucketed. A parameter with a gradient on
    some rank and none on another takes a zero gradient there: which ones
    have one is agreed first (one small all-reduce), so every rank's
    buckets hold the same tensors in the same order."""
    if not grouped():
        return
    params = list(params)
    if not params:
        return
    has = torch.tensor([p.grad is not None for p in params],
                       dtype=torch.float32, device=params[0].device)
    has = all_sum(has).tolist()
    live = []
    for p, n in zip(params, has):
        if n:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            live.append(p)
    bucket, size = [], 0
    for i, p in enumerate(live):
        bucket.append(p.grad)
        size += p.grad.numel() * p.grad.element_size()
        if (i + 1 == len(live) or size >= BUCKET_BYTES
                or live[i + 1].grad.dtype != p.grad.dtype):
            flat = all_sum(torch.cat([g.reshape(-1) for g in bucket]))
            for g, part in zip(bucket, flat.split([g.numel()
                                                   for g in bucket])):
                g.copy_(part.view_as(g))
            bucket, size = [], 0


def make_train_step(model: nn.Module, optimizer: ClippedAdamW,
                    seed: int = 0):
    """train_step(batch, step) -> metrics: a training-mode forward with
    the step's dropout generator, the losses, the backward and one
    optimizer update; the norm statistics of the optimizer's frozen
    modules are given back as they were before the step. ``batch``:
    dict(inputs=the model's positional inputs (points, points_mask[, img,
    fg] for the flagship, [, img, metas] for TransFusion-LC), gt_bboxes,
    gt_labels, gt_valid) on the model's device; inside a process group,
    this rank's share of the global batch (``parallel.shard_batch``), every
    rank holding the same parameters (``parallel.replicate``). Metrics:
    the loss dict, 'total_loss' and 'grad_norm' (before clipping, over
    every gradient, the frozen parameters' included), as tensors, the
    global batch's inside a group."""
    frozen = optimizer.frozen_prefixes

    def train_step(batch: Dict[str, Any], step: int) -> Dict[str, Any]:
        model.train()
        model.zero_grad(set_to_none=True)       # the frozen ones' too
        kept = [(b, b.clone()) for n, b in model.named_buffers()
                if _under(n, frozen)]
        gen = dropout_generator(batch['gt_bboxes'].device, seed, step)
        if grouped():
            gen = SharedGenerator(gen, get_rank(), get_world_size())
        preds = model(*batch['inputs'], generator=gen)
        losses = model.loss(preds, batch['gt_bboxes'], batch['gt_labels'],
                            batch['gt_valid'])
        total = total_loss(losses)
        total.backward()
        with torch.no_grad():
            reduce_gradients(model.parameters())
            for b, old in kept:                 # _keep_frozen_stats
                b.copy_(old)
            grad_norm = global_norm(p.grad for p in model.parameters())
        optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics['total_loss'] = total.detach()
        if grouped():                           # the ranks' shares summed
            keys = list(metrics)
            summed = all_sum(torch.stack([metrics[k].float()
                                          for k in keys]))
            metrics = dict(zip(keys, summed.unbind()))
        metrics['grad_norm'] = grad_norm
        return metrics
    return train_step
