"""Training CLI.

Counterpart of the JAX package's ``tools/train.py`` (reference
tools/train.py:98-283): config -> detector -> the frozen prefixes of
``freeze_lidar_components`` / ``freeze_img`` -> the config's train dataset
and loader -> the train step (warmup schedule, global-norm clip, AdamW)
with per-interval logs, a checkpoint per epoch and the per-epoch
``EvalHook``.

    python -m msmdfusion_torch.tools.train CONFIG [--work-dir DIR] \\
        [--resume-from CKPT | --load-from CKPT] [--seed 0] \\
        [--max-steps N] [--no-validate] [--cfg-options key=value ...] \\
        [--device cuda]

Without ``--resume-from`` a run resumes from the newest ``ckpt_<step>`` of
its work dir, at the epoch that step falls in and with that epoch's batch
order (the epoch starts again from its first batch, as the JAX tool's
does). Logs: ``<work_dir>/train.log``, ``<work_dir>/<time>.log.json``
(train and val records) and, where ``log_config.hooks`` lists
``TensorboardLoggerHook``, event files under ``<work_dir>/tf_logs``.
``--device`` and ``--backend`` as in the test CLI.

``--launcher pytorch`` (under torchrun: ``dist_train.sh``) or ``manual``
trains data-parallel: each rank loads its ``samples_per_gpu`` samples of
each global batch of ``samples_per_gpu x world`` (``datasets.loader``),
every rank starts from rank 0's weights (``parallel.replicate``, after a
resume too), and the step is the single-process step on the global batch
(``apis.train``). Only rank 0 writes checkpoints and logs; the logged
samples/s counts the global batch; the ``EvalHook`` evaluates
rank-sharded.
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Any, Dict, List, Optional

import torch

from ..apis.inference import batch_model_inputs, make_batch_infer
from ..apis.train import (build_lr_schedule, build_optimizer,
                          frozen_prefixes, make_train_step)
from ..config import load_config, parse_cli_overrides
from ..datasets.loader import DataLoader
from ..models.builder import build_detector
from ..parallel.distributed import (broadcast_tensors, dist_scope, get_rank,
                                    get_world_size)
from ..parallel.mesh import replicate
from ..registry import DATASETS
from ..utils.checkpoint import (checkpoint_path, latest_checkpoint,
                                load_checkpoint, save_checkpoint)
from ..utils.log_hooks import EvalHook, JsonLogWriter
from ..utils.tb_writer import TensorboardEventWriter
from . import check_launcher, full_fp32


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description='Train a detector')
    p.add_argument('config')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--resume-from', default=None)
    p.add_argument('--load-from', default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--max-steps', type=int, default=None,
                   help='cap total steps (debug)')
    p.add_argument('--cfg-options', nargs='+', default=[])
    p.add_argument('--launcher', default='none',
                   help='none, pytorch (torchrun) or manual (MSMD_* '
                        'variables): data-parallel training')
    p.add_argument('--no-validate', action='store_true',
                   help='skip the in-training EvalHook')
    p.add_argument('--backend', default=None, choices=('nccl', 'gloo'),
                   help='the process group\'s (default: nccl on the card, '
                        'gloo on the CPU; gloo on the card for ranks that '
                        'share one card, which nccl refuses)')
    p.add_argument('--device', default='cuda',
                   help='the detector\'s device (cuda: each rank\'s card; '
                        'cuda:N; cpu)')
    return p.parse_args(argv)


class _FanOut:
    def __init__(self, writers):
        self.writers = writers

    def write(self, *a, **kw):
        for w in self.writers:
            w.write(*a, **kw)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the CLI; returns dict(model, optimizer, work_dir, checkpoint,
    start_step, step, batches: the dataset indices of each step's batch)
    for callers that run it in-process."""
    import msmdfusion_torch.datasets  # noqa: F401  (registers the pipeline)
    import msmdfusion_torch.models  # noqa: F401  (registers the modules)
    args = parse_args(argv)
    check_launcher(args.launcher)
    full_fp32()
    cfg = load_config(args.config, parse_cli_overrides(args.cfg_options))
    work_dir = args.work_dir or os.path.join(
        'work_dirs', os.path.splitext(os.path.basename(args.config))[0])
    with dist_scope(args.launcher, args.device,
                    args.backend) as device:
        logger = logging.getLogger('msmdfusion_torch')
        logger.setLevel(logging.INFO)
        handlers = []
        if get_rank() == 0:          # rank 0 alone logs and writes files
            os.makedirs(work_dir, exist_ok=True)
            fmt = logging.Formatter(
                '%(asctime)s - %(levelname)s - %(message)s')
            handlers = [logging.StreamHandler(), logging.FileHandler(
                os.path.join(work_dir, 'train.log'))]
            for handler in handlers:
                handler.setFormatter(fmt)
                logger.addHandler(handler)
        try:
            return _train(args, cfg, work_dir, device, logger)
        finally:
            for handler in handlers:
                logger.removeHandler(handler)
                handler.close()


def _train(args, cfg, work_dir, device, logger) -> Dict[str, Any]:
    rank, world = get_rank(), get_world_size()
    logger.info(f'device: {device}' + (
        f' ({torch.cuda.get_device_name(device)})'
        if device.type == 'cuda' else '')
        + (f', {world} ranks' if world > 1 else ''))
    model = build_detector(cfg.model, device=device, seed=args.seed)
    train_cfg = dict(cfg.data.train)
    if train_cfg['type'] == 'CBGSDataset':
        train_cfg['seed'] = args.seed     # the duplicates CBGS draws
    dataset = DATASETS.build(train_cfg)
    loader = DataLoader(dataset, cfg.data.samples_per_gpu,
                        num_workers=cfg.data.get('workers_per_gpu', 4),
                        seed=args.seed, device=device, rank=rank,
                        world=world)
    steps_per_epoch = len(loader)
    total_steps = steps_per_epoch * cfg.total_epochs
    if args.max_steps:
        total_steps = min(total_steps, args.max_steps)
    logger.info('params: %.2fM' % (sum(
        p.numel() for p in model.parameters()) / 1e6))
    logger.info(f'{len(dataset)} train samples, {steps_per_epoch} steps an '
                f'epoch of {cfg.data.samples_per_gpu * world} samples a '
                f'step, {total_steps} steps')

    frozen = frozen_prefixes(cfg)
    lr_sched = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer.lr,
                                 total_steps, steps_per_epoch)
    optimizer = build_optimizer(model, dict(cfg.optimizer),
                                dict(cfg.get('optimizer_config') or {}),
                                lr_sched, frozen_prefixes=frozen)
    start_step = 0
    resume = args.resume_from or latest_checkpoint(work_dir)
    if resume:
        state = load_checkpoint(resume, model)
        optimizer.load_state_dict(state['optimizer'])
        start_step = int(state['step'])
        logger.info(f'resumed from {resume} at step {start_step}')
    elif args.load_from:
        load_checkpoint(args.load_from, model)
        logger.info(f'loaded weights from {args.load_from}')
    # every rank holds rank 0's parameters, statistics and Adam moments
    replicate(model)
    broadcast_tensors([t for p in model.parameters()
                       for t in optimizer.state.get(p, {}).values()])
    train_step = make_train_step(model, optimizer, seed=args.seed)

    # line-JSON scalar log (mmcv TextLoggerHook format), TensorBoard event
    # files where log_config lists the hook (one writer even if listed
    # twice: two would collide on the second-resolution file name)
    writers = []
    if rank == 0:
        writers.append(JsonLogWriter(work_dir))
        if any(dict(h).get('type') == 'TensorboardLoggerHook'
               for h in cfg.get('log_config', {}).get('hooks', [])):
            writers.append(TensorboardEventWriter(
                os.path.join(work_dir, 'tf_logs')))
    json_log = _FanOut(writers)
    eval_hook = None
    eval_cfg = dict(cfg.get('evaluation', {}))
    if not args.no_validate and eval_cfg and 'val' in cfg.data:
        val_ds = DATASETS.build(dict(cfg.data.val))
        batch_infer = make_batch_infer(model, cfg.model.type)
        eval_hook = EvalHook(val_ds, batch_infer,
                             interval=eval_cfg.get('interval', 1),
                             max_samples=eval_cfg.get('max_samples'),
                             num_workers=cfg.data.get('workers_per_gpu', 4),
                             device=device, rank=rank, world=world)
        logger.info(f'EvalHook: {len(val_ds)} val samples every '
                    f'{eval_hook.interval} epoch(s)')

    step = start_step
    batches = []
    ckpt = None
    log_interval = cfg.get('log_config', {}).get('interval', 50)
    t0 = time.perf_counter()
    # on resume, continue from the right epoch with the per-epoch shuffle
    # a fresh run would have used (DistributedSampler.set_epoch semantics)
    start_epoch = min(start_step // max(steps_per_epoch, 1),
                      cfg.total_epochs)
    with loader:
        for epoch in range(start_epoch, cfg.total_epochs):
            loader.set_epoch(epoch)
            for batch in loader:
                if step >= total_steps:
                    break
                metrics = train_step(dict(
                    inputs=batch_model_inputs(cfg.model.type, batch, device),
                    gt_bboxes=batch['gt_bboxes_3d'],
                    gt_labels=batch['gt_labels_3d'].to(torch.int32),
                    gt_valid=batch['gt_valid']), step)
                batches.append([int(m['sample_idx'])
                                for m in batch['metas']])
                step += 1
                if step % log_interval == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    rate = log_interval * cfg.data.samples_per_gpu * \
                        world / (time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    logger.info(
                        f'epoch {epoch} step {step}/{total_steps} '
                        f'{rate:.1f} samples/s ' +
                        ' '.join(f'{k}={v:.4f}' for k, v in metrics.items()))
                    json_log.write('train', epoch, step, metrics,
                                   lr=float(lr_sched(step)),
                                   samples_per_s=round(rate, 2))
            ckpt = checkpoint_path(work_dir, step)
            if rank == 0:
                save_checkpoint(work_dir, step, model, optimizer,
                                meta={'epoch': epoch, 'config': args.config})
                logger.info(f'saved {ckpt}')
            if eval_hook is not None and eval_hook.should_run(epoch):
                val_metrics = eval_hook.run()
                if rank == 0:
                    logger.info('val: ' + ' '.join(
                        f'{k}={v:.4f}' for k, v in val_metrics.items()))
                    json_log.write('val', epoch, step, val_metrics)
            if step >= total_steps:
                break
    return dict(model=model, optimizer=optimizer, work_dir=work_dir,
                checkpoint=ckpt, start_step=start_step, step=step,
                batches=batches)


if __name__ == '__main__':
    main()
