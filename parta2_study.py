#!/usr/bin/env python3
"""Two studies of Part-A2's train step on one NVIDIA card, behind
``chip_smoke.py`` phase 23 (``configs/parta2_kitti.py`` at its widths on
phase 22's 40,000-point KITTI frame, seed-0 weights, norms calibrated).

    python3 parta2_study.py [STEPS]

1. Where the step's backward spends its device time (``torch.profiler``,
   self CUDA time, one backward after two warm-up steps).
2. Why the phase's timed steps restart from the calibrated weights:
   STEPS (default 3) steps of the config's recipe from those weights in
   anomaly mode, on the kernels and on their plain versions
   (``MSMD_SPARSE_BACKEND=xla``): each step's total loss, or the first
   operation whose gradient is NaN, and the RoIs' smallest and largest
   size after the steps. The JAX package's recipe diverges alike from the
   same weights (``tests/test_torch_parta2_recipe.py``, on the CPU).
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def backward_profile(label, model, inputs, gt):
    import torch
    model.train()
    for it in range(3):
        model.zero_grad(set_to_none=True)
        losses = model.loss(model(*inputs), *gt)
        total = sum(losses.values())
        torch.cuda.synchronize()
        if it < 2:
            total.backward()
            continue
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            total.backward()
            torch.cuda.synchronize()
    events = prof.key_averages()
    device = sum(e.self_device_time_total for e in events) / 1e3
    print(f'{label}: backward device self time {device:.1f} ms', flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f'{label}:   {e.self_device_time_total / 1e3:9.3f} ms '
              f'{e.count:5d} calls  {e.key[:90]}', flush=True)
    model.zero_grad(set_to_none=True)


def nan_steps(label, model, inputs, gt, cfg, steps):
    import torch
    from msmdfusion_torch.apis.train import (build_lr_schedule,
                                             build_optimizer,
                                             make_train_step)
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 cfg.total_epochs * 1000, 1000)
    opt = build_optimizer(model, dict(cfg.optimizer),
                          dict(cfg.optimizer_config), schedule)
    step = make_train_step(model, opt, seed=0)
    batch = dict(inputs=inputs, gt_bboxes=gt[0], gt_labels=gt[1],
                 gt_valid=gt[2])
    for i in range(steps):
        with torch.autograd.detect_anomaly(check_nan=True):
            try:
                metrics = step(batch, i)
            except RuntimeError as e:
                print(f'{label}: step {i}: {str(e).splitlines()[0]}',
                      flush=True)
                break
        print(f'{label}: step {i}: total loss '
              f'{float(metrics["total_loss"]):.4f}', flush=True)
    with torch.no_grad():
        sizes = model(*inputs)['roi']['rois'][0][:, 3:6]
    print(f'{label}: RoI sizes after the steps {float(sizes.min()):.3g} to '
          f'{float(sizes.max()):.3g} m', flush=True)


def main():
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print('parta2_study: needs an NVIDIA card', file=sys.stderr)
        return 1
    import chip_smoke as cs
    from msmdfusion_torch import kernels
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.utils.calibrate import calibrate_norms
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    dev = torch.device('cuda')
    kernels.build()
    config = cs.TWO_STAGE['parta2']['config']
    model = cs.zoo_model(config, dev)
    inputs, gt = cs.kitti_frame(model, cs.ZOO['kitti_points'], dev)
    with torch.no_grad():
        calibrate_norms(model, *inputs)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    backward_profile('backward', model, inputs, gt)
    for backend in ('auto', 'xla'):
        model.load_state_dict(start)
        os.environ['MSMD_SPARSE_BACKEND'] = backend
        nan_steps('kernels' if backend == 'auto' else 'plain versions',
                  model, inputs, gt, load_config(str(config)), steps)
    os.environ.pop('MSMD_SPARSE_BACKEND')
    return 0


if __name__ == '__main__':
    sys.exit(main())
