"""Run a function on W ranks of a gloo process group on the CPU.

``run_ranks(fn, world, *args)`` spawns ``world`` processes (the ``spawn``
start method), each with the launcher's environment (``launcher='manual'``:
``MSMD_COORDINATOR`` on a free localhost port, ``MSMD_NUM_PROCESSES``,
``MSMD_PROCESS_ID``; ``'pytorch'``: torchrun's variables) and one torch
thread; with ``join`` each joins the group through ``msmdfusion_torch``'s
own ``init_dist`` on the CPU (gloo) around ``fn(rank, world, *args)``
(without, ``fn`` joins it itself, as a CLI does); returns the pickled
results in rank order. A rank that raises fails the call; so does a run
past ``timeout`` seconds. ``fn`` must be importable from a module that
does not import JAX (the ranks import it): the rank functions of the
``tests/test_torch_*`` files that spawn ranks are below.
"""
import contextlib
import os
import pickle
import socket
import tempfile
import time

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, port, launcher, join, out, args):
    from msmdfusion_torch.parallel import dist_scope
    torch.set_num_threads(1)
    if launcher == 'manual':
        os.environ.update(MSMD_COORDINATOR=f'127.0.0.1:{port}',
                          MSMD_NUM_PROCESSES=str(world),
                          MSMD_PROCESS_ID=str(rank))
    else:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                          MASTER_PORT=str(port))
    if join:
        with dist_scope(launcher, 'cpu'):
            result = fn(rank, world, *args)
    else:
        result = fn(rank, world, *args)
    with open(os.path.join(out, f'{rank}.pkl'), 'wb') as f:
        pickle.dump(result, f)


@contextlib.contextmanager
def ranks_running(fn, world, *args, launcher='manual', join=True,
                  timeout=240):
    """``run_ranks`` as a scope whose body runs while the ranks do; the
    yielded list holds their results after the scope."""
    results = []
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.start_processes(
            _entry, args=(fn, world, free_port(), launcher, join, out, args),
            nprocs=world, join=False, start_method='spawn')
        try:
            yield results
        finally:
            deadline = time.monotonic() + timeout
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    raise TimeoutError(f'{world} ranks of {fn.__name__} '
                                       f'still running after {timeout} s')
        for rank in range(world):
            with open(os.path.join(out, f'{rank}.pkl'), 'rb') as f:
                results.append(pickle.load(f))


def run_ranks(fn, world, *args, **kwargs):
    with ranks_running(fn, world, *args, **kwargs) as results:
        pass
    return results


# ---------------------------------------------------------------------------
# tests/test_torch_distributed.py
# ---------------------------------------------------------------------------

def collect_rank(rank, world, n):
    """collect_results of unequal shards, merged; replicate of a layer
    drawn from each rank's own seed; shard_batch of a global batch."""
    from msmdfusion_torch.parallel import (collect_results, get_rank,
                                           get_world_size, replicate,
                                           shard_batch, shard_indices)
    from msmdfusion_torch.parallel import merge_sharded_results
    assert (get_rank(), get_world_size()) == (rank, world)
    mine = [f'sample {i}' for i in shard_indices(n, rank, world)]
    collected = collect_results(mine)
    torch.manual_seed(rank)
    layer = torch.nn.Linear(3, 2)
    layer.register_buffer('stat', torch.full((2,), float(rank)))
    replicate(layer)
    batch = dict(x=torch.arange(world * 6).reshape(world * 2, 3),
                 nested=[torch.arange(world * 2)], meta='kept')
    return dict(collected=collected,
                merged=merge_sharded_results(collected, n),
                weight=layer.weight.detach().numpy(),
                stat=layer.stat.numpy(),
                shard=shard_batch(batch))


# ---------------------------------------------------------------------------
# tests/test_torch_sync_norm.py
# ---------------------------------------------------------------------------

def sync_norm_rank(rank, world, rows, masks, cots, params, grid, grid_cot):
    """The masked norm on this rank's rows and the 2-D norm on its maps,
    in training mode: outputs, running statistics, the gradients of
    sum(y * cot) by the input and this rank's share of the affine's."""
    from msmdfusion_torch.models.norm import (MaskedBatchNorm,
                                              NaiveSyncBatchNorm2d)
    out = {}
    for name, norm, x, mask, cot in (
            ('masked', MaskedBatchNorm(rows[rank].shape[1]), rows[rank],
             masks[rank], cots[rank]),
            ('2d', NaiveSyncBatchNorm2d(grid.shape[2]), grid[rank],
             None, grid_cot[rank])):
        with torch.no_grad():
            for key, value in params.items():
                getattr(norm, key).copy_(torch.from_numpy(value))
        norm.train()
        x = torch.from_numpy(x).requires_grad_(True)
        y = norm(x) if mask is None else norm(x, torch.from_numpy(mask))
        (y * torch.from_numpy(cot)).sum().backward()
        out[name] = dict(y=y.detach().numpy(), x_grad=x.grad.numpy(),
                         weight_grad=norm.weight.grad.numpy(),
                         bias_grad=norm.bias.grad.numpy(),
                         running_mean=norm.running_mean.numpy(),
                         running_var=norm.running_var.numpy())
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_ddp_step.py
# ---------------------------------------------------------------------------

FG_KEYS = ('fg_pixels', 'fg_points', 'fg_mask', 'fg_real_pixels',
           'fg_real_mask', 'lidar2img')


def flagship_step(cfg, batch, gt, recipe, seed=0):
    """One ``make_train_step`` of the flagship of ``cfg`` (weights from
    ``seed``) on numpy ``batch``/``gt``, this rank's share of them inside a
    group: (metrics, state, gradients, overflow counts summed over the
    ranks), numpy."""
    from msmdfusion_torch.apis.train import (build_lr_schedule,
                                             build_optimizer,
                                             make_train_step)
    from msmdfusion_torch.models.builder import build_detector
    from msmdfusion_torch.parallel import replicate, shard_batch
    from msmdfusion_torch.utils import overflow
    model = build_detector(cfg, device='cpu', seed=seed)
    replicate(model)
    opt = build_optimizer(model, recipe['optimizer'], recipe['clip'],
                          build_lr_schedule(recipe['lr'],
                                            recipe['optimizer']['lr'], 10, 1),
                          frozen_prefixes=recipe['frozen'])
    t = torch.from_numpy
    full = dict(inputs=(t(batch['points']), t(batch['points_mask']),
                        t(batch['img']),
                        {k: t(batch['fg'][k]) for k in FG_KEYS}),
                **{k: t(v) for k, v in gt.items()})
    with overflow.capture() as cap:
        metrics = make_train_step(model, opt, seed=seed)(
            shard_batch(full), 0)
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        state={k: v.numpy().copy() for k, v in model.state_dict().items()},
        grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()
               if p.grad is not None},
        overflow=cap.global_counters())


def ddp_step_rank(rank, world, cfg, batch, gt, recipe):
    return flagship_step(cfg, batch, gt, recipe)


def head_loss_rank(rank, world, head_cfg, cases):
    """The head's loss terms on this rank's samples (its share of the
    global loss), for each case (preds, gt, labels, valid)."""
    from msmdfusion_torch.models.heads.transfusion_head import \
        TransFusionHead
    from msmdfusion_torch.parallel import shard_batch
    head = TransFusionHead(**head_cfg)
    t = torch.from_numpy
    out = []
    for preds, gt, labels, valid in cases:
        p, g, lab, ok = shard_batch(({k: t(v) for k, v in preds.items()},
                                     t(gt), t(labels), t(valid)))
        out.append({k: float(v) for k, v in head.loss(p, g, lab,
                                                      ok).items()})
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_dist_cli.py
# ---------------------------------------------------------------------------

def train_cli_rank(rank, world, argv):
    """The train CLI under ``--launcher manual``: its checkpoint path,
    batches and the model's state after the run."""
    from msmdfusion_torch.tools import train as train_cli
    run = train_cli.main(argv + ['--launcher', 'manual'])
    return dict(checkpoint=run['checkpoint'], batches=run['batches'],
                start_step=run['start_step'], step=run['step'],
                state={k: v.numpy().copy()
                       for k, v in run['model'].state_dict().items()})
