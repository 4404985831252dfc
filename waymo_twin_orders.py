"""Why ``chip_smoke.py``'s phase 16 runs the Waymo TransFusion-L step
without its twin: a study on the card, apart from the smoke run.

    python3 waymo_twin_orders.py [RUNS] [ORDERS]      # default 3 runs, 6

On one calibrated model and ``chip_smoke.py``'s Waymo frame (``WAYMO``),
``RUNS`` times: the kernel path's step, then its twin (the all-plain
path on the kernel path's proposals, assignment, dropout, head-input
gradient, ReLU masks and x3 roundings, as phase 11 pins them) and the
same plain path with its sums in the reversed order (``ReorderedSums``);
per run the worst value over its limit (``compare_train``: 10 times the
reversed order's spread), printed, not held. On the last run, the plain
path under ``ORDERS`` more fp32 orders of the same sums, drawn by
``torch.randperm`` (``DrawnOrderSums``): for the worst value, each
order's spread and the kernel path's deviation over it. Needs one card;
prints the card's name and power limit first.
"""
import statistics
import sys
import time

import chip_smoke as cs


class DrawnOrderSums(cs.ReorderedSums):
    """``ReorderedSums`` with each call's taps, channels and weight-gradient
    rows in an order drawn from ``torch.randperm`` on a generator seeded
    with ``seed``, instead of the reversed one."""

    def __init__(self, seed):
        self.seed = seed

    def __enter__(self):
        import dataclasses
        import torch
        from msmdfusion_torch.ops.sparse import matchconv as mc
        self._mc = mc
        self._orig = conv, dw, match = (mc.gather_gemm_conv_plain,
                                        mc.conv_dw_plain, mc.match_conv_plain)
        gen = torch.Generator().manual_seed(self.seed)

        def order(n, device):
            return torch.randperm(n, generator=gen).to(device)

        def taps(plan, pt):
            return dataclasses.replace(plan, inb=plan.inb[:, pt], **{
                k: getattr(plan, k)[..., pt] for k in ('dkey', 'queries')
                if getattr(plan, k) is not None})

        def conv_in_order(feats, rows, weights, *a, **k):
            pc = order(feats.shape[1], feats.device)
            pt = order(rows.shape[1], rows.device)
            return conv(feats[:, pc], rows[:, pt], weights[pt][:, pc],
                        *a, **k)

        def dw_in_order(feats, rows, g):
            pr = order(rows.shape[0], rows.device)
            return dw(feats, rows[pr], g[pr])

        def match_in_order(feats, keys, plan, weights, *a, **k):
            pc = order(feats.shape[1], feats.device)
            pt = order(plan.inb.shape[1], plan.inb.device)
            return match(feats[:, pc], keys, taps(plan, pt),
                         weights[pt][:, pc], *a, **k)
        mc.gather_gemm_conv_plain = conv_in_order
        mc.conv_dw_plain = dw_in_order
        mc.match_conv_plain = match_in_order
        return self


def plain_pass(model, inputs, gt, run, relu, pins, sums=None):
    """The all-plain step on the kernel path's step ``run``'s proposals,
    assignment, dropout masks, head-input gradient, ReLU masks (``relu``)
    and x3 roundings (``pins``), its sums reordered by ``sums`` if given."""
    from msmdfusion_torch import kernels
    scopes = [kernels.plain_kernels(), cs.X3Plain()]
    scopes += [sums] if sums is not None else []
    return cs.train_pass(
        model, inputs, gt, scopes=scopes + [cs.ReluMasks(relu.masks),
                                            pins.replay()],
        targets=run['targets'], index=run['index'],
        head_grad=run['head_grad'])


def study(card, dev, runs, orders):
    import torch
    from msmdfusion_torch.utils.calibrate import calibrate_norms
    label = 'Waymo twin'
    waymo = cs.WAYMO
    inputs, gt = cs.make_lc_scene(waymo['config_lc'], waymo['dataset'],
                                  waymo['n_points'], (8, 8), dev)
    inputs = inputs[:2]
    model = cs.build_model(dev, config=waymo['config'],
                           n_caps=waymo['enc_caps'])
    calibrate_norms(model, *inputs)
    model.train()
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def restore():
        with torch.no_grad():
            for name, b in model.named_buffers():
                b.copy_(start[name])
    worst = []
    for i in range(runs):
        relu, pins = cs.ReluMasks(), cs.PinnedRounding()
        run = cs.train_pass(model, inputs, gt, scopes=[relu, pins])
        restore()
        ref = plain_pass(model, inputs, gt, run, relu, pins)
        restore()
        alt = plain_pass(model, inputs, gt, run, relu, pins,
                         cs.ReorderedSums())
        restore()
        rel, limit, floor, name = cs.compare_train(run, ref, alt)[0]
        worst.append(rel / limit)
        print(f'{label}: run {i}: worst {name} {rel:.3g} of max |ref| over '
              f'its limit {limit:.3g} (10x the reversed order\'s spread '
              f'{floor:.3g}): {rel / limit:.3f} [{card}]', flush=True)
    spreads = []
    for seed in range(orders):
        other = plain_pass(model, inputs, gt, run, relu, pins,
                           DrawnOrderSums(seed))
        restore()
        spreads.append(cs.rel_err(other['grads'][name],
                                  ref['grads'][name])[1])
        del other
    ratios = [rel / max(x, 1e-30) for x in spreads]
    print(f'{label}: {name}: the kernel path {rel:.3g} of max |ref| from '
          f'the plain path; the plain path under the reversed order '
          f'{floor:.3g} ({rel / max(floor, 1e-30):.2f}x), under {orders} '
          f'drawn orders {[float(f"{x:.3g}") for x in spreads]} (the '
          f'kernel path over each {[round(r, 2) for r in ratios]}, median '
          f'{statistics.median(ratios):.2f}x, largest drawn spread over '
          f'the smallest {max(spreads) / max(min(spreads), 1e-30):.2f}x) '
          f'[{card}]', flush=True)
    print(f'{label}: {runs} runs, worst value over its limit per run '
          f'{[round(w, 3) for w in worst]}', flush=True)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print('waymo_twin_orders: torch.cuda.is_available() is False: this '
              'study needs an NVIDIA card', file=sys.stderr)
        return 1
    from msmdfusion_torch import kernels
    runs, orders = (int(a) for a in (argv + ['3', '6'][len(argv):])[:2])
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build()
    print(f'build: {time.perf_counter() - t0:.1f} s', flush=True)
    t0 = time.perf_counter()
    study(card, torch.device('cuda'), runs, orders)
    print(f'waymo_twin_orders: {time.perf_counter() - t0:.1f} s', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
