#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of TransFusion-L once on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a non-zero exit):

1. environment: the card's name and power limit (``nvidia-smi``); TF32 off
   for cuDNN and matmul, so every float32 product is full float32;
2. build: every kernel under ``msmdfusion_torch/csrc`` with one ``nvcc``
   process per source, all started together, into
   ``msmdfusion_torch/_build/``;
3. model and scene: ``configs/transfusion_nusc_voxel_L.py`` at full width
   (1440 x 1440 x 41 grid, 160k voxel capacity, the flagship's measured
   encoder stage capacities), weights drawn from a seed, and one 250k-point
   synthetic nuScenes-like frame. One forward records the arguments of
   every kernel call the main path makes;
4. kernel A (``rows_affine``) against its plain version on each recorded
   call: equal ints;
5. kernel B (``gather_gemm_conv``) against its plain version on each
   recorded call, with its epilogue and without: max error <= 1e-4 of the
   largest reference value;
6. main path: launch counts set to 0, one forward + decode, counts read;
   every kernel must have run. Boxes finite, scores in [0, 1], no overflow.
   Then the same forward with the plain versions, decoding the kernel
   path's proposals: those must be a top-k choice of the plain path's
   heatmap up to the tolerance, and heatmaps, boxes and scores must agree
   within it. Per-stage CUDA-event times, frames/s and a profile follow.

The line before the last is ``{"kernels": [...]}`` with, per kernel, its
launches on the main path, its largest error against the plain version and
its time, the plain version's, its bound and a library call's: each time
is the sum over the main path's calls of that kernel (ms per frame), each
call timed alone with CUDA events at the shapes the main path gave it.
The last line is ``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / 'configs' / 'transfusion_nusc_voxel_L.py'
SEED = 0
N_POINTS = 250000
MAX_VOXELS = 160000
# encoder strided-output capacities measured for this encoder on the
# flagship's full-scale scene (spconv1..3, conv_out)
STAGE_CAPS = [174336, 74240, 25088, 22784]
TOL = 1e-4                      # of the largest |reference| value
EXPECTED_LAUNCHES = {'rows_affine': 8, 'gather_gemm_conv': 21}
ENCODER_WIDTHS = {(5, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64),
                  (64, 128), (128, 128)}
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, fp32 FLOP/s outside the tensor
# cores (the kernels run fp32 FFMA), both at the 700 W power limit
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
KERNEL_INFO = {
    'rows_affine': dict(
        route='cuda', source='msmdfusion_torch/csrc/rows_affine.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:1759'),
    'gather_gemm_conv': dict(
        route='cuda', source='msmdfusion_torch/csrc/gather_gemm_conv.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:924'),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls,
    after one warm-up call, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Recorder:
    """Keep the arguments of every kernel-wrapper call made inside the
    scope (the wrappers themselves still run)."""

    def __init__(self, matchconv):
        self.mc = matchconv
        self.calls = {name: [] for name in KERNEL_INFO}

    def _wrap(self, name):
        orig = getattr(self.mc, name)

        def wrapper(*args, **kwargs):
            self.calls[name].append((args, kwargs))
            return orig(*args, **kwargs)
        return orig, wrapper

    def __enter__(self):
        self._orig = {}
        for name in KERNEL_INFO:
            self._orig[name], wrapper = self._wrap(name)
            setattr(self.mc, name, wrapper)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.mc, name, fn)
        return False


def build_model(device, config=CONFIG, n_caps=STAGE_CAPS, max_voxels=None,
                overrides=None):
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.models.builder import build_detector
    import msmdfusion_torch.models  # noqa: F401  (registers the modules)
    cfg = load_config(str(config), overrides)
    model_cfg = cfg.model
    if max_voxels is not None:
        model_cfg.pts_voxel_layer.max_voxels = (max_voxels, max_voxels)
    model_cfg.pts_middle_encoder.stage_capacities = list(n_caps)
    return build_detector(model_cfg, device=device, seed=SEED)


def make_points(model, n_points, device):
    import numpy as np
    import torch
    from msmdfusion_torch.utils.synth_scene import lidar_scene
    pcr = model.pts_voxel_layer['point_cloud_range']
    pts, _ = lidar_scene(np.random.RandomState(SEED), n_points, pcr)
    points = torch.from_numpy(pts)[None].to(device)
    mask = torch.ones(points.shape[:2], dtype=torch.bool, device=device)
    return points, mask


def forward(model, points, mask):
    preds = model(points, mask)
    return preds, model.get_bboxes(preds)


def rel_err(got, want):
    """(max |got - want|, that over max |want|)."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return err, err / max(scale, 1e-30)


def rows_calls(calls, mc, reps=20):
    """Kernel A vs its plain version and torch.searchsorted per call."""
    import torch
    out = []
    for i, (args, kwargs) in enumerate(calls):
        in_keys, okeys, dkey, inb = args
        got = mc.rows_affine(*args, **kwargs)
        want = mc.rows_affine_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f'rows_affine call {i}: {int((got != want).sum())} rows differ '
              'from the plain version')
        q = okeys[:, None] + dkey[None, :]
        nbytes = (in_keys.numel() + okeys.numel() + dkey.numel()) * 4 + \
            inb.numel() + got.numel() * 4
        rec = dict(
            k_in=in_keys.numel(), k_out=okeys.numel(), ta=dkey.numel(),
            hits=int((got >= 0).sum()), err=0.0,
            ms=cuda_ms(lambda: mc.rows_affine(*args), reps),
            plain_ms=cuda_ms(lambda: mc.rows_affine_plain(*args), reps),
            library_ms=cuda_ms(lambda: torch.searchsorted(in_keys, q), reps),
            bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=0.0)
        out.append(rec)
        print(f"rows_affine[{i}] K_in={rec['k_in']} K_out={rec['k_out']} "
              f"Ta={rec['ta']} hits={rec['hits']} exact ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"searchsorted_ms={rec['library_ms']:.4f} "
              f"bound_ms={rec['bytes_ms']:.4f}", flush=True)
    return out


def conv_calls(calls, mc, reps=10, plain_reps=3):
    """Kernel B vs its plain version per call, with the recorded epilogue
    and without any."""
    import torch
    out = []
    for i, (args, kwargs) in enumerate(calls):
        feats, rows, weights = args
        k_out, ta = rows.shape
        cin, cout = weights.shape[1], weights.shape[2]
        errs = []
        for kw in (kwargs, {}):
            got = mc.gather_gemm_conv(feats, rows, weights, **kw)
            want = mc.gather_gemm_conv_plain(feats, rows, weights, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f'gather_gemm_conv call {i}: non-finite output')
            err, rel = rel_err(got, want)
            check(rel <= TOL, f'gather_gemm_conv call {i} ({cin}->{cout}, '
                  f'epilogue={bool(kw)}): error {err:.3g} is {rel:.3g} of '
                  f'max |ref|, above {TOL}')
            errs.append(err)
        hits = int((rows >= 0).sum())
        n_epi = sum(kwargs.get(k) is not None for k in ('scale', 'shift'))
        nbytes = 4 * (feats.numel() + rows.numel() + weights.numel()
                      + n_epi * cout + k_out * cout)
        if kwargs.get('out_valid') is not None:
            nbytes += k_out
        rec = dict(
            cin=cin, cout=cout, k_in=feats.shape[0], k_out=k_out, ta=ta,
            hits=hits, err=max(errs),
            ms=cuda_ms(lambda: mc.gather_gemm_conv(*args, **kwargs), reps),
            plain_ms=cuda_ms(
                lambda: mc.gather_gemm_conv_plain(*args, **kwargs),
                plain_reps),
            library_ms=None,
            bytes_ms=nbytes / PEAK_BYTES * 1e3,
            ops_ms=2.0 * hits * cin * cout / PEAK_FP32 * 1e3)
        out.append(rec)
        print(f"gather_gemm_conv[{i}] {cin}->{cout} K_in={rec['k_in']} "
              f"K_out={k_out} Ta={ta} hits={hits} "
              f"epilogue={sorted(k for k, v in kwargs.items() if v is not None and v is not False)} "
              f"max_abs_err={rec['err']:.3g} ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={max(rec['bytes_ms'], rec['ops_ms']):.4f}",
              flush=True)
    covered = {(r['cin'], r['cout']) for r in out}
    check(ENCODER_WIDTHS <= covered,
          f'encoder widths not exercised: {sorted(ENCODER_WIDTHS - covered)}')
    return out


def kernel_summary(name, recs, launches):
    """One entry of the ``kernels`` line: sums over the main path's calls."""
    bytes_ms = sum(r['bytes_ms'] for r in recs)
    ops_ms = sum(r['ops_ms'] for r in recs)
    lib = [r['library_ms'] for r in recs]
    return dict(
        name=name, **KERNEL_INFO[name], launches=launches[name],
        max_abs_err=max(r['err'] for r in recs),
        ms=sum(r['ms'] for r in recs),
        plain_ms=sum(r['plain_ms'] for r in recs),
        bound_ms=sum(max(r['bytes_ms'], r['ops_ms']) for r in recs),
        bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
        library_ms=None if None in lib else sum(lib))


class PinnedProposals:
    """Inside the scope the TransFusion head takes the given flat proposal
    indices [B, P] (class * H * W + cell) in place of its own top-k, so
    that two paths can decode the same proposals."""

    def __init__(self, index):
        self.index = index

    def __enter__(self):
        import torch
        from msmdfusion_torch.models.heads import transfusion_head as th
        self._th, self._orig = th, th.topk_lower_index_first
        th.topk_lower_index_first = lambda x, k: (
            torch.gather(x, 1, self.index), self.index)
        return self

    def __exit__(self, *exc):
        self._th.topk_lower_index_first = self._orig
        return False


def proposal_index(preds):
    h, w = preds['dense_heatmap'].shape[-2:]
    return preds['query_labels'] * (h * w) + preds['query_spatial']


def check_proposals(head, index, preds_p):
    """The kernel path's proposals must be a top-P choice of the plain
    path's heatmap up to TOL: no unchosen cell may beat a chosen one by
    more. Returns (that worst excess, proposals that differ from the plain
    path's own choice, which a near-tie at the cut can swap)."""
    import torch
    from msmdfusion_torch.models.heads.transfusion_head import (
        local_maximum_nms, topk_lower_index_first)
    hm = local_maximum_nms(torch.sigmoid(preds_p['dense_heatmap']),
                           head.nms_kernel_size,
                           head._flat_classes()).flatten(1)
    chosen = torch.zeros_like(hm, dtype=torch.bool).scatter_(1, index, True)
    lowest = torch.where(chosen, hm, float('inf')).amin(dim=1)
    best_left = torch.where(chosen, float('-inf'), hm).amax(dim=1)
    excess = float((best_left - lowest).max())
    check(excess <= TOL * float(hm.abs().max()),
          f'the kernel path chose proposals an unchosen cell of the plain '
          f'heatmap beats by {excess:.3g}')
    own = topk_lower_index_first(hm, head.num_proposals)[1]
    differ = int((~(index[:, :, None] == own[:, None, :]).any(-1)).sum())
    return excess, differ


def compare_outputs(preds, boxes, preds_p, boxes_p):
    """Kernel-path outputs vs plain-path outputs on the same proposals."""
    import torch
    worst = {}
    for key in ('dense_heatmap', 'heatmap', 'center', 'dim'):
        worst[key] = rel_err(preds[key], preds_p[key])[1]
    for key in ('bboxes', 'scores'):
        worst[key] = rel_err(boxes[key], boxes_p[key])[1]
    for key in ('labels', 'valid'):
        check(torch.equal(boxes[key], boxes_p[key]),
              f'{key} differ between the kernel and plain paths')
    for key, rel in worst.items():
        check(rel <= TOL, f'{key}: kernel vs plain path {rel:.3g} of max '
              f'|ref|, above {TOL}')
    return worst


def profile_forward(model, points, mask, top=8):
    """One forward under torch.profiler: (host window ms, device busy ms,
    [(device ms, kernel name)] of the ``top`` kernels). Busy time is the
    union of the device events' spans (CUPTI's own buffer events left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward(model, points, mask)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for evt in prof.events():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.name in ('Buffer Flush', 'Activity Buffer Request')):
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        by_name[evt.name] = by_name.get(evt.name, 0.0) + \
            (evt.time_range.end - evt.time_range.start) / 1e3
    busy_us, reach = 0.0, float('-inf')
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    ranked = sorted(((ms, name) for name, ms in by_name.items()),
                    reverse=True)[:top]
    return window_ms, busy_us / 1e3, ranked


def main():
    if not (ROOT / 'msmdfusion_torch' / '__init__.py').is_file():
        print('chip_smoke: msmdfusion_torch/ not found beside this script',
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False: this script '
              'needs an NVIDIA card', file=sys.stderr)
        return 1
    from msmdfusion_torch import kernels
    from msmdfusion_torch.ops.sparse import matchconv as mc
    from msmdfusion_torch.utils import overflow, timing

    # 1. environment
    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)} x '
          f'{torch.cuda.device_count()}', flush=True)

    # 2. build
    t0 = time.perf_counter()
    built = kernels.build()
    build_s = time.perf_counter() - t0
    for name, (secs, log) in built.items():
        ptxas = [ln.strip() for ln in log.splitlines()
                 if 'registers' in ln or 'spill' in ln]
        print(f'build {name}: {secs:.1f} s; ' + ' | '.join(ptxas),
              flush=True)
    for name in KERNEL_INFO:
        kernels.entry_point(name)
    print(f'build: {len(built)} kernels in {build_s:.1f} s (parallel nvcc)',
          flush=True)

    # 3. model, scene, and the main path's kernel calls
    t0 = time.perf_counter()
    model = build_model(dev, max_voxels=MAX_VOXELS)
    points, mask = make_points(model, N_POINTS, dev)
    print(f'setup: model + {N_POINTS} points in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    with torch.no_grad(), Recorder(mc) as rec:
        forward(model, points, mask)
    torch.cuda.synchronize()
    check(len(rec.calls['rows_affine']) == EXPECTED_LAUNCHES['rows_affine']
          and len(rec.calls['gather_gemm_conv'])
          == EXPECTED_LAUNCHES['gather_gemm_conv'],
          f'recorded calls {[len(v) for v in rec.calls.values()]}, expected '
          f'{list(EXPECTED_LAUNCHES.values())}')

    # 4.-5. each kernel against its plain version at the main path's shapes
    with torch.no_grad():
        a_recs = rows_calls(rec.calls['rows_affine'], mc)
        b_recs = conv_calls(rec.calls['gather_gemm_conv'], mc)
    del rec

    # 6. the main path through the kernels, counted
    with torch.no_grad():
        kernels.reset_launches()
        with overflow.capture() as cap, timing.record(dev) as tr:
            preds, boxes = forward(model, points, mask)
        launches = dict(kernels.launches)
        torch.cuda.synchronize()
    print(f'launches on the main path: {launches}', flush=True)
    for name in KERNEL_INFO:
        check(launches[name] > 0, f'{name} never launched on the main path')
        check(launches[name] == EXPECTED_LAUNCHES[name],
              f'{name}: {launches[name]} launches, expected '
              f'{EXPECTED_LAUNCHES[name]}')
    counters = cap.counters()
    occupancy = cap.gauge_values()
    check(cap.total() == 0, f'overflow on the main path: {counters}')
    b = boxes['bboxes']
    check(b.shape[-1] == 9 and b.shape[1] == model.pts_bbox_head.num_proposals,
          f'bboxes shape {tuple(b.shape)}')
    check(bool(torch.isfinite(b).all()), 'non-finite boxes')
    s = boxes['scores']
    check(bool(((s >= 0) & (s <= 1)).all()), 'scores outside [0, 1]')
    stage_ms = tr.ms()
    print(f'overflow_total 0; occupancy '
          f'{ {k: v for k, v in occupancy.items() if k.startswith("occ.")} }',
          flush=True)
    print(f'stage_ms {json.dumps({k: round(v, 4) for k, v in stage_ms.items()})} '
          f'[{card}]', flush=True)

    # the same forward on the plain versions, decoding the kernel path's
    # proposals: a near-tie at the top-k cut may not swap one
    with torch.no_grad():
        index = proposal_index(preds)
        with kernels.plain_kernels(), PinnedProposals(index):
            preds_p, boxes_p = forward(model, points, mask)
        excess, differ = check_proposals(model.pts_bbox_head, index, preds_p)
        worst = compare_outputs(preds, boxes, preds_p, boxes_p)
    print(f'kernel vs plain path, error over max |ref|: '
          f'{json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()})}; '
          f'proposals: a top-{model.pts_bbox_head.num_proposals} of the plain '
          f'heatmap (worst excess {excess:.3g}), {differ} differ from its own '
          'choice', flush=True)

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        frame_ms = cuda_ms(lambda: forward(model, points, mask), 10)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        for _ in range(5):
            forward(model, points, mask)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
        with kernels.plain_kernels():
            plain_frame_ms = cuda_ms(lambda: forward(model, points, mask), 3)
    print(f'e2e TransFusion-L {N_POINTS} points: {frame_ms:.3f} ms/frame '
          f'(CUDA events), {1e3 / frame_ms:.2f} frames/s; host clock '
          f'{host_ms:.3f} ms/frame; plain versions {plain_frame_ms:.3f} '
          f'ms/frame; peak memory {peak_gb:.2f} GiB [{card}]', flush=True)
    with torch.no_grad():
        window_ms, busy_ms, ranked = profile_forward(model, points, mask)
    check(busy_ms > 0, 'the profiler saw no device work in a forward')
    print(f'profile: one forward {window_ms:.3f} ms host window, device '
          f'busy {busy_ms:.3f} ms, idle share '
          f'{1 - busy_ms / window_ms:.3f} [{card}]', flush=True)
    for ms, name in ranked:
        print(f'profile: {ms:9.3f} ms  {name[:100]}', flush=True)

    summary = [kernel_summary('rows_affine', a_recs, launches),
               kernel_summary('gather_gemm_conv', b_recs, launches)]
    print(json.dumps({'kernels': summary}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
