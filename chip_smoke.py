#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA card: TransFusion-L, then
the full MSMDFusion flagship.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a non-zero exit):

1. environment: the card's name and power limit (``nvidia-smi``); TF32 off
   for cuDNN and matmul, so every float32 product is full float32;
2. build: every kernel under ``msmdfusion_torch/csrc`` with one ``nvcc``
   process per source, all started together, into
   ``msmdfusion_torch/_build/``;
3. TransFusion-L: ``configs/transfusion_nusc_voxel_L.py`` at full width
   (1440 x 1440 x 41 grid, 160k voxel capacity, the flagship's measured
   encoder stage capacities), weights drawn from a seed, one 250k-point
   synthetic frame, batch norms calibrated on it. The path below runs on
   it;
4. MSMDFusion: ``configs/MSMDFusion_nusc_voxel_LC.py`` with the
   capacities of the JAX package's ``_flagship_model('full')`` (voxels,
   encoder, GMA downscale, GMA union and foreground voxels), weights from
   a seed, and the JAX package's realistic scene (``realistic_batch``:
   250k points, six 448 x 800 cameras, 20000 foreground points and 15000
   real pixels per camera). The same path runs on it, and then the dense
   layers new to this model are timed on and off cuDNN.

Batch norms are calibrated on each model's frame first
(``utils/calibrate.py``: running statistics set to those of each norm's
input, as a trained checkpoint's roughly are), so that activations keep
a realistic scale; with random statistics the flagship's gated GMA
features grow to ~1e8 and a tolerance scaled by the largest value would
pass a kernel that corrupts the small rows.

The path, per model: one forward records the arguments of every kernel
call; each call is held against the kernel's plain version (rows,
nearest neighbours and row gathers equal; each conv element within 1e-4
of the magnitude of its own sum, and the whole output within 1e-4 of its
largest value) and timed alone by CUDA events; launch counts
are set to 0, one forward + decode runs, and the counts are read and
asserted; boxes must be finite, scores in [0, 1], no row dropped at any
capacity; the same forward on the plain versions, decoding the kernel
path's proposals, must give a top-k choice of its heatmap and agree
within 1e-4 of max up to the head's decoder (the head's input and the
dense heatmap), and after it (decoder outputs, boxes) within 10 times the
plain path's own spread under reordered sums (never less than 1e-4): the
decoder's attention amplifies rounding; then per-stage CUDA-event times,
ms/frame, frames/s, peak memory and a profile with the device's idle
share.

The line before the last is ``{"kernels": [...]}`` for the flagship path:
per kernel its launches, its largest error against the plain version, its
time, the plain version's, its bound and a library call's, each time the
sum over the path's calls (ms per frame). The last line is
``{"ok": true, "device": {...}}``.
"""
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = 1e-4                      # of the largest |reference| value
# after the head's decoder: times the plain path's own spread under
# reordered sums
FLOOR_MARGIN = 10
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, fp32 FLOP/s outside the tensor
# cores (the kernels run fp32 FFMA), both at the 700 W power limit
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
NN_OPS_PER_PAIR = 8             # 3 mul + 2 add (dot), 1 mul + 2 add (dist)

TL = dict(
    config=ROOT / 'configs' / 'transfusion_nusc_voxel_L.py',
    n_points=250000, max_voxels=160000,
    # encoder strided-output capacities measured for this encoder on the
    # flagship's full-scale scene (spconv1..3, conv_out)
    enc_caps=[174336, 74240, 25088, 22784],
    launches={'rows_affine': 8, 'gather_gemm_conv': 21},
    widths={(5, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64),
            (64, 128), (128, 128)})
# the JAX package's _flagship_model('full') (__graft_entry__.py:40-151)
FLAGSHIP = dict(
    config=ROOT / 'configs' / 'MSMDFusion_nusc_voxel_LC.py',
    max_voxels=160000,
    enc_caps=[174336, 74240, 25088, 22784],
    gma_caps=[188416, 94208, 33280, 29696],
    union_caps=[161792, 179968, 78848, 26624],
    fg_caps=[30720, 23040, 15360, 7680],
    shape=dict(n=250000, v=6, m=20000, mr=15000, img_hw=(448, 800)),
    # encoder 8 + GMA 8 plans; encoder 21 + GMA 4 x (grouped, 2
    # aggregation, downscale) convs; 2 searches per GMA stage; the sums of
    # GMA stages 1-3
    launches={'rows_affine': 16, 'gather_gemm_conv': 37, 'masked_nn': 8,
              'merge_take': 3},
    widths={(16, 16), (32, 32), (64, 64), (128, 128), (80, 80), (96, 96),
            (192, 192), (80, 96), (96, 128), (128, 192)})
KERNEL_INFO = {
    'rows_affine': dict(
        route='cuda', source='msmdfusion_torch/csrc/rows_affine.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:1759'),
    'gather_gemm_conv': dict(
        route='cuda', source='msmdfusion_torch/csrc/gather_gemm_conv.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:924'),
    'masked_nn': dict(
        route='cuda', source='msmdfusion_torch/csrc/masked_nn.cu',
        replaces='msmdfusion_tpu/ops/nn_argmin.py:25'),
    'merge_take': dict(
        route='cuda', source='msmdfusion_torch/csrc/merge_take.cu',
        replaces='msmdfusion_tpu/ops/sparse/merge_take.py:64'),
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


def wrapper_sites():
    """{kernel: (module, attribute)}: where the path looks each kernel's
    wrapper up, so that a Recorder can stand in for it."""
    from msmdfusion_torch.models.middle_encoders import gma_encoder
    from msmdfusion_torch.ops.sparse import matchconv, tensor
    return {'rows_affine': (matchconv, 'rows_affine'),
            'gather_gemm_conv': (matchconv, 'gather_gemm_conv'),
            'masked_nn': (gma_encoder, 'masked_nn'),
            'merge_take': (tensor, 'merge_take_rows')}


class Recorder:
    """Keep the arguments of every kernel-wrapper call made inside the
    scope (the wrappers themselves still run)."""

    def __init__(self):
        self.sites = wrapper_sites()
        self.calls = {name: [] for name in self.sites}

    def __enter__(self):
        self._orig = {}
        for name, (module, attr) in self.sites.items():
            orig = getattr(module, attr)
            self._orig[name] = orig

            def wrapper(*args, _name=name, _orig=orig, **kwargs):
                self.calls[_name].append((args, kwargs))
                return _orig(*args, **kwargs)
            setattr(module, attr, wrapper)
        return self

    def __exit__(self, *exc):
        for name, (module, attr) in self.sites.items():
            setattr(module, attr, self._orig[name])
        return False


def build_model(device, config=TL['config'], n_caps=TL['enc_caps'],
                max_voxels=None, overrides=None):
    """TransFusion-L at full width (``overrides``: dotted config keys)."""
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.models.builder import build_detector
    import msmdfusion_torch.models  # noqa: F401  (registers the modules)
    cfg = load_config(str(config), overrides)
    model_cfg = cfg.model
    if max_voxels is not None:
        model_cfg.pts_voxel_layer.max_voxels = (max_voxels, max_voxels)
    model_cfg.pts_middle_encoder.stage_capacities = list(n_caps)
    return build_detector(model_cfg, device=device, seed=SEED)


def build_flagship(device, overrides=None, caps=FLAGSHIP):
    """MSMDFusion at the capacities of ``_flagship_model('full')``."""
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.models.builder import build_detector
    import msmdfusion_torch.models  # noqa: F401
    cfg = load_config(str(FLAGSHIP['config']), overrides).model
    cfg.pts_voxel_layer.max_voxels = (caps['max_voxels'],) * 2
    cfg.pts_middle_encoder.stage_capacities = list(caps['enc_caps'])
    cfg.multimodal_middle_encoder.stage_capacities = list(caps['gma_caps'])
    cfg.multimodal_middle_encoder.union_capacities = list(caps['union_caps'])
    cfg.fg_max_voxels = list(caps['fg_caps'])
    return build_detector(cfg, device=device, seed=SEED)


def make_points(model, n_points, device):
    """TransFusion-L inputs: (points [1, N, 5], mask [1, N])."""
    import numpy as np
    import torch
    from msmdfusion_torch.utils.synth_scene import lidar_scene
    pcr = model.pts_voxel_layer['point_cloud_range']
    pts, _ = lidar_scene(np.random.RandomState(SEED), n_points, pcr)
    points = torch.from_numpy(pts)[None].to(device)
    mask = torch.ones(points.shape[:2], dtype=torch.bool, device=device)
    return points, mask


def make_scene(model, shape, device):
    """Flagship inputs: (points, mask, img, fg) of ``realistic_batch``."""
    import torch
    from msmdfusion_torch.utils.synth_scene import realistic_batch
    batch = realistic_batch(
        dict(shape, pcr=model.pts_voxel_layer['point_cloud_range']), b=1,
        seed=SEED)

    def dev(x):
        return torch.from_numpy(x).to(device)
    return (dev(batch['points']), dev(batch['points_mask']),
            dev(batch['img']), {k: dev(v) for k, v in batch['fg'].items()})


def forward(model, inputs):
    preds = model(*inputs)
    return preds, model.get_bboxes(preds)


def rel_err(got, want):
    """(max |got - want|, that over max |want|)."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return err, err / max(scale, 1e-30)


def rows_calls(calls, reps, card):
    """Kernel rows_affine vs its plain version and torch.searchsorted."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
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
              f"bound_ms={rec['bytes_ms']:.4f} [{card}]", flush=True)
    return out


def conv_calls(calls, widths, reps, card, plain_reps=3):
    """Kernel gather_gemm_conv vs its plain version per call, with the
    recorded epilogue and without any. Each element is held to TOL of the
    magnitude of its own sum (the plain conv of |feats| and |weights|,
    through the epilogue's |scale| and |shift|), whatever its row's scale,
    and the whole output to TOL of its largest |value|; every width in
    ``widths`` must occur."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    out = []
    for i, (args, kwargs) in enumerate(calls):
        feats, rows, weights = args
        k_out, ta = rows.shape
        cin, cout = weights.shape[1], weights.shape[2]
        magnitude = mc.gather_gemm_conv_plain(feats.abs(), rows,
                                              weights.abs())
        errs, rels, elems = [], [], []
        for kw in (kwargs, {}):
            got = mc.gather_gemm_conv(feats, rows, weights, **kw)
            want = mc.gather_gemm_conv_plain(feats, rows, weights, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f'gather_gemm_conv call {i}: non-finite output')
            mag = magnitude
            if kw.get('scale') is not None:
                mag = mag * kw['scale'].abs()
            if kw.get('shift') is not None:
                mag = mag + kw['shift'].abs()
            diff = (got - want).abs()
            bad = int((diff > TOL * mag).sum())
            check(bad == 0, f'gather_gemm_conv call {i} ({cin}->{cout}, '
                  f'epilogue={bool(kw)}): {bad} elements differ by more '
                  f'than {TOL} of the magnitude of their sum')
            err, rel = rel_err(got, want)
            check(rel <= TOL, f'gather_gemm_conv call {i} ({cin}->{cout}, '
                  f'epilogue={bool(kw)}): error {err:.3g} is {rel:.3g} of '
                  f'max |ref|, above {TOL}')
            errs.append(err)
            rels.append(rel)
            elems.append(float((diff / mag.clamp_min(1e-30)).max()))
        # scale of the conv's sums on the active rows (``want`` is the
        # call without epilogue)
        active = want[(rows >= 0).any(1)].abs()
        median = float(active.median()) if active.numel() else 0.0
        hits = int((rows >= 0).sum())
        n_epi = sum(kwargs.get(k) is not None for k in ('scale', 'shift'))
        nbytes = 4 * (feats.numel() + rows.numel() + weights.numel()
                      + n_epi * cout + k_out * cout)
        if kwargs.get('out_valid') is not None:
            nbytes += k_out
        rec = dict(
            cin=cin, cout=cout, k_in=feats.shape[0], k_out=k_out, ta=ta,
            hits=hits, err=max(errs), rel=max(rels), elem=max(elems),
            median=median, max_ref=float(active.max()) if active.numel()
            else 0.0,
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
              f"max_abs_err={rec['err']:.3g} ({rec['rel']:.3g} of max "
              f"|ref|; |ref| max {rec['max_ref']:.3g} median "
              f"{median:.3g}) worst |err|/|sum| {rec['elem']:.3g} "
              f"(limit {TOL}) ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={max(rec['bytes_ms'], rec['ops_ms']):.4f} [{card}]",
              flush=True)
    covered = {(r['cin'], r['cout']) for r in out}
    check(widths <= covered,
          f'widths not exercised: {sorted(widths - covered)}')
    return out


def nn_calls(calls, reps, card, plain_reps=3):
    """Kernel masked_nn vs its plain version per call: idx and d2 equal."""
    import torch
    from msmdfusion_torch.ops import nn_argmin
    out = []
    for i, (args, kwargs) in enumerate(calls):
        a, ab, b, bb, b_valid = args
        idx, d2 = nn_argmin.masked_nn(*args, **kwargs)
        p_idx, p_d2 = nn_argmin.masked_nn_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(idx, p_idx) and torch.equal(d2, p_d2),
              f'masked_nn call {i}: {int((idx != p_idx).sum())} indices and '
              f'{int((d2 != p_d2).sum())} distances differ from the plain '
              'version')
        # the pairs this run's data needs: each A row against the valid B
        # rows of its batch
        pairs = sum(int((ab == g).sum()) * int((b_valid & (bb == g)).sum())
                    for g in torch.unique(bb[b_valid]).tolist())
        # a, ab and b, bb, b_valid read once; idx and d2 written once
        nbytes = 16 * a.shape[0] + 17 * b.shape[0] + 8 * a.shape[0]
        rec = dict(
            na=a.shape[0], nb=b.shape[0], pairs=pairs,
            found=int((idx >= 0).sum()), err=0.0,
            ms=cuda_ms(lambda: nn_argmin.masked_nn(*args), reps),
            plain_ms=cuda_ms(lambda: nn_argmin.masked_nn_plain(*args),
                             plain_reps),
            library_ms=None, bytes_ms=nbytes / PEAK_BYTES * 1e3,
            ops_ms=NN_OPS_PER_PAIR * pairs / PEAK_FP32 * 1e3)
        out.append(rec)
        print(f"masked_nn[{i}] Na={rec['na']} Nb={rec['nb']} "
              f"pairs={pairs} found={rec['found']} exact "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={max(rec['bytes_ms'], rec['ops_ms']):.4f} [{card}]",
              flush=True)
    return out


def take_calls(calls, reps, card):
    """Kernel merge_take vs its plain version per call: equal rows."""
    import torch
    from msmdfusion_torch.ops.sparse import merge_take as mt
    out = []
    for i, (args, kwargs) in enumerate(calls):
        table, idx = args[:2]
        idx2, dup = args[2:4] if len(args) > 2 else (None, None)
        got = mt.merge_take_rows(*args, **kwargs)
        want = mt.merge_take_rows_plain(table, idx, idx2, dup)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f'merge_take call {i}: {int((got != want).any(1).sum())} rows '
              'differ from the plain version')
        n, c = table.shape
        m = idx.shape[0]
        rows = int(((idx >= 0) & (idx < n)).sum())
        nbytes = 4 * m                                 # idx
        if dup is not None:
            rows += int(dup.sum())
            nbytes += 5 * m                            # idx2, dup
        nbytes += 4 * c * (rows + m)           # rows read, output written
        rec = dict(
            n=n, c=c, m=m, rows=rows, err=0.0,
            ms=cuda_ms(lambda: mt.merge_take_rows(*args), reps),
            plain_ms=cuda_ms(lambda: mt.merge_take_rows_plain(
                table, idx, idx2, dup), reps),
            library_ms=None, bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=0.0)
        out.append(rec)
        print(f"merge_take[{i}] N={n} C={c} M={m} rows_read={rows} exact "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={rec['bytes_ms']:.4f} [{card}]", flush=True)
    return out


def kernel_summary(name, recs, launches):
    """One entry of the ``kernels`` line: sums over the path's calls."""
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


class ReorderedSums:
    """Inside the scope the plain sparse conv sums its taps, and each tap's
    input channels, in the reverse order: the same sums in another fp32
    order, a legitimate path whose spread from the plain path measures
    what the model itself makes of rounding."""

    def __enter__(self):
        from msmdfusion_torch.ops.sparse import matchconv as mc
        self._mc, orig = mc, mc.gather_gemm_conv_plain
        self._orig = orig
        mc.gather_gemm_conv_plain = lambda feats, rows, weights, *a, **k: \
            orig(feats.flip(1), rows.flip(1), weights.flip(0).flip(1),
                 *a, **k)
        return self

    def __exit__(self, *exc):
        self._mc.gather_gemm_conv_plain = self._orig
        return False


class HeadInput:
    """Keep the BEV map the detection head is called on inside the scope."""

    def __init__(self, head):
        self.head = head
        self.x = None

    def __enter__(self):
        def keep(module, args):
            self.x = args[0].clone()
        self._handle = self.head.register_forward_pre_hook(keep)
        return self

    def __exit__(self, *exc):
        self._handle.remove()
        return False


def pinned_forward(model, inputs, index, *scopes):
    """(head input, preds, boxes) of one forward decoding ``index``."""
    with contextlib.ExitStack() as stack:
        for scope in scopes:
            stack.enter_context(scope)
        stack.enter_context(PinnedProposals(index))
        head_in = stack.enter_context(HeadInput(model.pts_bbox_head))
        preds, boxes = forward(model, inputs)
    return dict(preds, **boxes, head_input=head_in.x)


def compare_outputs(run, ref, alt):
    """The kernel path ``run`` vs the plain path ``ref`` on the same
    proposals; ``alt`` is the plain path with reordered sums. Returns
    {key: (error over max |ref|, its limit, the same for ``alt``, median
    |ref|)}.

    Up to the head (its input and the dense heatmap) every output is held
    to TOL of its largest value. The decoder's attention then amplifies
    rounding (softmax over logits of tens), so its outputs and the boxes
    are held to FLOOR_MARGIN times the plain path's own spread under
    reordered sums, and never less than TOL."""
    import torch
    worst = {}
    for key in ('head_input', 'dense_heatmap', 'heatmap', 'center', 'dim',
                'bboxes', 'scores'):
        rel = rel_err(run[key], ref[key])[1]
        floor = rel_err(alt[key], ref[key])[1]
        limit = TOL if key in ('head_input', 'dense_heatmap') else \
            max(TOL, FLOOR_MARGIN * floor)
        worst[key] = (rel, limit, floor, float(ref[key].abs().median()))
        check(rel <= limit, f'{key}: kernel vs plain path {rel:.3g} of max '
              f'|ref|, above {limit:.3g} (reordered plain path {floor:.3g})')
    for key in ('labels', 'valid'):
        check(torch.equal(run[key], ref[key]),
              f'{key} differ between the kernel and plain paths')
    return worst


def profile_forward(fn, top=8):
    """``fn()`` once under torch.profiler: (host window ms, device busy ms,
    [(device ms, kernel name)] of the ``top`` kernels). Busy time is the
    union of the device events' spans (CUPTI's own buffer events left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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


def drive(label, model, inputs, spec, card, reps):
    """Run the path described in the module docstring on one model.
    Returns ({kernel: per-call records}, {kernel: launches})."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.utils import overflow, timing
    expected = spec['launches']

    # the path's kernel calls, each against its plain version
    with torch.no_grad(), Recorder() as rec:
        forward(model, inputs)
    torch.cuda.synchronize()
    recorded = {k: len(v) for k, v in rec.calls.items() if v}
    check(recorded == expected,
          f'{label}: recorded calls {recorded}, expected {expected}')
    recs = {}
    with torch.no_grad():
        recs['rows_affine'] = rows_calls(rec.calls['rows_affine'],
                                         reps['kernel'], card)
        recs['gather_gemm_conv'] = conv_calls(rec.calls['gather_gemm_conv'],
                                              spec['widths'],
                                              reps['kernel'] // 2, card)
        if rec.calls['masked_nn']:
            recs['masked_nn'] = nn_calls(rec.calls['masked_nn'],
                                         reps['kernel'], card)
        if rec.calls['merge_take']:
            recs['merge_take'] = take_calls(rec.calls['merge_take'],
                                            reps['kernel'], card)
    del rec

    # the main path through the kernels, counted
    with torch.no_grad():
        kernels.reset_launches()
        with overflow.capture() as cap, timing.record('cuda') as tr:
            preds, boxes = forward(model, inputs)
        launches = dict(kernels.launches)
        torch.cuda.synchronize()
    print(f'{label}: launches on the main path: {launches}', flush=True)
    for name, n in expected.items():
        check(launches[name] > 0, f'{label}: {name} never launched')
        check(launches[name] == n,
              f'{label}: {name} launched {launches[name]} times, expected '
              f'{n}')
    check(cap.total() == 0, f'{label}: overflow {cap.counters()}')
    b = boxes['bboxes']
    check(b.shape[-1] == 9 and b.shape[1] == model.pts_bbox_head.num_proposals,
          f'{label}: bboxes shape {tuple(b.shape)}')
    check(bool(torch.isfinite(b).all()), f'{label}: non-finite boxes')
    s = boxes['scores']
    check(bool(((s >= 0) & (s <= 1)).all()), f'{label}: scores outside [0, 1]')
    occupancy = {k: v for k, v in cap.gauge_values().items()
                 if k.startswith('occ.')}
    print(f'{label}: overflow_total 0; occupancy {occupancy}', flush=True)
    stage_ms = {k: round(v, 4) for k, v in tr.ms().items()}
    print(f'{label}: stage_ms {json.dumps(stage_ms)} [{card}]', flush=True)

    # the same forward on the plain versions (and with reordered sums),
    # decoding the kernel path's proposals: a near-tie at the top-k cut may
    # not swap one
    with torch.no_grad():
        index = proposal_index(preds)
        run = pinned_forward(model, inputs, index)
        ref = pinned_forward(model, inputs, index, kernels.plain_kernels())
        alt = pinned_forward(model, inputs, index, kernels.plain_kernels(),
                             ReorderedSums())
        excess, differ = check_proposals(model.pts_bbox_head, index, ref)
        worst = compare_outputs(run, ref, alt)
        del run, ref, alt
    for key, (rel, limit, floor, median) in worst.items():
        print(f'{label}: kernel vs plain path: {key} {rel:.3g} of max |ref| '
              f'(limit {limit:.3g}; plain path with reordered sums '
              f'{floor:.3g}; median |ref| {median:.3g})', flush=True)
    print(f'{label}: proposals: a top-{model.pts_bbox_head.num_proposals} '
          f'of the plain heatmap (worst excess {excess:.3g}), {differ} '
          'differ from its own choice', flush=True)

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        frame_ms = cuda_ms(lambda: forward(model, inputs), reps['frame'])
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        for _ in range(reps['frame']):
            forward(model, inputs)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / reps['frame'] * 1e3
        with kernels.plain_kernels():
            plain_frame_ms = cuda_ms(lambda: forward(model, inputs), 2)
    print(f'{label}: e2e {frame_ms:.3f} ms/frame (CUDA events, '
          f'{reps["frame"]} frames), {1e3 / frame_ms:.2f} frames/s; host '
          f'clock {host_ms:.3f} ms/frame; plain versions '
          f'{plain_frame_ms:.3f} ms/frame; peak memory {peak_gb:.2f} GiB '
          f'[{card}]', flush=True)
    with torch.no_grad():
        window_ms, busy_ms, ranked = profile_forward(
            lambda: forward(model, inputs))
    check(busy_ms > 0, f'{label}: the profiler saw no device work')
    print(f'{label}: profile: one forward {window_ms:.3f} ms host window, '
          f'device busy {busy_ms:.3f} ms, idle share '
          f'{1 - busy_ms / window_ms:.3f} [{card}]', flush=True)
    for ms, name in ranked:
        print(f'{label}: profile: {ms:9.3f} ms  {name[:100]}', flush=True)
    return recs, launches


def dense_engines(model, inputs, card, reps=3):
    """The dense layers new to the flagship at its shapes, timed on cuDNN
    and on PyTorch's own convolution (cuDNN off) under the global flag:
    the check behind ``models/layers.py::cudnn_enabled``'s choices."""
    import torch
    img = inputs[2]
    b, v, h, w, _ = img.shape
    backbone = model.img_backbone

    def resnet_body(x):
        # ResNet.forward's layers without its own choice of engine
        x = backbone.maxpool(torch.relu(backbone.bn1(backbone.conv1(x))))
        for s in range(backbone.num_stages):
            x = getattr(backbone, f'layer{s + 1}')(x)
        return x

    with torch.no_grad():
        x = img.reshape(b * v, h, w, 3).permute(0, 3, 1, 2).contiguous()
        level0 = model.img_neck(backbone(x))[0]
        comp_in = torch.cat([level0, level0[:, :1]], 1)
        c_bev = model.bev_fusion.conv1x1[0].in_channels
        bev = torch.randn(1, c_bev, 180, 180, device=img.device)
        spp = model.bev_fusion
        cases = [
            (f'ResNet-50 {b * v}x3x{h}x{w}', lambda: resnet_body(x)),
            (f'compress {comp_in.shape[1]}->49 5x5 at '
             f'{level0.shape[2]}x{level0.shape[3]}',
             lambda: model.conv1x1_blocks[0](comp_in)),
            (f'SPP 3x3 {c_bev}->256 at 180x180', lambda: spp.conv3x3(bev)),
            (f'SPP 3x3 dilation 6 {c_bev}->256 at 180x180',
             lambda: spp.dilated_conv3x3_rate6(bev)),
            (f'SPP 3x3 dilation 12 {c_bev}->256 at 180x180',
             lambda: spp.dilated_conv3x3_rate12(bev)),
        ]
        was = torch.backends.cudnn.enabled
        try:
            for name, fn in cases:
                times = []
                for on in (True, False, True):
                    torch.backends.cudnn.enabled = on
                    times.append(cuda_ms(fn, reps))
                print(f'dense engines: {name}: cuDNN {times[0]:.3f} / '
                      f'{times[2]:.3f} ms, off cuDNN {times[1]:.3f} ms '
                      f'[{card}]', flush=True)
        finally:
            torch.backends.cudnn.enabled = was


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
    from msmdfusion_torch.utils.calibrate import calibrate_norms

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

    # 3. TransFusion-L
    t0 = time.perf_counter()
    model = build_model(dev, max_voxels=TL['max_voxels'])
    inputs = make_points(model, TL['n_points'], dev)
    calibrate_norms(model, *inputs)
    print(f'TransFusion-L setup: model + {TL["n_points"]} points + norms in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    drive('TransFusion-L', model, inputs, TL, card,
          reps=dict(kernel=10, frame=5))
    del model, inputs
    torch.cuda.empty_cache()

    # 4. MSMDFusion
    t0 = time.perf_counter()
    model = build_flagship(dev)
    inputs = make_scene(model, FLAGSHIP['shape'], dev)
    calibrate_norms(model, *inputs)
    print(f'MSMDFusion setup: model + realistic scene + norms in '
          f'{time.perf_counter() - t0:.1f} s; foreground points '
          f'{int(inputs[3]["fg_mask"].sum())}, real pixels '
          f'{int(inputs[3]["fg_real_mask"].sum())}', flush=True)
    recs, launches = drive('MSMDFusion', model, inputs, FLAGSHIP, card,
                           reps=dict(kernel=10, frame=10))
    dense_engines(model, inputs, card)

    summary = [kernel_summary(name, recs[name], launches)
               for name in KERNEL_INFO]
    print(json.dumps({'kernels': summary}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
