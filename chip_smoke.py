#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA card: TransFusion-L, the
full MSMDFusion flagship, the flagship's train step, then the flagship's
inference and train step on the two other sparse-conv engines.

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
   layers new to this model are timed on and off cuDNN;
5. the MSMDFusion train step on the same model and scene, with the
   scene's ground truth: the reference's stage-2 recipe (frozen
   ``img_backbone``/``img_neck``, AdamW lr 1e-4 and weight decay 0.05,
   global-norm clip 10, step schedule with linear warmup), dropout from a
   seeded generator. One step records the arguments of every
   ``rows_queries``, ``conv_dw`` and backward ``gather_gemm_conv`` call;
   each is held against its plain version (rows equal; ``dw`` and
   ``d_feats`` elements within 1e-4 of the magnitude of their sums) and
   timed alone. The same step on the plain versions, on the kernel path's
   proposals, assignment, dropout masks, head-input gradient and ReLU
   masks (at full scale every layer has ReLU inputs within rounding of 0,
   and a free ReLU there moves a gradient by up to a few percent of its
   largest value, the kernel path against itself included): the
   dense-heatmap loss and every parameter gradient below the head within
   1e-4 of their largest value, the decoder's losses, the head-input
   gradient and the head's parameter gradients within 10 times the plain
   path's own spread under reordered sums. Then one counted step through
   ``apis.train.make_train_step`` (launches of all six kernels asserted,
   no row dropped), five timed AdamW steps after a warm-up (forward with
   the auction timed apart, backward, optimizer; finite losses; the
   trainable parameters move, the frozen image branch does not), the
   backward on and off cuDNN, and a profile with the idle share;
6. the packed bf16 engine (``MSMD_CONV_DTYPE=bfloat16``, set around this
   phase only: the JAX package's benchmarked setting) on the same model
   with its calibrated weights: the path below with every conv call on
   kernel ``gather_gemm_conv_bf16`` held against its plain version (which
   rounds the same operands, so the per-element rule holds), the launches
   (16/37/8/3), and the all-plain twin held to 10 times the plain path's
   reordered spread up to the head too (bf16 rounding of every conv's
   input turns fp32 ulps into bf16 ulps); how far its head input and boxes
   lie from phase 4's fp32 path (printed, not held); then phase 5's
   train step with every ``conv_dw_bf16`` and backward-conv call held to
   1e-4 of its sums, the twin, a counted step (launches 16/8/73/37/8/3)
   and 3 timed steps. Every packed call must carry its plan's row order
   (``matchconv.RowOrder``); its line prints the useful share (hits over
   the row-taps or pairs the kernel stages) and its time over the fp32
   kernel's on the same call in phase 4 or 5 (``fp32_ratio``);
7. the one-hot engine (``MSMD_CONV_ALGO=onehot``): no rulebook rows, every
   conv matches its plan's queries in kernel ``match_conv``: the path
   below with every call held to its plain version, launches (37/8/3, no
   rows kernel), the twin and ms/frame; then the train step with the
   forward and backward ``match_conv`` calls, the 37 ``rows_affine`` calls
   that build each conv's ``dw`` rows in the backward and ``conv_dw``
   against their plain versions, a counted step (launches 37/73/37/8/3)
   and 2 timed steps. Last, the three engines' frames interleaved (one
   of each per round, 6 rounds), the frame and its stage ``plans`` per
   engine, so that a slow stretch of the host falls on all three.

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

The line before the last is ``{"kernels": [...]}``: per kernel its
launches, its largest error against the plain version, its time, the
plain version's, its bound and a library call's, each time the sum over
the path's calls; the flagship's inference path for ``rows_affine``,
``gather_gemm_conv``, ``masked_nn`` and ``merge_take`` (ms per frame), its
train step for ``rows_queries`` and ``conv_dw`` (ms per step), phase 6's
inference for ``gather_gemm_conv_bf16`` and train step for
``conv_dw_bf16``, phase 7's inference for ``match_conv``. The bf16
kernels' bound takes the card's dense bf16 tensor rate; their entries
also carry ``useful_share`` and ``fp32_ratio``. The last line is
``{"ok": true, "device": {...}}``.

Rehearse phases 4-7 on the CPU with the tiny flagship of
``tests/test_torch_train_step.py``: ``flagship_phases`` takes the model
and the specs (widths emptied); patch ``torch.cuda``'s events and
synchronisation, ``profile_forward`` and ``dense_engines``, and count a
launch where each wrapper of ``wrapper_sites()`` runs outside
``plain_kernels()``.
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
# the same data sheet: dense bf16 on the tensor cores (the packed engine's
# operands), 700 W
PEAK_BF16 = 989e12
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
# the flagship train step: the reference's stage-2 recipe as the JAX
# package's bench runs it (bench.py:258-285)
TRAIN = dict(
    optimizer=dict(type='AdamW', lr=1e-4, weight_decay=0.05),
    optimizer_config=dict(grad_clip=dict(max_norm=10)),
    lr_config=dict(policy='step', warmup='linear', warmup_iters=1000,
                   warmup_ratio=0.001, step=[4, 5]),
    total_steps=10000, steps_per_epoch=1000,
    frozen=('img_backbone', 'img_neck'),
    # forward as in inference plus 8 dual plans (encoder spconv1-3 and
    # conv_out, GMA downscales 1-4); backward: d_feats for every conv but
    # conv_input (whose input needs no gradient), dw for all 37
    launches={'rows_affine': 16, 'rows_queries': 8, 'gather_gemm_conv': 73,
              'conv_dw': 37, 'masked_nn': 8, 'merge_take': 3},
    steps=5, twin=True, extras=True)
# phase 6: the JAX package's benchmarked setting (bench.py:116-120), the
# rulebook engine with bf16 operands; the same plans, rows and counts
PACKED = dict(
    env={'MSMD_CONV_DTYPE': 'bfloat16'},
    launches={'rows_affine': 16, 'gather_gemm_conv_bf16': 37,
              'masked_nn': 8, 'merge_take': 3},
    widths=FLAGSHIP['widths'], pin_rounding=True,
    train=dict(launches={'rows_affine': 16, 'rows_queries': 8,
                         'gather_gemm_conv_bf16': 73, 'conv_dw_bf16': 37,
                         'masked_nn': 8, 'merge_take': 3},
               steps=3, twin=True, extras=False, pin_rounding=True))
# phase 7: the one-hot engine, no rulebook: every conv searches its
# queries; the backward builds each conv's rows for dw (37 rows_affine)
ONEHOT = dict(
    env={'MSMD_CONV_ALGO': 'onehot'},
    launches={'match_conv': 37, 'masked_nn': 8, 'merge_take': 3},
    widths=FLAGSHIP['widths'],
    train=dict(launches={'rows_affine': 37, 'match_conv': 73, 'conv_dw': 37,
                         'masked_nn': 8, 'merge_take': 3},
               steps=2, twin=False, extras=False))
KERNEL_INFO = {
    'rows_affine': dict(
        route='cuda', source='msmdfusion_torch/csrc/rows_affine.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:1759'),
    'rows_queries': dict(
        route='cuda', source='msmdfusion_torch/csrc/rows_affine.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:1696'),
    'gather_gemm_conv': dict(
        route='cuda', source='msmdfusion_torch/csrc/gather_gemm_conv.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:924'),
    'conv_dw': dict(
        route='cuda', source='msmdfusion_torch/csrc/conv_dw.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:924'),
    'gather_gemm_conv_bf16': dict(
        route='cuda', source='msmdfusion_torch/csrc/gather_gemm_conv_bf16.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:924'),
    'conv_dw_bf16': dict(
        route='cuda', source='msmdfusion_torch/csrc/conv_dw_bf16.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:924'),
    'match_conv': dict(
        route='cuda', source='msmdfusion_torch/csrc/match_conv.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:615'),
    'masked_nn': dict(
        route='cuda', source='msmdfusion_torch/csrc/masked_nn.cu',
        replaces='msmdfusion_tpu/ops/nn_argmin.py:25'),
    'merge_take': dict(
        route='cuda', source='msmdfusion_torch/csrc/merge_take.cu',
        replaces='msmdfusion_tpu/ops/sparse/merge_take.py:64'),
}
# the wrapper that launches each kernel where it is not the kernel's name:
# the rulebook conv and dw wrappers pick their bf16 kernels under the switch
WRAPPER = {'gather_gemm_conv_bf16': 'gather_gemm_conv',
           'conv_dw_bf16': 'conv_dw'}


def as_recorded(launches):
    """{wrapper: calls} that kernel launches {kernel: n} come from."""
    out = {}
    for name, n in launches.items():
        out[WRAPPER.get(name, name)] = out.get(WRAPPER.get(name, name), 0) + n
    return out


def kernel_of(wrapper):
    """The kernel a conv or dw wrapper launches under the switches."""
    from msmdfusion_torch.ops.sparse import matchconv as mc
    if wrapper in WRAPPER.values() and mc.packed():
        return wrapper + '_bf16'
    return wrapper


@contextlib.contextmanager
def switches(env):
    """The conv engine's switches (``MSMD_CONV_*``) set inside the scope."""
    import os
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
            'rows_queries': (matchconv, 'rows_queries'),
            'gather_gemm_conv': (matchconv, 'gather_gemm_conv'),
            'conv_dw': (matchconv, 'conv_dw'),
            'match_conv': (matchconv, 'match_conv'),
            'masked_nn': (gma_encoder, 'masked_nn'),
            'merge_take': (tensor, 'merge_take_rows')}


class Recorder:
    """Keep the arguments of every kernel-wrapper call made inside the
    scope (the wrappers themselves still run). ``phase`` labels the calls
    recorded while it is set (e.g. 'backward'): ``calls_in(name, phase)``."""

    def __init__(self):
        self.sites = wrapper_sites()
        self.calls = {name: [] for name in self.sites}
        self.phase = 'forward'
        self.phases = {name: [] for name in self.sites}

    def calls_in(self, name, phase):
        return [c for c, p in zip(self.calls[name], self.phases[name])
                if p == phase]

    def __enter__(self):
        self._orig = {}
        for name, (module, attr) in self.sites.items():
            orig = getattr(module, attr)
            self._orig[name] = orig

            def wrapper(*args, _name=name, _orig=orig, **kwargs):
                self.calls[_name].append((args, kwargs))
                self.phases[_name].append(self.phase)
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
    """Flagship inputs (points, mask, img, fg) of ``realistic_batch`` and
    the scene's ground truth (gt_bboxes, gt_labels, gt_valid)."""
    import torch
    from msmdfusion_torch.utils.synth_scene import realistic_batch
    batch = realistic_batch(
        dict(shape, pcr=model.pts_voxel_layer['point_cloud_range']), b=1,
        seed=SEED, return_gt=True)

    def dev(x):
        return torch.from_numpy(x).to(device)
    gt = batch['gt']
    return ((dev(batch['points']), dev(batch['points_mask']),
             dev(batch['img']), {k: dev(v) for k, v in batch['fg'].items()}),
            (dev(gt['gt_bboxes']), dev(gt['gt_labels']), dev(gt['gt_valid'])))


def forward(model, inputs):
    preds = model(*inputs)
    return preds, model.get_bboxes(preds)


def rel_err(got, want):
    """(max |got - want|, that over max |want|)."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return err, err / max(scale, 1e-30)


def rows_checked(name, i, got, want, masked):
    """The rows kernel's output (rows, and their tap-hit masks where the
    call asked for them: the packed engine's plans) against the plain
    rows and their ``row_masks``; returns (rows, the masks' bytes)."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    got, masks = got if masked else (got, None)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          f'{name} call {i}: {int((got != want).sum())} rows differ from '
          'the plain version')
    if masked:
        check(torch.equal(masks, mc.row_masks(want)),
              f'{name} call {i}: tap-hit masks differ from the rows\' ones')
    return got, 0 if masks is None else masks.numel() * 8


def rows_calls(calls, reps, card):
    """Kernel rows_affine vs its plain version and torch.searchsorted."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    out = []
    for i, (args, kwargs) in enumerate(calls):
        in_keys, okeys, dkey, inb = args
        masked = bool(kwargs.get('masks'))
        got, mask_bytes = rows_checked(
            'rows_affine', i, mc.rows_affine(*args, **kwargs),
            mc.rows_affine_plain(*args), masked)
        q = okeys[:, None] + dkey[None, :]
        nbytes = (in_keys.numel() + okeys.numel() + dkey.numel()) * 4 + \
            inb.numel() + got.numel() * 4 + mask_bytes
        rec = dict(
            k_in=in_keys.numel(), k_out=okeys.numel(), ta=dkey.numel(),
            hits=int((got >= 0).sum()), err=0.0,
            ms=cuda_ms(lambda: mc.rows_affine(*args, **kwargs), reps),
            plain_ms=cuda_ms(lambda: plain_rows(
                mc.rows_affine_plain(*args), masked), reps),
            library_ms=cuda_ms(lambda: torch.searchsorted(in_keys, q), reps),
            bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=0.0)
        out.append(rec)
        print(f"rows_affine[{i}] K_in={rec['k_in']} K_out={rec['k_out']} "
              f"Ta={rec['ta']} hits={rec['hits']} "
              f"{'with masks ' if masked else ''}exact ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"searchsorted_ms={rec['library_ms']:.4f} "
              f"bound_ms={rec['bytes_ms']:.4f} [{card}]", flush=True)
    return out


def plain_rows(rows, masked):
    """The plain rows, with their ``row_masks`` where the call asked."""
    from msmdfusion_torch.ops.sparse import matchconv as mc
    return (rows, mc.row_masks(rows)) if masked else rows


def rows_queries_calls(calls, reps, card):
    """Kernel rows_queries vs its plain version and torch.searchsorted."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    out = []
    for i, (args, kwargs) in enumerate(calls):
        in_keys, queries, inb = args
        masked = bool(kwargs.get('masks'))
        got, mask_bytes = rows_checked(
            'rows_queries', i, mc.rows_queries(*args, **kwargs),
            mc.rows_queries_plain(*args), masked)
        nbytes = (in_keys.numel() + queries.numel() + got.numel()) * 4 + \
            inb.numel() + mask_bytes
        rec = dict(
            k_in=in_keys.numel(), k_out=queries.shape[0],
            ta=queries.shape[1], hits=int((got >= 0).sum()), err=0.0,
            ms=cuda_ms(lambda: mc.rows_queries(*args, **kwargs), reps),
            plain_ms=cuda_ms(lambda: plain_rows(
                mc.rows_queries_plain(*args), masked), reps),
            library_ms=cuda_ms(lambda: torch.searchsorted(in_keys, queries),
                               reps),
            bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=0.0)
        out.append(rec)
        print(f"rows_queries[{i}] K_in={rec['k_in']} K={rec['k_out']} "
              f"Ta={rec['ta']} hits={rec['hits']} "
              f"{'with masks ' if masked else ''}exact ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"searchsorted_ms={rec['library_ms']:.4f} "
              f"bound_ms={rec['bytes_ms']:.4f} [{card}]", flush=True)
    return out


def held_to_sums(name, got, want, magnitude):
    """Each element of ``got`` within TOL of the magnitude of its own sum
    and the whole within TOL of the largest |want|; returns (max abs
    error, that over max |want|, the worst element error over its sum's
    magnitude)."""
    import torch
    check(bool(torch.isfinite(got).all()), f'{name}: non-finite output')
    diff = (got - want).abs()
    bad = int((diff > TOL * magnitude).sum())
    check(bad == 0, f'{name}: {bad} elements differ by more than {TOL} of '
          'the magnitude of their sum')
    err, rel = rel_err(got, want)
    check(rel <= TOL, f'{name}: error {err:.3g} is {rel:.3g} of max |ref|, '
          f'above {TOL}')
    return err, rel, float((diff / magnitude.clamp_min(1e-30)).max()) \
        if diff.numel() else 0.0


def dw_calls(calls, reps, card, plain_reps=3, fp32=None):
    """Kernel conv_dw (conv_dw_bf16 under the packed switch) vs its plain
    version per call: each element held to TOL of the magnitude of its sum
    (the plain dw of |feats| and |g|); two calls give the same bits. Under
    the packed switch each call must carry its plan's row order, and
    ``fp32`` (the fp32 kernel's records of the same calls) gives each
    call's time ratio to it."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    name = kernel_of('conv_dw')
    peak = PEAK_BF16 if mc.packed() else PEAK_FP32
    out = []
    for i, (args, kwargs) in enumerate(calls):
        feats, rows, g = args
        k_out, ta = rows.shape
        cin, cout = feats.shape[1], g.shape[1]
        check(not mc.packed() or kwargs.get('order') is not None,
              f'{name} call {i}: the path gave it no row order')
        got = mc.conv_dw(*args, **kwargs)
        again = mc.conv_dw(*args, **kwargs)
        want = mc.conv_dw_plain(*args)
        magnitude = mc.conv_dw_plain(feats.abs(), rows, g.abs())
        torch.cuda.synchronize()
        check(torch.equal(got, again), f'{name} call {i}: two calls differ')
        err, rel, elem = held_to_sums(f'{name} call {i} ({cin}x{cout})',
                                      got, want, magnitude)
        hits = int((rows >= 0).sum())
        nbytes = 4 * (feats.numel() + rows.numel() + g.numel() + got.numel())
        rec = dict(
            cin=cin, cout=cout, k_in=feats.shape[0], k_out=k_out, ta=ta,
            hits=hits, err=err, rel=rel, elem=elem,
            ms=cuda_ms(lambda: mc.conv_dw(*args, **kwargs), reps),
            plain_ms=cuda_ms(lambda: mc.conv_dw_plain(*args), plain_reps),
            library_ms=None, bytes_ms=nbytes / PEAK_BYTES * 1e3,
            ops_ms=2.0 * hits * cin * cout / peak * 1e3)
        extra = ''
        if mc.packed():
            rec['staged'] = dw_staged_pairs(kwargs['order'], cin, cout)
            extra += f"useful={hits / max(rec['staged'], 1):.3f} "
        extra += same_call_ratio(rec, fp32, i)
        out.append(rec)
        print(f"{name}[{i}] {cin}x{cout} K_in={rec['k_in']} K_out={k_out} "
              f"Ta={ta} hits={hits} deterministic max_abs_err={err:.3g} "
              f"({rel:.3g} of max |ref|) worst |err|/|sum| {elem:.3g} "
              f"(limit {TOL}) ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={max(rec['bytes_ms'], rec['ops_ms']):.4f} "
              f"{extra}[{card}]", flush=True)
    return out


def conv_staged_row_taps(order, ta):
    """Row-taps the packed conv multiplies: 16 rows for each tap of each
    16-row slice's mask (the useful share is the hits over these)."""
    from msmdfusion_torch.ops.sparse import matchconv as mc
    m = order.slice_masks()
    return mc.SLICE_ROWS * sum(int(((m >> t) & 1).sum()) for t in range(ta))


def dw_staged_pairs(order, cin, cout):
    """Pair slots conv_dw_bf16 stages: each chunk of each tap's pair
    list in whole stages (the useful share is the hits over these)."""
    from msmdfusion_torch.ops.sparse import matchconv as mc
    tile, chunk, _ = mc.conv_dw_bf16_launch(order.tap_hits, cin, cout)
    step = mc.dw_stage_pairs(tile)
    return sum(n // chunk * chunk + -(-(n % chunk) // step) * step
               for n in order.tap_hits)


def same_call_ratio(rec, fp32, i):
    """' fp32_ratio=x': this call's time over the fp32 kernel's on the
    same call (``fp32``: that kernel's records, same shapes, in order)."""
    if fp32 is None:
        return ''
    f = fp32[i]
    check((f['cin'], f['cout'], f['k_out'], f['hits']) ==
          (rec['cin'], rec['cout'], rec['k_out'], rec['hits']),
          f'call {i}: the fp32 record is of another call')
    rec['fp32_ms'] = f['ms']
    return f"fp32_ms={f['ms']:.4f} fp32_ratio={rec['ms'] / f['ms']:.3f} "


def conv_calls(calls, widths, reps, card, plain_reps=3, label=None,
               fp32=None):
    """Each recorded conv call (``gather_gemm_conv``, which launches
    ``gather_gemm_conv_bf16`` under the packed switch, or ``match_conv``)
    against its plain version, with the recorded epilogue and without
    any. Each element is held to TOL of the magnitude of its own sum (the
    plain conv of |feats| and |weights|, through the epilogue's |scale| and
    |shift|), whatever its row's scale, and the whole output to TOL of its
    largest |value|; every width in ``widths`` must occur. Under the packed
    switch each call must carry its plan's row order (it is not an
    epilogue argument), and ``fp32`` (the fp32 kernel's records of the same
    calls) gives each call's time ratio to it."""
    import functools
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    peak = PEAK_BF16 if mc.packed() else PEAK_FP32
    out = []
    for i, (args, kwargs) in enumerate(calls):
        kwargs = dict(kwargs)
        order = kwargs.pop('order', None)
        if len(args) == 4:                      # match_conv: no rulebook
            feats, in_keys, plan, weights = args
            conv, plain, name = mc.match_conv, mc.match_conv_plain, \
                'match_conv'
            rows = mc.plan_rows_plain(in_keys, plan)
            # the keys it searches and the plan it reads, not rows
            plan_bytes = 4 * in_keys.numel() + plan.inb.numel() + 4 * (
                plan.queries.numel() if plan.queries is not None
                else plan.okeys.numel() + plan.dkey.numel())
        else:
            feats, rows, weights = args
            conv, plain = mc.gather_gemm_conv, mc.gather_gemm_conv_plain
            name = kernel_of('gather_gemm_conv')
            plan_bytes = 4 * rows.numel()
            if mc.packed():
                check(order is not None,
                      f'{name} call {i}: the path gave it no row order')
                conv = functools.partial(conv, order=order)
        label = label or name
        k_out, ta = rows.shape
        cin, cout = weights.shape[1], weights.shape[2]
        magnitude = mc.gather_gemm_conv_plain(feats.abs(), rows,
                                              weights.abs())
        errs, rels, elems = [], [], []
        for kw in ((kwargs, {}) if kwargs else ({},)):
            got = conv(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f'{name} call {i}: non-finite output')
            mag = magnitude
            if kw.get('scale') is not None:
                mag = mag * kw['scale'].abs()
            if kw.get('shift') is not None:
                mag = mag + kw['shift'].abs()
            diff = (got - want).abs()
            bad = int((diff > TOL * mag).sum())
            check(bad == 0, f'{name} call {i} ({cin}->{cout}, '
                  f'epilogue={bool(kw)}): {bad} elements differ by more '
                  f'than {TOL} of the magnitude of their sum')
            err, rel = rel_err(got, want)
            check(rel <= TOL, f'{name} call {i} ({cin}->{cout}, '
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
        nbytes = 4 * (feats.numel() + weights.numel() + n_epi * cout
                      + k_out * cout) + plan_bytes
        if kwargs.get('out_valid') is not None:
            nbytes += k_out
        rec = dict(
            cin=cin, cout=cout, k_in=feats.shape[0], k_out=k_out, ta=ta,
            hits=hits, err=max(errs), rel=max(rels), elem=max(elems),
            median=median, max_ref=float(active.max()) if active.numel()
            else 0.0,
            ms=cuda_ms(lambda: conv(*args, **kwargs), reps),
            plain_ms=cuda_ms(lambda: plain(*args, **kwargs), plain_reps),
            library_ms=None,
            bytes_ms=nbytes / PEAK_BYTES * 1e3,
            ops_ms=2.0 * hits * cin * cout / peak * 1e3)
        extra = ''
        if order is not None:
            rec['staged'] = conv_staged_row_taps(order, ta)
            extra += f"useful={hits / max(rec['staged'], 1):.3f} "
        extra += same_call_ratio(rec, fp32, i)
        out.append(rec)
        print(f"{label}[{i}] {cin}->{cout} K_in={rec['k_in']} "
              f"K_out={k_out} Ta={ta} hits={hits} "
              f"epilogue={sorted(k for k, v in kwargs.items() if v is not None and v is not False)} "
              f"max_abs_err={rec['err']:.3g} ({rec['rel']:.3g} of max "
              f"|ref|; |ref| max {rec['max_ref']:.3g} median "
              f"{median:.3g}) worst |err|/|sum| {rec['elem']:.3g} "
              f"(limit {TOL}) ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={max(rec['bytes_ms'], rec['ops_ms']):.4f} "
              f"{extra}[{card}]", flush=True)
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
        library_ms=None if None in lib else sum(lib), **packed_shares(recs))


def packed_shares(recs):
    """Of the packed kernels' records: hits over the row-taps or pairs
    they stage (``useful_share``) and their time over the fp32 kernel's on
    the same calls (``fp32_ratio``), where the records carry them."""
    out = {}
    if recs and all('staged' in r for r in recs):
        out['useful_share'] = sum(r['hits'] for r in recs) / max(
            sum(r['staged'] for r in recs), 1)
    if recs and all('fp32_ms' in r for r in recs):
        out['fp32_ratio'] = sum(r['ms'] for r in recs) / sum(
            r['fp32_ms'] for r in recs)
    return out


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
    """Inside the scope the plain sparse convs sum their taps, and each
    tap's input channels, in the reverse order, and the plain weight
    gradient its rows: the same sums in another fp32 order, a legitimate
    path whose spread from the plain path measures what the model itself
    makes of rounding."""

    def __enter__(self):
        import dataclasses
        from msmdfusion_torch.ops.sparse import matchconv as mc
        self._mc = mc
        self._orig = conv, dw, match = (mc.gather_gemm_conv_plain,
                                        mc.conv_dw_plain, mc.match_conv_plain)

        def flip_taps(plan):
            return dataclasses.replace(plan, inb=plan.inb.flip(1), **{
                k: getattr(plan, k).flip(-1) for k in ('dkey', 'queries')
                if getattr(plan, k) is not None})
        mc.gather_gemm_conv_plain = lambda feats, rows, weights, *a, **k: \
            conv(feats.flip(1), rows.flip(1), weights.flip(0).flip(1),
                 *a, **k)
        mc.conv_dw_plain = lambda feats, rows, g: \
            dw(feats, rows.flip(0), g.flip(0))
        mc.match_conv_plain = lambda feats, keys, plan, weights, *a, **k: \
            match(feats.flip(1), keys, flip_taps(plan),
                  weights.flip(0).flip(1), *a, **k)
        return self

    def __exit__(self, *exc):
        mc = self._mc
        mc.gather_gemm_conv_plain, mc.conv_dw_plain, mc.match_conv_plain = \
            self._orig
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
    union of the device events' spans (CUPTI's own buffer events and the
    device-side spans of annotated regions, such as ``Optimizer.step``,
    left out)."""
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
                or getattr(evt, 'is_user_annotation', False)
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


def check_launches(label, launches, expected):
    """Every kernel in ``expected`` launched that many times (never 0),
    every other kernel not at all."""
    for name, n in launches.items():
        check(n == expected.get(name, 0), f'{label}: {name} launched {n} '
              f'times, expected {expected.get(name, 0)}')


def drive(label, model, inputs, spec, card, reps, fp32=None):
    """Run the path described in the module docstring on one model
    (``fp32``: {kernel: the fp32 kernel's records of the same calls}).
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
    check(recorded == as_recorded(expected),
          f'{label}: recorded calls {recorded}, expected '
          f'{as_recorded(expected)}')
    recs = {}
    with torch.no_grad():
        if rec.calls['rows_affine']:
            recs['rows_affine'] = rows_calls(rec.calls['rows_affine'],
                                             reps['kernel'], card)
        for wrapper in ('gather_gemm_conv', 'match_conv'):
            if rec.calls[wrapper]:
                name = kernel_of(wrapper)
                recs[name] = conv_calls(
                    rec.calls[wrapper], spec['widths'], reps['kernel'] // 2,
                    card, fp32=(fp32 or {}).get(name))
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
    check_launches(label, launches, expected)
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
    host_ms = {k: round(v, 4) for k, v in tr.host_ms().items()}
    print(f'{label}: stage ms by the host clock {json.dumps(host_ms)} '
          f'[{card}]', flush=True)

    # the same forward on the plain versions (and with reordered sums),
    # decoding the kernel path's proposals: a near-tie at the top-k cut may
    # not swap one
    with torch.no_grad():
        index = proposal_index(preds)
        pins = PinnedRounding(on=spec.get('pin_rounding', False))
        run = pinned_forward(model, inputs, index, pins)
        ref = pinned_forward(model, inputs, index, kernels.plain_kernels(),
                             pins.replay())
        alt = pinned_forward(model, inputs, index, kernels.plain_kernels(),
                             ReorderedSums(), pins.replay())
        excess, differ = check_proposals(model.pts_bbox_head, index, ref)
        worst = compare_outputs(run, ref, alt)
        del run, ref, alt, pins
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


def fp32_outputs(model, inputs):
    """The fp32 path's own proposals and its head input, heatmap and boxes
    on them, for the packed path's comparison."""
    import torch
    with torch.no_grad():
        index = proposal_index(forward(model, inputs)[0])
        run = pinned_forward(model, inputs, index)
    return {k: run[k] for k in ('head_input', 'dense_heatmap', 'bboxes',
                                'scores')} | dict(index=index)


def packed_vs_fp32(model, inputs, fp32):
    """How far the packed path lies from the fp32 path on the fp32 path's
    proposals, and how many of its own proposals differ (printed, not
    held: bf16 keeps 8 bits)."""
    import torch
    with torch.no_grad():
        own = proposal_index(forward(model, inputs)[0])
        run = pinned_forward(model, inputs, fp32['index'])
    differ = int((~(own[:, :, None] == fp32['index'][:, None, :])
                  .any(-1)).sum())
    for key in ('head_input', 'dense_heatmap', 'bboxes', 'scores'):
        err, rel = rel_err(run[key], fp32[key])
        print(f'MSMDFusion packed bf16 vs fp32 path: {key} {err:.4g} '
              f'({rel:.4g} of max |fp32|) on the fp32 proposals', flush=True)
    print(f'MSMDFusion packed bf16 vs fp32 path: {differ} of '
          f'{own.numel()} own proposals differ', flush=True)


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


class HeadGrad:
    """Inside the scope keep the gradient that reaches the detection
    head's input (``grad``) and, with ``replace``, hand the backward
    ``replace`` in its place: the backward below the head then starts from
    the same gradient in two paths."""

    def __init__(self, head, replace=None):
        self.head, self.replace, self.grad = head, replace, None

    def __enter__(self):
        def keep(grad):
            self.grad = grad.detach().clone()
            return self.replace

        def pre(module, args):
            if args[0].requires_grad:
                args[0].register_hook(keep)
        self._handle = self.head.register_forward_pre_hook(pre)
        return self

    def __exit__(self, *exc):
        self._handle.remove()
        return False


class ReluMasks:
    """Inside the scope every ReLU called through ``torch.relu``,
    ``F.relu`` or ``nn.ReLU`` (all of those below the detection head)
    records its mask ``x > 0`` (``masks`` None) or, given another pass's
    ``masks``, applies them in call order. At full scale every layer has
    inputs within fp32 rounding of 0, and the gradient passes one side of
    such a ReLU and not the other: a second pass that takes the first
    one's masks makes the same decisions, so that the backward is a smooth
    function of the values the two paths compute."""

    def __init__(self, masks=None):
        self.replay = masks is not None
        self.masks = [] if masks is None else masks
        self.calls = 0

    def relu(self, x, inplace=False):
        import torch
        del inplace
        if self.replay:
            mask = self.masks[self.calls]
            check(mask.shape == x.shape, f'ReLU call {self.calls}: shape '
                  f'{tuple(x.shape)}, recorded {tuple(mask.shape)}')
            out = torch.where(mask, x, 0.0)
        else:
            self.masks.append(x > 0)
            out = self._orig[0](x)
        self.calls += 1
        return out

    def __enter__(self):
        import torch
        import torch.nn.functional as F
        self._orig = (torch.relu, F.relu, torch.nn.ReLU.forward)
        torch.relu = F.relu = self.relu
        torch.nn.ReLU.forward = lambda module, x: self.relu(x)
        return self

    def __exit__(self, *exc):
        import torch
        import torch.nn.functional as F
        torch.relu, F.relu, torch.nn.ReLU.forward = self._orig
        check(exc[0] is not None or not self.replay
              or self.calls == len(self.masks),
              f'{self.calls} ReLU calls, {len(self.masks)} masks recorded')
        return False


class PinnedRounding:
    """The packed bf16 engine's rounding decisions, pinned like the ReLU
    masks. Each of its convs rounds its input features (in the backward
    the gradient, and both operands of ``dw``) to bf16, so an fp32 sum one
    ulp apart in two paths (another order of the sums) can round to
    neighbouring bf16 values, 2^-8 apart, and a deep stack of such convs
    turns fp32 ulps into bf16 steps. Inside the scope (``on``), the
    kernel path's ``gather_gemm_conv`` and ``conv_dw`` calls keep their
    operands as rounded, in call order; inside ``replay()`` each plain
    ``gather_gemm_conv_plain``/``conv_dw_plain`` call takes those values
    wherever its own rounding lands within one bf16 step of them, so that
    both paths multiply the same bf16 operands and differ by fp32 sum
    order alone. Off (the fp32 and one-hot engines) both scopes do
    nothing."""

    def __init__(self, on=True, kept=None):
        self.on, self.replaying = on, kept is not None
        self.kept = [] if kept is None else kept
        self.calls = 0

    def replay(self):
        return PinnedRounding(self.on, self.kept)

    @staticmethod
    def _step(x):
        """One bf16 step (2^-8 of the binade) at |x|."""
        import torch
        return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)

    def _pin(self, x):
        import torch
        from msmdfusion_torch.ops.sparse import matchconv as mc
        kept = self.kept[self.calls].to(torch.float32)
        check(kept.shape == x.shape, f'pinned rounding call {self.calls}: '
              f'shape {tuple(x.shape)}, kept {tuple(kept.shape)}')
        self.calls += 1
        mine = mc.bf16_round(x)
        near = (mine - kept).abs() <= self._step(
            torch.maximum(mine.abs(), kept.abs()))
        return torch.where(near, kept, x)

    def _keep(self, x):
        import torch
        from msmdfusion_torch.ops.sparse import matchconv as mc
        self.kept.append(mc.bf16_round(x).to(torch.bfloat16))

    def __enter__(self):
        from msmdfusion_torch.ops.sparse import matchconv as mc
        self._mc = mc
        if not self.on:
            return self
        if self.replaying:
            names = ('gather_gemm_conv_plain', 'conv_dw_plain')
            conv, dw = self._orig = [getattr(mc, n) for n in names]
            mc.gather_gemm_conv_plain = lambda feats, *a, **k: \
                conv(self._pin(feats), *a, **k)
            mc.conv_dw_plain = lambda feats, rows, g: \
                dw(self._pin(feats), rows, self._pin(g))
        else:
            names = ('gather_gemm_conv', 'conv_dw')
            conv, dw = self._orig = [getattr(mc, n) for n in names]

            def kept_conv(feats, *a, **k):
                self._keep(feats)
                return conv(feats, *a, **k)

            def kept_dw(feats, rows, g, **k):
                self._keep(feats)
                self._keep(g)
                return dw(feats, rows, g, **k)
            mc.gather_gemm_conv, mc.conv_dw = kept_conv, kept_dw
        self._names = names
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        for name, orig in zip(self._names, self._orig):
            setattr(self._mc, name, orig)
        check(exc[0] is not None or not self.replaying
              or self.calls == len(self.kept),
              f'{self.calls} pinned rounding calls, {len(self.kept)} kept')
        return False


def train_pass(model, inputs, gt, rec=None, targets=None, index=None,
               head_grad=None, scopes=()):
    """One training-mode forward, loss and backward (no update), with the
    dropout masks of step 0. ``targets``/``index``/``head_grad``: another
    path's assignment, proposals and head-input gradient to reuse (ReLU
    masks come in ``scopes``). Returns dict(losses, targets, index,
    head_grad (this path's own), grads)."""
    import torch
    from msmdfusion_torch.apis.train import dropout_generator, total_loss
    head = model.pts_bbox_head
    with contextlib.ExitStack() as stack:
        for scope in scopes:
            stack.enter_context(scope)
        if index is not None:
            stack.enter_context(PinnedProposals(index))
        hg = stack.enter_context(HeadGrad(head, head_grad))
        model.zero_grad(set_to_none=True)
        preds = model(*inputs, generator=dropout_generator(
            inputs[0].device, SEED, 0))
        if targets is None:
            targets = head.get_targets(preds, *gt)
        losses = model.loss(preds, *gt, targets=targets)
        if rec is not None:
            rec.phase = 'backward'
        total_loss(losses).backward()
        if rec is not None:
            rec.phase = 'forward'
    torch.cuda.synchronize()
    return dict(losses={k: v.detach() for k, v in losses.items()},
                targets=targets, index=proposal_index(preds),
                head_grad=hg.grad,
                grads={n: p.grad.detach().clone()
                       for n, p in model.named_parameters()
                       if p.grad is not None})


def compare_train(run, ref, alt):
    """The kernel path's step ``run`` vs the plain path ``ref`` (same
    proposals, assignment, dropout masks and head-input gradient); ``alt``
    is the plain path with reordered sums. Up to the head's input, the
    dense-heatmap loss (computed before the decoder) and every parameter
    gradient below the head (whose backward starts from the same
    head-input gradient in both paths) are held to TOL of their largest
    value. The decoder amplifies rounding, so its losses, the head-input
    gradient before its replacement and the head's parameter gradients
    are held to FLOOR_MARGIN times the plain path's own spread, never less
    than TOL. Returns [(error over max |ref|, limit, spread, name)], worst
    first by error over limit."""
    rows = []

    def held(name, got, want, other):
        rel = rel_err(got, want)[1]
        floor = rel_err(other, want)[1]
        below_head = name == 'loss_heatmap' or (
            '.' in name and not name.startswith('pts_bbox_head.'))
        limit = TOL if below_head else max(TOL, FLOOR_MARGIN * floor)
        rows.append((rel, limit, floor, name))

    for key in run['losses']:
        if 'loss' in key:
            held(key, run['losses'][key], ref['losses'][key],
                 alt['losses'][key])
    held('head_input_grad', run['head_grad'], ref['head_grad'],
         alt['head_grad'])
    check(set(run['grads']) == set(ref['grads']),
          'the kernel and plain paths give gradients to different '
          'parameters')
    for name, want in ref['grads'].items():
        held(name, run['grads'][name], want, alt['grads'][name])
    rows.sort(key=lambda r: r[0] / r[1], reverse=True)
    return rows


def drive_train(model, inputs, gt, card, spec=TRAIN,
                label='MSMDFusion train', fp32=None):
    """Phase 5 (see the module docstring) on the calibrated flagship, with
    the launches, timed steps and checks of ``spec`` (phases 6 and 7 skip
    the twin or the extras: free ReLUs, cuDNN on and off, the profile).
    ``fp32``: {kernel: the fp32 kernel's records of the same calls}.
    Returns ({kernel: per-call records}, {kernel: launches of one step})."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.apis.train import (build_lr_schedule,
                                             build_optimizer,
                                             dropout_generator,
                                             make_train_step, total_loss)
    from msmdfusion_torch.models.layers import cudnn_enabled
    from msmdfusion_torch.utils import overflow
    head = model.pts_bbox_head
    frozen = TRAIN['frozen']
    schedule = build_lr_schedule(TRAIN['lr_config'],
                                 TRAIN['optimizer']['lr'],
                                 TRAIN['total_steps'],
                                 TRAIN['steps_per_epoch'])
    opt = build_optimizer(model, TRAIN['optimizer'],
                          TRAIN['optimizer_config'], schedule,
                          frozen_prefixes=frozen)
    model.train()
    check(head.training and not model.img_backbone.training,
          f'{label}: the frozen image branch must stay in eval mode')
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def restore_buffers():
        """Undo the norm-statistics updates of the checking passes."""
        with torch.no_grad():
            for name, b in model.named_buffers():
                b.copy_(start[name])

    # one step's kernel calls, each against its plain version
    relu = ReluMasks()
    pins = PinnedRounding(on=spec.get('pin_rounding', False))
    with Recorder() as rec:
        run = train_pass(model, inputs, gt, rec=rec, scopes=[relu, pins])
    restore_buffers()
    recorded = {k: (len(rec.calls_in(k, 'forward')),
                    len(rec.calls_in(k, 'backward'))) for k in rec.calls}
    print(f'{label}: recorded calls (forward, backward): {recorded}',
          flush=True)
    want = spec['launches']
    totals = {k: sum(v) for k, v in recorded.items() if sum(v)}
    check(totals == as_recorded(want) and recorded['rows_queries'][1] == 0
          and recorded['conv_dw'][0] == 0,
          f'{label}: recorded calls {recorded}, expected '
          f'{as_recorded(want)} (rows_queries in the forward, conv_dw in '
          'the backward)')
    check(not any(n.startswith(frozen) for n in run['grads']),
          f'{label}: a frozen image parameter got a gradient')
    recs = {}
    with torch.no_grad():
        if rec.calls['rows_queries']:
            recs['rows_queries'] = rows_queries_calls(
                rec.calls['rows_queries'], 10, card)
        if rec.calls_in('rows_affine', 'backward'):
            recs['rows_affine_bwd'] = rows_calls(
                rec.calls_in('rows_affine', 'backward'), 5, card)
        fp32 = fp32 or {}
        recs[kernel_of('conv_dw')] = dw_calls(
            rec.calls['conv_dw'], 5, card, fp32=fp32.get(kernel_of('conv_dw')))
        # the backward's convs (d_feats); the one-hot forward's too
        for wrapper, phase in (('gather_gemm_conv', 'backward'),
                               ('match_conv', 'forward'),
                               ('match_conv', 'backward')):
            calls = rec.calls_in(wrapper, phase)
            if calls:
                name = kernel_of(wrapper) + ('_bwd' if phase == 'backward'
                                             else '_fwd')
                recs[name] = conv_calls(calls, set(), 5, card, label=name,
                                        fp32=fp32.get(name))
    del rec
    for name, rs in recs.items():
        extra = ''.join(f'{k}={v:.3f} ' for k, v in packed_shares(rs).items())
        print(f'{label}: {name} sums over one step: '
              f'{len(rs)} calls, ms={sum(r["ms"] for r in rs):.3f} '
              f'plain_ms={sum(r["plain_ms"] for r in rs):.3f} bound_ms='
              f'{sum(max(r["bytes_ms"], r["ops_ms"]) for r in rs):.3f} '
              f'{extra}[{card}]', flush=True)

    if spec['twin']:
        # the same step on the plain versions (and with reordered sums), on
        # the kernel path's proposals, assignment, dropout masks, head-input
        # gradient and ReLU masks
        pinned = dict(targets=run['targets'], index=run['index'],
                      head_grad=run['head_grad'])
        ref = train_pass(model, inputs, gt, scopes=[
            kernels.plain_kernels(), ReluMasks(relu.masks), pins.replay()],
            **pinned)
        restore_buffers()
        alt = train_pass(model, inputs, gt, scopes=[
            kernels.plain_kernels(), ReorderedSums(), ReluMasks(relu.masks),
            pins.replay()], **pinned)
        restore_buffers()
        if spec['extras']:
            # what the masks are for: the kernel path once more with its
            # ReLUs free (not asserted)
            free = train_pass(model, inputs, gt, **pinned)
            restore_buffers()
            spread = sorted(((rel_err(free['grads'][n], g)[1], n)
                             for n, g in run['grads'].items()
                             if not n.startswith('pts_bbox_head.')),
                            reverse=True)
            print(f'{label}: the kernel path against itself with free '
                  f'ReLUs: {sum(s <= TOL for s, _ in spread)} of '
                  f'{len(spread)} parameter gradients below the head within '
                  f'{TOL}, worst {spread[0][0]:.3g} of max |ref| '
                  f'({spread[0][1]})', flush=True)
            del free
        rows = compare_train(run, ref, alt)
        losses = {k: round(float(v), 6) for k, v in run['losses'].items()}
        print(f'{label}: losses {json.dumps(losses)}', flush=True)
        for rel, limit, floor, name in rows[:8]:
            print(f'{label}: kernel vs plain path: {name} {rel:.3g} of max '
                  f'|ref| (limit {limit:.3g}; reordered plain path '
                  f'{floor:.3g})', flush=True)
        for group, keep in (
                ('losses and head-input gradient',
                 lambda n: 'loss' in n or n == 'head_input_grad'),
                ('parameter gradients of the head',
                 lambda n: n.startswith('pts_bbox_head.')),
                ('parameter gradients below the head',
                 lambda n: '.' in n and not n.startswith('pts_bbox_head.'))):
            sel = [r for r in rows if keep(r[3])]
            worst = max(r[0] for r in sel)
            over_spread = max(r[0] / max(r[2], 1e-30) for r in sel)
            print(f'{label}: {len(sel)} {group}: worst {worst:.3g} of max '
                  f'|ref|, {sum(r[0] <= TOL for r in sel)} within {TOL}; '
                  f'worst over the reordered spread {over_spread:.3g}',
                  flush=True)
        bad = [r for r in rows if r[0] > r[1]]
        check(not bad, f'{label}: kernel vs plain path above the limit: '
              f'{bad[:5]}')
        del ref, alt
    del run, relu, pins

    # the main path: one step through make_train_step, counted
    restore_buffers()
    batch = dict(inputs=inputs, gt_bboxes=gt[0], gt_labels=gt[1],
                 gt_valid=gt[2])
    train_step = make_train_step(model, opt, seed=SEED)
    trainable = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
    kernels.reset_launches()
    with overflow.capture() as cap:
        metrics = train_step(batch, 0)
    launches = dict(kernels.launches)
    torch.cuda.synchronize()
    print(f'{label}: launches of one step: {launches}', flush=True)
    check_launches(label, launches, want)
    check(cap.total() == 0, f'{label}: overflow {cap.counters()}')
    check(bool(torch.isfinite(metrics['total_loss'])),
          f'{label}: non-finite loss')
    print(f'{label}: overflow_total 0; step 0 total_loss '
          f'{float(metrics["total_loss"]):.6f} grad_norm '
          f'{float(metrics["grad_norm"]):.6f} lr {schedule(0):.3g}',
          flush=True)

    # AdamW steps, timed: forward (with the assignment), backward,
    # optimizer, by CUDA events; the first is a warm-up
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    split, host, auction = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(1, spec['steps'] + 2):
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[0].record()
        preds = model(*inputs, generator=dropout_generator(
            inputs[0].device, SEED, step))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        targets = head.get_targets(preds, *gt)
        torch.cuda.synchronize()
        auction.append((time.perf_counter() - t1) * 1e3)
        losses = model.loss(preds, *gt, targets=targets)
        total = total_loss(losses)
        events[1].record()
        total.backward()
        events[2].record()
        opt.step()
        events[3].record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        split.append([events[i].elapsed_time(events[i + 1])
                      for i in range(3)])
        check(bool(torch.isfinite(total)), f'{label}: step {step} loss '
              'is not finite')
        print(f'{label}: step {step} total_loss '
              f'{float(total.detach()):.6f}', flush=True)
        del preds, losses, total
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd, bwd, upd = (sum(s[i] for s in split[1:]) / spec['steps']
                     for i in range(3))
    print(f'{label}: step {fwd + bwd + upd:.3f} ms = forward {fwd:.3f} '
          f'(the assignment {sum(auction[1:]) / spec["steps"]:.3f} of '
          f'it, host clock) + backward {bwd:.3f} + optimizer {upd:.3f} '
          f'(CUDA events, mean of {spec["steps"]} steps after a warm-up); '
          f'host clock {sum(host[1:]) / spec["steps"]:.3f} ms/step; peak '
          f'memory {peak_gb:.2f} GiB [{card}]', flush=True)

    moved = sum(not torch.equal(p, start[n]) for n, p in trainable)
    check(moved >= 0.9 * len(trainable),
          f'{label}: only {moved} of {len(trainable)} parameters moved')
    state = model.state_dict()
    still = all(torch.equal(state[k], v) for k, v in start.items()
                if k.startswith(frozen))
    check(still, f'{label}: the frozen image branch changed')
    check(all(p.grad is None for n, p in model.named_parameters()
              if n.startswith(frozen)),
          f'{label}: a frozen image parameter has a gradient')
    print(f'{label}: {moved} of {len(trainable)} trainable tensors moved; '
          'the frozen image branch (weights and norm statistics) '
          'unchanged', flush=True)

    if spec['extras']:
        # the backward's dense convolutions on and off cuDNN (one step each)
        for on in (True, False, True):
            opt.zero_grad(set_to_none=True)
            preds = model(*inputs, generator=dropout_generator(
                inputs[0].device, SEED, 0))
            total = total_loss(model.loss(preds, *gt))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with cudnn_enabled(on):
                total.backward()
                torch.cuda.synchronize()
            print(f'{label}: backward with cuDNN {"on" if on else "off"} '
                  f'{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock) '
                  f'[{card}]', flush=True)
            del preds, total

        def one_step():
            train_step(batch, spec['steps'] + 2)
        window_ms, busy_ms, ranked = profile_forward(one_step)
        check(busy_ms > 0, f'{label}: the profiler saw no device work')
        print(f'{label}: profile: one step {window_ms:.3f} ms host window, '
              f'device busy {busy_ms:.3f} ms, idle share '
              f'{1 - busy_ms / window_ms:.3f} [{card}]', flush=True)
        for ms, name in ranked:
            print(f'{label}: profile: {ms:9.3f} ms  {name[:100]}', flush=True)
    return recs, launches


def flagship_phases(model, inputs, gt, card, specs=(FLAGSHIP, PACKED,
                                                      ONEHOT)):
    """Phases 4-7 on the calibrated flagship (``specs``: the fp32, packed
    and one-hot inference specs). Returns [(records, launches)] of the
    seven drives in order."""
    fp32_spec, packed, onehot = specs
    calibrated = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
    phases = [drive('MSMDFusion', model, inputs, fp32_spec, card,
                    reps=dict(kernel=10, frame=10))]
    fp32 = fp32_outputs(model, inputs)
    dense_engines(model, inputs, card)

    # 5. the MSMDFusion train step
    phases.append(drive_train(model, inputs, gt, card))
    # the fp32 kernels' records of the calls the packed ones make again
    same_calls = dict(
        inference={'gather_gemm_conv_bf16': phases[0][0]['gather_gemm_conv']},
        train={'conv_dw_bf16': phases[1][0]['conv_dw'],
               'gather_gemm_conv_bf16_bwd':
                   phases[1][0]['gather_gemm_conv_bwd']})

    # 6. the packed bf16 engine, 7. the one-hot engine: the calibrated
    # model again, the switch set around the phase only
    for name, spec in (('packed bf16', packed), ('one-hot', onehot)):
        model.load_state_dict(calibrated)
        model.eval()
        with switches(spec['env']):
            print(f'MSMDFusion {name}: {spec["env"]}', flush=True)
            ratios = same_calls if spec is packed else {}
            phases.append(drive(f'MSMDFusion {name}', model, inputs, spec,
                                card, reps=dict(kernel=4, frame=5),
                                fp32=ratios.get('inference')))
            if spec is packed:
                packed_vs_fp32(model, inputs, fp32)
            phases.append(drive_train(model, inputs, gt, card, spec['train'],
                                      label=f'MSMDFusion {name} train',
                                      fp32=ratios.get('train')))
    model.load_state_dict(calibrated)
    model.eval()
    engines_interleaved(model, inputs, card, (
        ('fp32', {}), ('packed bf16', packed['env']),
        ('one-hot', onehot['env'])))
    return phases


def engines_interleaved(model, inputs, card, engines, rounds=6):
    """The conv engines' frames interleaved, one frame of each (name, env)
    per round after a warm-up round, so that the host's drift over the
    call falls on all of them alike (the frame is host-bound): per engine
    the median, least and most ms of the frame (CUDA events around the
    forward, its sections recording) and of its stage ``plans`` by CUDA
    events and by the host's clock, and the medians' ratio to the first
    engine's. Before the rounds, one forward of each engine counts the
    host's synchronisations with the device (PyTorch's sync debug mode)
    and prints the sites that made most of them."""
    import collections
    import statistics
    import warnings
    import torch
    from msmdfusion_torch.utils import timing
    with torch.no_grad():
        for name, env in engines:
            with switches(env), warnings.catch_warnings(record=True) as got:
                warnings.simplefilter('always')
                torch.cuda.set_sync_debug_mode('warn')
                try:
                    forward(model, inputs)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            sites = collections.Counter(
                f'{w.filename.rsplit("/", 2)[-1]}:{w.lineno}' for w in got
                if 'synchroniz' in str(w.message))
            print(f'MSMDFusion engines interleaved: {name} synchronises '
                  f'{sum(sites.values())} times a frame; most at '
                  f'{sites.most_common(6)} [{card}]', flush=True)
    frames = {name: [] for name, _ in engines}
    plans = {name: [] for name, _ in engines}
    plans_host = {name: [] for name, _ in engines}
    with torch.no_grad():
        for r in range(rounds + 1):
            for name, env in engines:
                with switches(env):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    with timing.record('cuda') as tr:
                        start.record()
                        forward(model, inputs)
                        end.record()
                    stages = tr.ms()
                if r:
                    frames[name].append(start.elapsed_time(end))
                    plans[name].append(stages.get('plans', 0.0))
                    plans_host[name].append(tr.host_ms().get('plans', 0.0))
    base = statistics.median(frames[engines[0][0]])
    for name, _ in engines:
        f, p, h = frames[name], plans[name], plans_host[name]
        print(f'MSMDFusion engines interleaved, {rounds} frames each: {name} '
              f'{statistics.median(f):.3f} ms/frame median (min {min(f):.3f}, '
              f'max {max(f):.3f}; {statistics.median(f) / base:.3f} of '
              f'{engines[0][0]}), stage plans {statistics.median(p):.3f} ms '
              f'median (min {min(p):.3f}, max {max(p):.3f}), host clock '
              f'{statistics.median(h):.3f} median (min {min(h):.3f}, max '
              f'{max(h):.3f}) [{card}]', flush=True)


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
    print(f'build: {len(built)} sources of {len(KERNEL_INFO)} kernels in '
          f'{build_s:.1f} s (parallel nvcc)',
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
    inputs, gt = make_scene(model, FLAGSHIP['shape'], dev)
    calibrate_norms(model, *inputs)
    print(f'MSMDFusion setup: model + realistic scene + norms in '
          f'{time.perf_counter() - t0:.1f} s; foreground points '
          f'{int(inputs[3]["fg_mask"].sum())}, real pixels '
          f'{int(inputs[3]["fg_real_mask"].sum())}', flush=True)
    phases = flagship_phases(model, inputs, gt, card)

    # each kernel's records and launches from the first phase that ran it
    picked = {}
    for recs, launches in phases:
        for name in recs:
            if name in KERNEL_INFO and name not in picked:
                picked[name] = (recs[name], launches)
    check(set(picked) == set(KERNEL_INFO),
          f'kernels never checked: {sorted(set(KERNEL_INFO) - set(picked))}')
    summary = [kernel_summary(name, *picked[name]) for name in KERNEL_INFO]
    print(json.dumps({'kernels': summary}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
