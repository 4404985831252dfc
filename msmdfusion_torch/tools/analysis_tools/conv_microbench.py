"""The sparse-conv engine's ops alone, at the flagship's stage shapes.

Counterpart of the JAX package's ``tools/analysis_tools/conv_microbench.py``
with its coordinate sets and ``CONFIGS``: the realistic scene
(``utils/synth_scene.realistic_batch``, seed 0) voxelized at the
flagship's grid into at most 160,000 voxels, then three strided stages
capped at 76,000, 26,500 and 23,500 rows. Per config (stage, Cin, Cout,
feature and weight values from ``np.random.RandomState(0)`` in the JAX
tool's order) it times:

- ``plan``: ``build_subm_plan``; ``rows``: ``plan_rows`` (kernel 1,
  ``rows_affine``); ``attach``: ``attach_rows`` with the row order the
  tensor-core convs read (``needs_order()``);
- ``conv``: ``gather_gemm_conv`` (kernel 2 as the switches pick it:
  ``gather_gemm_conv_x3`` by default, ``gather_gemm_conv_bf16`` under
  ``MSMD_CONV_DTYPE=bfloat16``, the exact ``gather_gemm_conv`` under
  ``MSMD_CONV_GEMM=highest``); ``onehot``: ``match_conv`` (kernel 3,
  ``match_kernel()``);
- ``coords``: ``downsample_out_coords`` of stages 0-2; ``glue``:
  ``make_sparse_tensor`` of a union-like 80-channel set of 192,000 rows
  (stage 0's and its first 32,000 again) into 160,000.

The JAX tool repeats each op inside one jitted loop whose salt defeats
XLA's common-subexpression elimination; here each op's calls run back to
back, each bracketed by its own pair of CUDA events (the host clock on the
CPU), and the line gives the minimum and the median of ``REPS`` calls in
ms. Each conv's bound follows ``PERF.md`` section 6: the larger of its
bytes (features, weights and output once, its rows or its plan's keys
and queries) over the HBM rate and of 2 x hits x Cin x Cout over the fp32
rate (exact kernels) or, times the tensor-core passes (x3: 3, packed: 1),
over the dense bf16 rate (H100 SXM data sheet).

    python -m msmdfusion_torch.tools.analysis_tools.conv_microbench \\
        [--ops rows,conv,onehot,coords,glue] [--configs enc1_c16,...] \\
        [--device cuda]
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import add_device, device_of

# H100 SXM data sheet, 700 W: HBM3 bytes/s, fp32 FFMA and dense bf16
# tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
# bf16 tensor-core products a kernel's FLOP take; the others run fp32 FFMA
TENSOR_PASSES = {'gather_gemm_conv_bf16': 1, 'gather_gemm_conv_x3': 3,
                 'match_conv_x3': 3, 'match_conv_bf16': 2}

SHAPE = dict(n=250000, v=6, m=20000, mr=15000, img_hw=(448, 800),
             pcr=[-54.0, -54.0, -5.0, 54.0, 54.0, 3.0])
VOXEL_SIZE = [0.075, 0.075, 0.2]
GRID = (41, 1440, 1440)
MAX_VOXELS = 160000
REPS = 10           # timed calls of each op
CAPS = {1: 76000, 2: 26500, 3: 23500}
CONFIGS = [
    # (name, stage, cin, cout)  -- the flagship's conv population
    ('enc1_c16', 0, 16, 16),
    ('enc2_c32', 1, 32, 32),
    ('enc3_c64', 2, 64, 64),
    ('enc4_c128', 3, 128, 128),
    ('agg0_c80', 0, 80, 80),
    ('agg1_c96', 1, 96, 96),
    ('agg2_c128', 2, 128, 128),
    ('agg3_c192', 3, 192, 192),
]


def call_ms(fn, reps: int, device) -> tuple:
    """(min, median) ms of ``reps`` back-to-back calls of ``fn`` after one
    warm-up call: CUDA events around each call on the card, the host clock
    on the CPU."""
    fn()
    if device.type != 'cuda':
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times), statistics.median(times)
    torch.cuda.synchronize(device)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize(device)
    times = [start.elapsed_time(end) for start, end in events]
    return min(times), statistics.median(times)


def bound_ms(kernel: str, nbytes: int, hits: int, cin: int,
             cout: int) -> float:
    """The least time of conv kernel ``kernel`` on a call: its bytes over
    the HBM rate, or its FLOP over its product's rate, the larger."""
    flop = 2.0 * hits * cin * cout
    ops = (TENSOR_PASSES[kernel] * flop / PEAK_BF16 if kernel in
           TENSOR_PASSES else flop / PEAK_FP32)
    return max(nbytes / PEAK_BYTES, ops) * 1e3


def stage_sets(device, shape=SHAPE, max_voxels=MAX_VOXELS,
               caps=CAPS) -> Dict[int, object]:
    """{stage: SparseTensor}: the realistic scene voxelized (stage 0) and
    the flagship's three strided output sets."""
    from ...ops.sparse.conv import downsample_out_coords
    from ...ops.sparse.tensor import make_sparse_tensor
    from ...ops.voxelize import voxelize_mean_batch
    from ...utils.synth_scene import realistic_batch
    batch = realistic_batch(shape, b=1, seed=0)
    feats, coors, valid = voxelize_mean_batch(
        torch.from_numpy(batch['points']).to(device),
        torch.from_numpy(batch['points_mask']).to(device), VOXEL_SIZE,
        shape['pcr'], max_voxels)
    st = make_sparse_tensor(feats, coors, valid, GRID, 1,
                            assume_sorted=True)
    sets = {0: st}
    for i in (1, 2, 3):
        ks = (3, 1, 1) if i == 3 else 3
        sd = (2, 1, 1) if i == 3 else 2
        pd = (0, 1, 1) if i == 2 else (0 if i == 3 else 1)
        out_keys, out_coords, out_valid, out_shape = downsample_out_coords(
            st, ks, sd, pd, caps[i])
        nf = torch.zeros((out_keys.shape[0], 1), device=device)
        st = make_sparse_tensor(nf, out_coords, out_valid, out_shape, 1,
                                assume_sorted=True)
        sets[i] = st
    return sets


def conv_line(name, st, cin, cout, rng, ops, reps, device) -> Dict:
    """One config's ops (see the module docstring); returns its record."""
    from ...ops.sparse import matchconv as mc
    k = st.capacity
    feats = torch.from_numpy(rng.randn(k, cin).astype(np.float32)).to(device)
    feats = torch.where(st.valid[:, None], feats, 0.0)
    w = torch.from_numpy(
        (rng.randn(27, cin, cout) * 0.05).astype(np.float32)).to(device)
    rec = dict(name=name, k=k, cin=cin, cout=cout)
    rec['plan'] = call_ms(lambda: mc.build_subm_plan(st, 3), reps, device)
    plan = mc.build_subm_plan(st, 3)
    line = f'{name:12s} K={k:7d} plan={rec["plan"][0]:6.2f}'
    if 'rows' in ops:
        rec['rows'] = call_ms(lambda: mc.plan_rows(st.keys, plan), reps,
                              device)
        rec['attach'] = call_ms(lambda: mc.attach_rows(
            st.keys, plan, order=mc.needs_order()), reps, device)
        line += f' rows={rec["rows"][0]:6.2f} attach={rec["attach"][0]:6.2f}'
    planr = mc.attach_rows(st.keys, plan, order=mc.needs_order())
    rec['hits'] = hits = int((planr.rows >= 0).sum())
    out_bytes = 4 * (feats.numel() + w.numel() + k * cout)
    if 'conv' in ops:
        kernel = ('gather_gemm_conv_bf16' if mc.packed() else
                  'gather_gemm_conv_x3' if mc.x3() else 'gather_gemm_conv')
        rec['conv'] = call_ms(lambda: mc.gather_gemm_conv(
            feats, planr.rows, w, order=planr.order), reps, device)
        rec['conv_kernel'] = kernel
        rec['conv_bound'] = bound_ms(kernel, out_bytes + 4 * planr.rows
                                     .numel(), hits, cin, cout)
        line += (f' {kernel}={rec["conv"][0]:7.3f}/{rec["conv"][1]:7.3f}'
                 f' bound={rec["conv_bound"]:6.3f}')
    if 'onehot' in ops:
        kernel = mc.match_kernel()
        rec['onehot'] = call_ms(lambda: mc.match_conv(feats, st.keys, plan,
                                                      w), reps, device)
        plan_bytes = 4 * st.keys.numel() + plan.inb.numel() + 4 * (
            plan.okeys.numel() + plan.dkey.numel())
        rec['onehot_kernel'] = kernel
        rec['onehot_bound'] = bound_ms(kernel, out_bytes + plan_bytes, hits,
                                       cin, cout)
        line += (f' {kernel}={rec["onehot"][0]:7.3f}/'
                 f'{rec["onehot"][1]:7.3f} bound={rec["onehot_bound"]:6.3f}')
    print(line, flush=True)
    return rec


def run(ops, configs=None, reps: int = REPS, device=torch.device('cuda'),
        sets=None) -> Dict:
    """The microbench's lines; returns dict(stages: {stage: (capacity,
    occupied)}, convs: [conv_line records], coords: {stage: ms}, glue)."""
    from ...ops.sparse.conv import downsample_out_coords
    from ...ops.sparse.tensor import make_sparse_tensor
    sets = sets if sets is not None else stage_sets(device)
    out = dict(stages={}, convs=[], coords={})
    for i, st in sets.items():
        occ = int(st.valid.sum())
        out['stages'][i] = (st.capacity, occ)
        print(f'stage {i}: capacity={st.capacity} occ={occ}', flush=True)
    rng = np.random.RandomState(0)
    for name, stage, cin, cout in CONFIGS:
        if configs and name not in configs:
            continue
        out['convs'].append(conv_line(name, sets[stage], cin, cout, rng,
                                      ops, reps, device))
    if 'coords' in ops:
        for i in (0, 1, 2):
            st = sets[i]
            ms = call_ms(lambda: downsample_out_coords(st, 3, 2, 1,
                                                       st.capacity),
                         reps, device)
            out['coords'][i] = ms
            print(f'downsample_out_coords stage{i} K={st.capacity}: '
                  f'{ms[0]:6.2f} ms', flush=True)
    if 'glue' in ops:
        st = sets[0]
        k, extra = st.capacity, min(32000, st.capacity)
        f80 = torch.from_numpy(
            rng.randn(k + extra, 80).astype(np.float32)).to(device)
        c2 = torch.cat([st.coords, st.coords[:extra]])
        v2 = torch.cat([st.valid, st.valid[:extra]])
        ms = call_ms(lambda: make_sparse_tensor(
            f80, c2, v2, st.spatial_shape, 1, capacity=k), reps, device)
        out['glue'] = ms
        print(f'make_sparse_tensor union-like ({k + extra} rows, 80ch -> '
              f'{k}): {ms[0]:6.2f} ms', flush=True)
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument('--ops', default='rows,conv,onehot,coords,glue')
    ap.add_argument('--configs', default=None,
                    help='comma list of config names (default all)')
    add_device(ap, 'the coordinate sets and the ops')
    args = ap.parse_args(argv)
    device = device_of(args)
    from .. import full_fp32
    full_fp32()
    configs = set(args.configs.split(',')) if args.configs else None
    return run(set(args.ops.split(',')), configs, device=device)


if __name__ == '__main__':
    main()
