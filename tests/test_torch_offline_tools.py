"""The port's offline tools against the JAX package's, on the CPU.

- ``tools.misc.print_config``: the same text as the JAX tool for every
  file under ``configs/``, with and without ``--cfg-options``.
- ``core.visualizer``: ``show_result``'s OBJ and HTML files byte-equal to
  the JAX package's, its PNG equal pixel for pixel (decoded: the files'
  metadata differ), and without matplotlib the OBJ and HTML files alone;
  ``core.box_np_ops.corners_3d_np`` equal to JAX's.
- On the tiny TransFusion-L dataset of ``tests/test_train_cli.py``, after
  two steps of the port's train CLI and its eval CLI's ``--out``:
  ``analyze_logs`` prints the JAX tool's summary of the port's logs;
  ``publish_model`` writes ``<out>-<sha256[:8]>`` of the written file,
  without the optimizer, loadable by ``load_checkpoint``;
  ``visualize_results`` and ``Custom3DDataset.show`` write what the JAX
  tool and dataset write from the same pickle; ``fuse_conv_bn``'s fused
  checkpoint gives the unfused model's outputs; the speed CLI runs the
  config and refuses the flagship's, as the JAX tool cannot run it.
- ``trace_summary``'s sums on a small synthetic Chrome trace, and on a
  real CPU trace of ``utils.profiling.trace`` its top-level scope.
- ``conv_microbench`` on a small scene; ``profiling.time_fn``.
- The SLURM scripts' ``srun`` command and each task's environment and
  command, with stub ``srun``, ``scontrol`` and interpreter on ``PATH``.
- Every tool stops without a card unless given ``--device cpu``.
"""
import contextlib
import hashlib
import importlib.util
import io
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from msmdfusion_tpu.core import box_np_ops as jax_box_np_ops
from msmdfusion_tpu.core import visualizer as jax_visualizer
import msmdfusion_tpu.datasets  # noqa: F401  (registers the JAX datasets)

from msmdfusion_torch.apis.inference import init_detector
from msmdfusion_torch.config import load_config
from msmdfusion_torch.core import box_np_ops, visualizer
from msmdfusion_torch.registry import DATASETS
from msmdfusion_torch.tools import test as test_cli
from msmdfusion_torch.tools import train as train_cli
from msmdfusion_torch.tools.analysis_tools import (analyze_logs, benchmark,
                                                   conv_microbench,
                                                   trace_summary)
from msmdfusion_torch.tools.misc import (fuse_conv_bn, print_config,
                                         visualize_results)
from msmdfusion_torch.tools.model_converters import publish_model
from msmdfusion_torch.utils import profiling
from msmdfusion_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_bf16_train import one_thread  # noqa: F401
from tests.test_train_cli import CONFIG_TEMPLATE

REPO = Path(__file__).resolve().parents[1]
CPU = ['--device', 'cpu']
CONFIGS = sorted(str(p.relative_to(REPO))
                 for p in (REPO / 'configs').rglob('*.py'))
OVERRIDES = ['total_epochs=3', 'data.workers_per_gpu=0',
             'model.extra.values=1,2.5,none', 'optimizer.lr=0.5']


def jax_tool(rel):
    """The JAX package's tool script ``tools/<rel>`` as a module."""
    spec = importlib.util.spec_from_file_location(
        'jax_' + rel.replace('/', '_')[:-3], REPO / 'tools' / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_main(monkeypatch, rel, argv):
    """stdout of the JAX tool's ``main()`` on ``argv``."""
    module = jax_tool(rel)
    monkeypatch.setattr(sys, 'argv', [rel] + list(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main()
    return out.getvalue()


def port_main(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(list(argv))
    return out.getvalue(), result


@pytest.mark.parametrize('options', [False, True])
@pytest.mark.parametrize('config', CONFIGS)
def test_print_config_matches_jax(monkeypatch, config, options):
    argv = [config] + (['--cfg-options', *OVERRIDES] if options else [])
    want = jax_main(monkeypatch, 'misc/print_config.py', argv)
    got, cfg = port_main(print_config.main, argv + CPU)
    assert got == want and got.startswith('{')
    if options:
        assert cfg.model.extra['values'] == [1, 2.5, None]


def scene(rng, n_det=5, n_gt=3):
    points = rng.uniform(-50, 50, (3000, 3)).astype(np.float32)
    points[:, 2] = rng.uniform(-3, 2, 3000)

    def boxes(n):
        b = np.concatenate([rng.uniform(-40, 40, (n, 2)),
                            rng.uniform(-2, 0, (n, 1)),
                            rng.uniform(0.5, 5, (n, 3)),
                            rng.uniform(-np.pi, np.pi, (n, 1)),
                            rng.uniform(-1, 1, (n, 2))], 1)
        return b.astype(np.float32)
    return points, boxes(n_det), boxes(n_gt)


def test_corners_3d_np_matches_jax():
    _, det, _ = scene(np.random.RandomState(3))
    for boxes in (det[:, :7], det[:, :7].astype(np.float64)):
        got = box_np_ops.corners_3d_np(boxes)
        want = jax_box_np_ops.corners_3d_np(boxes)
        assert got.dtype == want.dtype and got.shape == (5, 8, 3)
        np.testing.assert_array_equal(got, want)


def png_pixels(path):
    import matplotlib.image
    return matplotlib.image.imread(path)


def assert_same_outputs(got_files, want_files):
    """Equal file names; OBJ and HTML byte-equal, PNG pixel-equal."""
    assert [Path(f).name for f in got_files] == \
        [Path(f).name for f in want_files]
    for got, want in zip(got_files, want_files):
        if got.endswith('.png'):
            np.testing.assert_array_equal(png_pixels(got), png_pixels(want))
        else:
            assert Path(got).read_bytes() == Path(want).read_bytes(), got


def test_visualizer_matches_jax(tmp_path):
    points, det, gt = scene(np.random.RandomState(0))
    got = visualizer.show_result(points, gt, det, str(tmp_path / 'port'),
                                 'frame')
    want = jax_visualizer.show_result(points, gt, det, str(tmp_path / 'jax'),
                                      'frame')
    assert len(got) == 4 and all(os.path.getsize(f) for f in got)
    assert_same_outputs(got, want)
    # no points, no ground truth
    got = visualizer.show_result(None, None, det[:1], str(tmp_path / 'p2'),
                                 'empty')
    want = jax_visualizer.show_result(None, None, det[:1],
                                      str(tmp_path / 'j2'), 'empty')
    assert_same_outputs(got, want)


def test_visualizer_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is not installed (the card's machine) the OBJ and
    HTML files are written alone, with a warning."""
    points, det, gt = scene(np.random.RandomState(0))
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, 'find_spec', lambda name, *a: (
        None if name == 'matplotlib' else find_spec(name, *a)))
    with pytest.warns(UserWarning, match='matplotlib is not installed'):
        got = visualizer.show_result(points, gt, det, str(tmp_path),
                                     'frame')
    assert [Path(f).name for f in got] == [
        'frame_pred.obj', 'frame_gt.obj', 'frame_viewer.html']


def write_dataset(root, rng):
    """``tests/test_train_cli.py``'s synthetic dataset (six 300-point
    samples, 1-4 boxes each) with its config, a test set added."""
    infos = []
    for i in range(6):
        pts = np.concatenate([
            rng.uniform(-4.5, 4.5, (300, 2)),
            rng.uniform(-3.5, 3.5, (300, 1)),
            rng.uniform(0, 1, (300, 2))], axis=1).astype(np.float32)
        pts.tofile(str(root / f'sample_{i}.bin'))
        n_gt = rng.randint(1, 5)
        boxes = np.zeros((n_gt, 7), np.float32)
        boxes[:, :2] = rng.uniform(-4, 4, (n_gt, 2))
        boxes[:, 2] = -1
        boxes[:, 3:6] = rng.uniform(0.5, 2.0, (n_gt, 3))
        names = rng.choice(['car', 'pedestrian', 'truck'], n_gt)
        infos.append(dict(token=f't{i}', lidar_path=str(root / f'sample_{i}'
                                                        '.bin'),
                          timestamp=i, sweeps=[], gt_boxes=boxes,
                          gt_names=names,
                          gt_velocity=np.zeros((n_gt, 2), np.float32)))
    with open(root / 'infos.pkl', 'wb') as f:
        pickle.dump(dict(infos=infos, metadata={}), f)
    path = root / 'cfg.py'
    path.write_text(CONFIG_TEMPLATE.format(root=str(root))
                    + "\ndata['test'] = dict(data['val'])\n")
    return str(path)


@pytest.fixture(scope='module')
def trained(tmp_path_factory, one_thread):  # noqa: F811
    """The tiny TransFusion-L dataset, two train-CLI steps logged at every
    step (``ckpt_2``, ``train.log``, ``*.log.json``) and the eval CLI's
    ``--out`` pickle, in a working directory of its own."""
    root = tmp_path_factory.mktemp('tools')
    path = write_dataset(root, np.random.RandomState(0))
    with contextlib.chdir(root):
        work = str(root / 'work')
        run = train_cli.main([path, '--work-dir', work, *CPU, '--max-steps',
                              '2', '--no-validate', '--cfg-options',
                              'data.workers_per_gpu=0'])
        out = str(root / 'results.pkl')
        test_cli.main([path, '--out', out, *CPU, '--cfg-options',
                       'data.workers_per_gpu=0'])
    return dict(root=root, config=path, work=work, ckpt=run['checkpoint'],
                out=out)


def test_analyze_logs_matches_jax(trained, monkeypatch):
    work = trained['work']
    logs = [os.path.join(work, 'train.log')] + sorted(
        str(p) for p in Path(work).glob('*.log.json'))
    assert len(logs) == 2
    argv = logs + ['--keys', 'total_loss', 'grad_norm', 'lr']
    want = jax_main(monkeypatch, 'analysis_tools/analyze_logs.py', argv)
    got, _ = port_main(analyze_logs.main, argv + CPU)
    assert got == want
    assert got.count('2 entries') == 2 and 'total_loss: first' in got
    png = str(trained['root'] / 'curves.png')
    port_main(analyze_logs.main, argv + ['--out', png] + CPU)
    assert png_pixels(png).ndim == 3


def test_publish_model_drops_the_optimizer(trained):
    out = str(trained['root'] / 'published')
    text, final = port_main(publish_model.main,
                            [trained['ckpt'], out] + CPU)
    assert text.strip() == final
    digest = hashlib.sha256(Path(final).read_bytes()).hexdigest()
    assert final == f'{out}-{digest[:8]}'
    assert 'optimizer' in load_checkpoint(trained['ckpt'])
    model, _ = init_detector(trained['config'], device='cpu', seed=1)
    state = load_checkpoint(final, model)
    assert 'optimizer' not in state and state['step'] == 2
    want = load_checkpoint(trained['ckpt'])['state_dict']
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_visualize_results_matches_jax(trained, monkeypatch):
    show = str(trained['root'] / 'show_port')
    _, got = port_main(visualize_results.main, [
        trained['config'], '--result', trained['out'], '--show-dir', show,
        '--max-samples', '3'] + CPU)
    jax_show = str(trained['root'] / 'show_jax')
    jax_main(monkeypatch, 'misc/visualize_results.py', [
        trained['config'], '--result', trained['out'], '--show-dir',
        jax_show, '--max-samples', '3'])
    want = [os.path.join(jax_show, Path(f).name) for f in got]
    assert len(got) == 12
    assert_same_outputs(got, want)

    # Custom3DDataset.show against the JAX dataset's
    with open(trained['out'], 'rb') as f:
        results = pickle.load(f)[:2]
    cfg = load_config(trained['config'])
    got = DATASETS.build(dict(cfg.data.test)).show(
        results, str(trained['root'] / 'ds_port'))
    from msmdfusion_tpu.registry import DATASETS as JAX_DATASETS
    want = JAX_DATASETS.build(dict(cfg.data.test)).show(
        results, str(trained['root'] / 'ds_jax'))
    assert len(got) == 8
    assert_same_outputs(got, want)


def test_fuse_conv_bn_cli_keeps_the_outputs(trained):
    fused_path = str(trained['root'] / 'fused.pth')
    text, run = port_main(fuse_conv_bn.main, [
        trained['config'], trained['ckpt'], fused_path] + CPU)
    assert text.strip() == f'fused {run["fused"]} conv+bn pairs'
    state = load_checkpoint(fused_path)
    assert state['meta']['fused_conv_bn'] == run['fused'] == 21
    ref, _ = init_detector(trained['config'], trained['ckpt'], device='cpu')
    fused, _ = init_detector(trained['config'], fused_path, device='cpu')
    rng = np.random.RandomState(5)
    pts = np.concatenate([rng.uniform(-4.5, 4.5, (1, 400, 2)),
                          rng.uniform(-3.5, 3.5, (1, 400, 1)),
                          rng.uniform(0, 1, (1, 400, 2))], -1)
    args = (torch.from_numpy(pts.astype(np.float32)),
            torch.ones((1, 400), dtype=torch.bool))
    with torch.no_grad():
        want, got = ref(*args), fused(*args)
    for key in ('dense_heatmap', 'center', 'dim'):
        scale = float(want[key].abs().max())
        assert float((got[key] - want[key]).abs().max()) <= 1e-5 * scale, key


def test_benchmark_runs_and_refuses_as_jax(trained):
    text, run = port_main(benchmark.main, [
        trained['config'], trained['ckpt'], '--samples', '2', '--warmup',
        '1', '--num-points', '3000'] + CPU)
    lines = text.strip().splitlines()
    assert lines[0].startswith('overflow_total ')
    assert lines[1].startswith('fps (median): ') and \
        lines[2].startswith('fps (best):   ') and \
        lines[3].startswith('latency ms: min ')
    assert len(run['times']) == 2
    # the points are the JAX tool's (benchmark.py:42-50)
    pcr = [-4.8, -4.8, -4.0, 4.8, 4.8, 4.0]
    rng = np.random.RandomState(0)
    want = np.concatenate([rng.uniform(pcr[0], pcr[3], (1, 7, 1)),
                           rng.uniform(pcr[1], pcr[4], (1, 7, 1)),
                           rng.uniform(pcr[2], pcr[5], (1, 7, 1)),
                           rng.uniform(0, 1, (1, 7, 2))], -1)
    np.testing.assert_array_equal(benchmark.uniform_points(pcr, 7),
                                  want.astype(np.float32))
    with pytest.raises(SystemExit, match='needs camera images'):
        benchmark.main(['configs/MSMDFusion_nusc_voxel_LC.py'] + CPU)


def synthetic_trace():
    """Two iterations of ``extract_pts_feat`` on one host thread: kernels
    launched inside ``voxelize`` and ``gma/plans``, one outside any range,
    a memcpy, and CPU ops that are not device time."""
    events = []

    def rng_(name, ts, dur):
        events.append(dict(ph='X', cat='user_annotation', name=name,
                           pid=1, tid=7, ts=ts, dur=dur))

    def launch(corr, ts, kernel, dur, cat='kernel'):
        events.append(dict(ph='X', cat='cuda_runtime',
                           name='cudaLaunchKernel', pid=1, tid=7, ts=ts,
                           dur=2, args=dict(correlation=corr)))
        events.append(dict(ph='X', cat=cat, name=kernel, pid=0, tid=9,
                           ts=ts + 5, dur=dur, args=dict(correlation=corr)))
    for it, t0 in enumerate((0, 1000)):
        rng_('extract_pts_feat', t0, 500)
        rng_('voxelize', t0 + 10, 100)
        launch(10 * it + 1, t0 + 20, 'voxel_kernel', 40.0)
        rng_('gma', t0 + 200, 200)
        rng_('plans', t0 + 200, 50)          # starts with its parent
        launch(10 * it + 2, t0 + 210, 'rows_affine', 30.0)
        launch(10 * it + 3, t0 + 300, 'gather_gemm_conv_x3', 100.0)
        launch(10 * it + 4, t0 + 600, 'Memcpy HtoD', 8.0, 'gpu_memcpy')
    events.append(dict(ph='X', cat='cpu_op', name='aten::add', pid=1,
                       tid=7, ts=30, dur=1000))
    return dict(traceEvents=events)


def test_trace_summary_sums(tmp_path):
    path = tmp_path / 'x.pt.trace.json'
    path.write_text(json.dumps(synthetic_trace()))
    text, out = port_main(trace_summary.main,
                          [str(tmp_path), '--scope-depth', '2'] + CPU)
    assert out['iters'] == 2
    assert out['total_ms'] == pytest.approx(2 * 178 / 1e3)
    assert out['scopes'] == pytest.approx({
        'extract_pts_feat/voxelize': 0.080, 'extract_pts_feat/gma': 0.260,
        '(top)': 0.016})
    assert out['ops'][0] == (pytest.approx(0.2), 2, 'kernel',
                             'gather_gemm_conv_x3')
    assert 'device self-time total: 0.4 ms (0.2 ms/iter over 2 iters)' in text
    _, deep = port_main(trace_summary.main,
                        [str(path), '--scope-depth', '3', '--iters', '4']
                        + CPU)
    assert deep['iters'] == 4 and deep['scopes'][
        'extract_pts_feat/gma/plans'] == pytest.approx(0.060)


def test_profiling_trace_and_time_fn(tmp_path, trained):
    model, _ = init_detector(trained['config'], trained['ckpt'],
                             device='cpu')
    pts = torch.from_numpy(benchmark.uniform_points(
        [-4.8, -4.8, -4.0, 4.8, 4.8, 4.0], 500))
    mask = torch.ones((1, 500), dtype=torch.bool)
    with torch.no_grad(), profiling.trace(str(tmp_path / 'trace')):
        for _ in range(2):
            model(pts, mask)
    events = trace_summary.load_events(
        trace_summary.find_trace(str(tmp_path / 'trace')))
    names = [e['name'] for e in events if e.get('cat') == 'user_annotation']
    assert names.count('extract_pts_feat') == 2 and 'voxelize' in names
    assert trace_summary.summarize(events)['iters'] == 2
    with profiling.named_scope('outside') as scope:
        assert scope is None          # no profiler: nothing recorded
    with torch.no_grad():
        times = profiling.time_fn(model, pts, mask, iters=2, warmup=1)
    assert set(times) == {'min_s', 'median_s', 'mean_s', 'max_s'}
    assert 0 < times['min_s'] <= times['median_s'] <= times['max_s']


def test_conv_microbench_small_scene():
    shape = dict(conv_microbench.SHAPE, n=6000, v=1, m=8, mr=8,
                 img_hw=(8, 16))
    sets = conv_microbench.stage_sets(torch.device('cpu'), shape=shape,
                                      caps={1: 3000, 2: 1500, 3: 1500},
                                      max_voxels=5000)
    out = conv_microbench.run(
        {'rows', 'conv', 'onehot', 'coords', 'glue'},
        {'enc1_c16', 'agg3_c192'}, reps=1, device=torch.device('cpu'),
        sets=sets)
    assert [r['name'] for r in out['convs']] == ['enc1_c16', 'agg3_c192']
    for rec in out['convs']:
        assert rec['hits'] > 0 and rec['conv_kernel'] == \
            'gather_gemm_conv_x3' and rec['onehot_kernel'] == 'match_conv_x3'
        assert rec['conv_bound'] == pytest.approx(max(
            (4 * (rec['k'] * rec['cin'] + 27 * rec['cin'] * rec['cout']
                  + rec['k'] * rec['cout']) + 4 * 27 * rec['k'])
            / conv_microbench.PEAK_BYTES,
            3 * 2.0 * rec['hits'] * rec['cin'] * rec['cout']
            / conv_microbench.PEAK_BF16) * 1e3)
    assert set(out['coords']) == {0, 1, 2} and out['glue'][0] > 0
    assert out['stages'][0][1] > out['stages'][1][1] > 0


@pytest.mark.parametrize('kind', ['train', 'test'])
def test_slurm_scripts(tmp_path, kind):
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    stubs = {
        # records its options, then runs the task command twice as SLURM's
        # tasks 0 and 1 of a two-node job
        'srun': '''#!/usr/bin/env bash
while [ "$1" != bash ]; do printf '%s\\n' "$1" >> "$OUT/srun"; shift; done
for i in 0 1; do
  SLURM_NTASKS=2 SLURM_PROCID=$i SLURM_JOB_NODELIST='gpu[3-4]' "$@"
done
''',
        'scontrol': '''#!/usr/bin/env bash
[ "$1 $2 $3" = "show hostnames gpu[3-4]" ] && printf 'gpu3\\ngpu4\\n'
''',
        'task_python': '''#!/usr/bin/env bash
printf '%s\\n' "$MSMD_COORDINATOR" "$MSMD_NUM_PROCESSES" \\
  "$MSMD_PROCESS_ID" "$@" > "$OUT/task_$MSMD_PROCESS_ID"
'''}
    for name, text in stubs.items():
        (bin_dir / name).write_text(text)
        (bin_dir / name).chmod(0o755)
    env = dict(os.environ, PATH=f'{bin_dir}:{os.environ["PATH"]}',
               OUT=str(tmp_path), GPUS='2', PORT='29611',
               PYTHON=str(bin_dir / 'task_python'), SRUN_ARGS='--qos=low')
    env.pop('MSMD_COORDINATOR', None)
    fourth = 'work_dirs/x' if kind == 'train' else 'ckpt_3'
    script = REPO / 'msmdfusion_torch' / 'tools' / f'slurm_{kind}.sh'
    subprocess.run([str(script), 'part', 'job', 'cfg.py', fourth, '--seed',
                    '3'], env=env, check=True, timeout=60)
    assert (tmp_path / 'srun').read_text().split() == [
        '-p', 'part', '--job-name=job', '--ntasks=2', '--ntasks-per-node=2',
        '--gres=gpu:2', '--cpus-per-task=5', '--kill-on-bad-exit=1',
        '--qos=low']
    second = ['--work-dir=work_dirs/x'] if kind == 'train' else ['ckpt_3']
    for rank in (0, 1):
        lines = (tmp_path / f'task_{rank}').read_text().splitlines()
        assert lines == ['gpu3:29611', '2', str(rank), '-u', '-m',
                         f'msmdfusion_torch.tools.{kind}', 'cfg.py',
                         *second, '--launcher', 'manual', '--seed', '3']


@pytest.mark.parametrize('main, argv', [
    (print_config.main, ['configs/transfusion_nusc_voxel_L.py']),
    (visualize_results.main, ['c.py', '--result', 'r.pkl', '--show-dir',
                              'd']),
    (fuse_conv_bn.main, ['c.py', 'ckpt', 'out']),
    (publish_model.main, ['ckpt', 'out']),
    (analyze_logs.main, ['train.log']),
    (benchmark.main, ['configs/transfusion_nusc_voxel_L.py']),
    (conv_microbench.main, []),
    (trace_summary.main, ['trace']),
    (test_cli.main, ['configs/transfusion_nusc_voxel_L.py']),
], ids=lambda v: getattr(v, '__module__', '').rsplit('.', 1)[-1] or None)
def test_entry_points_stop_without_a_card(main, argv):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='torch.cuda.is_available'):
        main(argv)
