#!/usr/bin/env python3
"""Two studies behind the Hopper x3 sparse-conv kernels
(``csrc/gather_gemm_conv_x3.cu``, ``csrc/conv_dw_x3.cu``) on one NVIDIA
card, on the plans of a synthetic 250,000-point LiDAR frame
(``tests/test_torch_rows_card.frame_plans``) at the flagship's widths:

    git archive <parent commit> | tar -x -C _parent_tree
    python3 x3_study.py [PARENT]

1. The kernels against the ``mma.sync`` kernels they replaced, the
   three-pass instantiation of ``csrc/gather_gemm_conv_bf16.cu`` and
   ``csrc/conv_dw_bf16.cu`` in the checkout at PARENT (default
   ``_parent_tree``, a git-ignored directory), built here with ``nvcc``:
   each call's device time, entry points called back to back (CUDA
   events), with the useful share of the subm plan at 16- and 64-row
   tiles.
2. The fresh accumulator's chain: the forward kernel built with CHAIN = 1,
   2 and 4 units a fresh accumulator (``gather_gemm_conv_x3.cu``), and the
   parent's, each output's signed and absolute error over its magnitude
   against an fp64 x3 reference on positive fp32 and bf16-valued
   features (the tensor cores round their sums toward zero: a bias), and
   their times.

First it prints each kernel's registers, spills and static shared memory
(``nvcc -Xptxas -v``), old and new, by template arguments.
"""
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WIDTHS = [(16, 16), (32, 32), (64, 64), (80, 80), (96, 96), (128, 128),
          (192, 192), (128, 192), (5, 16)]


def build(src, out, edits=()):
    """``src`` compiled with the port's flags into ``out`` (a copy with
    ``edits`` applied, beside the headers it includes)."""
    from msmdfusion_torch import kernels
    src = Path(src)
    work = Path(tempfile.mkdtemp(dir=out.parent))
    for header in src.parent.glob('*.cuh'):
        shutil.copy(header, work)
    text = src.read_text()
    for a, b in edits:
        assert a in text, a
        text = text.replace(a, b)
    (work / src.name).write_text(text)
    return subprocess.Popen([kernels.nvcc(), *kernels.NVCC_FLAGS, '-o',
                             str(out), str(work / src.name)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def ptxas_report(tag, log):
    """One line a kernel of an ``nvcc -Xptxas -v`` log: its template
    arguments, registers, spill stores/loads and static shared memory."""
    name, spill = None, ''
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kern = re.search(r'(\w+_kernel)', m.group(1))
            args = ','.join(re.findall(r'Li(\d+)E', m.group(1)))
            name = f'{kern.group(1) if kern else m.group(1)}<{args}>'
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            spill = f'{m.group(1)}/{m.group(2)}'
            continue
        m = re.search(r'Used (\d+) registers(?:.*?(\d+) bytes smem)?', line)
        if m and name:
            print(f'  {tag} {name}: registers {m.group(1)}, spills {spill} '
                  f'bytes, static smem {m.group(2) or 0}', flush=True)
            name = None


def ms(fn, reps=10):
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv):
    sys.path[:0] = [str(ROOT), str(ROOT / 'tests')]
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.ops.sparse import matchconv as mc
    from test_torch_rows_card import frame_plans
    if not torch.cuda.is_available():
        sys.exit('x3_study.py needs an NVIDIA card')
    parent = Path(argv[0] if argv else ROOT / '_parent_tree')
    out = Path(tempfile.mkdtemp())
    P, I = ctypes.c_void_p, ctypes.c_int
    csrc = ROOT / 'msmdfusion_torch' / 'csrc'
    chain = 'constexpr int CHAIN = 1;'
    procs = [build(parent / 'msmdfusion_torch/csrc/gather_gemm_conv_bf16.cu',
                   out / 'old_conv.so'),
             build(parent / 'msmdfusion_torch/csrc/conv_dw_bf16.cu',
                   out / 'old_dw.so')]
    procs += [build(csrc / 'gather_gemm_conv_x3.cu', out / f'chain{n}.so',
                    [(chain, f'constexpr int CHAIN = {n};')])
              for n in (1, 2, 4)]
    procs.append(build(csrc / 'conv_dw_x3.cu', out / 'new_dw.so'))
    kernels.build(['gather_gemm_conv_x3', 'conv_dw_x3'])
    print('ptxas (the parent\'s x3 instantiation has the last template '
          'argument 3; the new forward at CHAIN 1 is the committed one)',
          flush=True)
    for tag, p in zip(('parent', 'parent', 'chain 1', 'chain 2', 'chain 4',
                       'new'), procs):
        log, _ = p.communicate()
        assert p.returncode == 0, log
        if tag in ('parent', 'chain 1', 'new'):
            ptxas_report(tag, log)
    old_conv = ctypes.CDLL(str(out / 'old_conv.so')).msmd_gather_gemm_conv_x3
    old_conv.argtypes = [P, I, P, I, I, P, P, P, P, I, I, I, I, P, P, I, P,
                         P, P]
    old_dw = ctypes.CDLL(str(out / 'old_dw.so')).msmd_conv_dw_x3
    old_dw.argtypes = [P, I, P, I, I, P, P, P, I, I, I, P, P, P]
    chains = {}
    for n in (1, 2, 4):
        fn = ctypes.CDLL(str(out / f'chain{n}.so')).msmd_gather_gemm_conv_x3
        fn.argtypes = list(kernels.ENTRY_POINTS['gather_gemm_conv_x3'][2])
        chains[n] = fn
    new_conv = kernels.entry_point('gather_gemm_conv_x3')
    new_dw = kernels.entry_point('conv_dw_x3')
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    plans = frame_plans(dev, n_points=250000)
    gen = torch.Generator(device=dev).manual_seed(0)

    print('1. old (mma.sync) against new (wgmma) x3 kernels, ms a call',
          flush=True)
    totals = dict(conv_old=0.0, conv_new=0.0, dw_old=0.0, dw_new=0.0)
    for name, keys, plan in plans:
        rows = mc.plan_rows(keys, plan)
        order = mc.row_order(rows)
        k_out, ta = rows.shape
        k_in = int(rows.max()) + 1
        hits = int((rows >= 0).sum())
        shares = [hits / max(1, n * sum(int(((order.slice_masks(n) >> t) & 1)
                                              .sum()) for t in range(ta)))
                  for n in (16, 64)]
        print(f'{name}: K={k_out} Ta={ta} hits={hits} useful at 16 rows '
              f'{shares[0]:.3f}, at 64 rows {shares[1]:.3f}', flush=True)
        for cin, cout in WIDTHS if name == 'subm' else [(16, 32), (64, 128)]:
            feats = torch.randn(k_in, cin, device=dev, generator=gen)
            w = torch.randn(ta, cin, cout, device=dev, generator=gen) * 0.1
            g = torch.randn(k_out, cout, device=dev, generator=gen)
            out_t = torch.empty(k_out, cout, device=dev)
            dw = torch.empty(ta, cin, cout, device=dev)
            hi, lo, np_o, kc = mc.x3_weights(w)
            laid, np_n, col_blocks = mc.x3_layout(w)
            tile, chunk, n_chunks = mc.conv_dw_bf16_launch(order.tap_hits,
                                                           cin, cout)
            launch = mc.conv_dw_x3_launch(order.tap_hits, cin, cout)
            part_o = torch.empty(max(n_chunks, 1), cin, cout, device=dev)
            part_n = torch.empty(max(launch.n_chunks, 1), cin, cout,
                                 device=dev)
            common = (rows.data_ptr(), k_out, ta, order.perm.data_ptr(),
                      order.masks.data_ptr())
            pairs = (order.pair_in.data_ptr(), order.pair_out.data_ptr(),
                     order.tap_start.data_ptr())
            runs = dict(
                conv_old=lambda: old_conv(
                    feats.data_ptr(), cin, *common, hi.data_ptr(),
                    lo.data_ptr(), np_o, kc, hi.shape[2], cout, None, None,
                    0, None, out_t.data_ptr(), stream),
                conv_new=lambda: new_conv(
                    feats.data_ptr(), cin, *common, laid.data_ptr(), np_n,
                    col_blocks, cout, None, None, 0, None, out_t.data_ptr(),
                    stream),
                dw_old=lambda: old_dw(
                    feats.data_ptr(), cin, g.data_ptr(), cout, ta, *pairs,
                    tile, chunk, n_chunks, part_o.data_ptr(), dw.data_ptr(),
                    stream),
                dw_new=lambda: new_dw(
                    feats.data_ptr(), cin, g.data_ptr(), cout, ta, *pairs,
                    *launch, part_n.data_ptr(), dw.data_ptr(), stream))
            line = f'  {name} {cin}x{cout}:'
            for key, fn in runs.items():
                assert fn() == 0
                t = ms(fn)
                totals[key] += t
                line += f' {key} {t:.4f}'
            bound = 3 * 2 * hits * cin * cout / 989e12 * 1e3
            print(f'{line} ops bound {bound:.4f}', flush=True)
    print('  sums: ' + ' '.join(f'{k} {v:.4f}' for k, v in totals.items()),
          flush=True)

    print('2. the forward\'s fresh-accumulator chain: error over |x3 sum| '
          'against fp64 (mean signed, mean absolute), ms', flush=True)
    name, keys, plan = plans[0]
    rows = mc.plan_rows(keys, plan)
    order = mc.row_order(rows)
    k_out, ta = rows.shape
    k_in = int(rows.max()) + 1
    for cin, cout in [(16, 16), (64, 64), (128, 128), (192, 192)]:
        for kind in ('fp32', 'bf16'):
            feats = torch.rand(k_in, cin, device=dev, generator=gen)
            if kind == 'bf16':
                feats = feats.bfloat16().float()
            w = torch.rand(ta, cin, cout, device=dev, generator=gen) * 0.1
            f_hi, f_lo = mc.split_hi_lo(feats)
            w_hi, w_lo = mc.split_hi_lo(w)
            want = torch.zeros(k_out, cout, dtype=torch.float64, device=dev)
            for t in range(ta):
                r = rows[:, t]
                x_hi = f_hi[r.clamp(min=0).long()].double()
                x_lo = f_lo[r.clamp(min=0).long()].double()
                part = (x_hi @ w_hi[t].double() + x_hi @ w_lo[t].double()
                        + x_lo @ w_hi[t].double())
                want += torch.where((r >= 0)[:, None], part, 0.0)
            live = want > 0
            out_t = torch.empty(k_out, cout, device=dev)
            hi, lo, np_o, kc = mc.x3_weights(w)
            laid, np_n, col_blocks = mc.x3_layout(w)
            common = (rows.data_ptr(), k_out, ta, order.perm.data_ptr(),
                      order.masks.data_ptr())
            runs = {'parent': lambda: old_conv(
                feats.data_ptr(), cin, *common, hi.data_ptr(), lo.data_ptr(),
                np_o, kc, hi.shape[2], cout, None, None, 0, None,
                out_t.data_ptr(), stream)}
            for n, fn in chains.items():
                runs[f'chain {n}'] = (lambda fn: lambda: fn(
                    feats.data_ptr(), cin, *common, laid.data_ptr(), np_n,
                    col_blocks, cout, None, None, 0, None, out_t.data_ptr(),
                    stream))(fn)
            line = f'  {cin}x{cout} {kind}:'
            for key, fn in runs.items():
                assert fn() == 0
                torch.cuda.synchronize()
                rel = ((out_t.double() - want) / want)[live]
                line += (f' | {key} {float(rel.mean()):.2e} '
                         f'{float(rel.abs().mean()):.2e} {ms(fn):.4f}')
            print(line, flush=True)
    shutil.rmtree(out, ignore_errors=True)


if __name__ == '__main__':
    main(sys.argv[1:])
