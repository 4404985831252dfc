"""The flagship under ``compute_dtype='bfloat16'`` (the JAX package's
``MSMD_BF16``), port vs the JAX package on the CPU, in both parameter
modes: fp32 parameters, and parameters cast to bf16 as the JAX bench casts
its params tree (``layers.cast_params``; batch statistics stay fp32).

The tiny flagship of ``test_torch_msmdfusion.py``. One jitted JAX forward
per mode captures every module's output (``capture_intermediates``),
compiled without XLA's excess precision (``capture``).

- Per module: each port module runs on the JAX module's own input (the
  captured output of the module before it) and its output is held to the
  JAX module's output: the same dtype, and values within 2^-7 of the JAX
  output's largest magnitude (two bf16 roundings: the port's kernel path
  rounds a bf16 conv once after its epilogue, the JAX package's XLA path
  on the CPU once before it and once after).
- The whole detector: every stage boundary's dtype equals JAX's; the
  port's head input departs from its fp32 one by at least half as much as
  JAX's bf16 head input departs from its fp32 one; and with the one
  rounding the two packages place apart made the same (the JAX XLA path
  also rounds each bf16 sparse conv's sum before its epilogue:
  ``xla_rounding``) it lies from JAX's bf16 head input at most half as
  far as JAX's own bf16 head input lies from its fp32 one on the same
  inputs: the port rounds to bf16 where the JAX package does.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from msmdfusion_torch.models.layers import cast_params
from msmdfusion_torch.ops.sparse import matchconv as tmc
from msmdfusion_torch.ops.sparse import tensor as ttensor
from msmdfusion_torch.ops.voxelize import voxelize_mean_batch
from msmdfusion_torch.utils.convert import (from_jax_variables,
                                            msmdfusion_rules)
from tests.test_torch_msmdfusion import (build_pair, jax_inputs, make_batch,
                                         port_inputs, tiny_config)

TOL = 2.0 ** -7
LISTS = ('fps_num_list', 'radius_list', 'max_cluster_samples_list',
         'dist_thresh_list')


def bf16_params(variables):
    """The JAX bench's ``MSMD_BF16`` cast: fp32 params to bf16, batch
    statistics as they are."""
    out = dict(variables)
    out['params'] = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x).astype(jnp.bfloat16)
        if x.dtype == np.float32 else x, variables['params'])
    return out


def capture(jmodel, variables, batch):
    """The JAX model's predictions and every module's output, compiled
    without XLA's excess precision: by default XLA on the CPU drops a
    bf16 rounding between fused operations (between a conv and its norm,
    say), so its modules would not round where their dtypes say."""
    def run(v, *args):
        return jmodel.apply(v, *args, capture_intermediates=True,
                            mutable=['intermediates'])
    args = (variables, *jax_inputs(batch))
    compiled = jax.jit(run).lower(*args).compile(
        {'xla_allow_excess_precision': False})
    preds, state = compiled(*args)
    return preds, state['intermediates']


def out(inter, *path):
    """The captured output of the module at ``path``."""
    node = inter
    for key in path:
        node = node[key]
    return node['__call__'][0]


def torch_of(x):
    """A numpy or JAX array as a torch tensor of the same dtype (bf16
    through fp32, exactly)."""
    a = np.asarray(x)
    if a.dtype.name == 'bfloat16':
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def nchw(x):
    return torch_of(x).permute(0, 3, 1, 2).contiguous()


def port_sparse(st):
    return ttensor.SparseTensor(
        features=torch_of(st.features), coords=torch_of(st.coords),
        valid=torch_of(st.valid), keys=torch_of(st.keys),
        spatial_shape=tuple(st.spatial_shape), batch_size=st.batch_size)


def dtype_name(t):
    return str(t.dtype).rsplit('.', 1)[-1]


def check(got, want, what):
    """``got`` (torch) has ``want``'s dtype and lies within TOL of its
    largest magnitude."""
    want = np.asarray(want)
    assert dtype_name(got) == want.dtype.name, (what, got.dtype, want.dtype)
    w = want.astype(np.float32)
    g = got.detach().float().numpy()
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.abs(w).max() > 0, what
    np.testing.assert_allclose(g, w, rtol=0, atol=TOL * np.abs(w).max(),
                               err_msg=what)


@pytest.fixture(scope='module')
def fp32_ref():
    """The fp32 models' head inputs on the tiny scene: (JAX's, the
    port's), channels-last."""
    batch = make_batch(np.random.RandomState(0))
    jmodel, variables, port = build_pair(
        tiny_config(), batch, msmdfusion_rules(depth=18, layer_nums=(2, 2)))
    _, inter = capture(jmodel, variables, batch)
    return (np.asarray(out(inter, 'neck_pts')[0]),
            head_input(port, port_inputs(batch)))


def head_input(port, inputs):
    """The port's head input [B, H, W, C] in fp32 on ``inputs``."""
    seen = []
    hook = port.pts_neck.register_forward_hook(
        lambda m, a, o: seen.append(o[0]))
    try:
        with torch.no_grad():
            port(*inputs)
    finally:
        hook.remove()
    return seen[0].permute(0, 2, 3, 1).float().numpy()


def xla_rounding(conv):
    """``conv`` (``matchconv.gather_gemm_conv``) rounding a bf16 conv's
    sum to bf16 before its epilogue and again after it, as the JAX
    package's XLA path does (``_fallback_conv``, then
    ``apply_epilogue_xla``); the port's kernels and their plain versions
    round once, after it, as its TPU kernels do."""
    def run(feats, rows, weights, scale=None, shift=None, relu=False,
            out_valid=None, order=None):
        if feats.dtype != torch.bfloat16:
            return conv(feats, rows, weights, scale, shift, relu, out_valid,
                        order)
        raw = conv(feats, rows, weights, order=order)
        return tmc.apply_epilogue(raw.float(), out_valid, scale, shift,
                                  relu).to(torch.bfloat16)
    return run


@pytest.fixture(scope='module', params=['fp32 params', 'bf16 params'])
def pair(request):
    """(JAX model, its variables, the port model loaded from them, the
    scene, the JAX predictions and captured outputs) in one mode."""
    batch = make_batch(np.random.RandomState(0))
    cfg = dict(tiny_config(), compute_dtype='bfloat16')
    jmodel, variables, port = build_pair(
        cfg, batch, msmdfusion_rules(depth=18, layer_nums=(2, 2)))
    if request.param == 'bf16 params':
        variables = bf16_params(variables)
        cast_params(port)
    preds, inter = capture(jmodel, variables, batch)
    return dict(mode=request.param, jmodel=jmodel, port=port, batch=batch,
                preds=preds, inter=inter, variables=variables)


def test_cast_params_casts_parameters_only(pair):
    port = pair['port']
    want = (torch.bfloat16 if pair['mode'] == 'bf16 params'
            else torch.float32)
    assert {p.dtype for p in port.parameters()} == {want}
    assert {b.dtype for n, b in port.named_buffers()
            if 'running' in n} == {torch.float32}


def test_converter_carries_the_parameters_dtype(pair):
    """``from_jax_variables`` of a bf16 params tree gives bf16 tensors of
    the same bits (batch statistics fp32), which load into the cast port
    as they are."""
    sd = from_jax_variables(pair['variables'],
                            msmdfusion_rules(depth=18, layer_nums=(2, 2)))
    want = (torch.bfloat16 if pair['mode'] == 'bf16 params'
            else torch.float32)
    params = dict(pair['port'].named_parameters())
    assert {sd[n].dtype for n in params} == {want}
    assert {v.dtype for k, v in sd.items() if 'running' in k} == \
        {torch.float32}
    for name, p in params.items():
        assert torch.equal(sd[name], p.detach()), name
    dummy = np.asarray(pair['variables']['params']['mm_encoder']
                       ['dummy_embedding_0'])
    np.testing.assert_array_equal(
        sd['multimodal_middle_encoder.dummy_embedding_0'].float().numpy(),
        dummy.astype(np.float32))


def test_modules_match_jax_in_bf16(pair):
    port, inter, batch = pair['port'], pair['inter'], pair['batch']
    points, mask, img, fg = port_inputs(batch)
    with torch.no_grad():
        # image branch: the ResNet's stem and each residual block, then
        # the FPN, each on the JAX module's input
        b, v, h, w, _ = img.shape
        flat = img.reshape(b * v, h, w, 3).permute(0, 3, 1, 2)
        res = port.img_backbone
        stem = res.bn1(res.conv1(flat.to(torch.bfloat16)))
        check(stem.permute(0, 2, 3, 1), out(inter, 'backbone_img', 'bn1'),
              'ResNet stem')
        x = res.maxpool(torch.relu(nchw(out(inter, 'backbone_img', 'bn1'))))
        for s in range(res.num_stages):
            for k, block in enumerate(getattr(res, f'layer{s + 1}')):
                name = f'layer{s + 1}_{k}'
                check(block(x).permute(0, 2, 3, 1),
                      out(inter, 'backbone_img', name), f'ResNet {name}')
                x = nchw(out(inter, 'backbone_img', name))
        jneck = out(inter, 'neck_img')
        neck = port.img_neck([nchw(x) for x in out(inter, 'backbone_img')])
        for i, want in enumerate(jneck):
            check(neck[i].permute(0, 2, 3, 1), want, f'neck {i}')

        # depth-aware compression on the JAX neck's levels
        levels = [nchw(x) for x in jneck]
        comp = port.depth_aware_compression(
            levels, fg['fg_real_pixels'], fg['fg_real_mask'], (h, w))
        for i in range(3):
            check(comp[i].permute(0, 2, 3, 1),
                  out(inter, f'compress_{i}'), f'compress {i}')

        # the LiDAR encoder block by block, each on the JAX block's input
        # (the first on the bf16 voxel features)
        vl = port.pts_voxel_layer
        vox, coors, valid = voxelize_mean_batch(
            points, mask, vl['voxel_size'], vl['point_cloud_range'],
            vl['max_voxels'][1])
        enc_port = port.pts_middle_encoder
        st = ttensor.make_sparse_tensor(
            vox.to(torch.bfloat16), coors, valid, enc_port.sparse_shape, 1,
            assume_sorted=True)
        counts = {}
        for m in enc_port.modules():
            kind = type(m).__name__
            if kind not in ('SparseConvBlock', 'SparseBasicBlock'):
                continue
            k = counts[kind] = counts.get(kind, -1) + 1
            want = out(inter, 'middle_encoder', f'{kind}_{k}')[0]
            got = m(st, {})[0]
            np.testing.assert_array_equal(got.keys.numpy(),
                                          np.asarray(want.keys))
            check(got.features, want.features, f'encoder {kind}_{k}')
            st = port_sparse(want)
        assert counts == {'SparseConvBlock': 4, 'SparseBasicBlock': 7}
        jx, jenc, _ = out(inter, 'middle_encoder')

        # GMA on the JAX encoder's stages and the 2D voxels of the JAX
        # neck's levels
        feat_list = [comp[0], comp[0], comp[1], comp[2]]
        v2 = []
        for i in range(4):
            pcd, ok = port.get_foreground2d(
                feat_list[i], fg['fg_pixels'], fg['fg_points'],
                fg['fg_mask'], fg['lidar2img'], (h, w))
            v2.append(port.fetch_2d_voxels(pcd, ok, i))
        stages = port.multimodal_middle_encoder(
            [port_sparse(s) for s in jenc[:4]], v2,
            *(getattr(port, k) for k in LISTS))
        jstages = out(inter, 'mm_encoder')
        for i, (g, want) in enumerate(zip(stages, jstages)):
            np.testing.assert_array_equal(g.keys.numpy(),
                                          np.asarray(want.keys))
            check(g.features, want.features, f'GMA stage {i}')

        # SPP, SECOND, SECONDFPN and the head, each on its JAX input
        x_mm = ttensor.to_dense_bev(port_sparse(jstages[-1]))
        spp = port.bev_fusion(torch.cat([nchw(jx), x_mm.permute(0, 3, 1, 2)],
                                        1))
        check(spp.permute(0, 2, 3, 1), out(inter, 'bev_fusion'), 'SPP')
        second = port.pts_backbone(nchw(out(inter, 'bev_fusion')))
        for i, want in enumerate(out(inter, 'backbone_pts')):
            check(second[i].permute(0, 2, 3, 1), want, f'SECOND {i}')
        jneck_pts = out(inter, 'neck_pts')
        fpn = port.pts_neck([nchw(x) for x in out(inter, 'backbone_pts')])
        check(fpn[0].permute(0, 2, 3, 1), jneck_pts[0], 'SECONDFPN')
        preds = port.pts_bbox_head(nchw(jneck_pts[0]))
        boxes = port.get_bboxes(preds)
    jpreds = pair['preds']
    np.testing.assert_array_equal(preds['query_labels'].numpy(),
                                  np.asarray(jpreds['query_labels']))
    for key in ('dense_heatmap', 'heatmap', 'center', 'height', 'dim', 'rot',
                'vel'):
        check(preds[key], jpreds[key], key)
    assert boxes['bboxes'].dtype == torch.float32


# port module -> JAX module, whose outputs' dtypes must agree
BOUNDARIES = [('img_backbone', ('backbone_img',)),
              ('img_neck', ('neck_img',)),
              ('conv1x1_blocks.0', ('compress_0',)),
              ('score_net', ('score_net',)),
              ('pts_middle_encoder', ('middle_encoder',)),
              ('multimodal_middle_encoder.gate_control.0',
               ('mm_encoder', 'gate_0')),
              ('multimodal_middle_encoder.cross_gate_control.0',
               ('mm_encoder', 'cross_gate_0')),
              ('multimodal_middle_encoder.grouped_sp_conv_blocks_3D.stage_1',
               ('mm_encoder', 'grouped_3d_0')),
              ('multimodal_middle_encoder.aggregation_blocks.stage_1',
               ('mm_encoder', 'aggregation_0')),
              ('multimodal_middle_encoder', ('mm_encoder',)),
              ('bev_fusion', ('bev_fusion',)),
              ('pts_backbone', ('backbone_pts',)),
              ('pts_neck', ('neck_pts',)),
              ('pts_bbox_head', ('bbox_head',))]


def first_float(x):
    """The first floating array of a module's output (a sparse tensor's
    features), torch or JAX."""
    for leaf in jax.tree_util.tree_leaves(x, is_leaf=lambda v: isinstance(
            v, (ttensor.SparseTensor, torch.Tensor))):
        if isinstance(leaf, ttensor.SparseTensor):
            return leaf.features
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point():
                return leaf
        elif np.issubdtype(np.asarray(leaf).dtype, np.floating) or \
                np.asarray(leaf).dtype.name == 'bfloat16':
            return np.asarray(leaf)
    raise ValueError('no floating output')


def test_detector_stage_dtypes_and_head_input(pair, fp32_ref, monkeypatch):
    port, inter = pair['port'], pair['inter']
    inputs = port_inputs(pair['batch'])
    seen = {}
    modules = dict(port.named_modules())
    hooks = [modules[name].register_forward_hook(
        lambda m, a, o, name=name: seen.setdefault(name, o))
        for name, _ in BOUNDARIES]
    try:
        with torch.no_grad():
            preds = port(*inputs)
            boxes = port.get_bboxes(preds)
    finally:
        for h in hooks:
            h.remove()
    for name, path in BOUNDARIES:
        got, want = first_float(seen[name]), first_float(out(inter, *path))
        assert dtype_name(got) == want.dtype.name, (name, got.dtype,
                                                    want.dtype)
    assert seen['pts_middle_encoder'][0].dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in boxes.values()
               if v.is_floating_point())

    # the port departs from its fp32 run as bf16 rounding does; with the
    # JAX XLA path's extra rounding of each bf16 conv's sum it lies within
    # half of JAX's own bf16-vs-fp32 distance from JAX's bf16 head input
    jax_fp32, port_fp32 = fp32_ref
    jax_bf16 = np.asarray(out(inter, 'neck_pts')[0]).astype(np.float32)
    jax_gap = np.abs(jax_bf16 - jax_fp32).max()
    own = seen['pts_neck'][0].permute(0, 2, 3, 1).float().numpy()
    assert np.abs(own - port_fp32).max() >= 0.5 * jax_gap > 0
    monkeypatch.setattr(tmc, 'gather_gemm_conv',
                        xla_rounding(tmc.gather_gemm_conv))
    xla = head_input(port, inputs)
    assert np.abs(xla - jax_bf16).max() <= 0.5 * jax_gap, \
        (np.abs(xla - jax_bf16).max(), jax_gap)
