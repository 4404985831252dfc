"""Port image branch and MDU decoration vs the JAX package's, on the CPU.

ResNet-18 and ResNet-50 with the FPN neck on a 2 x 64 x 96 batch; the
sparse depth canvas (repeated pixels: the last write in (b, v, mr) order
wins, as XLA's scatter does) and its antialiased bilinear resize; the
depth-aware compression and ``get_foreground2d`` of the tiny flagship. The
same seeded numpy inputs and weights go through both packages; dense maps
agree to 1e-4 of the largest reference value. The JAX package is NHWC, the
port NCHW.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from flax import linen as fnn

from msmdfusion_tpu.models.backbones.resnet import ResNet as JaxResNet
from msmdfusion_tpu.models.detectors import MSMDFusionDetector as JaxMSMD
from msmdfusion_tpu.models.necks.fpn import FPN as JaxFPN

from msmdfusion_torch.models.backbones.resnet import ResNet
from msmdfusion_torch.models.detectors.msmdfusion import depth_canvas
from msmdfusion_torch.models.necks.fpn import FPN
from msmdfusion_torch.utils.convert import (fpn_rules, from_jax_variables,
                                            msmdfusion_rules, new_rules,
                                            resnet_rules)
from tests.test_torch_msmdfusion import (IMG_HW, build_pair, make_batch,
                                         tiny_config)
from tests.test_torch_transfusion_l import randomize

TOL = 1e-4
WIDTHS = {18: [64, 128, 256, 512], 50: [256, 512, 1024, 2048]}


def assert_close(got, want, msg=''):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * np.abs(want).max(), err_msg=msg)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


class JaxBranch(fnn.Module):
    depth: int

    @fnn.compact
    def __call__(self, x):
        feats = JaxResNet(depth=self.depth, name='backbone_img')(x)
        return JaxFPN(in_channels=WIDTHS[self.depth], out_channels=32,
                      num_outs=5, name='neck_img')(feats)


class PortBranch(torch.nn.Module):
    def __init__(self, depth):
        super().__init__()
        self.img_backbone = ResNet(depth=depth)
        self.img_neck = FPN(WIDTHS[depth], 32, 5)

    def forward(self, x):
        return self.img_neck(self.img_backbone(x))


@pytest.mark.parametrize('depth', [18, 50])
def test_resnet_fpn_matches_jax(depth):
    rng = np.random.RandomState(depth)
    img = rng.randn(2, 64, 96, 3).astype(np.float32)
    jmod = JaxBranch(depth)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), img)
    variables = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes)), rng)
    want = jax.jit(jmod.apply)(variables, img)
    rules, add = new_rules()
    resnet_rules(add, 'img_backbone', 'backbone_img', depth)
    fpn_rules(add, 'img_neck', 'neck_img')
    port = PortBranch(depth).eval()
    port.load_state_dict(from_jax_variables(variables, rules))
    with torch.no_grad():
        got = port(torch.from_numpy(img).permute(0, 3, 1, 2).contiguous())
    assert [tuple(g.shape[-2:]) for g in got] == \
        [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    for level, (g, w) in enumerate(zip(got, want)):
        assert_close(g.permute(0, 2, 3, 1).numpy(), w, f'level {level}')


def jax_canvas(pixels, mask, h, w):
    """The JAX detector's depth canvas (msmdfusion.py:136-147), jitted."""
    @jax.jit
    def run(pixels, mask):
        b, v, mr = pixels.shape[:3]
        u = pixels[..., 0].astype(jnp.int32)
        vv = pixels[..., 1].astype(jnp.int32)
        ok = mask & (u >= 0) & (u < w) & (vv >= 0) & (vv < h)
        cam = jax.lax.broadcasted_iota(jnp.int32, (b, v, mr), 1) + \
            jax.lax.broadcasted_iota(jnp.int32, (b, v, mr), 0) * v
        flat = jnp.where(ok, (cam * h + vv) * w + u, b * v * h * w)
        canvas = jnp.zeros((b * v * h * w + 1,), pixels.dtype)
        canvas = canvas.at[flat.reshape(-1)].set(
            pixels[..., 2].reshape(-1), mode='drop')
        return canvas[:-1].reshape(b * v, h, w)
    return np.asarray(run(jnp.asarray(pixels), jnp.asarray(mask)))


def test_depth_canvas_last_write_wins_like_xla():
    rng = np.random.RandomState(1)
    h, w = IMG_HW
    b, v, mr = 2, 3, 400
    # 400 pixels over 16 x 10 cells, one row and column of them off the
    # image: most cells are written several times
    cells = np.stack([rng.randint(-1, 15, (b, v, mr)) * 6,
                      rng.randint(-1, 9, (b, v, mr)) * 6], -1)
    pixels = np.concatenate([cells + rng.rand(b, v, mr, 2) * 0.99,
                             rng.uniform(1, 50, (b, v, mr, 1))], -1)
    pixels = pixels.astype(np.float32)
    mask = rng.rand(b, v, mr) < 0.9
    got = depth_canvas(torch.from_numpy(pixels), torch.from_numpy(mask), h,
                       w)[:, 0].numpy()
    want = np.zeros((b * v, h, w), np.float32)
    writes = 0
    for bi in range(b):
        for vi in range(v):
            for k in range(mr):
                u, vv = pixels[bi, vi, k, :2].astype(np.int32)
                if mask[bi, vi, k] and 0 <= u < w and 0 <= vv < h:
                    want[bi * v + vi, vv, u] = pixels[bi, vi, k, 2]
                    writes += 1
    assert writes > 2 * (want != 0).sum()          # many repeated cells
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_canvas(pixels, mask, h, w))


def test_canvas_resize_matches_jax_antialiased_bilinear():
    rng = np.random.RandomState(2)
    h, w = 448, 800
    canvas = np.zeros((2, h, w, 1), np.float32)
    hit = rng.rand(2, h, w) < 0.03
    canvas[hit, 0] = rng.uniform(1, 60, hit.sum())
    t = torch.from_numpy(canvas).permute(0, 3, 1, 2)
    for fh, fw in ((112, 200), (56, 100), (28, 50)):
        want = jax.image.resize(jnp.asarray(canvas), (2, fh, fw, 1),
                                method='bilinear')
        got = F.interpolate(t, size=(fh, fw), mode='bilinear',
                            antialias=True, align_corners=False)
        assert_close(got.permute(0, 2, 3, 1).numpy(), want, f'{fh}x{fw}')


@pytest.fixture(scope='module')
def tiny():
    batch = make_batch(np.random.RandomState(5))
    jmodel, variables, port = build_pair(
        tiny_config(), batch, msmdfusion_rules(depth=18, layer_nums=(2, 2)),
        seed=5)
    return jmodel, variables, port, batch


def test_image_features_and_mdu_decoration_match_jax(tiny):
    jmodel, variables, port, batch = tiny
    fg = {k: jnp.asarray(v) for k, v in batch['fg'].items()}
    tfg = {k: torch.from_numpy(v) for k, v in batch['fg'].items()}
    img = jnp.asarray(batch['img'])

    @jax.jit
    def run(v):
        feats = jmodel.apply(v, img, False, method=JaxMSMD.extract_img_feat)
        comp = jmodel.apply(v, feats, fg['fg_real_pixels'],
                            fg['fg_real_mask'], IMG_HW, False,
                            method=JaxMSMD.depth_aware_compression)
        dec = [jmodel.apply(v, c, fg['fg_pixels'], fg['fg_points'],
                            fg['fg_mask'], fg['lidar2img'], IMG_HW,
                            method=JaxMSMD.get_foreground2d) for c in comp]
        return feats, comp, dec
    j_feats, j_comp, j_dec = run(variables)

    with torch.no_grad():
        feats = port.extract_img_feat(torch.from_numpy(batch['img']))
        for g, w in zip(feats, j_feats):
            assert_close(g.permute(0, 2, 3, 1).numpy(), w, 'fpn')
        # from here on both sides start from the JAX package's FPN maps
        comp = port.depth_aware_compression(
            [nchw(f) for f in j_feats], tfg['fg_real_pixels'],
            tfg['fg_real_mask'], IMG_HW)
        for g, w in zip(comp, j_comp):
            assert g.shape[1] == 49
            assert_close(g.permute(0, 2, 3, 1).numpy(), w, 'compression')
        for c, (j_pcd, j_ok) in zip(j_comp, j_dec):
            pcd, ok = port.get_foreground2d(
                nchw(c), tfg['fg_pixels'], tfg['fg_points'], tfg['fg_mask'],
                tfg['lidar2img'], IMG_HW)
            np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
            assert pcd.shape == (1, 2 * 256, 15 + 49)
            assert_close(pcd.numpy(), j_pcd, 'decorated points')
    assert 0 < int(ok.sum()) < ok.numel()      # some pixels fall outside
