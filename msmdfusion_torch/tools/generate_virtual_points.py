"""Generate the MDU virtual-point foreground artifacts (MVP-style).

Counterpart of the repository's ``tools/generate_virtual_points.py``: from
per-camera 2D instances (masks or boxes) and a LiDAR frame it writes the
``FOREGROUND_MIXED_6NN_WITH_DEPTH`` artifacts that the flagship's
foreground pipeline reads (``datasets/pipelines/foreground.py``,
``LoadForeground2D``), one ``<lidar file>.pkl.npy`` per keyframe holding a
dict of per-camera lists:

    virtual_pixel_indices [M, 3 + 11]  (u, v, depth, one-hot label block)
    real_pixel_indices    [Mr, 3 + 11]
    virtual_points        [M, 3]       LiDAR-frame xyz
    real_points           [Mr, 3]

The LiDAR points are projected into each camera, the ones inside an
instance are its real pixels, virtual pixels are drawn uniformly over the
instance (from ``np.random.RandomState(seed + camera)``, in the tool's
order of draws), each takes the inverse-distance-weighted depth of its 6
nearest real pixels of the instance and is unprojected to 3D. The 6-NN
depth runs on torch tensors on ``device`` (the card by default; ``cpu``
when asked); projection, membership and unprojection are the tool's numpy.

    python -m msmdfusion_torch.tools.generate_virtual_points ROOT \\
        --detections dets.pkl [--num-virtual 50] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List, Sequence

import numpy as np
import torch

NUM_LABEL_SLOTS = 11   # 10 nuScenes classes + 1 background/ignore slot


def project_points(points: np.ndarray, lidar2img: np.ndarray,
                   img_hw) -> Dict[str, np.ndarray]:
    """dict(uvd [N, 3]: pixel u, v and depth; in_img [N]: in front of the
    camera (depth > 0.1) and inside the image)."""
    n = points.shape[0]
    hom = np.concatenate([points[:, :3], np.ones((n, 1), points.dtype)], 1)
    proj = hom @ lidar2img.T
    depth = proj[:, 2]
    safe = np.where(np.abs(depth) > 1e-6, depth, 1e-6)
    u = proj[:, 0] / safe
    v = proj[:, 1] / safe
    h, w = img_hw
    in_img = (depth > 0.1) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return dict(uvd=np.stack([u, v, depth], 1), in_img=in_img)


def instance_membership(uv: np.ndarray, inst: Dict) -> np.ndarray:
    """[N] bool: the pixels inside the instance's mask, or its box."""
    if inst.get('mask') is not None:
        m = inst['mask']
        ui = np.clip(uv[:, 0].astype(np.int64), 0, m.shape[1] - 1)
        vi = np.clip(uv[:, 1].astype(np.int64), 0, m.shape[0] - 1)
        return m[vi, ui]
    x1, y1, x2, y2 = inst['bbox']
    return ((uv[:, 0] >= x1) & (uv[:, 0] <= x2)
            & (uv[:, 1] >= y1) & (uv[:, 1] <= y2))


def sample_virtual_pixels(inst: Dict, num: int,
                          rng: np.random.RandomState) -> np.ndarray:
    """[num, 2] (u, v) uniform over the instance's mask (a pixel, then a
    jitter within it) or box."""
    if inst.get('mask') is not None:
        vs, us = np.nonzero(inst['mask'])
        if len(us) == 0:
            return np.zeros((0, 2), np.float32)
        sel = rng.randint(0, len(us), num)
        jitter = rng.rand(num, 2) - 0.5
        return np.stack([us[sel], vs[sel]], 1) + jitter
    x1, y1, x2, y2 = inst['bbox']
    return np.stack([rng.uniform(x1, x2, num),
                     rng.uniform(y1, y2, num)], 1).astype(np.float32)


def unproject(uv: np.ndarray, depth: np.ndarray,
              lidar2img: np.ndarray) -> np.ndarray:
    """(u, v, depth) -> LiDAR-frame xyz through the inverse projection."""
    n = uv.shape[0]
    img_pts = np.concatenate(
        [uv * depth[:, None], depth[:, None], np.ones((n, 1))], 1)
    out = img_pts @ np.linalg.inv(lidar2img).T
    return out[:, :3] / np.where(np.abs(out[:, 3:4]) > 1e-9, out[:, 3:4], 1)


def knn_depth(virtual_uv: np.ndarray, real_uvd: np.ndarray, k: int,
              device) -> np.ndarray:
    """[M] depth of each virtual pixel: its ``k`` nearest real pixels'
    depths weighted by 1 / sqrt(d^2 + 1e-6), normalised; in the dtype numpy
    would compute it in, on ``device``."""
    dtype = torch.float64 if np.result_type(
        virtual_uv, real_uvd) == np.float64 else torch.float32
    vuv = torch.as_tensor(virtual_uv, dtype=dtype, device=device)
    real = torch.as_tensor(real_uvd, dtype=dtype, device=device)
    d2 = ((vuv[:, None, :] - real[None, :, :2]) ** 2).sum(-1)
    kk = min(k, d2.shape[1])
    nd, nn = torch.topk(d2, kk, dim=1, largest=False)
    wgt = 1.0 / torch.sqrt(nd + 1e-6)
    wgt = wgt / wgt.sum(1, keepdim=True)
    return (real[:, 2][nn] * wgt).sum(1).cpu().numpy()


def generate_camera_foreground(points: np.ndarray, lidar2img: np.ndarray,
                               img_hw, instances: Sequence[Dict],
                               num_virtual: int = 50, k: int = 6,
                               seed: int = 0, device='cuda'):
    """One camera's (virtual_pixel_indices, real_pixel_indices,
    virtual_points, real_points). ``instances``: dicts with 'label' (an
    int below ``NUM_LABEL_SLOTS - 1``) and 'mask' (bool [H, W]) or 'bbox'
    [x1, y1, x2, y2]."""
    rng = np.random.RandomState(seed)
    proj = project_points(points, lidar2img, img_hw)
    uvd, in_img = proj['uvd'], proj['in_img']
    vpx, rpx, vpt, rpt = [], [], [], []
    for inst in instances:
        idx = np.nonzero(in_img & instance_membership(uvd[:, :2], inst))[0]
        if len(idx) == 0:
            continue
        onehot = np.zeros((NUM_LABEL_SLOTS,), np.float32)
        onehot[int(inst['label'])] = 1.0
        real_uvd = uvd[idx].astype(np.float32)
        rpx.append(np.concatenate(
            [real_uvd, np.tile(onehot, (len(idx), 1))], 1))
        rpt.append(points[idx, :3].astype(np.float32))
        vuv = sample_virtual_pixels(inst, num_virtual, rng)
        if len(vuv) == 0:
            continue
        depth = knn_depth(vuv, real_uvd, k, device)
        vpx.append(np.concatenate(
            [vuv.astype(np.float32), depth[:, None].astype(np.float32),
             np.tile(onehot, (len(vuv), 1))], 1))
        vpt.append(unproject(vuv, depth, lidar2img).astype(np.float32))

    def cat(chunks, width):
        if chunks:
            return np.concatenate(chunks, 0).astype(np.float32)
        return np.zeros((0, width), np.float32)
    return (cat(vpx, 3 + NUM_LABEL_SLOTS), cat(rpx, 3 + NUM_LABEL_SLOTS),
            cat(vpt, 3), cat(rpt, 3))


def generate_sample_artifact(points: np.ndarray, cams: Sequence[Dict],
                             num_virtual: int = 50, k: int = 6,
                             seed: int = 0, device='cuda'
                             ) -> Dict[str, List[np.ndarray]]:
    """A keyframe's artifact dict, one list entry per camera. ``cams``:
    dicts with 'lidar2img' [4, 4], 'img_hw' (h, w) and 'instances' (see
    ``generate_camera_foreground``); camera ``c`` draws from ``seed +
    c``."""
    info = dict(virtual_pixel_indices=[], real_pixel_indices=[],
                virtual_points=[], real_points=[])
    for ci, cam in enumerate(cams):
        parts = generate_camera_foreground(
            points, np.asarray(cam['lidar2img'], np.float64), cam['img_hw'],
            cam['instances'], num_virtual=num_virtual, k=k, seed=seed + ci,
            device=device)
        for key, part in zip(('virtual_pixel_indices', 'real_pixel_indices',
                              'virtual_points', 'real_points'), parts):
            info[key].append(part)
    return info


def main(argv=None) -> int:
    """Write one artifact per keyframe of ``--detections`` (a pickle:
    LiDAR file name -> list of camera dicts) found under
    ``ROOT/samples/LIDAR_TOP``; returns the number written."""
    p = argparse.ArgumentParser(description='MDU virtual-point artifacts')
    p.add_argument('root_path', help='dataset root with samples/LIDAR_TOP')
    p.add_argument('--detections', required=True)
    p.add_argument('--out-subdir', default='FOREGROUND_MIXED_6NN_WITH_DEPTH')
    p.add_argument('--num-virtual', type=int, default=50)
    p.add_argument('--load-dim', type=int, default=5)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    from ..models.builder import resolve_device
    device = resolve_device(args.device)
    with open(args.detections, 'rb') as f:
        det = pickle.load(f)
    lidar_dir = os.path.join(args.root_path, 'samples', 'LIDAR_TOP')
    out_dir = os.path.join(args.root_path, 'samples', args.out_subdir)
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for fname, cams in det.items():
        pts_path = os.path.join(lidar_dir, fname)
        if not os.path.exists(pts_path):
            continue
        pts = np.fromfile(pts_path, np.float32).reshape(-1, args.load_dim)
        info = generate_sample_artifact(pts, cams,
                                        num_virtual=args.num_virtual,
                                        device=device)
        np.save(os.path.join(out_dir, fname + '.pkl'),
                np.asarray(info, dtype=object), allow_pickle=True)
        n += 1
    print(f'wrote {n} foreground artifacts to {out_dir}')
    return n


if __name__ == '__main__':
    main()
