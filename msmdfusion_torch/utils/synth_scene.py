"""Synthetic nuScenes-like LiDAR + camera frames (numpy only).

Private copies of the JAX package's ``utils/synth_scene.py``
(``lidar_scene``, ``camera_rig``, ``realistic_batch``), of the virtual-point
generator they run (``tools/generate_virtual_points.py``: per-instance 2D
boxes -> virtual pixels -> 6NN depth lifting -> unprojection) and of the
foreground packing (``datasets/pipelines/foreground.py``:
``LoadForeground2D._organize``, ``PadForeground2D``). A spinning 32-beam
model with ground rings, walls with 1/r^2 return density and car-sized
object clusters, accumulated over 10 sweeps; a 6-camera ring; foreground
virtual points on the objects' surfaces. The same seed gives the same
arrays as the JAX package's copies: the flagship's capacities were
measured on that scene. ``lc_batch`` (the port's own) draws TransFusion-LC
inputs: the LiDAR frame, camera images and a rig per dataset
(``LC_YAWS``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from . import overflow

NUM_LABEL_SLOTS = 11   # 10 nuScenes classes + 1 background/ignore slot


def _box_surface_points(rng, center, dims, yaw, count):
    """Sample `count` points on the surface of an upright box."""
    l, w, h = dims
    areas = np.array([l * h, l * h, w * h, w * h, l * w])  # 4 sides + top
    face = rng.choice(5, size=count, p=areas / areas.sum())
    u = rng.uniform(-0.5, 0.5, count)
    v = rng.uniform(-0.5, 0.5, count)
    x = np.where(face < 2, u * l, np.where(face < 4,
                 np.where(face == 2, 0.5, -0.5) * w, u * l))
    y = np.where(face < 2, np.where(face == 0, 0.5, -0.5) * w,
                 np.where(face < 4, u * w, v * w))
    z = np.where(face < 4, v * h, 0.5 * h)
    c, s = np.cos(yaw), np.sin(yaw)
    px = center[0] + c * x - s * y
    py = center[1] + s * x + c * y
    pz = center[2] + z
    return np.stack([px, py, pz], 1) + rng.normal(0, 0.02, (count, 3))


def lidar_scene(rng: np.random.RandomState, n_points: int,
                pcr: Sequence[float], num_objects: int = 32,
                sweeps: int = 10):
    """(points [n_points, 5], objects) — a plausible 10-sweep lidar frame.

    objects: list of dicts(center [3], dims [3], yaw) for the car-sized
    clusters (the 2D-instance sources for the foreground generator).
    """
    max_r = float(min(pcr[3], pcr[4]))
    lidar_z = 1.8
    chunks = []

    # ground rings: 20 downward beams x ~1000 azimuths x `sweeps` sweeps.
    # Physical range noise is ~2 cm (NOT proportional to range: the
    # round-3 3%-of-r scatter smeared far rings over +-1 m of isolated
    # voxels). Sweep accumulation follows real nuScenes: the ego moves
    # between 20 Hz sweeps, so older rings land shifted by v*dt in the
    # current frame — thin, surface-coherent annuli, like real data.
    elevs = np.deg2rad(np.linspace(-29.0, -2.0, 20))
    n_az = max(int(n_points * 0.55 / (len(elevs) * sweeps)), 8)
    ego_v = rng.uniform(0.0, 9.0)                    # m/s
    ego_dir = rng.uniform(0, 2 * np.pi)
    ego_step = ego_v * 0.05 * np.array([np.cos(ego_dir), np.sin(ego_dir)])
    # smooth low-order terrain: radius and height modulation per azimuth
    t_amp = rng.uniform(0.0, 0.04)
    t_ph = rng.uniform(0, 2 * np.pi, 3)
    for phi in elevs:
        r = min(lidar_z / np.tan(-phi), max_r * 1.2)
        for s in range(sweeps):
            theta = (np.arange(n_az) / n_az) * 2 * np.pi \
                + rng.uniform(0, 2 * np.pi / n_az)
            terrain = (1.0 + t_amp * np.sin(3 * theta + t_ph[0])
                       + 0.5 * t_amp * np.sin(7 * theta + t_ph[1]))
            rr = r * terrain + rng.normal(0, 0.02, n_az)
            org = -s * ego_step                      # sweep-s ego position
            chunks.append(np.stack([
                org[0] + rr * np.cos(theta), org[1] + rr * np.sin(theta),
                np.full(n_az, -lidar_z) + rng.normal(0, 0.02, n_az)], 1))

    # walls: vertical planes, return count ~ area / d^2
    n_wall_budget = int(n_points * 0.25)
    wall_counts = []
    walls = []
    for _ in range(14):
        d = rng.uniform(12.0, max_r)
        theta = rng.uniform(0, 2 * np.pi)
        width = rng.uniform(8.0, 30.0)
        height = rng.uniform(3.0, 8.0)
        walls.append((d, theta, width, height))
        wall_counts.append(width * height / d ** 2)
    wall_counts = np.asarray(wall_counts)
    wall_counts = (wall_counts / wall_counts.sum() * n_wall_budget).astype(int)
    for (d, theta, width, height), cnt in zip(walls, wall_counts):
        if cnt <= 0:
            continue
        ctr = np.array([d * np.cos(theta), d * np.sin(theta)])
        tang = np.array([-np.sin(theta), np.cos(theta)])
        u = rng.uniform(-0.5, 0.5, cnt) * width
        z = rng.uniform(0, height, cnt) - lidar_z
        xy = ctr[None, :] + u[:, None] * tang[None, :]
        chunks.append(np.concatenate(
            [xy + rng.normal(0, 0.03, (cnt, 2)), z[:, None]], 1))

    # objects: car-sized boxes, closer-weighted, 1/d^2 returns x sweeps
    objects = []
    for _ in range(num_objects):
        d = 5.0 + (max_r - 8.0) * rng.power(1.6)
        theta = rng.uniform(0, 2 * np.pi)
        dims = np.array([rng.uniform(3.8, 5.2), rng.uniform(1.7, 2.1),
                         rng.uniform(1.4, 1.9)])
        center = np.array([d * np.cos(theta), d * np.sin(theta),
                           -lidar_z + dims[2] / 2])
        yaw = rng.uniform(0, 2 * np.pi)
        cnt = int(np.clip(sweeps * 1500.0 / d ** 2, 20, 2500))
        chunks.append(_box_surface_points(rng, center, dims, yaw, cnt))
        objects.append(dict(center=center, dims=dims, yaw=yaw,
                            label=int(rng.randint(0, 10))))

    pts = np.concatenate(chunks, 0)
    # clip to range with margin, then sample/pad to the exact target count
    in_r = np.all(np.abs(pts[:, :2]) < max_r * 1.05, axis=1)
    pts = pts[in_r]
    if len(pts) >= n_points:
        sel = rng.choice(len(pts), n_points, replace=False)
        pts = pts[sel]
    else:
        extra = rng.choice(len(pts), n_points - len(pts), replace=True)
        pts = np.concatenate([pts, pts[extra] + rng.normal(
            0, 0.01, (n_points - len(pts), 3))], 0)
    feats = np.concatenate(
        [pts, rng.uniform(0, 1, (n_points, 1)),
         np.zeros((n_points, 1))], 1).astype(np.float32)
    return feats, objects


# ---------------------------------------------------------------------------
# Camera rig
# ---------------------------------------------------------------------------

# the camera yaws (degrees, counter-clockwise from the LiDAR's x axis) of
# ``lc_batch``'s rigs, views in each dataset's order: nuScenes' CAM_ORDER
# (FRONT_LEFT, FRONT, FRONT_RIGHT, BACK_RIGHT, BACK, BACK_LEFT) on the
# 60-degree ring, Waymo's five cameras (FRONT, FRONT_LEFT, FRONT_RIGHT,
# SIDE_LEFT, SIDE_RIGHT); neighbouring views overlap
LC_YAWS = {'nuScenes': (60.0, 0.0, -60.0, -120.0, 180.0, 120.0),
           'Waymo': (0.0, 45.0, -45.0, 90.0, -90.0)}


def camera_rig(img_hw, num_cams: int = 6, seed: int = 0,
               yaws=None) -> np.ndarray:
    """[V, 4, 4] lidar2img of a nuScenes-like ring of outward cameras at
    60-degree yaw steps, ~70-degree horizontal FOV (``yaws``: the views'
    yaws in degrees instead, one per camera)."""
    h, w = img_hw
    rng = np.random.RandomState(seed)
    fx = w / (2.0 * np.tan(np.deg2rad(35.0)))        # 70 deg hFOV
    fy = fx
    cx, cy = w / 2.0, h / 2.0
    intr = np.array([[fx, 0, cx, 0], [0, fy, cy, 0],
                     [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
    yaws = np.deg2rad([0.0, -60.0, 60.0, 180.0, 120.0, -120.0]
                      if yaws is None else yaws)
    mats = []
    for i in range(num_cams):
        psi = yaws[i % len(yaws)] + rng.uniform(-0.02, 0.02)
        c, s = np.cos(psi), np.sin(psi)
        fwd = np.array([c, s, 0.0])                  # camera z (lidar frame)
        right = np.array([s, -c, 0.0])               # camera x
        down = np.array([0.0, 0.0, -1.0])            # camera y
        rot = np.stack([right, down, fwd])           # R: lidar -> cam
        t = fwd * 0.7 + np.array([0, 0, -0.3])       # mount offset
        ext = np.eye(4)
        ext[:3, :3] = rot
        ext[:3, 3] = -rot @ t
        mats.append(intr @ ext)
    return np.stack(mats).astype(np.float32)


# ---------------------------------------------------------------------------
# Virtual points (the bounding-box path of generate_virtual_points.py)
# ---------------------------------------------------------------------------

def project_points(points: np.ndarray, lidar2img: np.ndarray,
                   img_hw) -> Dict[str, np.ndarray]:
    """uvd [N, 3] (pixel u, v and depth) and in_img [N] of lidar points in
    one camera: in front of it and inside the image."""
    n = points.shape[0]
    hom = np.concatenate([points[:, :3], np.ones((n, 1), points.dtype)], 1)
    proj = hom @ lidar2img.T                       # [N, 4]
    depth = proj[:, 2]
    safe = np.where(np.abs(depth) > 1e-6, depth, 1e-6)
    u = proj[:, 0] / safe
    v = proj[:, 1] / safe
    h, w = img_hw
    in_img = (depth > 0.1) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return dict(uvd=np.stack([u, v, depth], 1), in_img=in_img)


def unproject(uv: np.ndarray, depth: np.ndarray,
              lidar2img: np.ndarray) -> np.ndarray:
    """(u, v, depth) -> lidar-frame xyz via the inverse projection."""
    n = uv.shape[0]
    img_pts = np.concatenate(
        [uv * depth[:, None], depth[:, None], np.ones((n, 1))], 1)
    out = img_pts @ np.linalg.inv(lidar2img).T
    return out[:, :3] / np.where(np.abs(out[:, 3:4]) > 1e-9, out[:, 3:4], 1)


def generate_camera_foreground(points, lidar2img, img_hw, instances,
                               num_virtual: int = 50, k: int = 6,
                               seed: int = 0):
    """One camera's (virtual_pixel_indices [M, 14], real_pixel_indices
    [Mr, 14], virtual_points [M, 3], real_points [Mr, 3]) for instances
    given as 'bbox' [x1, y1, x2, y2] and 'label'."""
    rng = np.random.RandomState(seed)
    proj = project_points(points, lidar2img, img_hw)
    uvd, in_img = proj['uvd'], proj['in_img']
    vpx, rpx, vpt, rpt = [], [], [], []
    for inst in instances:
        x1, y1, x2, y2 = inst['bbox']
        member = in_img & ((uvd[:, 0] >= x1) & (uvd[:, 0] <= x2)
                           & (uvd[:, 1] >= y1) & (uvd[:, 1] <= y2))
        idx = np.nonzero(member)[0]
        onehot = np.zeros((NUM_LABEL_SLOTS,), np.float32)
        onehot[int(inst['label'])] = 1.0
        if len(idx) == 0:
            continue
        real_uvd = uvd[idx].astype(np.float32)
        rpx.append(np.concatenate(
            [real_uvd, np.tile(onehot, (len(idx), 1))], 1))
        rpt.append(points[idx, :3].astype(np.float32))

        vuv = np.stack([rng.uniform(x1, x2, num_virtual),
                        rng.uniform(y1, y2, num_virtual)],
                       1).astype(np.float32)
        # inverse-distance-weighted depth of the 6 nearest real pixels
        d2 = ((vuv[:, None, :] - real_uvd[None, :, :2]) ** 2).sum(-1)
        kk = min(k, d2.shape[1])
        nn = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
        nd = np.take_along_axis(d2, nn, axis=1)
        wgt = 1.0 / np.sqrt(nd + 1e-6)
        wgt /= wgt.sum(1, keepdims=True)
        depth = (np.take_along_axis(
            np.broadcast_to(real_uvd[None, :, 2], d2.shape), nn, axis=1)
            * wgt).sum(1)
        vpx.append(np.concatenate(
            [vuv, depth[:, None].astype(np.float32),
             np.tile(onehot, (len(vuv), 1))], 1))
        vpt.append(unproject(vuv, depth, lidar2img).astype(np.float32))

    def cat(chunks, width):
        if chunks:
            return np.concatenate(chunks, 0).astype(np.float32)
        return np.zeros((0, width), np.float32)

    return (cat(vpx, 3 + NUM_LABEL_SLOTS), cat(rpx, 3 + NUM_LABEL_SLOTS),
            cat(vpt, 3), cat(rpt, 3))


def _instances_for_camera(objects, lidar2img, img_hw):
    """2D box instances: each visible object's projected extent."""
    instances = []
    for obj in objects:
        corners = _box_surface_points(
            np.random.RandomState(0), obj['center'], obj['dims'],
            obj['yaw'], 64)
        proj = project_points(corners, lidar2img.astype(np.float64), img_hw)
        vis = proj['in_img']
        if vis.sum() < 8:
            continue
        uv = proj['uvd'][vis, :2]
        x1, y1 = uv.min(0)
        x2, y2 = uv.max(0)
        instances.append(dict(bbox=[x1, y1, x2, y2], label=obj['label']))
    return instances


# ---------------------------------------------------------------------------
# Foreground packing (LoadForeground2D._organize + PadForeground2D)
# ---------------------------------------------------------------------------

def _organize(vpx_list, rpx_list, vpt_list, rpt_list):
    """Per camera: pixels [virtual; real] (u, v, depth) and points [virtual;
    real] (xyz, 11 label slots, timestamp 0), and the real pixels."""
    fg_pixels, fg_points, fg_real_pixels = [], [], []
    for vp, rp, vpts, rpts in zip(vpx_list, rpx_list, vpt_list, rpt_list):
        fg_pixels.append(np.concatenate([vp[:, :3], rp[:, :3]], axis=0))
        vpts = np.concatenate([vpts, vp[:, -11:]], axis=1)
        rpts = np.concatenate([rpts, rp[:, -11:]], axis=1)
        pts = np.concatenate([vpts, rpts], axis=0)
        fg_points.append(np.concatenate(
            [pts, np.zeros((pts.shape[0], 1), pts.dtype)], axis=1))
        fg_real_pixels.append(rp[:, :3])
    return fg_pixels, fg_points, fg_real_pixels


def _pad(arrays, num_cams: int, cap: int, dim: int, site: str):
    """[V, cap, dim] zero-padded rows and their [V, cap] mask; rows past
    ``cap`` are dropped and counted at ``site``."""
    out = np.zeros((num_cams, cap, dim), np.float32)
    mask = np.zeros((num_cams, cap), bool)
    for cam, arr in enumerate(arrays[:num_cams]):
        n = min(len(arr), cap)
        if len(arr) > cap:
            overflow.record(site, len(arr) - cap)
        if n:
            out[cam, :n, :min(arr.shape[1], dim)] = \
                arr[:n, :dim].astype(np.float32)
            mask[cam, :n] = True
    return out, mask


def scene_gt(objects, max_gt: int = 32):
    """(gt_bboxes [max_gt, 9] bottom-centre (x, y, z, dx, dy, dz, yaw, vx,
    vy), gt_labels [max_gt] int32, gt_valid [max_gt]) of ``lidar_scene``'s
    objects, zero-padded."""
    boxes = np.zeros((max_gt, 9), np.float32)
    labels = np.zeros((max_gt,), np.int32)
    valid = np.zeros((max_gt,), bool)
    for gi, obj in enumerate(objects[:max_gt]):
        c, d = obj['center'], obj['dims']
        boxes[gi] = [c[0], c[1], c[2] - d[2] / 2, d[0], d[1], d[2],
                     obj['yaw'], 0.0, 0.0]
        labels[gi] = obj['label']
        valid[gi] = True
    return boxes, labels, valid


def realistic_batch(shape: Dict, b: int, seed: int = 0,
                    num_virtual: int = 200, return_gt: bool = False,
                    max_gt: int = 32) -> Dict:
    """The flagship's input batch: dict(points [B, N, 5], points_mask,
    img [B, V, H, W, 3], fg=dict(fg_pixels [B, V, M, 3], fg_points
    [B, V, M, 15], fg_mask, fg_real_pixels [B, V, Mr, 3], fg_real_mask,
    lidar2img [B, V, 4, 4])) as numpy arrays.

    shape: dict(n, v, m, mr, img_hw, pcr), the JAX package's
    ``_flagship_model`` shape contract. ``return_gt`` adds ``gt``:
    dict(gt_bboxes [B, max_gt, 9] bottom-centre (x, y, z, dx, dy, dz, yaw,
    vx, vy) of the scene's objects, gt_labels [B, max_gt] int32, gt_valid
    [B, max_gt]), zero-padded.
    """
    n, v, m, mr = shape['n'], shape['v'], shape['m'], shape['mr']
    img_hw = shape['img_hw']
    pcr = shape['pcr']
    rng = np.random.RandomState(seed)

    points = np.zeros((b, n, 5), np.float32)
    imgs = rng.randn(b, v, img_hw[0], img_hw[1], 3).astype(np.float32)
    fg_batches: List[Dict[str, np.ndarray]] = []
    l2i_batches = []
    gt_bboxes = np.zeros((b, max_gt, 9), np.float32)
    gt_labels = np.zeros((b, max_gt), np.int32)
    gt_valid = np.zeros((b, max_gt), bool)
    for bi in range(b):
        pts, objects = lidar_scene(rng, n, pcr)
        points[bi] = pts
        gt_bboxes[bi], gt_labels[bi], gt_valid[bi] = scene_gt(objects,
                                                              max_gt)
        l2i = camera_rig(img_hw, num_cams=v, seed=seed + 17 * bi)
        per_cam = [generate_camera_foreground(
            pts, np.asarray(l2i[ci], np.float64), img_hw,
            _instances_for_camera(objects, l2i[ci], img_hw),
            num_virtual=num_virtual, seed=seed + 31 * bi + ci)
            for ci in range(v)]
        pix, pts_fg, real_pix = _organize(*zip(*per_cam))
        fg_points, fg_mask = _pad(pts_fg, v, m, 15, 'foreground.points_cap')
        fg_pixels, _ = _pad(pix, v, m, 3, 'foreground.pixels_cap')
        fg_real, real_mask = _pad(real_pix, v, mr, 3,
                                  'foreground.real_pixels_cap')
        fg_batches.append(dict(fg_pixels=fg_pixels, fg_points=fg_points,
                               fg_mask=fg_mask, fg_real_pixels=fg_real,
                               fg_real_mask=real_mask))
        l2i_batches.append(l2i)
    fg = {k: np.stack([fb[k] for fb in fg_batches]) for k in fg_batches[0]}
    fg['lidar2img'] = np.stack(l2i_batches)
    batch = dict(points=points, points_mask=np.ones((b, n), bool), img=imgs,
                 fg=fg)
    if return_gt:
        batch['gt'] = dict(gt_bboxes=gt_bboxes, gt_labels=gt_labels,
                           gt_valid=gt_valid)
    return batch


def lc_batch(shape: Dict, b: int = 1, seed: int = 0,
             return_gt: bool = False, max_gt: int = 32,
             num_classes: int = 10, box_dim: int = 9) -> Dict:
    """TransFusion-LC inputs: dict(points [B, N, 5], points_mask, img
    [B, V, H, W, 3], metas=dict(lidar2img [B, V, 4, 4])) as numpy arrays.

    shape: dict(n, img_hw, pcr, yaws) (``LC_YAWS``: one camera a yaw).
    Each sample's points are ``lidar_scene``'s draw first from the seed's
    generator, so a one-sample batch's points are the TransFusion-L
    frame's of the same seed; the images (unit gaussian noise, as
    ``realistic_batch``'s) come after. ``return_gt`` adds ``gt`` as
    ``realistic_batch`` does, with labels below ``num_classes`` and the
    boxes' first ``box_dim`` columns (7 drops the velocity).
    """
    n, img_hw, pcr = shape['n'], shape['img_hw'], shape['pcr']
    yaws = shape['yaws']
    v = len(yaws)
    rng = np.random.RandomState(seed)
    points = np.zeros((b, n, 5), np.float32)
    gt_bboxes = np.zeros((b, max_gt, box_dim), np.float32)
    gt_labels = np.zeros((b, max_gt), np.int32)
    gt_valid = np.zeros((b, max_gt), bool)
    for bi in range(b):
        points[bi], objects = lidar_scene(rng, n, pcr)
        boxes, labels, gt_valid[bi] = scene_gt(objects, max_gt)
        gt_bboxes[bi] = boxes[:, :box_dim]
        gt_labels[bi] = labels % num_classes
    imgs = rng.randn(b, v, img_hw[0], img_hw[1], 3).astype(np.float32)
    lidar2img = np.stack([camera_rig(img_hw, v, seed + 17 * bi, yaws)
                          for bi in range(b)])
    batch = dict(points=points, points_mask=np.ones((b, n), bool), img=imgs,
                 metas=dict(lidar2img=lidar2img))
    if return_gt:
        batch['gt'] = dict(gt_bboxes=gt_bboxes, gt_labels=gt_labels,
                           gt_valid=gt_valid)
    return batch
