"""Synthetic nuScenes-like LiDAR frames (numpy only).

Private copy of ``lidar_scene`` from the JAX package's
``utils/synth_scene.py``: a spinning 32-beam model with ground rings, walls
with 1/r^2 return density and car-sized object clusters, accumulated over
10 sweeps. The same seed gives the same points as the JAX package's copy.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


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
