"""Point sampling and neighbourhood ops, point-in-box tests and RoI-aware
pooling.

Counterpart of the JAX package's ``ops/sampling.py`` (reference
mmdet3d/ops/{furthest_point_sample,knn,ball_query,group_points,
interpolate,roiaware_pool3d}). The point ops are batched over a leading
B where the JAX functions take one sample; each sample's result is
exactly the per-sample one:

- ``square_distance``: the JAX function's quadratic expansion
  ``|a|^2 + |b|^2 - 2ab`` (a float32 product, TF32 off), clamped at 0;
  ``knn``, ``ball_query`` and ``three_nn`` read it;
- ``furthest_point_sample`` (D-FPS) and ``combined_fps`` (3DSSD's F-FPS,
  xyz plus a feature metric): one loop over the samples to draw, all B
  at once, in the JAX loop's difference form ``sum((xyz - xyz[cur])^2)``,
  each step taking the first farthest point (``argmax``'s first, as
  ``jnp.argmax``); the loop runs on the host and never synchronises;
- ``knn``/``three_nn`` and ``ball_query`` take the nearest by
  ``topk_lower_index``: equal distances (duplicated points) in
  ``jax.lax.top_k``'s order, the lower index first. An empty ball gives
  -1 slots; a ball with fewer points than slots repeats its nearest;
- ``gather_points``, ``group_points`` (the -1 slots zeroed) and
  ``three_interpolate``.

Each point-in-box test moves the points into each box's frame; RoI-aware
pooling buckets them into the box's (ox, oy, oz) grid and reduces per
cell by a max or a mean (a fixed-order segment sum, so two runs agree bit
for bit). All boxes go through one reduction (in chunks of boxes that
bound the [boxes, points, C] intermediate), with no loop over single
boxes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.boxes import box_frame, points_in_rbbox
from ..core.coders import topk_lower_index
from .voxelize import segment_sum

# elements of the [boxes, points, C] intermediate a chunk of boxes holds
POOL_ELEMENTS = 2 ** 26
# the distance of an invalid or out-of-radius point (JAX ``BIG``)
BIG = 1e10


def square_distance(src, dst):
    """[..., N, 3] x [..., M, 3] -> [..., N, M] squared distances by the
    quadratic expansion (the JAX function's form; ``torch.cdist`` picks
    its own), clamped at 0."""
    prod = torch.matmul(src, dst.transpose(-1, -2))
    d = (src * src).sum(-1)[..., :, None] + \
        (dst * dst).sum(-1)[..., None, :] - 2.0 * prod
    return torch.clamp(d, min=0.0)


def _fps(xyz, num_samples: int, valid, metric):
    """The FPS loop over [B, N] points: ``metric(i)`` gives each point's
    distance [B, N] to the current points ``i`` [B]. The invalid points
    start at -BIG and stay there (every distance is >= 0)."""
    b, n = xyz.shape[:2]
    if valid is None:
        valid = torch.ones(b, n, dtype=torch.bool, device=xyz.device)
    dist = torch.where(valid, BIG, -BIG).to(xyz.dtype)
    current = torch.argmax(valid.to(torch.uint8), -1)       # first valid
    out = []
    for _ in range(num_samples):
        out.append(current)
        dist = torch.minimum(dist, metric(current))
        current = torch.argmax(dist, -1)
    return torch.stack(out, -1)


def _rows(x, i):
    """x [B, N, C], i [B] -> [B, 1, C]: each sample's row ``i``."""
    return torch.gather(x, 1, i[:, None, None].expand(-1, 1, x.shape[-1]))


def furthest_point_sample(xyz, num_samples: int, valid=None):
    """Iterative farthest-point sampling of xyz [B, N, 3] (valid [B, N]):
    [B, num_samples] int64 indices, from each sample's first valid point
    (repeats where it has fewer valid points)."""
    def metric(i):
        return ((xyz - _rows(xyz, i)) ** 2).sum(-1)
    return _fps(xyz, num_samples, valid, metric)


def combined_fps(xyz, features, num_samples: int, valid=None,
                 feature_weight: float = 1.0):
    """F-FPS: farthest-point sampling in ``|dxyz|^2 + w |dfeat|^2 / C``
    (reference points_sampler.py, the 3DSSD candidates); ``features``
    None is D-FPS. xyz [B, N, 3], features [B, N, C] -> [B, num_samples]
    int64."""
    if features is None:
        return furthest_point_sample(xyz, num_samples, valid)
    c = features.shape[-1]

    def metric(i):
        d_xyz = ((xyz - _rows(xyz, i)) ** 2).sum(-1)
        d_feat = ((features - _rows(features, i)) ** 2).sum(-1) / c
        return d_xyz + feature_weight * d_feat
    return _fps(xyz, num_samples, valid, metric)


def knn(query, key, k: int, key_valid=None):
    """The k nearest keys of each query: query [B, Nq, 3], key [B, Nk, 3]
    -> (squared distances [B, Nq, k], indices [B, Nq, k] int64), equal
    distances lower index first; invalid keys at ``BIG``."""
    d = square_distance(query, key)
    if key_valid is not None:
        d = torch.where(key_valid[:, None, :], d, BIG)
    neg, idx = topk_lower_index(-d, k)
    return -neg, idx


def three_nn(query, key, key_valid=None):
    """The 3 nearest keys (reference three_nn)."""
    return knn(query, key, 3, key_valid)


def ball_query(radius: float, num_samples: int, xyz, centers,
               xyz_valid=None):
    """Up to ``num_samples`` points of xyz [B, N, 3] within ``radius`` of
    each centre [B, M, 3], nearest first: [B, M, num_samples] int64. Empty
    slots repeat the nearest in-radius point (ball_query_cuda.cu); a ball
    with none gives -1."""
    d = square_distance(centers, xyz)
    if xyz_valid is not None:
        d = torch.where(xyz_valid[:, None, :], d, BIG)
    masked = torch.where(d <= radius * radius, d, BIG)
    neg, idx = topk_lower_index(-masked, num_samples)
    found = -neg < BIG / 2
    first = idx[..., :1]
    return torch.where(found, idx, torch.where(found[..., :1], first, -1))


def gather_points(points, idx):
    """points [B, N, C], idx [B, ...] -> [B, ..., C] (a -1 reads row 0)."""
    b, n, c = points.shape
    flat = idx.clamp(min=0).reshape(b, -1) + \
        torch.arange(b, device=idx.device)[:, None] * n
    return points.reshape(b * n, c).index_select(0, flat.reshape(-1)) \
        .reshape(*idx.shape, c)


def group_points(points, idx):
    """points [B, N, C], idx [B, M, S] -> [B, M, S, C], -1 slots zeroed."""
    return torch.where((idx >= 0)[..., None], gather_points(points, idx),
                       0.0)


def three_interpolate(feats, idx, dist2, eps: float = 1e-8):
    """Inverse-distance weights over the 3 neighbours: feats [B, M, C],
    idx and dist2 [B, N, 3] -> [B, N, C]."""
    w = 1.0 / (dist2 + eps)
    w = w / w.sum(-1, keepdim=True)
    return (gather_points(feats, idx) * w[..., None]).sum(-2)


def points_in_boxes_batch(points, boxes):
    """points [B, P, 3+], boxes [B, N, 7] -> [B, P, N] bool."""
    return torch.stack([points_in_rbbox(p, b) for p, b in zip(points, boxes)])


def _cells(points, boxes, out_size):
    """Each point's cell in each box's grid, [N, P] int64, the spare cell
    ``ox*oy*oz`` where the point lies outside the box. The cell index is
    truncated to int32 before its clip, as the JAX function's."""
    ox, oy, oz = out_size
    (lx, ly, lz), inside = box_frame(points, boxes)           # [P, N]
    w, l, h = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    ix = torch.clamp(((lx / w + 0.5) * ox).to(torch.int32), 0, ox - 1)
    iy = torch.clamp(((ly / l + 0.5) * oy).to(torch.int32), 0, oy - 1)
    iz = torch.clamp((lz / h * oz).to(torch.int32), 0, oz - 1)
    cell = (ix.to(torch.int64) * oy + iy) * oz + iz
    return torch.where(inside, cell, ox * oy * oz).T, inside.T


def roiaware_pool3d(points, feats, boxes, out_size: Tuple[int, int, int],
                    mode: str = 'max'):
    """points [P, 3], feats [P, C], boxes [N, 7] -> [N, ox, oy, oz, C]: per
    box and cell the max (``'max'``; an empty cell 0) or the mean
    (``'avg'``, the sum over max(count, 1)) of the features of the points
    in that cell."""
    if mode not in ('max', 'avg'):
        raise ValueError(f'roiaware_pool3d mode {mode!r}')
    n, c = boxes.shape[0], feats.shape[-1]
    ox, oy, oz = out_size
    cells = ox * oy * oz + 1
    chunk = max(1, POOL_ELEMENTS // max(points.shape[0] * c, 1))
    outs = []
    for start in range(0, n, chunk):
        part = boxes[start:start + chunk]
        m = part.shape[0]
        cell, inside = _cells(points, part, out_size)
        index = (cell + torch.arange(m, device=cell.device)[:, None] * cells
                 ).reshape(-1)
        src = feats[None].expand(m, -1, -1)
        if mode == 'max':
            src = torch.where(inside[..., None], src, float('-inf'))
            out = feats.new_full((m * cells, c), float('-inf'))
            out = out.scatter_reduce(0, index[:, None].expand(-1, c),
                                     src.reshape(-1, c), 'amax')
            out = torch.where(torch.isfinite(out), out, 0.0)
        else:
            # a fixed-order sum per cell (no float atomics: two runs give
            # the same bits), the points outside every cell parked
            key = torch.where(inside.reshape(-1), index, m * cells)
            key, order = torch.sort(key, stable=True)
            out = segment_sum(src.reshape(-1, c).index_select(0, order),
                              key, m * cells)
            bounds = torch.searchsorted(
                key, torch.arange(m * cells + 1, device=key.device))
            cnt = (bounds[1:] - bounds[:-1]).to(feats.dtype)
            out = out / torch.clamp(cnt[:, None], min=1)
        outs.append(out.reshape(m, cells, c)[:, :-1])
    return torch.cat(outs).reshape(n, ox, oy, oz, c)
