"""Fixed-capacity sparse voxel tensor with the sorted-key invariant.

Counterpart of the JAX package's ``ops/sparse/tensor.py``. A
``SparseTensor`` holds

    features [K, C]   zero rows for empty slots
    coords   [K, 4]   int32 (b, z, y, x); -1 rows for empty slots
    valid    [K]      bool row mask
    keys     [K]      int32 packed key ((b*Z + z)*Y + y)*X + x, INT_MAX
                      on empty slots

with rows in ascending key order and the empty rows at the end. The sorted
key array is the hash table: a neighbour lookup is a binary search, and the
coordinate-set operations (``sparse_add``'s union, ``lookup_sorted_pair``'s
intersection) are sorts and binary searches.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ...utils import overflow
from .merge_take import merge_take_rows

INT_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    features: torch.Tensor   # [K, C]
    coords: torch.Tensor     # [K, 4] (b, z, y, x), -1 when invalid
    valid: torch.Tensor      # [K] bool
    keys: torch.Tensor       # [K] int32, INT_MAX when invalid
    spatial_shape: Tuple[int, int, int]
    batch_size: int

    @property
    def capacity(self) -> int:
        return self.features.shape[0]

    @property
    def num_channels(self) -> int:
        return self.features.shape[1]

    def replace_features(self, features) -> 'SparseTensor':
        return dataclasses.replace(self, features=features)


def pack_keys(coords, spatial_shape: Tuple[int, int, int], batch_size: int,
              valid=None) -> torch.Tensor:
    """Pack (b, z, y, x) coords into sortable int32 keys."""
    z, y, x = spatial_shape
    if batch_size * z * y * x >= 2 ** 31:
        raise ValueError(
            f'key space too large for int32: {batch_size}x{z}x{y}x{x}')
    c = coords.to(torch.int64)
    key = ((c[:, 0] * z + c[:, 1]) * y + c[:, 2]) * x + c[:, 3]
    if valid is not None:
        key = torch.where(valid, key, INT_MAX)
    return key.to(torch.int32)


def unpack_keys(keys, spatial_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Inverse of pack_keys -> [K, 4] int32 coords (garbage for INT_MAX)."""
    z, y, x = spatial_shape
    k = keys.to(torch.int64)
    xc = k % x
    rest = k // x
    yc = rest % y
    rest = rest // y
    zc = rest % z
    bc = rest // z
    return torch.stack([bc, zc, yc, xc], dim=-1).to(torch.int32)


def make_sparse_tensor(features, coords, valid,
                       spatial_shape: Tuple[int, int, int], batch_size: int,
                       assume_sorted: bool = False, capacity: int = None,
                       site: str = '') -> SparseTensor:
    """Build a SparseTensor, establishing the sorted-key invariant.

    ``assume_sorted``: rows already ascend in key (the fused voxelizer's
    output order), so no sort runs. ``capacity``: keep only the first
    ``capacity`` rows after the sort, i.e. drop the largest keys, counted
    at ``sparse.make.capacity[site]``.
    """
    keys = pack_keys(coords, spatial_shape, batch_size, valid)
    if not assume_sorted:
        keys, order = torch.sort(keys, stable=True)
        valid = keys != INT_MAX
        if site:
            overflow.gauge(f'occ.make[{site}]', valid.sum())
        if capacity is not None and capacity < keys.shape[0]:
            tag = f'[{site}]' if site else ''
            overflow.record(f'sparse.make.capacity{tag}',
                            valid[capacity:].sum())
            keys = keys[:capacity]
            order = order[:capacity]
            valid = valid[:capacity]
        features = features[order]
        coords = unpack_keys(torch.where(valid, keys, 0), spatial_shape)
    features = torch.where(valid[:, None], features, 0)
    coords = torch.where(valid[:, None], coords.to(torch.int32), -1)
    return SparseTensor(features=features, coords=coords, valid=valid,
                        keys=keys, spatial_shape=tuple(spatial_shape),
                        batch_size=batch_size)


def sparse_add(a: SparseTensor, b: SparseTensor,
               capacity: int) -> SparseTensor:
    """Coordinate-union elementwise add of two sparse tensors (spconv's
    ``Fsp.sparse_add``), ``capacity`` output rows.

    The union keeps the smallest keys; rows past ``capacity`` are counted
    at ``sparse.sparse_add.union_cap``. Each input's valid keys must be
    unique (the sorted-key invariant), so every output row is one input
    row or the sum of two adjacent rows of the stable key sort; kernel
    ``merge_take`` gathers (and adds) them.
    """
    if a.spatial_shape != b.spatial_shape or \
            a.num_channels != b.num_channels:
        raise ValueError('sparse_add: spatial shapes and widths must match')
    n = a.capacity + b.capacity
    if capacity > n:
        raise ValueError(f'sparse_add capacity {capacity} exceeds input row '
                         f'budget {a.capacity}+{b.capacity}')
    keys = torch.cat([a.keys, b.keys])
    feats = torch.cat([a.features, b.features])
    skey, order = torch.sort(keys, stable=True)
    svalid = skey != INT_MAX
    head = torch.cat([svalid[:1], (skey[1:] != skey[:-1]) & svalid[1:]])
    n_head = head.sum()
    overflow.record('sparse.sparse_add.union_cap',
                    torch.clamp(n_head - capacity, min=0))
    overflow.gauge('occ.sparse_add_union', n_head)
    # sorted positions of the group heads (n past the last one)
    iota = torch.arange(n, device=keys.device)
    hp = torch.sort(torch.where(head, iota, n)).values[:capacity]
    out_valid = hp < n
    here = torch.clamp(hp, max=n - 1)
    nxt = torch.clamp(hp + 1, max=n - 1)
    out_keys = torch.where(out_valid, skey[here], INT_MAX)
    dup = out_valid & (hp + 1 < n) & (skey[nxt] == skey[here])
    idx0 = torch.where(out_valid, order[here], INT_MAX).to(torch.int32)
    idx1 = order[nxt].to(torch.int32)
    merged = merge_take_rows(feats, idx0, idx1, dup, site='sparse_add')
    coords = unpack_keys(torch.where(out_valid, out_keys, 0),
                         a.spatial_shape)
    return SparseTensor(
        features=torch.where(out_valid[:, None], merged, 0.0),
        coords=torch.where(out_valid[:, None], coords, -1),
        valid=out_valid, keys=out_keys, spatial_shape=a.spatial_shape,
        batch_size=max(a.batch_size, b.batch_size))


def lookup_sorted_pair(a_keys, b_keys):
    """Mutual row lookup between two sorted key arrays with unique valid
    keys: (row in b of each a key, row in a of each b key), -1 where the
    key is absent or INT_MAX. Two binary searches over the sorted-key
    invariant."""
    def find(keys, queries):
        pos = torch.searchsorted(keys, queries)
        pos = torch.clamp(pos, max=keys.shape[0] - 1)
        hit = (keys[pos] == queries) & (queries != INT_MAX)
        return torch.where(hit, pos, -1).to(torch.int32)
    return find(b_keys, a_keys), find(a_keys, b_keys)


def to_dense_bev(st: SparseTensor) -> torch.Tensor:
    """Densify to a channels-last BEV map [B, H, W, C*D].

    Channel index c*D + d, as the reference's ``dense(); view(N, C*D, H,
    W)`` collapse; the layout is the JAX package's NHWC.
    """
    d, h, w = st.spatial_shape
    b = st.batch_size
    c = st.num_channels
    n = b * d * h * w
    co = st.coords.to(torch.int64)
    flat = (co[:, 0] * d + co[:, 1]) * (h * w) + co[:, 2] * w + co[:, 3]
    # invalid rows park on one spare row past the end, dropped below
    flat = torch.where(st.valid, flat, n)
    dense = st.features.new_zeros((n + 1, c))
    dense.index_copy_(0, flat, st.features)
    dense = dense[:n].reshape(b, d, h, w, c)
    return dense.permute(0, 2, 3, 4, 1).reshape(b, h, w, c * d)
