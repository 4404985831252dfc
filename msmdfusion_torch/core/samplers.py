"""Proposal samplers for two-stage RoI training.

Counterpart of the JAX package's ``core/samplers.py`` (reference
mmdet3d/core/bbox/samplers/iou_neg_piecewise_sampler.py:8-157 and mmdet's
PseudoSampler), the same numpy code: sampling runs on the host, on
variable-size proposal sets, from an explicit ``np.random.RandomState``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..registry import Registry

BBOX_SAMPLERS = Registry('bbox_sampler')


@dataclasses.dataclass
class SamplingResult:
    """Indices of sampled proposals (reference mmdet SamplingResult)."""
    pos_inds: np.ndarray
    neg_inds: np.ndarray
    pos_assigned_gt_inds: np.ndarray      # gt index per positive
    iou: Optional[np.ndarray] = None      # when return_iou (PartA2)

    @property
    def inds(self) -> np.ndarray:
        return np.concatenate([self.pos_inds, self.neg_inds])


@BBOX_SAMPLERS.register('PseudoSampler')
class PseudoSampler:
    """Keep every assigned proposal (what TransFusionHead uses,
    reference transfusion_head.py:789)."""

    def sample(self, gt_inds: np.ndarray, max_overlaps: np.ndarray,
               rng: Optional[np.random.RandomState] = None) -> SamplingResult:
        pos = np.nonzero(gt_inds > 0)[0]
        neg = np.nonzero(gt_inds == 0)[0]
        return SamplingResult(pos, neg, gt_inds[pos] - 1)


@BBOX_SAMPLERS.register('IoUNegPiecewiseSampler')
class IoUNegPiecewiseSampler:
    """IoU piece-wise negative sampling (reference :8-157).

    Negatives are partitioned by ``neg_iou_piece_thrs`` (upper bounds,
    descending); each piece contributes ``neg_piece_fractions`` of the
    expected negatives, with shortfalls rolled into the next piece and the
    last piece absorbing the remainder down to IoU 0.

    Works on an assignment encoded as the reference's AssignResult arrays:
    ``gt_inds`` ([P] int, 0 = negative, >0 = 1-based gt index, -1 =
    ignored) + ``max_overlaps`` ([P] float).
    """

    def __init__(self, num: int, pos_fraction: float,
                 neg_piece_fractions: Sequence[float],
                 neg_iou_piece_thrs: Sequence[float],
                 neg_pos_ub: float = -1, add_gt_as_proposals: bool = False,
                 return_iou: bool = False):
        assert len(neg_piece_fractions) == len(neg_iou_piece_thrs)
        self.num = int(num)
        self.pos_fraction = float(pos_fraction)
        self.neg_piece_fractions = list(neg_piece_fractions)
        self.neg_iou_thr = list(neg_iou_piece_thrs)
        self.neg_pos_ub = neg_pos_ub
        self.add_gt_as_proposals = add_gt_as_proposals
        self.return_iou = return_iou
        self.neg_piece_num = len(self.neg_piece_fractions)

    @staticmethod
    def _choice(rng, inds: np.ndarray, n: int) -> np.ndarray:
        return rng.choice(inds, n, replace=False) if len(inds) > n else inds

    def _sample_neg(self, rng, neg_inds: np.ndarray,
                    max_overlaps: np.ndarray, num_expected: int) -> np.ndarray:
        if len(neg_inds) <= num_expected:
            return neg_inds
        ovl = max_overlaps[neg_inds]
        choice: List[np.ndarray] = []
        chosen = 0
        extend = 0
        for p in range(self.neg_piece_num):
            if p == self.neg_piece_num - 1:
                expected = num_expected - chosen
                min_thr = 0.0
            else:
                expected = int(
                    num_expected * self.neg_piece_fractions[p]) + extend
                min_thr = self.neg_iou_thr[p + 1]
            max_thr = self.neg_iou_thr[p]
            piece = np.nonzero((ovl >= min_thr) & (ovl < max_thr))[0]
            if len(piece) < expected:
                choice.append(neg_inds[piece])
                chosen += len(piece)
                extend = expected - len(piece)
            else:
                picked = self._choice(rng, piece, expected)
                choice.append(neg_inds[picked])
                chosen += expected
                extend = 0
        return (np.concatenate(choice) if choice
                else np.zeros((0,), np.int64))

    def sample(self, gt_inds: np.ndarray, max_overlaps: np.ndarray,
               rng: Optional[np.random.RandomState] = None) -> SamplingResult:
        rng = rng or np.random
        gt_inds = np.asarray(gt_inds)
        max_overlaps = np.asarray(max_overlaps)
        pos_inds = np.nonzero(gt_inds > 0)[0]
        num_expected_pos = int(self.num * self.pos_fraction)
        if len(pos_inds) > num_expected_pos:
            pos_inds = self._choice(rng, pos_inds, num_expected_pos)
        num_expected_neg = self.num - len(pos_inds)
        if self.neg_pos_ub >= 0:
            num_expected_neg = min(
                num_expected_neg, int(self.neg_pos_ub * max(1, len(pos_inds))))
        neg_inds = self._sample_neg(rng, np.nonzero(gt_inds == 0)[0],
                                    max_overlaps, num_expected_neg)
        result = SamplingResult(np.sort(pos_inds), neg_inds,
                                gt_inds[np.sort(pos_inds)] - 1)
        if self.return_iou:
            result.iou = max_overlaps[result.inds]
        return result
