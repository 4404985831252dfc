"""The generic MVX detector name and test-time augmentation over any
detector.

Counterpart of the JAX package's ``models/detectors/mvx_two_stage.py``
(reference mmdet3d/models/detectors/mvx_two_stage.py:18-541 and
base.py:14-43): ``MVXTwoStageDetector`` registers the generic name on the
TransFusion detector (the plain voxelize -> encode -> BEV -> head flow,
with the optional camera branch); ``aug_test_detector`` runs a detector's
``simple_test`` on each augmented view and merges the views' boxes
(``merge_aug_bboxes_3d``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ...registry import DETECTORS
from .transfusion import TransFusionDetector


@DETECTORS.register('MVXTwoStageDetector')
class MVXTwoStageDetector(TransFusionDetector):
    """The reference's generic assembly under its own name."""


def aug_test_detector(model, aug_inputs: List[Dict],
                      max_boxes: Optional[int] = None) -> Dict:
    """``model.simple_test`` on each view, merged (the reference's
    ``aug_test``, batch size 1).

    aug_inputs: one dict per view, {'points': [1, N, D], 'points_mask':
    [1, N], 'aug': dict(scale, flip_h, flip_v)} (``MultiScaleFlipAug3D``'s
    record). Returns the merged numpy dict (bboxes, scores, labels)."""
    from ...datasets.pipelines.test_time_aug import merge_aug_bboxes_3d
    aug_results, aug_states = [], []
    for view in aug_inputs:
        with torch.no_grad():
            res = model.simple_test(view['points'], view['points_mask'])
        res = {k: v.cpu().numpy() for k, v in res.items()}
        out = dict(bboxes=res['bboxes' if 'bboxes' in res else 'boxes'][0],
                   scores=res['scores'][0], labels=res['labels'][0])
        if 'valid' in res:
            keep = res['valid'][0].astype(bool)
            out = {k: v[keep] for k, v in out.items()}
        aug_results.append(out)
        aug_states.append(dict(view.get('aug', {})))
    return merge_aug_bboxes_3d(aug_results, aug_states,
                               max_num=max_boxes or 500)
