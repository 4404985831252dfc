"""Inference API: batch inputs, batch inference, init_detector and
inference_detector.

Counterpart of the JAX package's ``apis/inference.py`` (reference
mmdet3d/apis/inference.py:30-135): build the model from a config, load a
checkpoint, run the test pipeline and the detector, return the masked
detections as numpy arrays.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# the test-pipeline transforms of the camera branch, left out where
# ``inference_detector`` is given no images
_CAMERA_TRANSFORMS = (
    'LoadMultiViewImageFromFiles', 'LoadForeground2D',
    'LoadForeground2DFromMultiSweeps', 'GlobalRotTransFilterForeground2D',
    'MyResize', 'ImageResize', 'MyNormalize', 'ImageNormalize', 'MyPad',
    'ImagePad', 'ImgScaleCropFlipForeground2D', 'PadForeground2D')


def unpack_detections(res: Dict[str, torch.Tensor]) -> List[Dict]:
    """Detection dict of batch tensors -> per-sample masked numpy dicts
    (``bboxes``, ``scores``, ``labels``): the reference returns
    variable-length box lists, here the validity masks carry that. The
    boxes are under ``bboxes`` (TransFusion, CenterPoint) or ``boxes``
    (the anchor heads' multi-class NMS)."""
    res = {k: v.cpu().numpy() for k, v in res.items()}
    boxes = res['bboxes'] if 'bboxes' in res else res['boxes']
    out = []
    for i in range(boxes.shape[0]):
        valid = res['valid'][i] if 'valid' in res else \
            np.ones(boxes.shape[1], bool)
        out.append(dict(bboxes=boxes[i][valid], scores=res['scores'][i][valid],
                        labels=res['labels'][i][valid]))
    return out


def refuse_cli_model(model_type: str, model=None) -> None:
    """Raise for a model the CLIs cannot run, gaps the JAX package's tools
    share: ``PartA2``, whose decode gives no labels, an
    ``MVXFasterRCNN`` with a fusion layer, whose middle encoder reads the
    image fusion's channels while the CLIs pass points alone (as the JAX
    tools do for every model but the flagship), and ``ImVoteNet``, whose
    head reads the image cues' channels for the same reason."""
    if model_type == 'ImVoteNet':
        raise NotImplementedError(
            'ImVoteNet through the CLIs: they pass points alone, and its '
            'VoteHead reads the image cues\' 128 channels beside the seed '
            'features (the JAX tools cannot run it from files either)')
    if model_type == 'PartA2':
        raise NotImplementedError(
            'PartA2 through the CLIs: its get_bboxes returns bboxes, scores '
            'and valid and no labels (as the JAX detector\'s), which '
            'unpack_detections reads; the JAX eval CLI cannot run it either')
    if model_type == 'MVXFasterRCNN' and \
            getattr(model, 'pts_fusion_layer', None) is not None:
        raise NotImplementedError(
            'MVXFasterRCNN with a fusion layer through the CLIs: they pass '
            'points alone, and its weights read the image fusion\'s '
            'channels (the JAX tools cannot run it from files either)')


def batch_model_inputs(model_type: str, batch, device) -> tuple:
    """The model's positional inputs from a collated batch, on ``device``:
    (points, points_mask, img, foreground) for the flagship, (points,
    points_mask) for every other model (as the JAX tools pass them);
    ``PartA2`` raises (``refuse_cli_model``)."""
    refuse_cli_model(model_type)

    def on(x):
        return x.to(device, non_blocking=True)
    inputs = (on(batch['points']), on(batch['points_mask']))
    if model_type == 'MSMDFusionDetector':
        inputs += (on(batch['img']),
                   {k: on(v) for k, v in batch['foreground'].items()})
    return inputs


def make_batch_infer(model: torch.nn.Module, model_type: str):
    """batch -> per-sample detections: the model in eval mode under
    ``torch.inference_mode``, its ``get_bboxes``, ``unpack_detections``
    (``refuse_cli_model``'s models raise here)."""
    refuse_cli_model(model_type, model)
    device = next(model.parameters()).device

    def infer(batch) -> List[Dict]:
        model.eval()
        with torch.inference_mode():
            preds = model(*batch_model_inputs(model_type, batch, device))
            return unpack_detections(model.get_bboxes(preds))
    return infer


def init_detector(config, checkpoint: Optional[str] = None,
                  device='cuda', seed: int = 0):
    """(model, config) from a config path or dict: the detector on
    ``device`` with weights drawn from ``seed``, then ``checkpoint``'s
    where one is given (``utils.checkpoint.load_checkpoint``)."""
    import msmdfusion_torch.models  # noqa: F401  (registers the modules)
    from ..config import load_config
    from ..models.builder import build_detector
    from ..utils.checkpoint import load_checkpoint

    if isinstance(config, str):
        config = load_config(config)
    model = build_detector(config.model, device=device, seed=seed)
    if checkpoint:
        load_checkpoint(checkpoint, model)
    return model, config


def inference_detector(model, cfg, pcd_path: str,
                       img_paths: Optional[Sequence[str]] = None,
                       lidar2img: Optional[np.ndarray] = None) -> Dict:
    """Single-sample inference on a point cloud file, through the config's
    test pipeline. For the flagship pass the camera image paths and
    lidar2img [V, 4, 4]: the whole test pipeline (images, foreground
    artifacts, padding) then runs, as the reference's inference_detector
    builds it from cfg.data.test (apis/inference.py:64-107)."""
    import msmdfusion_torch.datasets  # noqa: F401  (registers transforms)
    from ..datasets.loader import collate
    from ..datasets.pipelines.loading import Compose

    multimodal = img_paths is not None
    skip = () if multimodal else _CAMERA_TRANSFORMS
    pipeline = Compose([t for t in cfg.data.test.pipeline
                        if t['type'] not in skip])
    sample = {'pts_filename': pcd_path, 'sweeps': [], 'timestamp': 0}
    if multimodal:
        sample['img_filename'] = list(img_paths)
        sample['lidar2img'] = (np.asarray(lidar2img, np.float32)
                               if lidar2img is not None else
                               np.tile(np.eye(4, dtype=np.float32),
                                       (len(img_paths), 1, 1)))
    det = make_batch_infer(model, cfg.model.type)(
        collate([pipeline(sample)]))[0]
    return dict(boxes_3d=det['bboxes'], scores_3d=det['scores'],
                labels_3d=det['labels'])
