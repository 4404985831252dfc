"""Model registry population: importing this package registers every
ported module under its config ``type`` name."""
from .backbones import pointnet2, resnet, second  # noqa: F401
from . import fusion_layers  # noqa: F401
from .detectors import (indoor_zoo, msmdfusion, mvx_two_stage,  # noqa: F401
                        parta2, transfusion, votenet, voxelnet)
from .heads import (anchor3d_head, centerpoint_head,  # noqa: F401
                    free_anchor3d_head, h3d_heads, parta2_roi_head,
                    parta2_rpn_head, shape_aware_head, ssd3d_head,
                    transfusion_head, vote_head)
from .middle_encoders import (gma_encoder, pillar_scatter,  # noqa: F401
                              sparse_encoder, sparse_unet)
from .necks import extra_necks, fpn, second_fpn  # noqa: F401
from .voxel_encoders import voxel_encoder  # noqa: F401
from ..core import anchors, coders  # noqa: F401
