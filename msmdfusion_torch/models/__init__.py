"""Model registry population: importing this package registers every
ported module under its config ``type`` name."""
from .backbones import resnet, second  # noqa: F401
from .detectors import msmdfusion, transfusion, voxelnet  # noqa: F401
from .heads import (anchor3d_head, centerpoint_head,  # noqa: F401
                    free_anchor3d_head, transfusion_head)
from .middle_encoders import (gma_encoder, pillar_scatter,  # noqa: F401
                              sparse_encoder)
from .necks import fpn, second_fpn  # noqa: F401
from .voxel_encoders import voxel_encoder  # noqa: F401
from ..core import anchors, coders  # noqa: F401
