"""Model registry population: importing this package registers every
ported module under its config ``type`` name."""
from .backbones import resnet, second  # noqa: F401
from .detectors import msmdfusion, transfusion  # noqa: F401
from .heads import transfusion_head  # noqa: F401
from .middle_encoders import gma_encoder, sparse_encoder  # noqa: F401
from .necks import fpn, second_fpn  # noqa: F401
from ..core import coders  # noqa: F401
