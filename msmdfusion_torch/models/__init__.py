"""Model registry population: importing this package registers every
ported module under its config ``type`` name."""
from .backbones import second  # noqa: F401
from .detectors import transfusion  # noqa: F401
from .heads import transfusion_head  # noqa: F401
from .middle_encoders import sparse_encoder  # noqa: F401
from .necks import second_fpn  # noqa: F401
from ..core import coders  # noqa: F401
