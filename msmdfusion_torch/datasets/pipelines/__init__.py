"""Data pipelines: importing this package registers every transform."""
from . import (foreground, indoor, loading,  # noqa: F401
               test_time_aug, transforms_3d)
from .loading import Compose

__all__ = ['Compose']
