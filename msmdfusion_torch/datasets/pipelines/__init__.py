"""Data pipelines: importing this package registers every transform."""
from . import (foreground, loading, test_time_aug,  # noqa: F401
               transforms_3d)
from .loading import Compose

__all__ = ['Compose']
