"""Data pipelines: importing this package registers every transform."""
from . import foreground, loading, transforms_3d  # noqa: F401
from .loading import Compose

__all__ = ['Compose']
