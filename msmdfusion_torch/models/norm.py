"""Cross-replica batch normalization.

Counterpart of the JAX package's ``models/norm.py`` (reference
mmdet3d/ops/norm.py:10-133, ``NaiveSyncBatchNorm1d/2d``). The port's batch
norms (``layers.MaskedBatchNorm``, ``BatchNorm1d``, ``BatchNorm2d``) take
their training moments over every rank of the process group
(``layers.global_moments``), so synchronised batch norm is their default
behaviour, not an opt-in layer; these aliases keep configs written against
the reference names working.
"""
from .layers import BatchNorm1d, BatchNorm2d, MaskedBatchNorm

NaiveSyncBatchNorm1d = BatchNorm1d
NaiveSyncBatchNorm2d = BatchNorm2d

__all__ = ['MaskedBatchNorm', 'NaiveSyncBatchNorm1d', 'NaiveSyncBatchNorm2d']
