"""Datasets, pipelines and the loader: importing this package registers
every dataset and transform."""
from . import pipelines  # noqa: F401
from .custom_3d import CBGSDataset, Custom3DDataset
from .kitti import KittiDataset
from .loader import DataLoader, collate
from .nuscenes import NuScenesDataset
from .other_datasets import ScanNetDataset, SUNRGBDDataset, WaymoDataset

__all__ = ['CBGSDataset', 'Custom3DDataset', 'DataLoader', 'KittiDataset',
           'NuScenesDataset', 'ScanNetDataset', 'SUNRGBDDataset',
           'WaymoDataset', 'collate']
