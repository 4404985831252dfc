from .voxel_encoder import (DynamicVFE, HardSimpleVFE, HardVFE,
                            PillarFeatureNet, hard_simple_vfe)

__all__ = ['DynamicVFE', 'HardSimpleVFE', 'HardVFE', 'PillarFeatureNet',
           'hard_simple_vfe']
