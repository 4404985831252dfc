"""The port's command-line entry points (``python -m
msmdfusion_torch.tools.test`` and ``python -m msmdfusion_torch.tools.train``;
``dist_test.sh`` and ``dist_train.sh`` start them under torchrun; the data
tools ``create_data`` and ``generate_virtual_points``) and what they
share."""
import torch

from ..parallel.distributed import check_launcher  # noqa: F401


def full_fp32() -> None:
    """Full fp32 products on the card: TF32 off in cuDNN (whose default
    allows it) and in cuBLAS. The port's fp32 contract, under which every
    check of it runs; the same algorithms in every process, so that each
    rank of a group computes what one process does."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
