"""The port's command-line entry points (``python -m
msmdfusion_torch.tools.test`` and ``python -m msmdfusion_torch.tools.train``;
``dist_test.sh`` and ``dist_train.sh`` start them under torchrun,
``slurm_test.sh`` and ``slurm_train.sh`` under SLURM's ``srun``; the data
tools ``create_data`` and ``generate_virtual_points``; the offline tools
``misc.{fuse_conv_bn,print_config,visualize_results}``,
``model_converters.publish_model`` and ``analysis_tools.{analyze_logs,
benchmark,conv_microbench,trace_summary}``) and what they share."""
import torch

from ..parallel.distributed import check_launcher  # noqa: F401


def full_fp32() -> None:
    """Full fp32 products on the card: TF32 off in cuDNN (whose default
    allows it) and in cuBLAS. The port's fp32 contract, under which every
    check of it runs; the same algorithms in every process, so that each
    rank of a group computes what one process does."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def add_device(parser, what: str = 'the tool\'s tensors') -> None:
    """``--device`` as every entry point of the port takes it: the card by
    default; without one the run stops unless ``--device cpu`` is given."""
    parser.add_argument('--device', default='cuda',
                        help=f'where {what} live (cuda, cuda:N or cpu; '
                             'default cuda, which stops without a card)')


def device_of(args) -> torch.device:
    """``args.device`` as a ``torch.device``; ``cuda`` with no card raises
    (``models.builder.resolve_device``)."""
    from ..models.builder import resolve_device
    return resolve_device(args.device)
