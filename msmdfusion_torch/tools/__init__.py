"""The port's command-line entry points (``python -m
msmdfusion_torch.tools.test`` and ``python -m msmdfusion_torch.tools.train``)
and what they share."""


def check_launcher(launcher: str) -> None:
    """Only single-process runs are ported: ``--launcher none``."""
    if launcher != 'none':
        raise NotImplementedError(
            f'--launcher {launcher}: distributed runs are not ported yet '
            '(ROADMAP.md, queue 1: DDP over NCCL); use --launcher none')
