"""Print a fully resolved config.

Counterpart of the JAX package's ``tools/misc/print_config.py`` (reference
tools/misc/print_config.py), on the port's ``config.load_config`` and
``parse_cli_overrides``: the same text, ``pprint`` of the merged dict.

    python -m msmdfusion_torch.tools.misc.print_config CONFIG \\
        [--cfg-options key=value ...] [--device cuda]

It reads files only; like every entry point of the port it stops on a
machine with no card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import pprint
from typing import List, Optional

from ...config import ConfigDict, load_config, parse_cli_overrides
from .. import add_device, device_of


def main(argv: Optional[List[str]] = None) -> ConfigDict:
    p = argparse.ArgumentParser(description='print a resolved config')
    p.add_argument('config')
    p.add_argument('--cfg-options', nargs='+', default=[])
    add_device(p, 'nothing (the tool reads files)')
    args = p.parse_args(argv)
    device_of(args)
    cfg = load_config(args.config, parse_cli_overrides(args.cfg_options))
    pprint.pprint(dict(cfg), width=100)
    return cfg


if __name__ == '__main__':
    main()
