"""Strip a training checkpoint for publishing.

Counterpart of the JAX package's ``tools/model_converters/publish_model.py``
(reference tools/model_converters/publish_model.py:1-34) on the port's
checkpoint files (``utils/checkpoint.py``): ``{state_dict, step, meta}``
without ``optimizer`` is written to ``<out>-<sha256[:8]>``, the first 8
hex digits of the SHA-256 of the written file (the JAX tool hashes the
orbax directory it writes). The published file is loaded back through
``load_checkpoint`` onto ``--device`` before its path is printed.

    python -m msmdfusion_torch.tools.model_converters.publish_model \\
        IN_FILE OUT [--device cuda]
"""
from __future__ import annotations

import argparse
import hashlib
import os
from typing import List, Optional

import torch

from ...utils.checkpoint import load_checkpoint
from .. import add_device, device_of


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, 'rb') as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest()


def process_checkpoint(in_file: str, out: str,
                       device: torch.device = torch.device('cpu')) -> str:
    """Publish ``in_file`` as ``<out>-<sha256[:8]>``; returns that path."""
    state = load_checkpoint(in_file)
    published = {k: v for k, v in state.items() if k != 'optimizer'}
    tmp = f'{out}.tmp'
    torch.save(published, tmp)
    final = f'{out}-{file_sha256(tmp)[:8]}'
    os.replace(tmp, final)
    loaded = torch.load(final, map_location=device, weights_only=True)
    if 'optimizer' in loaded or set(loaded['state_dict']) != \
            set(state['state_dict']):
        raise RuntimeError(f'{final} does not hold {in_file}\'s weights '
                           'alone')
    print(final)
    return final


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description='Publish a checkpoint')
    p.add_argument('in_file', help='the port\'s checkpoint file')
    p.add_argument('out', help='the published file\'s path, before the hash')
    add_device(p, 'the published file is loaded back')
    args = p.parse_args(argv)
    return process_checkpoint(args.in_file, args.out, device_of(args))


if __name__ == '__main__':
    main()
