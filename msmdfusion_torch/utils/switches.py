"""The JAX package's environment switches that the port does not run yet.

Each is read at call time where the JAX package reads it. A value that
selects another path in the JAX package raises a ``ValueError`` that names
the switch, so that a run under such a switch never silently computes the
default's result instead (ROADMAP queue 1 item 4 ports them); a value the
JAX package reads as its default runs as the default does.
"""
from __future__ import annotations

import os

# name: (the JAX package's default, which values select another path
# there, what they select)
UNPORTED = {
    'MSMD_GMA_NN': ('approx', lambda v: v == 'exact',
                    'the exact-NN oracle for orphan gating, '
                    'gma_encoder.py:167'),
    'MSMD_GMA_DUMMY': ('learned', lambda v: v.startswith('random'),
                       'a fresh uniform dummy row per call, '
                       'gma_encoder.py:186'),
    'MSMD_FUSE_BN': ('1', lambda v: v == '0',
                     'the unfused eval-mode batch norm, matchconv.py:114'),
    'MSMD_SPARSE_BACKEND': ('auto', lambda v: v == 'xla',
                            'the XLA sparse backend, matchconv.py:72'),
}


def require_default(name: str) -> str:
    """The switch's value, which must not select another path than the
    default's."""
    default, departs, selects = UNPORTED[name]
    value = os.environ.get(name, default)
    if departs(value):
        raise ValueError(f'{name}={value!r} is not ported: it selects '
                         f'{selects} in the JAX package; only the default '
                         f'{default!r} path runs')
    return value
