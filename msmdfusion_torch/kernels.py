"""Build and load the port's hand-written CUDA kernels.

Each kernel has a plain C entry point in a ``csrc/<source>.cu`` (one
source may hold several entry points; sources share device code through
``csrc/*.cuh`` headers). Each source is compiled by its own ``nvcc``
process for ``sm_90a`` into a shared library under
``msmdfusion_torch/_build/`` at first use (the processes of one ``build()``
run in parallel). The library file name carries a hash of the source, of
every header it includes and of the flags, so an edited source or header
is rebuilt. Libraries are loaded with ``ctypes``; pointer and stream
arguments are ``c_void_p``.

Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / 'csrc'
BUILD_DIR = _HERE / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P, _I = ctypes.c_void_p, ctypes.c_int
# source stem, C entry point and argument types of each kernel
ENTRY_POINTS = {
    'rows_affine': ('rows_affine', 'msmd_rows_affine',
                    (_P, _I, _P, _I, _P, _I, _P, _P, _P, _P)),
    'rows_queries': ('rows_affine', 'msmd_rows_queries',
                     (_P, _I, _P, _I, _I, _P, _P, _P, _P)),
    'gather_gemm_conv': ('gather_gemm_conv', 'msmd_gather_gemm_conv',
                         (_P, _I, _P, _I, _I, _P, _I, _I, _I, _I, _P, _P,
                          _I, _P, _P, _P)),
    'gather_gemm_conv_bf16': ('gather_gemm_conv_bf16',
                              'msmd_gather_gemm_conv_bf16',
                              (_P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I,
                               _I, _P, _P, _I, _P, _P, _P)),
    'gather_gemm_conv_x3': ('gather_gemm_conv_bf16',
                            'msmd_gather_gemm_conv_x3',
                            (_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                             _I, _P, _P, _I, _P, _P, _P)),
    'conv_dw': ('conv_dw', 'msmd_conv_dw',
                (_P, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                 _P)),
    'conv_dw_bf16': ('conv_dw_bf16', 'msmd_conv_dw_bf16',
                     (_P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P,
                      _P)),
    'conv_dw_x3': ('conv_dw_bf16', 'msmd_conv_dw_x3',
                   (_P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P,
                    _P)),
    'match_conv': ('match_conv', 'msmd_match_conv',
                   (_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I,
                    _I, _P, _P, _I, _P, _P, _P)),
    'match_conv_x3': ('match_conv', 'msmd_match_conv_x3',
                      (_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _I,
                       _I, _I, _I, _P, _P, _I, _P, _P, _P)),
    'match_conv_bf16': ('match_conv', 'msmd_match_conv_bf16',
                        (_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _I,
                         _I, _I, _I, _P, _P, _I, _P, _P, _P)),
    'masked_nn': ('masked_nn', 'msmd_masked_nn',
                  (_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P)),
    'merge_take': ('merge_take', 'msmd_merge_take',
                   (_P, _I, _I, _P, _P, _P, _I, _P, _I, _P)),
}

_LOADED: Dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home and os.path.isfile(os.path.join(home, 'bin', 'nvcc')):
            return os.path.join(home, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')
    return found


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_files(source: str):
    """``csrc/<source>.cu`` and every header it includes with quotes,
    recursively (paths relative to the including file)."""
    todo, files = [CSRC / f'{source}.cu'], []
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / name.decode()
                 for name in _INCLUDE.findall(path.read_bytes())]
    return files


def _lib_path(source: str) -> Path:
    digest = hashlib.sha256()
    for path in source_files(source):
        digest.update(path.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{source}_{digest.hexdigest()[:16]}.so'


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Tuple[float, str]]:
    """Compile the sources of the named kernels (default: all) that are
    not built yet.

    One nvcc process per source, all started together. Returns {source:
    (seconds, compiler log)} for the sources built by this call; raises
    with the compiler's output if any build fails.
    """
    names = list(ENTRY_POINTS if names is None else names)
    sources = sorted({ENTRY_POINTS[n][0] for n in names})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {s: _lib_path(s) for s in sources if not _lib_path(s).exists()}
    if not todo:
        return {}
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        cmd = [exe, *NVCC_FLAGS, '-o', tmp, str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    done, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'--- {name} (nvcc exit {proc.returncode})\n{log}')
            os.unlink(tmp)
            continue
        os.replace(tmp, out)    # atomic: a reader never sees half a file
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))
    return done


def entry_point(name: str):
    """The loaded C entry point of kernel ``name`` (built if needed)."""
    fn = _LOADED.get(name)
    if fn is None:
        build([name])
        source, symbol, argtypes = ENTRY_POINTS[name]
        lib = ctypes.CDLL(str(_lib_path(source)))
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _LOADED[name] = fn
    return fn


def check_tensor(name: str, t, dtype, ndim: int, device) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d ``dtype`` tensor on
    ``device``: what a kernel's C entry point takes."""
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f'{name}: expected {ndim}-d {dtype}, got '
                        f'{t.dim()}-d {t.dtype}')
    if t.device != device:
        raise ValueError(f'{name} on {t.device}, expected {device}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def check(name: str, status: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(
            f'CUDA kernel {name} failed to launch: cudaError_t {status}')


# launches of each kernel by its wrapper (plain-version runs not counted)
launches: Dict[str, int] = {name: 0 for name in ENTRY_POINTS}
_FORCE_PLAIN = [False]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


class plain_kernels:
    """Scope in which the wrappers run their plain PyTorch versions on CUDA
    tensors too: the yardstick that ``chip_smoke.py`` and the tests hold
    the kernels against. Outside it a CUDA tensor always goes to the
    kernel."""

    def __enter__(self):
        self._prev = _FORCE_PLAIN[0]
        _FORCE_PLAIN[0] = True
        return self

    def __exit__(self, *exc):
        _FORCE_PLAIN[0] = self._prev
        return False


def use_kernel(t) -> bool:
    """True when a tensor on ``t``'s device goes to the CUDA kernel: it
    lies on the card and no ``plain_kernels`` scope is open. A CPU tensor
    takes the plain version."""
    return t.is_cuda and not _FORCE_PLAIN[0]
