"""Build and load the port's CUDA kernels.

Each source under `csrc/` is compiled by nvcc for sm_90a into a shared
library with a plain C interface, loaded with ctypes.  Libraries go to
`build/blom_tpu_torch/` under the repository root, named by a hash of
the source, the headers under `csrc/` and the flags, so an edited source
or header is rebuilt.  Nothing is
compiled or loaded at import; `build_all` compiles every source in
parallel (one nvcc process each) and `library` loads one, building it
first if needed."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / 'build' / 'blom_tpu_torch'
SOURCES = ('cppm_sweep', 'momtum_uv', 'ale_regrid', 'ale_remap')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')

_loaded: dict = {}
build_info: dict = {}   # name -> {'seconds': ..., 'ptxas': ...}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 '/usr/local/cuda/bin/nvcc', shutil.which('nvcc') or ''):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _target(name: str) -> Path:
    csrc = PACKAGE_DIR / 'csrc'
    src = (csrc / f'{name}.cu').read_bytes()
    src += b''.join(h.read_bytes() for h in sorted(csrc.glob('*.cuh')))
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}-{digest[:16]}.so'


def build_all(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, all at once;
    raise if any fails.  Returns build_info."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists() and name in build_info:
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp),
               str(PACKAGE_DIR / 'csrc' / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_info[name] = {'seconds': time.perf_counter() - t0,
                            'ptxas': log}
        if proc.returncode != 0:
            failed.append(f'{name}:\n{log}')
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return build_info


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
    return lib


def check(err: int, what: str):
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with error {err}')
