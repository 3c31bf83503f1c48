"""Build and load the port's CUDA kernels.

Each kernel is one source under ``facenet_tpu_torch/csrc/`` with a plain C
launch function. `CudaKernel.load` compiles it at first use with ``nvcc``
for sm_90a into a shared library under ``facenet_tpu_torch/_build/`` (named
by the source's hash, so an edited source builds anew) and binds it with
ctypes. `build_all` starts one ``nvcc`` per source at once and waits for all
of them, so a run that needs every kernel pays for the slowest build only.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / 'csrc'
BUILD_DIR = _PACKAGE / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')
    if default.exists():
        return str(default)
    raise RuntimeError('nvcc not found: the CUDA toolkit is needed to build '
                       'the kernels in facenet_tpu_torch/csrc')


class CudaKernel:
    """One CUDA source and its ctypes binding.

    :param source: file name under ``csrc/``
    :param signatures: {C function name: list of ctypes argument types};
        every function returns an int (a cudaError_t, 0 on success)
    """

    def __init__(self, source, signatures):
        self.source = CSRC / source
        self.signatures = dict(signatures)
        self._library = None
        self._proc = None
        self._tmp = None

    @property
    def name(self):
        return self.source.stem

    def library_path(self):
        """The shared library for the current source (named by its hash)."""
        digest = hashlib.sha1(self.source.read_bytes()).hexdigest()[:12]
        return BUILD_DIR / f'lib{self.name}-{digest}.so'

    def start(self):
        """Start nvcc in the background unless the library is on disk."""
        if self._library is not None or self._proc is not None:
            return
        out = self.library_path()
        if out.exists():
            return
        out.parent.mkdir(parents=True, exist_ok=True)
        self._tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        cmd = [nvcc(), *NVCC_FLAGS, '-o', str(self._tmp), str(self.source)]
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)

    def load(self):
        """Compile (unless built) and load; returns the ctypes library.

        Its ``build_log`` holds nvcc's output (``-Xptxas -v``: registers,
        shared memory, spills), or '' when the library was already built.
        """
        if self._library is not None:
            return self._library
        import ctypes

        self.start()
        log = ''
        if self._proc is not None:
            stdout, stderr = self._proc.communicate()
            code, self._proc = self._proc.returncode, None
            if code != 0:
                raise RuntimeError(f'nvcc failed ({code}) on {self.source}:\n'
                                   f'{stderr}')
            os.replace(self._tmp, self.library_path())
            log = stdout + stderr

        lib = ctypes.CDLL(str(self.library_path()))
        for fn, argtypes in self.signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.build_log = log
        self._library = lib
        return lib


def build_all(kernels):
    """Build every kernel with its nvcc running at the same time; returns
    the loaded libraries in order. Every nvcc started is waited for, even
    when an earlier build fails; the first failure is then raised."""
    for kernel in kernels:
        kernel.start()
    libs, failure = [], None
    for kernel in kernels:
        try:
            libs.append(kernel.load())
        except RuntimeError as exc:
            failure = failure or exc
    if failure is not None:
        raise failure
    return libs


def check(err, name):
    """Raise when a launch function returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: cudaError {err}')
