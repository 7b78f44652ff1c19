"""Build the CUDA sources under ``ops/csrc`` with ``nvcc`` and bind them.

Each ``csrc/*.cu`` has a plain C interface and becomes one shared library,
loaded with ``ctypes``. Nothing is built when a module is imported: a
:class:`Kernel` builds its library on its first launch, and
:func:`build` builds every source at once, one ``nvcc`` process per
source, all started together. Libraries are named by a hash of their
source, the headers beside it and the flags, so an edited source is rebuilt
and an unchanged one is reused. A failed build raises.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
# <checkout>/build/mrefsr_tpu_torch, a directory .gitignore lists
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'mrefsr_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_libs = {}


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = Path(cuda_home) / 'bin' / 'nvcc'
    if path.exists():
        return str(path)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, '
                           '/usr/local/cuda/bin and PATH): the CUDA kernels '
                           'cannot be built')
    return found


def _target(source):
    # the headers (csrc/*.cuh) count for every source that may include them
    text = b''.join(p.read_bytes() for p in [source,
                                             *sorted(CSRC.glob('*.cuh'))])
    digest = hashlib.sha256(text
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'{source.stem}-{digest[:16]}.so'


def build(names=None):
    """Build the named sources (stems of ``csrc/*.cu``; all by default).

    Returns ``{stem: {'path', 'seconds', 'cached', 'log'}}``, where ``log``
    holds nvcc's output, ``-Xptxas -v``'s registers, shared memory and
    spills per kernel included.
    """
    sources = sorted(CSRC.glob('*.cu'))
    if names is not None:
        sources = [s for s in sources if s.stem in names]
        missing = set(names) - {s.stem for s in sources}
        if missing:
            raise FileNotFoundError(f'no CUDA source for {sorted(missing)} '
                                    f'in {CSRC}')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info, procs = {}, {}
    t0 = time.perf_counter()
    try:
        for src in sources:
            out = _target(src)
            if out.exists():
                log = out.with_suffix('.log')
                info[src.stem] = {'path': out, 'seconds': 0.0, 'cached': True,
                                  'log': log.read_text() if log.exists()
                                  else ''}
                continue
            tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
            cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
            procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), out, tmp)
        for src, (proc, out, tmp) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed for {src.name} '
                                   f'(exit {proc.returncode}):\n{log}')
            os.replace(tmp, out)
            out.with_suffix('.log').write_text(log)
            info[src.stem] = {'path': out,
                              'seconds': time.perf_counter() - t0,
                              'cached': False, 'log': log}
    finally:
        for proc, _, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return info


def load_library(name):
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name not in _libs:
            path = build([name])[name]['path']
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    The entry point returns ``cudaGetLastError()`` after its launch; a
    non-zero code raises here. ``launches`` counts successful launches and
    nothing else.
    """

    def __init__(self, library, symbol, argtypes):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            lib = load_library(self.library)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            self._error_string = lib.cuda_error_string
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f'{self.symbol} failed to launch: CUDA error {err} '
                f'({self._error_string(err).decode()})')
        self.launches += 1


def _raw_stream(index):
    """The ``cudaStream_t`` of PyTorch's current stream on CUDA device
    ``index``, as an int, without making a ``torch.cuda.Stream``."""
    import torch
    get = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    if get is not None:
        return get(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(kernel, device, *args):
    """``kernel(*args, stream)`` on PyTorch's current stream of the CUDA
    ``device``. The device is made current only where it is not already:
    a ``torch.cuda.device`` context on every call costs the host more than
    a small kernel takes on the card."""
    import torch
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        return kernel(*args, _raw_stream(index))
    with torch.cuda.device(index):
        return kernel(*args, _raw_stream(index))
