"""Packed shards, the ``pack`` backend's container (port of
``mrefsr_tpu/data/packio.py``): one immutable file per dataset, mmap'ed
by the reader and read without a copy from the page cache. The file
format is the JAX package's, so a shard written by either package reads
back byte for byte in the other.

The shard library is host code, ``csrc/packio.cpp`` with a plain C
interface. Nothing is built when this module is imported: the first
:class:`PackReader` or :class:`PackWriter` (or :func:`build`) compiles it
with ``g++`` into ``build/mrefsr_tpu_torch/``, named by a hash of the
source and the flags as ``ops/_build.py`` names the CUDA libraries, and
loads it with ``ctypes``. A failed build raises.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / 'csrc' / 'packio.cpp'
# <checkout>/build/mrefsr_tpu_torch, a directory .gitignore lists
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'mrefsr_tpu_torch'
CXX_FLAGS = ('-O2', '-std=c++17', '-fPIC', '-Wall', '-Wextra', '-shared')

_lock = threading.Lock()
_lib = None

# (symbol, restype, argtypes) of the library's C entry points
_SIGNATURES = (
    ('packio_create', ctypes.c_void_p, [ctypes.c_char_p]),
    ('packio_add', ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_uint64]),
    ('packio_finish', ctypes.c_int, [ctypes.c_void_p]),
    ('packio_open', ctypes.c_void_p, [ctypes.c_char_p]),
    ('packio_count', ctypes.c_uint64, [ctypes.c_void_p]),
    ('packio_get', ctypes.POINTER(ctypes.c_ubyte),
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]),
    ('packio_keys', ctypes.c_uint64, [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64]),
    ('packio_close', None, [ctypes.c_void_p]),
)


def library_path():
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + ' '.join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'packio-{digest[:16]}.so'


def build():
    """Build the library with ``g++`` unless it is there; returns its path
    and whether it was built now."""
    out = library_path()
    if out.exists():
        return out, False
    cxx = os.environ.get('CXX') or shutil.which('g++')
    if cxx is None:
        raise RuntimeError('g++ not found: the packio library cannot be '
                           'built')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, '-o', str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'g++ failed for {SOURCE.name} (exit '
                               f'{proc.returncode}):\n{proc.stdout}'
                               f'{proc.stderr}')
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out, True


def load_library():
    """The loaded shard library, built if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            for symbol, restype, argtypes in _SIGNATURES:
                fn = getattr(lib, symbol)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


class PackWriter:
    """A new shard at ``path``: :meth:`put` each key's bytes, then
    :meth:`close`. Where shapes are given it also writes an lmdb-style
    ``<path>.meta_info.txt`` (``key.png (h,w,c) compress_level`` a line)."""

    def __init__(self, path):
        self._lib = load_library()
        self._handle = self._lib.packio_create(os.fsencode(path))
        if not self._handle:
            raise IOError(f'cannot create pack shard at {path}')
        self.path = str(path)
        self._meta = []

    def put(self, key, data, shape=None, compress_level=1):
        data = bytes(data)
        if self._lib.packio_add(self._handle, key.encode(), data,
                                len(data)) != 0:
            raise IOError(f'packio_add failed for key {key}')
        if shape is not None:
            h, w, c = shape
            self._meta.append(f'{key}.png ({h},{w},{c}) {compress_level}')

    def close(self):
        handle, self._handle = self._handle, None
        if self._lib.packio_finish(handle) != 0:
            raise IOError(f'packio_finish failed for {self.path}')
        if self._meta:
            with open(f'{self.path}.meta_info.txt', 'w') as f:
                f.write('\n'.join(self._meta) + '\n')


class PackReader:
    """The keys and values of the shard at ``path``, read from its mmap;
    :meth:`close` (or the garbage collector) unmaps it."""

    def __init__(self, path):
        self._lib = load_library()
        self._handle = self._lib.packio_open(os.fsencode(path))
        if not self._handle:
            raise IOError(f'cannot open pack shard at {path}')

    def __len__(self):
        return self._lib.packio_count(self._handle)

    def keys(self):
        need = self._lib.packio_keys(self._handle, None, 0)
        buf = ctypes.create_string_buffer(int(need))
        self._lib.packio_keys(self._handle, buf, need)
        return buf.raw[:int(need)].decode().splitlines()

    def get(self, key):
        """A copy of ``key``'s bytes; ``KeyError`` where the shard has no
        such key."""
        length = ctypes.c_uint64()
        ptr = self._lib.packio_get(self._handle, key.encode(),
                                   ctypes.byref(length))
        if not ptr:
            raise KeyError(key)
        return ctypes.string_at(ptr, length.value)

    def close(self):
        if getattr(self, '_handle', None):
            self._lib.packio_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
