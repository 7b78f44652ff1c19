"""Where a dataset reads its bytes (port of
``mrefsr_tpu/utils/file_client.py``, the reference's
``basicsr/utils/file_client.py``): ``disk`` reads files, ``lmdb`` reads
keys of one or more lmdb environments, ``pack`` keys of one or more packed
shards (``data/packio.py``), ``memcached`` keys of a memcached cluster.
``lmdb`` and ``mc`` are imported where a backend is made, and raise
``ImportError`` naming the module where it is missing.

The loader's workers are threads sharing one dataset, so
:func:`ensure_file_client` makes the dataset's client once, under a lock.
"""
import threading


def _normalize_paths(db_paths, client_keys, what):
    """``db_paths`` and ``client_keys`` as lists of str of equal length."""
    if isinstance(client_keys, str):
        client_keys = [client_keys]
    if isinstance(db_paths, str) or hasattr(db_paths, '__fspath__'):
        db_paths = [db_paths]
    db_paths = [str(v) for v in db_paths]
    if len(client_keys) != len(db_paths):
        raise ValueError(
            f'client_keys and db_paths should have the same length for '
            f'{what}, but received {len(client_keys)} and {len(db_paths)}.')
    return db_paths, list(client_keys)


class HardDiskBackend:
    """Files on disk (reference file_client.py:58-71)."""

    def get(self, filepath):
        with open(str(filepath), 'rb') as f:
            return f.read()

    def get_text(self, filepath):
        with open(str(filepath)) as f:
            return f.read()


class LmdbBackend:
    """Keys of lmdb environments, one per client key (reference
    file_client.py:74-129)."""

    def __init__(self, db_paths, client_keys='default', readonly=True,
                 lock=False, readahead=False, **kwargs):
        import lmdb
        self.db_paths, client_keys = _normalize_paths(db_paths, client_keys,
                                                      'LmdbBackend')
        self._client = {key: lmdb.open(path, readonly=readonly, lock=lock,
                                       readahead=readahead, **kwargs)
                        for key, path in zip(client_keys, self.db_paths)}

    def get(self, filepath, client_key):
        if client_key not in self._client:
            raise KeyError(f'client_key {client_key} is not in lmdb '
                           'clients.')
        with self._client[client_key].begin(write=False) as txn:
            value = txn.get(str(filepath).encode('ascii'))
        if value is None:
            raise KeyError(f'key {str(filepath)!r} not found in lmdb '
                           f'{client_key!r}')
        return value

    def get_text(self, filepath):
        raise NotImplementedError


class PackBackend:
    """Keys of packed shards, one per client key (the JAX package's
    file_client.py:127-158): the ``lmdb`` backend's ``db_paths`` /
    ``client_keys`` interface over ``data/packio.py``'s readers."""

    def __init__(self, db_paths, client_keys='default', **kwargs):
        from mrefsr_tpu_torch.data.packio import PackReader
        db_paths, client_keys = _normalize_paths(db_paths, client_keys,
                                                 'PackBackend')
        self._client = {key: PackReader(path)
                        for key, path in zip(client_keys, db_paths)}

    def get(self, filepath, client_key):
        if client_key not in self._client:
            raise KeyError(f'client_key {client_key} is not in pack '
                           'clients.')
        return self._client[client_key].get(str(filepath))

    def get_text(self, filepath):
        raise NotImplementedError


class MemcachedBackend:
    """Keys of a memcached cluster through its ``mc`` client module
    (reference file_client.py:22-55); ``sys_path`` is put on ``sys.path``
    first where given. The loader's workers are threads sharing one
    client, so each thread has a receive buffer of its own."""

    def __init__(self, server_list_cfg, client_cfg, sys_path=None):
        if sys_path is not None:
            import sys
            sys.path.append(sys_path)
        try:
            import mc
        except ImportError as exc:
            raise ImportError('MemcachedBackend needs the memcached client '
                              "module 'mc', which is not installed") from exc
        self.server_list_cfg = server_list_cfg
        self.client_cfg = client_cfg
        self._mc = mc
        self._client = mc.MemcachedClient.GetInstance(server_list_cfg,
                                                      client_cfg)
        self._local = threading.local()

    def get(self, filepath):
        buf = getattr(self._local, 'mc_buffer', None)
        if buf is None:
            buf = self._local.mc_buffer = self._mc.pyvector()
        self._client.Get(str(filepath), buf)
        return self._mc.ConvertBuffer(buf)

    def get_text(self, filepath):
        raise NotImplementedError


# the JAX package's backends the port does not have, with their ROADMAP
# items: none is left
PENDING_BACKENDS = {}


class FileClient:
    """A backend by name (reference file_client.py:132-167)."""

    _backends = {'disk': HardDiskBackend, 'lmdb': LmdbBackend,
                 'pack': PackBackend, 'memcached': MemcachedBackend}

    def __init__(self, backend='disk', **kwargs):
        if backend in PENDING_BACKENDS:
            raise NotImplementedError(
                f"io_backend '{backend}' is not ported yet (ROADMAP "
                f'{PENDING_BACKENDS[backend]})')
        if backend not in self._backends:
            raise ValueError(f'Backend {backend} is not supported. Currently '
                             f'supported ones are {list(self._backends)}')
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath, client_key='default'):
        if self.backend in ('lmdb', 'pack'):
            return self.client.get(filepath, client_key)
        return self.client.get(filepath)

    def get_text(self, filepath):
        return self.client.get_text(filepath)


_lock = threading.Lock()


def ensure_file_client(dataset):
    """``dataset.file_client``, made once from ``dataset.io_backend_opt``
    (``type`` plus the backend's arguments) by whichever loader thread
    comes first."""
    if dataset.file_client is None:
        with _lock:
            if dataset.file_client is None:
                opt = dict(dataset.io_backend_opt)
                dataset.file_client = FileClient(opt.pop('type'), **opt)
    return dataset.file_client
