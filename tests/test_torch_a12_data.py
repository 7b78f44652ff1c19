"""A12's data utilities in the port against the JAX package on the CPU:

* ``utils/flow_util.py``: ``.flo`` files and quantized flow images read
  and written by either package, and (de)quantisation, bit for bit;
* packed shards: a shard written by either package reads back byte for
  byte in the other, both writers (and both ``create_pack`` scripts) give
  byte-identical files and meta-info, and ``FileClient('pack')`` reads
  keys; the shard library builds with ``g++`` at first use;
* lmdb and memcached under fake ``lmdb`` and ``mc`` modules put in
  ``sys.modules`` (the tests need neither installed): ``make_lmdb_from_imgs``
  (with and without the port's spawned read processes) and ``LmdbMaker``
  put the same
  keys and bytes and write the same ``meta_info.txt`` as the JAX writers,
  the lmdb backend reads them back, ``MemcachedBackend`` returns the JAX
  backend's bytes, and without the modules both raise ``ImportError``
  naming them.

The REDS flows and ``PairedImageDataset`` on packs are held to the JAX
datasets in ``test_torch_video_data.py``.
"""
import os
import subprocess
import sys
import types

import cv2
import numpy as np
import pytest

from mrefsr_tpu.data import packio as jax_packio
from mrefsr_tpu.utils import file_client as jax_file_client
from mrefsr_tpu.utils import flow_util as jax_flow_util
from mrefsr_tpu.utils import lmdb_util as jax_lmdb_util
from mrefsr_tpu_torch.data import packio
from mrefsr_tpu_torch.scripts.data_preparation import create_pack
from mrefsr_tpu_torch.utils import file_client, flow_util, lmdb_util
from mrefsr_tpu_torch.utils.file_client import FileClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_packio_built_here(root):
    """A context in which the JAX package's ``data/packio.py`` loads a
    library built from its own source (``native/packio.cpp``) with ``g++``
    into ``root``: the package builds in place with ``make``, which
    another test process may be doing at that moment."""
    lib = os.path.join(str(root), 'libpackio_jax.so')
    subprocess.run(['g++', '-O2', '-std=c++17', '-fPIC', '-shared', '-o', lib,
                    os.path.join(REPO, 'native', 'packio.cpp')], check=True,
                   capture_output=True)
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_packio, '_LIB_PATH', lib)
    patch.setattr(jax_packio, '_lib', None)
    return patch


@pytest.fixture(scope='module', autouse=True)
def _jax_packio(tmp_path_factory):
    patch = jax_packio_built_here(tmp_path_factory.mktemp('jax_packio'))
    yield
    patch.undo()


def _flow(seed, h=12, w=10):
    return (np.random.RandomState(seed).randn(h, w, 2) * 3).astype(
        np.float32)


def test_flo_files_in_both_directions(tmp_path):
    flow = _flow(0)
    flow_util.flowwrite(flow, str(tmp_path / 'port.flo'))
    jax_flow_util.flowwrite(flow, str(tmp_path / 'jax.flo'))
    assert (tmp_path / 'port.flo').read_bytes() == \
        (tmp_path / 'jax.flo').read_bytes()
    for name in ('port.flo', 'jax.flo'):
        np.testing.assert_array_equal(
            flow_util.flowread(str(tmp_path / name)),
            jax_flow_util.flowread(str(tmp_path / name)))
    np.testing.assert_array_equal(flow_util.flowread(str(tmp_path /
                                                         'port.flo')), flow)
    (tmp_path / 'bad.flo').write_bytes(b'XXXX' + bytes(8))
    with pytest.raises(IOError, match='PIEH'):
        flow_util.flowread(str(tmp_path / 'bad.flo'))


@pytest.mark.parametrize('concat_axis', [0, 1])
@pytest.mark.parametrize('kwargs', [{}, {'max_val': 20, 'norm': False}])
def test_quantized_flow_images(tmp_path, concat_axis, kwargs):
    flow = _flow(1) * (0.002 if not kwargs else 3)
    port, jax = str(tmp_path / 'q' / 'port.png'), str(tmp_path / 'q' /
                                                       'jax.png')
    flow_util.flowwrite(flow, port, True, concat_axis, **kwargs)
    jax_flow_util.flowwrite(flow, jax, True, concat_axis, **kwargs)
    np.testing.assert_array_equal(cv2.imread(port, cv2.IMREAD_UNCHANGED),
                                  cv2.imread(jax, cv2.IMREAD_UNCHANGED))
    read = {'max_val': kwargs.get('max_val', 0.02),
            'denorm': kwargs.get('norm', True)}
    got = flow_util.flowread(port, True, concat_axis, **read)
    np.testing.assert_array_equal(
        got, jax_flow_util.flowread(port, True, concat_axis, **read))
    assert got.dtype == np.float32 and got.shape == flow.shape


def test_quantize_and_dequantize():
    flow = _flow(2) * 0.01
    dx, dy = flow_util.quantize_flow(flow)
    jdx, jdy = jax_flow_util.quantize_flow(flow)
    np.testing.assert_array_equal(dx, jdx)
    np.testing.assert_array_equal(dy, jdy)
    assert dx.dtype == np.uint8
    np.testing.assert_array_equal(flow_util.dequantize_flow(dx, dy),
                                  jax_flow_util.dequantize_flow(dx, dy))
    arr = np.linspace(-2, 2, 41)
    np.testing.assert_array_equal(flow_util.quantize(arr, -1, 1, 7),
                                  jax_flow_util.quantize(arr, -1, 1, 7))
    levels = np.arange(7)
    np.testing.assert_array_equal(flow_util.dequantize(levels, -1, 1, 7),
                                  jax_flow_util.dequantize(levels, -1, 1, 7))
    for bad in ({'levels': 1}, {'levels': 2.5}):
        with pytest.raises(ValueError, match='levels'):
            flow_util.quantize(arr, -1, 1, **bad)
    with pytest.raises(ValueError, match='min_val'):
        flow_util.dequantize(levels, 1, 1, 7)


def _entries():
    rng = np.random.RandomState(3)
    entries = [(f'{i:03d}/{j:08d}', rng.bytes(int(rng.randint(0, 300))))
               for i in range(2) for j in range(5)]
    return entries + [('empty', b''), ('ünïcode key', b'\x00\x01')]


def test_packs_in_both_directions_and_byte_identical_writers(tmp_path):
    entries = _entries()
    paths = {'port': str(tmp_path / 'port.pack'),
             'jax': str(tmp_path / 'jax.pack')}
    for name, writer_cls in (('port', packio.PackWriter),
                             ('jax', jax_packio.PackWriter)):
        writer = writer_cls(paths[name])
        for key, data in entries:
            writer.put(key, data, shape=(4, 5, 3), compress_level=2)
        writer.close()
    assert open(paths['port'], 'rb').read() == open(paths['jax'],
                                                    'rb').read()
    assert open(paths['port'] + '.meta_info.txt').read() == \
        open(paths['jax'] + '.meta_info.txt').read()
    for path in paths.values():
        for reader_cls in (packio.PackReader, jax_packio.PackReader):
            reader = reader_cls(path)
            assert len(reader) == len(entries)
            assert sorted(reader.keys()) == sorted(k for k, _ in entries)
            for key, data in entries:
                assert reader.get(key) == data
            with pytest.raises(KeyError):
                reader.get('absent')
            reader.close()
    client = FileClient('pack', db_paths=[paths['jax']],
                        client_keys=['gt'])
    assert client.get('001/00000003', 'gt') == dict(entries)['001/00000003']
    with pytest.raises(KeyError, match='client_key'):
        client.get('001/00000003', 'lq')
    with pytest.raises(IOError, match='cannot open'):
        packio.PackReader(str(tmp_path / 'missing.pack'))


def test_the_library_builds_from_the_ports_own_source():
    path, _ = packio.build()
    assert path.exists() and path.parent == packio.BUILD_DIR
    assert packio.SOURCE.parent == \
        packio.Path(REPO) / 'mrefsr_tpu_torch' / 'data' / 'csrc'
    assert packio.build() == (path, False)


def _image_folder(root, n=5):
    rng = np.random.RandomState(4)
    for i in range(n):
        shape = (9 + i, 7, 3) if i % 2 else (8, 6 + i)
        cv2.imwrite(str(root / f'img{i:02d}.png'),
                    (rng.rand(*shape) * 255).astype(np.uint8))
    (root / 'sub').mkdir()
    cv2.imwrite(str(root / 'sub' / 'deep.png'),
                (rng.rand(5, 5, 3) * 255).astype(np.uint8))
    return root


def test_create_pack_scripts_give_the_same_shard(tmp_path, monkeypatch,
                                                 capsys):
    import importlib.util
    (tmp_path / 'imgs').mkdir()
    folder = _image_folder(tmp_path / 'imgs')
    spec = importlib.util.spec_from_file_location(
        'jax_create_pack', os.path.join(REPO, 'scripts', 'data_preparation',
                                        'create_pack.py'))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    for recursive in (False, True):
        port_path = str(tmp_path / f'port{recursive}.pack')
        jax_path = str(tmp_path / f'jax{recursive}.pack')
        argv = [str(folder), port_path] + (['--recursive'] if recursive
                                           else [])
        assert create_pack.main(argv) == 5 + recursive
        jax_script.create_pack_from_folder(str(folder), jax_path,
                                           recursive=recursive)
        assert open(port_path, 'rb').read() == open(jax_path, 'rb').read()
        assert open(port_path + '.meta_info.txt').read() == \
            open(jax_path + '.meta_info.txt').read()
    reader = packio.PackReader(str(tmp_path / 'portTrue.pack'))
    img = cv2.imdecode(np.frombuffer(reader.get('sub/deep'), np.uint8),
                       cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(
        img, cv2.imread(str(folder / 'sub' / 'deep.png'),
                        cv2.IMREAD_UNCHANGED))
    assert 'Wrote 6 images' in capsys.readouterr().out


class _FakeLmdb(types.ModuleType):
    """The parts of ``lmdb`` the writers and the backend use, over dicts:
    ``open`` makes the directory as lmdb does; ``commits`` counts the
    writers' transactions."""

    def __init__(self):
        super().__init__('lmdb')
        self.stores, self.commits = {}, 0

    def open(self, path, readonly=False, map_size=None, **kwargs):
        if not readonly:
            os.makedirs(path, exist_ok=True)
        return _FakeEnv(self, self.stores.setdefault(str(path), {}))


class _FakeEnv:
    def __init__(self, module, store):
        self.module, self.store = module, store

    def begin(self, write=False):
        return _FakeTxn(self.module, self.store)

    def close(self):
        pass


class _FakeTxn:
    def __init__(self, module, store):
        self.module, self.store = module, store

    def put(self, key, value):
        self.store[key] = bytes(value)

    def get(self, key):
        return self.store.get(key)

    def commit(self):
        self.module.commits += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize('multiprocessing_read', [False, True])
def test_lmdb_writers_under_a_fake_module(tmp_path, monkeypatch,
                                          multiprocessing_read):
    fake = _FakeLmdb()
    monkeypatch.setitem(sys.modules, 'lmdb', fake)
    folder = tmp_path / 'imgs'
    folder.mkdir()
    _image_folder(folder)
    paths = sorted(p for p in os.listdir(folder) if p.endswith('.png'))
    keys = [p[:-4] for p in paths]
    out = {}
    # the JAX writer's read pool forks, which a process running JAX must
    # not do: it reads in this process
    for name, module, pool in (('port', lmdb_util, multiprocessing_read),
                               ('jax', jax_lmdb_util, False)):
        lmdb_path = str(tmp_path / f'{name}.lmdb')
        module.make_lmdb_from_imgs(str(folder), lmdb_path, paths, keys,
                                   batch=2, compress_level=3,
                                   multiprocessing_read=pool, n_thread=2)
        out[name] = (fake.stores[lmdb_path],
                     open(os.path.join(lmdb_path, 'meta_info.txt')).read())
    assert out['port'] == out['jax']
    store, meta = out['port']
    assert sorted(store) == [k.encode() for k in keys]
    assert meta.splitlines()[1] == 'img01.png (10,7,3) 3'
    client = FileClient('lmdb', db_paths=[str(tmp_path / 'port.lmdb')],
                        client_keys=['gt'])
    assert client.get('img03', 'gt') == store[b'img03']
    with pytest.raises(ValueError, match='.lmdb'):
        lmdb_util.make_lmdb_from_imgs(str(folder), str(tmp_path / 'x'),
                                      paths, keys)
    with pytest.raises(ValueError, match='same length'):
        lmdb_util.make_lmdb_from_imgs(str(folder), str(tmp_path / 'x.lmdb'),
                                      paths, keys[:-1])


def test_lmdb_maker_under_a_fake_module(tmp_path, monkeypatch):
    fake = _FakeLmdb()
    monkeypatch.setitem(sys.modules, 'lmdb', fake)
    rng = np.random.RandomState(5)
    items = [(rng.bytes(20), f'k{i}', (3, 4, 1 + 2 * (i % 2)))
             for i in range(5)]
    out = {}
    for name, module in (('port', lmdb_util), ('jax', jax_lmdb_util)):
        path = str(tmp_path / f'{name}.lmdb')
        fake.commits = 0
        maker = module.LmdbMaker(path, batch=2, compress_level=4)
        for item in items:
            maker.put(*item)
        maker.close()
        out[name] = (fake.stores[path], fake.commits,
                     open(os.path.join(path, 'meta_info.txt')).read())
    assert out['port'] == out['jax']
    assert out['port'][1] == 3 and 'k1.png (3,4,3) 4' in out['port'][2]


def test_lmdb_and_memcached_without_their_modules(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'lmdb', None)
    monkeypatch.setitem(sys.modules, 'mc', None)
    with pytest.raises(ImportError, match="'lmdb'"):
        lmdb_util.LmdbMaker(str(tmp_path / 'a.lmdb'))
    with pytest.raises(ImportError, match="'mc'"):
        FileClient('memcached', server_list_cfg='s', client_cfg='c')


class _FakeMc(types.ModuleType):
    """``mc``'s client, buffer and conversion over a dict of bytes."""

    def __init__(self, store):
        super().__init__('mc')
        self.store, self.configs = store, []
        fake = self

        class MemcachedClient:
            @staticmethod
            def GetInstance(server_list_cfg, client_cfg):
                fake.configs.append((server_list_cfg, client_cfg))
                return fake

        self.MemcachedClient = MemcachedClient

    def Get(self, key, buf):
        buf[:] = [self.store[key]]

    @staticmethod
    def pyvector():
        return []

    @staticmethod
    def ConvertBuffer(buf):
        return buf[0]


def test_memcached_backend_under_a_fake_module(monkeypatch, tmp_path):
    store = {'a/b.png': b'\x89PNG-a', 'c.png': b'\x89PNG-c'}
    fake = _FakeMc(store)
    monkeypatch.setitem(sys.modules, 'mc', fake)
    port = FileClient('memcached', server_list_cfg='servers.conf',
                      client_cfg='client.conf', sys_path=str(tmp_path))
    jax = jax_file_client.FileClient('memcached',
                                     server_list_cfg='servers.conf',
                                     client_cfg='client.conf')
    assert fake.configs == [('servers.conf', 'client.conf')] * 2
    for key in store:
        assert port.get(key) == jax.get(key) == store[key]
    assert str(tmp_path) in sys.path
    sys.path.remove(str(tmp_path))
    assert isinstance(port.client, file_client.MemcachedBackend)
