"""The port's downloads and checkpoint stamping against the JAX package's,
on the CPU: ``utils/download_util.py`` and the scripts over it
(``download_gdrive``, ``download_pretrained_models``,
``data_preparation/download_datasets``), and ``publish_models``.

No test opens a connection: ``requests`` is replaced by a stub that serves
files from a dict and records each request, and ``socket.connect`` raises.
Both packages import ``requests`` inside their functions, so both take the
stub; each writes the same bytes to the same names, and asks the same
questions at the overwrite prompt."""
import hashlib
import importlib.util
import os
import runpy
import socket
import sys
import types

import pytest
import torch

from mrefsr_tpu_torch.scripts import (download_gdrive,
                                      download_pretrained_models,
                                      publish_models)
from mrefsr_tpu_torch.scripts.data_preparation import download_datasets
from mrefsr_tpu_torch.utils import download_util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG_ID = 'big-file'             # a file behind Drive's confirmation page
FILES = {BIG_ID: bytes(range(256)) * 300,
         '1b3_bWZTjNO3iL2js1yWkJfjZykcQgvzT': b'esrgan' * 5000,
         '1swaV5iBMFfg-DL6ZyiARztbhutDCWXMM': b'psnr' * 7001,
         '1RtyIeUFTyW8u4zAEhmdQ3FWLv1Cy7EqA': b'set5' * 10,
         '1CzwwAtLSW9sog3acXj8s7Hg3S7kr2HiZ': b'set14' * 10,
         'https://example.org/weights/net.pth': b'weights' * 9999}


class _Response:
    def __init__(self, body, cookies=None, headers=None, status=200):
        self.body, self.status_code = body, status
        self.cookies = cookies or {}
        self.headers = headers or {}

    def iter_content(self, chunk_size):
        for i in range(0, len(self.body), chunk_size):
            yield self.body[i:i + chunk_size]
        yield b''                     # a keep-alive chunk

    def raise_for_status(self):
        if self.status_code != 200:
            raise IOError(self.status_code)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _stub_requests(log):
    """A ``requests`` module serving ``FILES``: Drive's page asks for a
    confirmation of ``BIG_ID`` by a ``download_warning`` cookie, and a
    ranged request gets the ``Content-Range`` of the size."""
    def drive(url, params=None, stream=False, headers=None):
        log.append((url, dict(params or {}), dict(headers or {})))
        body = FILES[params['id']]
        if params['id'] == BIG_ID and 'confirm' not in params:
            return _Response(b'<html>confirm</html>',
                             cookies={'download_warning_123': 'tok'})
        if headers and 'Range' in headers:
            return _Response(body[:3], headers={
                'Content-Range': f'bytes 0-2/{len(body)}'})
        return _Response(body)

    def get(url, stream=False):
        log.append((url, {}, {}))
        if url not in FILES:
            return _Response(b'', status=404)
        return _Response(FILES[url], headers={
            'Content-Length': str(len(FILES[url]))})

    module = types.ModuleType('requests')
    module.Session = lambda: types.SimpleNamespace(get=drive)
    module.get = get
    return module


@pytest.fixture
def offline(monkeypatch):
    """The stub in place of ``requests``, and no socket may connect."""
    def refuse(*args, **kwargs):
        raise AssertionError('a test opened a connection')

    monkeypatch.setattr(socket.socket, 'connect', refuse)
    monkeypatch.setattr(socket.socket, 'connect_ex', refuse)
    log = []
    monkeypatch.setitem(sys.modules, 'requests', _stub_requests(log))
    return log


def jax_module(*parts):
    spec = importlib.util.spec_from_file_location(
        'jax_' + parts[-1][:-3], os.path.join(REPO, *parts))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_download_util():
    from mrefsr_tpu.utils import download_util as jax_util
    return jax_util


def test_google_drive_download_with_confirmation(offline, tmp_path, capsys):
    """The confirmation cookie's token is sent back, the size comes from
    the ranged request, and the file is the served bytes; the same
    requests and progress line as the JAX package's."""
    jax_util = _jax_download_util()
    for tag, fn in (('jax', jax_util.download_file_from_google_drive),
                    ('port', download_util.download_file_from_google_drive)):
        start = len(offline)
        fn(BIG_ID, str(tmp_path / tag))
        assert (tmp_path / tag).read_bytes() == FILES[BIG_ID]
        requests_made = offline[start:]
        assert [p.get('confirm') for _, p, _ in requests_made] == [
            None, 'tok', 'tok']
        assert requests_made[-1][2] == {'Range': 'bytes=0-2'}
    out = capsys.readouterr().out
    jax_line, port_line = [line for line in out.split('\n') if line][-2:]
    assert port_line == jax_line and port_line.endswith('75.0 KB')


def test_load_file_from_url(offline, tmp_path):
    """Downloaded once into ``model_dir`` (under ``file_name`` where
    given), then found there; a failed request raises."""
    jax_util = _jax_download_util()
    url = 'https://example.org/weights/net.pth'
    for tag, fn in (('jax', jax_util.load_file_from_url),
                    ('port', download_util.load_file_from_url)):
        path = fn(url, model_dir=str(tmp_path / tag))
        assert path == str(tmp_path / tag / 'net.pth')
        assert open(path, 'rb').read() == FILES[url]
        start = len(offline)
        assert fn(url, model_dir=str(tmp_path / tag)) == path
        assert len(offline) == start
        renamed = fn(url, model_dir=str(tmp_path / tag), file_name='x.pth')
        assert os.path.basename(renamed) == 'x.pth'
        with pytest.raises(IOError):
            fn('https://example.org/missing.pth',
               model_dir=str(tmp_path / tag))


def test_download_names_requests_when_missing(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, 'requests', None)
    with pytest.raises(ImportError, match='requests'):
        download_util.load_file_from_url('https://example.org/a.pth',
                                         model_dir=str(tmp_path))
    with pytest.raises(ImportError, match='requests'):
        download_gdrive.main(['--id', BIG_ID, '--output',
                              str(tmp_path / 'x')])


def test_download_gdrive(offline, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['download_gdrive.py', '--id', BIG_ID,
                                      '--output', str(tmp_path / 'jax')])
    runpy.run_path(os.path.join(REPO, 'scripts', 'download_gdrive.py'),
                   run_name='__main__')
    download_gdrive.main(['--id', BIG_ID, '--output', str(tmp_path / 'port')])
    port, jax = ((tmp_path / tag).read_bytes() for tag in ('port', 'jax'))
    assert port == jax == FILES[BIG_ID]


def _answers(monkeypatch, replies, asked):
    replies = iter(replies)

    def answer(prompt):
        asked.append(prompt)
        return next(replies)

    monkeypatch.setattr('builtins.input', answer)


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), 'rb').read()
            for d, _, files in os.walk(root) for f in files}


@pytest.mark.parametrize('which', ['pretrained', 'datasets'])
def test_download_scripts(offline, tmp_path, monkeypatch, which):
    """Every file of every method or dataset (``all``) into the same tree;
    a second run asks before covering each file there (``n`` skips,
    ``Y`` covers, anything else raises), as the JAX scripts do."""
    if which == 'pretrained':
        jax_mod = jax_module('scripts', 'download_pretrained_models.py')
        jax_one, port_main = (jax_mod.download_pretrained_models,
                              download_pretrained_models.main)
    else:
        jax_mod = jax_module('scripts', 'data_preparation',
                             'download_datasets.py')
        jax_one, port_main = (jax_mod.download_dataset,
                              download_datasets.main)

    def jax_all():
        for key, ids in jax_mod.FILE_IDS.items():
            jax_one(key, ids)

    trees, prompts = {}, {}
    for tag, run in (('jax', jax_all), ('port', lambda: port_main(['all']))):
        os.makedirs(tmp_path / tag)
        monkeypatch.chdir(tmp_path / tag)
        asked = prompts.setdefault(tag, [])
        run()
        _answers(monkeypatch, ['n', 'Y'], asked)
        run()
        trees[tag] = _tree(str(tmp_path / tag))
        _answers(monkeypatch, ['maybe'], asked)
        with pytest.raises(ValueError, match='Only accepts Y/N'):
            run()
    assert trees['port'] == trees['jax'] and len(trees['port']) == 2
    assert prompts['port'] == prompts['jax'] and len(prompts['port']) == 3


def _checkpoints(root):
    """Three ``.pth`` files under ``root/experiments/pretrained_models``:
    a plain name, a stale ``-<sha>`` name and one a folder down."""
    folder = os.path.join(root, 'experiments', 'pretrained_models')
    os.makedirs(os.path.join(folder, 'sub'))
    gen = torch.Generator().manual_seed(0)
    for i, name in enumerate(('net_a.pth', 'net_b-deadbeef.pth',
                              os.path.join('sub', 'net_c.pth'))):
        torch.save({'params': {'w': torch.randn(4, 4, generator=gen) + i}},
                   os.path.join(folder, name))


def test_publish_models(tmp_path, monkeypatch):
    """The same new names (``<name>-<sha256[:8]>.pth``) from the same
    files; a file already stamped with its digits is left as it is."""
    names = {}
    jax_mod = jax_module('scripts', 'publish_models.py')
    for tag in ('jax', 'port'):
        _checkpoints(str(tmp_path / tag))
        monkeypatch.chdir(tmp_path / tag)
        if tag == 'jax':
            runpy.run_path(jax_mod.__file__, run_name='__main__')
        else:
            publish_models.main([])
        names[tag] = sorted(_tree('experiments'))
    assert names['port'] == names['jax'] and len(names['port']) == 3
    for name in names['port']:
        stem = os.path.basename(name)[:-len('.pth')].split('-')
        path = os.path.join('experiments', name)
        assert stem[1] == hashlib.sha256(
            open(path, 'rb').read()).hexdigest()[:8]
    assert publish_models.main([os.path.join('experiments', n)
                                for n in names['port']]) == [
        os.path.join('experiments', n) for n in names['port']]
    assert sorted(_tree('experiments')) == names['port']


def test_publish_models_asks_for_a_checkpoint_without_params(tmp_path,
                                                             monkeypatch):
    path = str(tmp_path / 'raw.pth')
    torch.save({'w': torch.zeros(2)}, path)
    asked = []
    _answers(monkeypatch, ['n'], asked)
    with pytest.raises(ValueError, match='Please modify'):
        publish_models.main([path])
    assert 'does not have' in asked[0]
    _answers(monkeypatch, ['y'], asked)
    (new,) = publish_models.main([path])
    assert not os.path.exists(path) and os.path.exists(new)
