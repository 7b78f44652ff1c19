"""``calculate_fid_folder`` and ``calculate_fid_stats_from_datasets`` in
the port against the JAX package's scripts on the CPU: one folder of four
seeded 32 x 32 faces, one ``pt_inception``-layout ``.pth`` (seeded flax
variables, its ``fc`` and ``AuxLogits`` heads included) passed to both as
``--inception_path``, batches of 2.

* The statistics each stats script writes (the JAX script's to
  ``inception_ffhq_<size>.pth`` in its working directory, numpy arrays,
  read by the port's ``load_fid_stats``): the means within 1e-4 of the
  largest (the features' own tolerance in ``test_torch_face_metrics.py``,
  measured 3.6e-7 there), the covariances within 1e-3 of the largest
  entry (measured 2.2e-4: four samples whose deviations from their mean
  are a small part of the features, so a feature's error weighs more in
  the covariance).
* The folder scripts against those statistics: the statistics of the
  folder that each passes to ``calculate_fid``, the same way. The
  distance itself is recorded, not computed here (scipy's ``sqrtm`` of a
  2048 x 2048 product takes about 25 s on four CPU cores); it is held on
  seeded Gaussians in ``test_torch_face_metrics.py::test_fid_math``, and
  on the features of the stats in ``test_torch_metric_cli_sg2.py``.
"""
import importlib.util
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs.inception import InceptionV3 as JaxInceptionV3
from mrefsr_tpu.metrics import fid as jax_fid
from mrefsr_tpu_torch.convert import state_dict_from_flax_with_counts
from mrefsr_tpu_torch.metrics.fid import load_fid_stats
from mrefsr_tpu_torch.scripts.metrics import (
    calculate_fid_folder, calculate_fid_stats_from_datasets)
from test_torch_hifacegan import _seeded_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
COV_TOL = 1e-3


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', os.path.join(REPO, 'scripts', 'metrics',
                                    f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp('fid_cli')
    rng = np.random.RandomState(0)
    os.makedirs(root / 'faces')
    for i in range(4):
        x = np.linspace(0, 255, 32)[None, :, None] * np.ones((32, 1, 3))
        img = np.clip(x * (0.5 + i / 4) + rng.randn(32, 32, 3) * 30, 0, 255)
        cv2.imwrite(str(root / 'faces' / f'{i:08d}.png'),
                    img.astype(np.uint8))
    module = JaxInceptionV3(output_blocks=(3,), resize_input=True,
                            normalize_input=False)
    variables = _seeded_variables(
        module, [np.zeros((2, 32, 32, 3), np.float32)], 4)
    state = state_dict_from_flax_with_counts(variables)
    state['fc.weight'] = torch.zeros(1008, 2048)
    state['AuxLogits.fc.weight'] = torch.zeros(1008, 768)
    torch.save(state, root / 'pt_inception.pth')
    return root


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, (what, err)


def test_stats_and_folder_scripts(files, tmp_path, monkeypatch):
    shared = {}

    def jax_inception(path):
        # one jitted extractor for both JAX scripts: one compile
        if path not in shared:
            shared[path] = jax_fid.load_patched_inception_v3(path)
        return shared[path]

    seen = {'jax': [], 'port': []}

    def recorder(who):
        def fid(mu1, sigma1, mu2, sigma2, eps=1e-6):
            seen[who].append((mu1, sigma1, mu2, sigma2))
            return -1.0
        return fid

    inception = str(files / 'pt_inception.pth')
    stats_script = _jax_script('calculate_fid_stats_from_datasets')
    folder_script = _jax_script('calculate_fid_folder')
    for script in (stats_script, folder_script):
        monkeypatch.setattr(script, 'load_patched_inception_v3',
                            jax_inception)
    monkeypatch.setattr(folder_script, 'calculate_fid', recorder('jax'))
    monkeypatch.setattr(calculate_fid_folder, 'calculate_fid',
                        recorder('port'))

    common = ['--num_sample', '4', '--batch_size', '2', '--inception_path',
              inception]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, 'argv', [
        'stats', '--dataroot', str(files / 'faces'), '--size', '32',
        *common])
    stats_script.main()
    jax_mean, jax_cov = load_fid_stats(str(tmp_path /
                                           'inception_ffhq_32.pth'))
    port_stats = str(tmp_path / 'port_stats.pth')
    mean, cov = calculate_fid_stats_from_datasets.main([
        '--dataroot', str(files / 'faces'), '--size', '32', '--save',
        port_stats, '--device', 'cpu', *common])
    assert mean.shape == (2048,) and cov.shape == (2048, 2048)
    _close(mean, jax_mean, 'stats mean')
    _close(cov, jax_cov, 'stats cov', COV_TOL)
    saved = torch.load(port_stats, map_location='cpu', weights_only=False)
    assert saved['name'] == 'ffhq' and saved['size'] == 32
    assert isinstance(saved['mean'], np.ndarray)
    np.testing.assert_array_equal(load_fid_stats(port_stats)[1], cov)

    # the JAX script reads statistics of tensors; the port either
    tensor_stats = str(tmp_path / 'tensor_stats.pth')
    torch.save({'mean': torch.from_numpy(mean), 'cov': torch.from_numpy(cov)},
               tensor_stats)
    monkeypatch.setattr(sys, 'argv', [
        'folder', str(files / 'faces'), '--fid_stats', tensor_stats,
        *common])
    folder_script.calculate_fid_folder()
    assert calculate_fid_folder.main([
        str(files / 'faces'), '--fid_stats', port_stats, '--device', 'cpu',
        *common]) == -1.0
    (jax_call,), (port_call,) = seen['jax'], seen['port']
    for name, got, want in zip(('mu1', 'sigma1', 'mu2', 'sigma2'),
                               port_call, jax_call):
        _close(got, want, f'folder {name}',
               COV_TOL if name.startswith('sigma') else TOL)
    # the folder's statistics are the stats script's: the same images
    np.testing.assert_allclose(port_call[0], mean, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port_call[2], mean)
