"""FFHQ and StyleGAN2 through the port's CLI, on the CPU:

* ``FFHQDataset`` item for item against the JAX package's (the folder
  scan, ``num_images``' ``%08d.png`` names, ``use_hflip``, the mean / std
  normalisation, a failed read retried on a random index: the same seed
  for JAX's global ``random`` and the port dataset's ``random.Random``),
  bit for bit; the lmdb branch refused where ``lmdb`` is not installed;
* three iterations of ``python -m mrefsr_tpu_torch.train`` on a
  ``StyleGAN2Model`` YAML (16 x 16, the discriminator's R1 and the path
  penalty every 2 iterations) over an ``FFHQDataset`` folder: validation
  without a validation set (the sample grid at iterations 2 and 3), a
  checkpoint at 2, then ``--auto_resume`` to iteration 4;
* the StyleGAN2 converter: a rosinality-layout checkpoint written from the
  port's keys by rosinality's names, converted by the port's module and by
  the JAX package's script, equal to each other and to the port's state,
  and the module's command line.
"""
import argparse
import importlib.util
import logging
import os
import random
import re
import runpy

import cv2
import numpy as np
import pytest
import torch
import yaml

from mrefsr_tpu.data.ffhq_dataset import FFHQDataset as JaxFFHQDataset
from mrefsr_tpu_torch.archs.stylegan2_arch import (StyleGAN2Discriminator,
                                                   StyleGAN2Generator)
from mrefsr_tpu_torch.data import build_dataset
from mrefsr_tpu_torch.data import ffhq_dataset
from mrefsr_tpu_torch.model_conversion import convert_stylegan
from mrefsr_tpu_torch.train import train_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 16


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def faces(tmp_path_factory):
    """Six smooth 16 x 16 PNGs named ``%08d.png``."""
    folder = tmp_path_factory.mktemp('ffhq')
    rng = np.random.RandomState(0)
    for i in range(6):
        img = cv2.resize(rng.rand(5, 5, 3), (SIDE, SIDE),
                         interpolation=cv2.INTER_CUBIC).clip(0, 1)
        cv2.imwrite(str(folder / f'{i:08d}.png'),
                    (img * 255).astype(np.uint8))
    return folder


def _ffhq_opt(folder, **kwargs):
    return {'name': 'FFHQ', 'type': 'FFHQDataset', 'phase': 'train',
            'dataroot_gt': str(folder), 'io_backend': {'type': 'disk'},
            'use_hflip': True, 'mean': [0.5, 0.5, 0.5],
            'std': [0.5, 0.5, 0.5], **kwargs}


@pytest.mark.parametrize('kwargs', [
    {}, {'num_images': 4}, {'use_hflip': False},
    {'mean': [0.4, 0.5, 0.6], 'std': [0.2, 0.3, 0.25]}])
def test_ffhq_dataset_matches_jax(faces, kwargs):
    opt = _ffhq_opt(faces, **kwargs)
    port = build_dataset(opt, seed=3)
    random.seed(3)
    jax_set = JaxFFHQDataset(dict(opt))
    assert len(port) == len(jax_set) == kwargs.get('num_images', 6)
    for index in (0, 3, 1, 3, 2):
        got, want = port[index], jax_set[index]
        assert got['gt_path'] == want['gt_path']
        assert got['gt'].dtype == np.float32
        np.testing.assert_array_equal(got['gt'], np.asarray(want['gt']))


def test_ffhq_retries_a_failed_read(faces, tmp_path, monkeypatch):
    """A file that cannot be read is replaced by a random index, the draw
    the JAX package's makes; a set that cannot be read at all raises
    after three tries."""
    import mrefsr_tpu.data.ffhq_dataset as jax_module
    sleeps = []
    monkeypatch.setattr(ffhq_dataset.time, 'sleep', sleeps.append)
    monkeypatch.setattr(jax_module.time, 'sleep', sleeps.append)
    opt = _ffhq_opt(faces, num_images=7)        # 00000006 is missing
    port = build_dataset(opt, seed=4)
    random.seed(4)
    jax_set = JaxFFHQDataset(dict(opt))
    replaced = 0
    for index in (6, 6, 2, 6):
        try:
            want = jax_set[index]
        except IOError:
            with pytest.raises(IOError, match='after retries'):
                port[index]
            continue
        got = port[index]
        assert got['gt_path'] == want['gt_path']
        np.testing.assert_array_equal(got['gt'], np.asarray(want['gt']))
        replaced += index == 6
    assert replaced
    assert sleeps and set(sleeps) == {1}
    empty = build_dataset(_ffhq_opt(tmp_path, num_images=2), seed=0)
    with pytest.raises(IOError, match='after retries'):
        empty[0]


def test_ffhq_lmdb_needs_the_lmdb_package(tmp_path):
    folder = tmp_path / 'ffhq.lmdb'
    folder.mkdir()
    (folder / 'meta_info.txt').write_text('00000000.png (16,16,3) 1\n')
    dataset = build_dataset(_ffhq_opt(folder, io_backend={'type': 'lmdb'}))
    assert dataset.paths == ['00000000']
    if importlib.util.find_spec('lmdb') is None:
        with pytest.raises(ModuleNotFoundError, match='lmdb'):
            dataset[0]
    with pytest.raises(ValueError, match='.lmdb'):
        build_dataset(_ffhq_opt(tmp_path, io_backend={'type': 'lmdb'}))


# ---------------------------------------------------------- the CLI run
NET = {'out_size': SIDE, 'channel_multiplier': 1, 'narrow': 0.0625}


def _cli_yml(root, faces, iters):
    opt = {
        'name': 'stylegan2_cli', 'model_type': 'StyleGAN2Model',
        'num_gpu': 1, 'manual_seed': 0,
        'datasets': {'train': dict(
            _ffhq_opt(faces), batch_size_per_gpu=2, num_worker_per_gpu=1,
            dataset_enlarge_ratio=1)},
        'network_g': {'type': 'StyleGAN2Generator', 'num_style_feat': 8,
                      'num_mlp': 2, **NET},
        'network_d': {'type': 'StyleGAN2Discriminator', 'stddev_group': 2,
                      **NET},
        'path': {'pretrain_network_g': None, 'strict_load_g': True,
                 'resume_state': None},
        'train': {'optim_g': {'type': 'Adam', 'lr': 2e-3},
                  'optim_d': {'type': 'Adam', 'lr': 2e-3},
                  'scheduler': {'type': 'MultiStepLR',
                                'milestones': [600000], 'gamma': 0.5},
                  'total_iter': iters, 'warmup_iter': -1,
                  'gan_opt': {'type': 'GANLoss', 'gan_type': 'wgan_softplus',
                              'loss_weight': 1.0},
                  'r1_reg_weight': 10, 'path_reg_weight': 2,
                  'net_g_reg_every': 2, 'net_d_reg_every': 2,
                  'mixing_prob': 0.9},
        'val': {'num_val_samples': 4, 'val_freq': 2, 'save_img': True},
        'logger': {'print_freq': 1, 'save_checkpoint_freq': 2,
                   'use_tb_logger': False},
        'dist_params': {'backend': 'gloo', 'port': 29500}}
    path = root / f'stylegan2_{iters}.yml'
    path.write_text(yaml.safe_dump(opt))
    return path


def test_stylegan2_through_the_cli(faces, tmp_path):
    """Three iterations: every loss logged finite, both penalties on
    iteration 2; the sample grid written at the validation of iteration 2
    and at the end; the checkpoint of iteration 2; ``--auto_resume`` with
    ``total_iter`` 4 goes on from ``2.state``: its first step is
    iteration 3."""
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = logging.getLogger('mrefsr_tpu_torch')
    logger.addHandler(handler)
    try:
        model = train_pipeline(str(tmp_path), [
            '-opt', str(_cli_yml(tmp_path, faces, 3)), '--device', 'cpu'])
        exp = tmp_path / 'experiments' / 'stylegan2_cli'
        for name in ('train_2.png', 'train_3.png'):
            grid = cv2.imread(str(exp / 'visualization' / 'train' / name))
            assert grid is not None and grid.shape == (2 * SIDE + 2,
                                                       2 * SIDE + 2, 3)
        for name in ('models/net_g_2.pth', 'models/net_d_2.pth',
                     'training_states/2.state', 'models/net_g_latest.pth'):
            assert (exp / name).is_file(), name
        iters = [line for line in records if 'l_d: ' in line]
        assert len(iters) == 3
        assert 'l_g_path' in iters[1] and 'l_d_r1' in iters[1]
        assert np.isfinite(model.get_current_log()['l_d'])
        records.clear()
        resumed = train_pipeline(str(tmp_path), [
            '-opt', str(_cli_yml(tmp_path, faces, 4)), '--auto_resume',
            '--device', 'cpu'])
    finally:
        logger.removeHandler(handler)
    assert any('Resuming training from epoch' in line and 'iter: 2' in line
               for line in records)
    assert (exp / 'training_states' / '4.state').is_file()
    assert resumed.schedulers[0].last_iter == 4


# ------------------------------------------------------------ converter
def _rosinality_g_key(key):
    """rosinality's generator name of a port key."""
    key = key.replace('style_mlp', 'style').replace('constant_input.weight',
                                                    'input.input')
    key = re.sub(r'^style_conv1\.', 'conv1.', key)
    key = re.sub(r'^style_convs\.', 'convs.', key)
    key = key.replace('modulated_conv', 'conv')
    if re.fullmatch(r'(conv1|convs\.\d+)\.weight', key):
        key = key[:-len('weight')] + 'noise.weight'
    return key.replace('noises.noise', 'noises.noise_')


def test_stylegan2_converter(tmp_path):
    with torch.device('meta'):
        g = StyleGAN2Generator(SIDE, 16, 2, 1, narrow=0.125)
        d = StyleGAN2Discriminator(SIDE, 1, narrow=0.125)
    gen = torch.Generator().manual_seed(8)
    port_g = {k: torch.randn(v.shape, generator=gen)
              for k, v in g.state_dict().items()}
    port_d = {k: torch.randn(v.shape, generator=gen)
              for k, v in d.state_dict().items()}
    ori = {'g_ema': {_rosinality_g_key(k): v for k, v in port_g.items()},
           'd': {k.replace('conv_body', 'convs'): v
                 for k, v in port_d.items()}}
    assert len(ori['g_ema']) == len(port_g)
    shapes_g = {k: tuple(v.shape) for k, v in port_g.items()}
    shapes_d = {k: tuple(v.shape) for k, v in port_d.items()}
    script = runpy.run_path(os.path.join(
        ROOT, 'scripts', 'model_conversion', 'convert_stylegan.py'))
    for convert, theirs, shapes, port, part in (
            (convert_stylegan.convert_net_g, script['convert_net_g'],
             shapes_g, port_g, 'g_ema'),
            (convert_stylegan.convert_net_d, script['convert_net_d'],
             shapes_d, port_d, 'd')):
        mine, want = convert(ori[part], shapes), theirs(ori[part], shapes)
        assert mine.keys() == want.keys() == port.keys()
        for key, val in port.items():
            assert torch.equal(mine[key], val) and torch.equal(want[key], val)
    with pytest.raises(ValueError, match='Wrong tensor size'):
        convert_stylegan.convert_net_g(ori['g_ema'], dict(
            shapes_g, **{'to_rgb1.bias': (2,)}))
    full_g, full_d = convert_stylegan.port_shapes(SIDE, 1)
    assert full_g['style_mlp.8.weight'] == (512, 512)
    assert set(full_d) == set(shapes_d)
    zeros = {k: torch.zeros(v) for k, v in full_g.items()}
    ori = {'g_ema': {_rosinality_g_key(k): v.clone()
                     for k, v in zeros.items()},
           'd': {k.replace('conv_body', 'convs'): torch.ones(v)
                 for k, v in full_d.items()},
           'args': argparse.Namespace(size=SIDE, channel_multiplier=1)}
    ori_path = tmp_path / 'rosinality.pt'
    torch.save(ori, ori_path)
    convert_stylegan.main(['--ori', str(ori_path), '--size', str(SIDE),
                           '--channel_multiplier', '1',
                           '--save', str(tmp_path / 'out.pth')])
    out = torch.load(tmp_path / 'out.pth', weights_only=True)
    assert out['params_ema'].keys() == full_g.keys()
    assert out['params'].keys() == full_d.keys()
    assert all(bool((v == 1).all()) for v in out['params'].values())
