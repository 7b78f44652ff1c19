"""The port's SR inference entry points (``mrefsr_tpu_torch.inference
.inference_esrgan``, ``inference_swinir``, ``inference_ridnet``) on
``--device cpu`` against the JAX package's scripts, run end to end on the
same folder and the same reference-layout ``.pth`` (``params`` for ESRGAN,
``params_ema`` for SwinIR, a bare state dict for RIDNet): every PNG
within one grey level of the JAX script's (the two round f32 outputs that
differ in the last bits). Both sides run the published nets at tiny widths
(the class each script builds, patched); SwinIR's task table is held to
the JAX script's ``define_model`` at full width, and the ``.pth`` loads
with and without SwinIR's buffers. Without a card and without ``--device
cpu`` each entry point raises."""
import os
import runpy
import sys

import cv2
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs import ridnet_arch as jax_ridnet
from mrefsr_tpu.archs import rrdbnet_arch as jax_rrdbnet
from mrefsr_tpu.archs import swinir_arch as jax_swinir
from mrefsr_tpu_torch.archs import ridnet_arch, rrdbnet_arch, swinir_arch
from mrefsr_tpu_torch.inference import (inference_esrgan, inference_ridnet,
                                        inference_swinir)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_RRDB = dict(num_feat=8, num_block=1, num_grow_ch=4)
TINY_SWINIR = dict(embed_dim=12, depths=(2,), num_heads=(2,))
TINY_RIDNET_MID = 16


def _images(folder, sizes, gray=False, seed=0):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i, (h, w) in enumerate(sizes):
        base = rng.rand(h // 4 + 2, w // 4 + 2, 1 if gray else 3)
        img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
        cv2.imwrite(os.path.join(folder, f'im{i}.png'),
                    (np.clip(img, 0, 1) * 255).round().astype(np.uint8))


def _seeded_pth(cls, kwargs, path, key, buffers=True):
    """A seeded port net's state dict in the reference layout under
    ``key`` (None: bare), SwinIR's buffers kept or left out."""
    with torch.device('meta'):
        net = cls(**kwargs)
    net.to_empty(device='cpu')
    net.init_weights(torch.Generator().manual_seed(5))
    state = {k: v for k, v in net.state_dict().items()
             if buffers or not k.endswith(('relative_position_index',
                                           'attn_mask'))}
    torch.save(state if key is None else {key: state}, path)


def _run_jax_script(monkeypatch, name, argv):
    monkeypatch.setattr(sys, 'argv', [name] + argv)
    runpy.run_path(os.path.join(ROOT, 'inference', name),
                   run_name='__main__')


def _same_pngs(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(sorted(ours), sorted(theirs)):
        assert os.path.basename(a) == os.path.basename(b)
        got = cv2.imread(a, cv2.IMREAD_UNCHANGED).astype(int)
        want = cv2.imread(b, cv2.IMREAD_UNCHANGED).astype(int)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1, a


def _listing(folder):
    return [os.path.join(folder, n) for n in os.listdir(folder)]


def test_esrgan_script_matches_jax(tmp_path, monkeypatch):
    _images(tmp_path / 'in', ((12, 16), (9, 11)))
    pth = tmp_path / 'esrgan.pth'
    _seeded_pth(rrdbnet_arch.RRDBNet, {**inference_esrgan.NET_KWARGS,
                                       **TINY_RRDB}, pth, 'params')
    monkeypatch.setattr(inference_esrgan, 'NET_KWARGS',
                        {**inference_esrgan.NET_KWARGS, **TINY_RRDB})
    ours = inference_esrgan.main(
        ['--input', str(tmp_path / 'in'), '--output', str(tmp_path / 'port'),
         '--model_path', str(pth), '--device', 'cpu'])
    real = jax_rrdbnet.RRDBNet
    monkeypatch.setattr(jax_rrdbnet, 'RRDBNet',
                        lambda **kw: real(**{**kw, **TINY_RRDB}))
    _run_jax_script(monkeypatch, 'inference_esrgan.py',
                    ['--input', str(tmp_path / 'in'), '--output',
                     str(tmp_path / 'jax'), '--model_path', str(pth)])
    _same_pngs(ours, _listing(tmp_path / 'jax'))
    assert cv2.imread(ours[0]).shape == (48, 64, 3)


@pytest.mark.parametrize('task,sizes,buffers', [
    ('classical_sr', ((13, 10), (16, 16)), True),
    ('jpeg_car', ((15, 9),), False)])
def test_swinir_script_matches_jax(tmp_path, monkeypatch, task, sizes,
                                   buffers):
    """``classical_sr`` x2 (window 8, an image to pad) from a ``.pth`` with
    the buffers; ``jpeg_car`` (one grey channel, window 7, ``img_range``
    255) from one without them."""
    gray = task == 'jpeg_car'
    _images(tmp_path / 'in', sizes, gray=gray)
    argv = ['--input', str(tmp_path / 'in'), '--task', task, '--scale',
            '1' if gray else '2', '--patch_size', '16']
    args = inference_swinir.parse_args(argv)
    kwargs = {**inference_swinir.model_kwargs(args), **TINY_SWINIR}
    if not gray:
        kwargs['img_size'] = 16
    pth = tmp_path / 'swinir.pth'
    _seeded_pth(swinir_arch.SwinIR, kwargs, pth, 'params_ema', buffers)
    monkeypatch.setattr(inference_swinir, 'model_kwargs',
                        lambda _: dict(kwargs))
    ours = inference_swinir.main(argv + ['--output', str(tmp_path / 'port'),
                                         '--model_path', str(pth),
                                         '--device', 'cpu'])
    real = jax_swinir.SwinIR
    monkeypatch.setattr(jax_swinir, 'SwinIR', lambda **kw: real(**{
        **kw, **TINY_SWINIR, 'img_size': kwargs['img_size']}))
    _run_jax_script(monkeypatch, 'inference_swinir.py',
                    argv + ['--output', str(tmp_path / 'jax'),
                            '--model_path', str(pth)])
    _same_pngs(ours, _listing(tmp_path / 'jax'))
    want = (sizes[0][0], sizes[0][1]) if gray else \
        (2 * sizes[0][0], 2 * sizes[0][1], 3)
    assert cv2.imread(ours[0], cv2.IMREAD_UNCHANGED).shape == want


@pytest.mark.parametrize('task,large', [
    ('classical_sr', False), ('lightweight_sr', False), ('real_sr', False),
    ('real_sr', True), ('gray_dn', False), ('color_dn', False),
    ('jpeg_car', False)])
def test_swinir_tasks_are_the_jax_scripts(monkeypatch, task, large):
    """Each task's SwinIR at full width: the port's ``model_kwargs`` give
    the fields of the net the JAX script's ``define_model`` builds."""
    scripts = runpy.run_path(os.path.join(ROOT, 'inference',
                                          'inference_swinir.py'))
    define_model = scripts['define_model']
    monkeypatch.setitem(define_model.__globals__, 'load_torch_state_dict',
                        lambda *a, **k: {})
    monkeypatch.setitem(define_model.__globals__, 'torch_to_flax',
                        lambda *a, **k: {})
    argv = ['--task', task, '--scale', '3', '--patch_size', '48'] \
        + (['--large_model'] if large else [])
    args = inference_swinir.parse_args(argv)
    jax_net, _ = define_model(args)
    kwargs = inference_swinir.model_kwargs(args)
    for key, val in kwargs.items():
        assert getattr(jax_net, key) == val, (task, key)
    with torch.device('meta'):
        swinir_arch.SwinIR(**kwargs)


def test_ridnet_script_matches_jax(tmp_path, monkeypatch):
    """[0, 255] inputs from ``<test_path>/X25``, a bare state dict; the
    results under ``results/RIDNet/<test set>`` of the working
    directory."""
    _images(tmp_path / 'rni' / 'X25', ((12, 14), (10, 9)))
    pth = tmp_path / 'ridnet.pth'
    kwargs = {**inference_ridnet.NET_KWARGS,
              'mid_channels': TINY_RIDNET_MID, 'num_block': 1}
    _seeded_pth(ridnet_arch.RIDNet, kwargs, pth, None)
    monkeypatch.setattr(inference_ridnet, 'NET_KWARGS', kwargs)
    monkeypatch.chdir(tmp_path / 'rni')
    argv = ['--test_path', str(tmp_path / 'rni'), '--noise_g', '25',
            '--model_path', str(pth)]
    ours = inference_ridnet.main(argv + ['--device', 'cpu'])
    os.rename('results', 'port_results')
    real = jax_ridnet.RIDNet
    monkeypatch.setattr(jax_ridnet, 'RIDNet', lambda a, b, c: real(
        a, TINY_RIDNET_MID, c, num_block=1))
    _run_jax_script(monkeypatch, 'inference_ridnet.py', argv)
    ours = [os.path.join('port_results', os.path.relpath(p, 'results'))
            for p in ours]
    _same_pngs(ours, _listing(os.path.join('results', 'RIDNet', 'rni')))
    assert os.path.basename(ours[0]) == 'im0_x25_RIDNet.png'


@pytest.mark.parametrize('module', [inference_esrgan, inference_swinir,
                                    inference_ridnet])
def test_entry_points_need_a_card_or_the_cpu_flag(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        module.main([])
