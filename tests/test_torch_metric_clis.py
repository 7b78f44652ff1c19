"""The port's metric CLIs (``mrefsr_tpu_torch/scripts/metrics/``) against
the JAX package's scripts (``scripts/metrics/``) on the CPU, on the same
folders and weight files:

* ``calculate_psnr_ssim`` (RGB with a border, the Y channel, pairing by
  ``--suffix``, ``--correct_mean_var``) and ``calculate_niqe``: the same
  printed lines, to the last digit;
* ``calculate_lpips`` on an official-layout ``vgg.pth`` and a torchvision
  ``vgg16`` written from seeded variables: each pair's value (read from
  the scripts' calls) and the average within rtol 1e-5.

``calculate_stylegan2_fid`` is held in ``test_torch_metric_cli_sg2.py``,
the Inception features of the FID CLIs in ``test_torch_metric_cli_fid.py``.
"""
import argparse
import importlib.util
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from mrefsr_tpu_torch.archs.vgg_arch import NAMES
from mrefsr_tpu_torch.convert import lpips_state_dict_from_flax
from mrefsr_tpu_torch.scripts.metrics import (calculate_lpips,
                                              calculate_niqe,
                                              calculate_psnr_ssim)
from test_torch_face_metrics import _lpips_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_script(name):
    """The JAX package's ``scripts/metrics/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', os.path.join(REPO, 'scripts', 'metrics',
                                    f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def folders(tmp_path_factory):
    """``gt`` and ``restored`` folders of three seeded 200 x 196 images
    (two rows of NIQE's 96 x 96 blocks), the restored ones named
    ``<name>_x.png`` in ``named``."""
    root = tmp_path_factory.mktemp('metric_clis')
    rng = np.random.RandomState(0)
    for i in range(3):
        x = np.linspace(0, 200, 196)[None, :, None] * np.ones((200, 1, 3))
        gt = np.clip(x + rng.randn(200, 196, 3) * 20, 0, 255).astype(np.uint8)
        restored = np.clip(gt * 0.9 + rng.randn(200, 196, 3) * 8 + 10, 0,
                           255).astype(np.uint8)
        for sub, name, img in (('gt', f'{i:03d}.png', gt),
                               ('restored', f'{i:03d}.png', restored),
                               ('named', f'{i:03d}_x.png', restored)):
            os.makedirs(root / sub, exist_ok=True)
            cv2.imwrite(str(root / sub / name), img)
    return root


@pytest.mark.parametrize('options', [
    {'crop_border': 4}, {'crop_border': 0, 'test_y_channel': True},
    {'crop_border': 2, 'suffix': '_x', 'correct_mean_var': True}])
def test_psnr_ssim(folders, options, capsys):
    restored = folders / ('named' if options.get('suffix') else 'restored')
    args = argparse.Namespace(gt=str(folders / 'gt'), restored=str(restored),
                              crop_border=options['crop_border'],
                              suffix=options.get('suffix', ''),
                              test_y_channel=options.get('test_y_channel',
                                                         False),
                              correct_mean_var=options.get(
                                  'correct_mean_var', False))
    jax_script('calculate_psnr_ssim').main(args)
    want = capsys.readouterr().out
    argv = ['--gt', args.gt, '--restored', args.restored, '--crop_border',
            str(args.crop_border), '--suffix', args.suffix]
    argv += ['--test_y_channel'] * args.test_y_channel
    argv += ['--correct_mean_var'] * args.correct_mean_var
    psnr, ssim = calculate_psnr_ssim.main(argv)
    assert capsys.readouterr().out == want
    assert f'Average: PSNR: {psnr:.6f} dB, SSIM: {ssim:.6f}' in want


def test_niqe(folders, capsys):
    jax_script('calculate_niqe').main(argparse.Namespace(
        input=str(folders / 'gt'), crop_border=2))
    want = capsys.readouterr().out
    average = calculate_niqe.main(['--input', str(folders / 'gt'),
                                   '--crop_border', '2'])
    assert capsys.readouterr().out == want
    assert np.isfinite(average) and f'NIQE: {average:.6f}' in want


def test_lpips(folders, tmp_path, capsys, monkeypatch):
    _, variables, _, _ = _lpips_pair()
    state = lpips_state_dict_from_flax(variables)
    index = {name: i for i, name in enumerate(NAMES['vgg16'])}
    lpips_path, vgg_path = tmp_path / 'vgg.pth', tmp_path / 'vgg16.pth'
    torch.save({k: v for k, v in state.items() if k.startswith('lin')},
               lpips_path)
    torch.save({f'features.{index[k.split(".")[2]]}.{k.split(".")[3]}': v
                for k, v in state.items() if k.startswith('vgg.')}, vgg_path)
    argv = ['--gt', str(folders / 'gt'), '--restored',
            str(folders / 'named'), '--suffix', '_x', '--lpips_weights',
            str(lpips_path), '--vgg16_weights', str(vgg_path)]
    values = {'jax': [], 'port': []}
    script = jax_script('calculate_lpips')

    def recording(who, fn):
        def call(*args, **kwargs):
            values[who].append(fn(*args, **kwargs))
            return values[who][-1]
        return call

    monkeypatch.setattr(script, 'calculate_lpips',
                        recording('jax', script.calculate_lpips))
    monkeypatch.setattr(calculate_lpips, 'calculate_lpips',
                        recording('port', calculate_lpips.calculate_lpips))
    monkeypatch.setattr(sys, 'argv', ['calculate_lpips', *argv])
    script.main()
    want = capsys.readouterr().out
    average = calculate_lpips.main(argv + ['--device', 'cpu'])
    assert capsys.readouterr().out.count('LPIPS:') == want.count(
        'LPIPS:') == 4
    assert len(values['port']) == 3 and min(values['jax']) > 0
    np.testing.assert_allclose(values['port'], values['jax'], rtol=1e-5)
    np.testing.assert_allclose(average, np.mean(values['jax']), rtol=1e-5)
