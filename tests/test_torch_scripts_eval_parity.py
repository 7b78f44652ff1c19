"""The port's CUFED5 parity gate (``mrefsr_tpu_torch/scripts/eval_parity.py``)
against the JAX package's (``scripts/eval_parity.py``) on the CPU, on the
same synthetic CUFED5 folder (two groups of an input and 5 refs near
90 x 70, padded to a 96 canvas) and the same reference-layout ``.pth``
files, written once with ``mrefsr_tpu.convert.save_torch_checkpoint`` from
seeded flax parameters (MRAPA ngf 8, one block, 8 deform groups; every
offset conv live, so DCN samples between pixels), and a seeded
torchvision-layout ``vgg19`` for the map's VGG.

PSNR and PSNR_Y within 1e-3 dB and SSIM_Y within 1e-5 of the JAX
script's (measured: 6.4e-6 dB, 9.8e-6 dB and 1.0e-6, at 9.81 dB, 12.74 dB and
0.136); the JSON report's
keys; exit status 0 without a gate and with a passing one, 2 with a
failing one (through ``python -m``); the bucketed
bf16 serving form runs; and without ``--device`` on a host without CUDA
the script raises rather than run on the CPU. The JAX script compiles its
forward once here."""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs.contras_extractor_arch import ContrasMultiExtractorSep
from mrefsr_tpu.archs.ref_mrapa_restoration_arch import MRAPARestorationNet
from mrefsr_tpu.convert import save_torch_checkpoint
from mrefsr_tpu_torch.scripts import eval_parity
from torch_video_params import random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS, NGF, N_BLOCKS, T = 96, 8, 1, 5
PSNR_TOL_DB, SSIM_TOL = 1e-3, 1e-5


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp('eval_parity')
    cufed = root / 'CUFED5'
    cufed.mkdir()
    rng = np.random.RandomState(0)
    for g in range(2):
        h, w = 90 - 8 * g, 70 + 6 * g
        for i in range(T + 1):
            img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(cufed / f'{g:03d}_{i}.png'),
                        cv2.GaussianBlur(img, (3, 3), 1))
    x = np.zeros((1, 32, 32, 3), np.float32)
    params_ex = random_params(ContrasMultiExtractorSep(),
                              [x, np.zeros((1, T, 32, 32, 3), np.float32)],
                              seed=1)
    pre = {lv: np.zeros((1, T, 8 * s, 8 * s, 9, 2), np.float32)
           for lv, s in (('relu3_1', 1), ('relu2_1', 2), ('relu1_1', 4))}
    feat = {lv: np.zeros((1, T, 8 * s, 8 * s, c), np.float32)
            for lv, s, c in (('relu3_1', 1, 256), ('relu2_1', 2, 128),
                             ('relu1_1', 4, 64))}
    params_g = random_params(
        MRAPARestorationNet(ngf=NGF, n_blocks=N_BLOCKS, groups=8),
        [np.zeros((1, 8, 8, 3), np.float32), pre, feat], seed=2)
    paths = {'extractor': str(root / 'feature_extraction_network.pth'),
             'net_g': str(root / 'mrapa_restoration.pth'),
             'vgg19': str(root / 'vgg19.pth')}
    save_torch_checkpoint(paths['extractor'], params_ex)
    save_torch_checkpoint(paths['net_g'], params_g)
    # torchvision's vgg19 layout up to conv3_1, the map's deepest tap: the
    # map's VGG from one file in both (seeded apart, the two would differ)
    gen = torch.Generator().manual_seed(3)
    vgg = {}
    for idx, cin, cout in ((0, 3, 64), (2, 64, 64), (5, 64, 128),
                           (7, 128, 128), (10, 128, 256)):
        vgg[f'features.{idx}.weight'] = torch.randn(
            cout, cin, 3, 3, generator=gen) * (2 / (9 * cin)) ** 0.5
        vgg[f'features.{idx}.bias'] = torch.randn(cout, generator=gen) * 0.01
    torch.save(vgg, paths['vgg19'])
    return dict(paths, cufed=str(cufed), results=str(root / 'results'))


def _argv(assets, extra=(), canvas=CANVAS):
    return ['--net_g', assets['net_g'], '--extractor', assets['extractor'],
            '--cufed5', assets['cufed'], '--vgg19', assets['vgg19'],
            '--results-dir', assets['results'],
            '--canvas', str(canvas), '--ngf', str(NGF),
            '--n-blocks', str(N_BLOCKS), *extra]


def _port(assets, extra=(), canvas=CANVAS):
    """The port's exit status and JSON report, in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = eval_parity.main(_argv(assets, ['--device', 'cpu', *extra],
                                      canvas))
    return code, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope='module')
def port_run(assets):
    """The port's run without gates."""
    return _port(assets)


@pytest.fixture(scope='module')
def jax_report(assets):
    """The JAX script's report without gates (its exit status 0)."""
    spec = importlib.util.spec_from_file_location(
        'jax_eval_parity', os.path.join(REPO, 'scripts', 'eval_parity.py'))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, 'argv', ['eval_parity.py'] + _argv(assets))
        with contextlib.redirect_stdout(out), \
                pytest.raises(SystemExit) as exc:
            script.main()
    assert (exc.value.code or 0) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_metrics_match_the_jax_script(port_run, jax_report):
    code, report = port_run
    assert code == 0 and report['parity_ok'] is None and report['gates'] == {}
    assert set(report) == set(jax_report) == {'metrics', 'gates',
                                              'parity_ok'}
    got, want = report['metrics'], jax_report['metrics']
    assert set(got) == set(want) == {'psnr', 'psnr_y', 'ssim_y'}
    for key in ('psnr', 'psnr_y'):
        assert abs(got[key] - want[key]) <= PSNR_TOL_DB, (key, got, want)
    assert abs(got['ssim_y'] - want['ssim_y']) <= SSIM_TOL, (got, want)


def test_gates(assets, port_run):
    """A gate at the measured values passes (0); one 0.2 dB off fails (2)
    through ``python -m``."""
    m = port_run[1]['metrics']
    code, gated = _port(assets, [
        '--expected-psnr', repr(m['psnr']),
        '--expected-psnr-y', repr(m['psnr_y']),
        '--expected-ssim-y', repr(m['ssim_y'])])
    assert code == 0 and gated['parity_ok'] is True
    assert all(g['pass'] for g in gated['gates'].values())
    assert len(gated['gates']) == 3
    proc = subprocess.run(
        [sys.executable, '-m', 'mrefsr_tpu_torch.scripts.eval_parity',
         *_argv(assets, ['--device', 'cpu', '--expected-psnr',
                         repr(m['psnr'] + 0.2)])],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert proc.returncode == 2, proc.stderr[-2000:]
    failed = json.loads(proc.stdout.strip().splitlines()[-1])
    assert failed['parity_ok'] is False and failed['metrics'] == m
    assert failed['gates']['psnr']['delta'] == pytest.approx(-0.2)


def test_bucketed_bf16_serving_form(assets):
    code, report = _port(assets, ['--bf16'], canvas='96,128')
    assert code == 0
    assert all(np.isfinite(v) for v in report['metrics'].values())


def test_no_cuda_and_no_device_raises(assets, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        eval_parity.main(_argv(assets))
