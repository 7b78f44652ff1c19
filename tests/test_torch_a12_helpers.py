"""A12's helpers in the port against their JAX counterparts on the CPU,
and the training CLI's profiler window:

* ``img_rotate``, ``tensor2img_fast``, ``crop_border``, ``ycbcr2rgb``,
  ``ycbcr2bgr``, ``cdf2``, ``random_generate_gaussian_noise`` and
  ``random_generate_poisson_noise`` (one numpy seed, the JAX package's
  global generator against the port's ``RandomState``), ``paste_nearest``
  and ``ordered_yaml``: equal to the last bit; ``ProgressBar``'s output
  with the clock fixed: equal;
* ``rgb2ycbcr_pt``: within 1e-6 (f32 products in another order);
* ``compress_jpeg`` / ``decompress_jpeg``: the quantised blocks (with the
  differentiable rounding, which has no tie to fall apart) within 1e-4,
  the round trip of the exact rounding within 1e-6, as ``DiffJPEG``'s test
  holds it;
* ``RefAwareBlock`` from the reference's parameter layout (the JAX
  module's ``variables_from_torch``), with and without ``original_size``:
  rtol 1e-5;
* ``StepProfiler`` in ``train_pipeline``: a 4-iteration CPU run with
  ``profile_start_iter: 3`` and ``profile_num_steps: 5`` writes one Chrome
  trace of iterations 3-4 under ``<experiments_root>/tb_logger`` (the
  window the loop's end closes); alone, a window of 2 from iteration 3
  (``>=``: a resumed run opens it at its first iteration), once.
"""
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mrefsr_tpu import utils as jax_utils
from mrefsr_tpu.archs.arch_util import RefAwareBlock as JaxRefAwareBlock
from mrefsr_tpu.archs.dfdnet_arch import paste_nearest as jax_paste_nearest
from mrefsr_tpu.data import degradations as jax_degradations
from mrefsr_tpu.data.transforms import img_rotate as jax_img_rotate
from mrefsr_tpu.utils import color_util as jax_color_util
from mrefsr_tpu.utils import diffjpeg as jax_diffjpeg
from mrefsr_tpu.utils.options import ordered_yaml as jax_ordered_yaml
from mrefsr_tpu_torch.archs.arch_util import RefAwareBlock
from mrefsr_tpu_torch.archs.dfdnet_arch import paste_nearest
from mrefsr_tpu_torch.data import degradations
from mrefsr_tpu_torch.data.transforms import img_rotate
from mrefsr_tpu_torch.train import train_pipeline
from mrefsr_tpu_torch.utils import (ProgressBar, color_util, crop_border,
                                    diffjpeg, tensor2img_fast)
from mrefsr_tpu_torch.utils.options import ordered_yaml
from mrefsr_tpu_torch.utils.profiler import StepProfiler

from test_torch_sr_model import _cli_options, _paired_folder


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _img(seed, shape, dtype=np.float32):
    img = np.random.RandomState(seed).rand(*shape)
    return (img * 255).astype(np.uint8) if dtype == np.uint8 \
        else img.astype(np.float32)


@pytest.mark.parametrize('kwargs', [{'angle': 30},
                                    {'angle': -75, 'center': (3, 5),
                                     'scale': 1.3}])
def test_img_rotate(kwargs):
    img = _img(0, (17, 23, 3))
    np.testing.assert_array_equal(img_rotate(img, **kwargs),
                                  jax_img_rotate(img, **kwargs))


@pytest.mark.parametrize('shape', [(1, 9, 7, 3), (9, 7, 3)])
@pytest.mark.parametrize('kwargs', [{}, {'rgb2bgr': False,
                                         'min_max': (-1, 1)}])
def test_tensor2img_fast_and_crop_border(shape, kwargs):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32) * 0.7
    want = jax_utils.tensor2img_fast(x, **kwargs)
    np.testing.assert_array_equal(tensor2img_fast(x, **kwargs), want)
    np.testing.assert_array_equal(tensor2img_fast(torch.from_numpy(x),
                                                  **kwargs), want)
    imgs = [want, want[:5]]
    for border in (0, 2):
        got, ref = crop_border(imgs, border), jax_utils.crop_border(imgs,
                                                                     border)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(crop_border(want, border),
                                      jax_utils.crop_border(want, border))


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_ycbcr_conversions(dtype):
    img = _img(2, (11, 13, 3), dtype)
    for name in ('ycbcr2rgb', 'ycbcr2bgr', 'rgb2ycbcr', 'bgr2ycbcr'):
        got = getattr(color_util, name)(img)
        want = getattr(jax_color_util, name)(img)
        assert got.dtype == want.dtype == dtype
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize('y_only', [False, True])
def test_rgb2ycbcr_pt(y_only):
    x = _img(3, (2, 3, 8, 9))
    got = color_util.rgb2ycbcr_pt(torch.from_numpy(x), y_only=y_only)
    want = np.asarray(jax_color_util.rgb2ycbcr_pt(jnp.asarray(x),
                                                  y_only=y_only))
    assert got.shape == want.shape == (2, 1 if y_only else 3, 8, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_cdf2_and_the_noise_draws():
    grid = np.random.RandomState(4).randn(5, 5, 2)
    d = np.array([[1.2, 0.3], [-0.1, 0.8]])
    np.testing.assert_array_equal(degradations.cdf2(d, grid),
                                  jax_degradations.cdf2(d, grid))
    img = _img(5, (12, 10, 3))
    for name, kwargs in (
            ('random_generate_gaussian_noise', {'sigma_range': (1, 20),
                                                'gray_prob': 0.5}),
            ('random_generate_poisson_noise', {'scale_range': (0.1, 2),
                                               'gray_prob': 0.5})):
        for seed in range(4):                # gray and colour draws
            np.random.seed(seed)
            want = getattr(jax_degradations, name)(img, **kwargs)
            got = getattr(degradations, name)(
                img, **kwargs, np_rng=np.random.RandomState(seed))
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_random_add_noise_keeps_its_draws():
    img = _img(6, (12, 10, 3))
    np.random.seed(7)
    want = jax_degradations.random_add_gaussian_noise(img, (1, 30), 0.4)
    got = degradations.random_add_gaussian_noise(
        img, (1, 30), 0.4, np_rng=np.random.RandomState(7))
    np.testing.assert_array_equal(got, want)
    np.random.seed(8)
    want = jax_degradations.random_add_poisson_noise(img, (0.05, 3), 0.4)
    got = degradations.random_add_poisson_noise(
        img, (0.05, 3), 0.4, np_rng=np.random.RandomState(8))
    np.testing.assert_array_equal(got, want)


def test_compress_and_decompress_jpeg():
    x = _img(9, (2, 32, 48, 3))
    factor = np.array([0.6, 1.7], np.float32)
    for rounding, jax_rounding, tol in (
            (diffjpeg.diff_round, jax_diffjpeg.diff_round, 1e-4),
            (torch.round, jnp.round, None)):
        got = diffjpeg.compress_jpeg(torch.from_numpy(x),
                                     torch.from_numpy(factor), rounding)
        want = jax_diffjpeg.compress_jpeg(jnp.asarray(x),
                                          jnp.asarray(factor), jax_rounding)
        for g, w, n in zip(got, want, (24, 6, 6)):
            assert g.shape == w.shape == (2, n, 8, 8)
            if tol is not None:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                           atol=tol)
        rec = diffjpeg.decompress_jpeg(*got, 32, 48,
                                       torch.from_numpy(factor))
        ref = jax_diffjpeg.decompress_jpeg(*want, 32, 48,
                                           jnp.asarray(factor))
        np.testing.assert_allclose(rec.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4 if tol else 1e-6)
    # a number as the factor, and DiffJPEG's round trip through both
    q = torch.tensor([40., 80.])
    np.testing.assert_array_equal(
        diffjpeg.DiffJPEG(False)(torch.from_numpy(x), q).numpy(),
        diffjpeg.decompress_jpeg(
            *diffjpeg.compress_jpeg(torch.from_numpy(x),
                                    diffjpeg.quality_to_factor(q)),
            32, 48, diffjpeg.quality_to_factor(q)).numpy())


@pytest.mark.parametrize('original_size', [None, (6, 5)])
def test_ref_aware_block(original_size):
    x, ref = _img(10, (2, 8, 7, 4)), _img(11, (2, 8, 7, 6))
    net = RefAwareBlock(out_channels=3, nf=4, ref_nf=6, num_experts=3)
    net.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.bias.normal_(generator=torch.Generator().manual_seed(1))
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    variables = JaxRefAwareBlock.variables_from_torch(state)
    module = JaxRefAwareBlock(out_channels=3, nf=4, ref_nf=6, num_experts=3)
    want = np.asarray(module.apply(variables, jnp.asarray(x),
                                   jnp.asarray(ref), original_size))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(ref).permute(0, 3, 1, 2), original_size)
    assert got.shape == (2, 3, 8, 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('box', [(2, 3, 9, 8), (-3, 5, 6, 14), (0, 0, 4, 4),
                                 (10, 10, 20, 20)])
def test_paste_nearest(box):
    atom = _img(12, (5, 4, 3))
    full, mask = paste_nearest(torch.from_numpy(atom).permute(2, 0, 1), box,
                               (12, 11))
    want, want_mask = jax_paste_nearest(jnp.asarray(atom), box, (12, 11))
    np.testing.assert_array_equal(full.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
    np.testing.assert_array_equal(mask.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want_mask).astype(np.float32))


def test_ordered_yaml():
    loader, dumper = ordered_yaml()
    assert (loader.__name__, dumper.__name__) == tuple(
        c.__name__ for c in jax_ordered_yaml())
    text = yaml.dump({'z': 1, 'a': [2, 3]}, Dumper=dumper, sort_keys=False)
    assert list(yaml.load(text, Loader=loader)) == ['z', 'a']


@pytest.mark.parametrize('task_num', [0, 3])
def test_progress_bar(task_num, capsys, monkeypatch):
    outputs = []
    for cls in (ProgressBar, jax_utils.ProgressBar):
        ticks = iter([100., 101.5, 103., 104.5])
        monkeypatch.setattr(time, 'time', lambda: next(ticks))
        bar = cls(task_num, bar_width=10)
        for i in range(3):
            bar.update(f'item {i}')
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1] and 'item 2' in outputs[0] or \
        task_num == 0 and outputs[0] == outputs[1]


def _profiled_run(root, **logger):
    """``train_pipeline`` on ``test_torch_sr_model.py``'s MSRResNet YAML
    (4 iterations on a paired folder, no validation) with ``logger``'s
    profiler keys; returns ``<experiments_root>/tb_logger`` (the options'
    root joined with the run's name)."""
    opt = yaml.safe_load(_cli_options(
        root, _paired_folder(root / 'data', n=4), 4).read_text())
    opt.pop('val')
    opt['datasets'].pop('val')
    opt['path']['experiments_root'] = str(root / 'experiments')
    opt['logger'].update(save_checkpoint_freq=100, **logger)
    path = root / 'profiled.yml'
    path.write_text(yaml.safe_dump(opt))
    train_pipeline(str(root), ['-opt', str(path), '--device', 'cpu'])
    return os.path.join(opt['path']['experiments_root'], opt['name'],
                        'tb_logger')


def test_step_profiler_window_in_a_cpu_run(tmp_path):
    """The window opens at iteration 3 of 4 and is still open when the
    loop ends: ``train_pipeline`` closes it there, before its last save."""
    trace_dir = _profiled_run(tmp_path, profile_start_iter=3,
                              profile_num_steps=5)
    assert os.listdir(trace_dir) == ['trace_iter3-4.json']
    with open(os.path.join(trace_dir, 'trace_iter3-4.json')) as f:
        events = json.load(f)['traceEvents']
    names = {e.get('name', '') for e in events}
    assert any(n.startswith('aten::conv2d') for n in names)


def test_step_profiler_rules(tmp_path):
    assert not StepProfiler({'logger': {}}).enabled
    prof = StepProfiler({'logger': {'profile_start_iter': 3,
                                    'profile_num_steps': 2,
                                    'profile_dir': str(tmp_path / 'p')},
                         'path': {'experiments_root': str(tmp_path)}})
    for it in range(1, 8):
        prof.maybe_start(it)
        torch.ones(2).sum()
        prof.maybe_stop(it)
    assert prof.trace_path == str(tmp_path / 'p' / 'trace_iter3-4.json')
    assert os.listdir(tmp_path / 'p') == ['trace_iter3-4.json']
    prof.close()
    assert os.listdir(tmp_path / 'p') == ['trace_iter3-4.json']
    # resumed past the start: the first iteration seen opens the window
    late = StepProfiler({'logger': {'profile_start_iter': 3},
                         'path': {'experiments_root': str(tmp_path / 'r')}})
    late.maybe_start(10)
    late.close(12)
    assert late.trace_path == str(tmp_path / 'r' / 'tb_logger' /
                                  'trace_iter10-12.json')
