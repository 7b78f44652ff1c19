"""Real-ESRGAN's data side of the port against the JAX package's on the
CPU: ``RealESRGANDataset`` and ``RealESRGANPairedDataset`` item for item
(the port's ``random.Random(seed)`` / ``RandomState(seed)`` against
python's and numpy's global generators seeded alike), the synthesizer's
host draws and resize matrices, the synthesis itself over its branches
and resize modes, the ``usm_source`` flag, the device crop and the pool.

The synthesis is held to the JAX package's with the noise made
deterministic (``noise_range`` and ``poisson_scale_range`` [0, 0], one
JPEG quality a stage), since ``jax.random``'s draws cannot be matched: the
JAX step's output before the last rounding to 8-bit levels (taken with
``degradation_synth``'s ``jnp.round`` replaced by the identity) within
1e-5 (measured 5.7e-7); after it, no entry more than one level apart and
at most 0.1 % of them one level apart (measured: none). JPEG's rounding is
discontinuous: a one-ulp change of a DCT coefficient at a tie would move a
whole 8 x 8 block, and the final rounding one pixel; these inputs hit no
tie. The JAX synthesis compiles twice (rounded and not), once each."""
import itertools
import random
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.data import build_dataset as jax_build_dataset
from mrefsr_tpu.models import degradation_synth as jax_synth_module
from mrefsr_tpu_torch.data import build_dataset
from mrefsr_tpu_torch.models.degradation_synth import (
    DegradationSynthesizer, TrainingPairPool, paired_random_crop_device)

GT, B, SCALE = 64, 2, 4
PRE_ROUND_TOL, ONE_LEVEL_SHARE = 1e-5, 1e-3
DEGRADE = {'scale': SCALE,
           'resize_prob': [0.2, 0.7, 0.1], 'resize_range': [0.15, 1.5],
           'gaussian_noise_prob': 0.5, 'noise_range': [0, 0],
           'poisson_scale_range': [0, 0], 'gray_noise_prob': 0.4,
           'jpeg_range': [70, 70], 'second_blur_prob': 0.8,
           'resize_prob2': [0.3, 0.4, 0.3], 'resize_range2': [0.3, 1.2],
           'gaussian_noise_prob2': 0.5, 'noise_range2': [0, 0],
           'poisson_scale_range2': [0, 0], 'gray_noise_prob2': 0.4,
           'jpeg_range2': [45, 45]}
KERNELS = {'blur_kernel_size': 21,
           'kernel_list': ['iso', 'aniso', 'generalized_iso',
                           'generalized_aniso', 'plateau_iso',
                           'plateau_aniso'],
           'kernel_prob': [0.45, 0.25, 0.12, 0.03, 0.12, 0.03],
           'sinc_prob': 0.5, 'blur_sigma': [0.2, 3], 'betag_range': [0.5, 4],
           'betap_range': [1, 2], 'blur_kernel_size2': 21,
           'kernel_list2': ['iso', 'aniso', 'generalized_iso',
                            'generalized_aniso', 'plateau_iso',
                            'plateau_aniso'],
           'kernel_prob2': [0.45, 0.25, 0.12, 0.03, 0.12, 0.03],
           'sinc_prob2': 0.5, 'blur_sigma2': [0.2, 1.5],
           'betag_range2': [0.5, 4], 'betap_range2': [1, 2],
           'final_sinc_prob': 0.5}
MODES = [('area', 'bilinear', 'bicubic'), ('bicubic', 'area', 'bilinear'),
         ('bilinear', 'bicubic', 'area')]


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def folders(tmp_path_factory):
    """A gt folder of 4 PNGs (two larger than ``crop_pad_size`` 64, one
    smaller, one equal) and an lq / gt pair folder of 3."""
    root = tmp_path_factory.mktemp('realesrgan')
    rng = np.random.RandomState(0)
    gt = root / 'gt'
    gt.mkdir()
    for name, (h, w) in zip('abcd', ((72, 80), (48, 70), (64, 64),
                                     (90, 66))):
        cv2.imwrite(str(gt / f'{name}.png'),
                    (rng.rand(h, w, 3) * 255).astype(np.uint8))
    for sub in ('pair_gt', 'pair_lq'):
        (root / sub).mkdir()
    for name in ('x', 'y', 'z'):
        img = (rng.rand(64, 48, 3) * 255).astype(np.uint8)
        cv2.imwrite(str(root / 'pair_gt' / f'{name}.png'), img)
        cv2.imwrite(str(root / 'pair_lq' / f'{name}.png'),
                    cv2.resize(img, (12, 16), interpolation=cv2.INTER_AREA))
    (root / 'meta.txt').write_text('x.png, x.png\nz.png, z.png\n')
    return root


def _dataset_opt(root):
    return {'name': 'toy', 'type': 'RealESRGANDataset', 'phase': 'train',
            'scale': SCALE, 'io_backend': {'type': 'disk'},
            'dataroot_gt': str(root / 'gt'), 'use_hflip': True,
            'use_rot': True, 'crop_pad_size': 64, **KERNELS}


def test_realesrgan_dataset_matches_jax(folders):
    """Two passes over the set: ``gt`` (flipped, padded or cropped to
    64), ``kernel1``, ``kernel2``, ``sinc_kernel`` and the path equal to
    the JAX package's bit for bit; the kernels sum to 1."""
    opt = _dataset_opt(folders)
    random.seed(5)
    np.random.seed(5)
    jax_set = jax_build_dataset(dict(opt))
    want = [jax_set[i % 4] for i in range(8)]
    port = build_dataset(dict(opt), seed=5)
    assert len(port) == 4
    for i, item in enumerate(want):
        got = port[i % 4]
        assert sorted(got) == sorted(item)
        assert got['gt_path'] == item['gt_path']
        for key in ('gt', 'kernel1', 'kernel2', 'sinc_kernel'):
            assert got[key].dtype == np.float32
            assert np.array_equal(got[key], item[key]), (i, key)
        assert got['gt'].shape == (64, 64, 3)
        for key in ('kernel1', 'kernel2', 'sinc_kernel'):
            np.testing.assert_allclose(got[key].sum(), 1, atol=1e-4)


@pytest.mark.parametrize('meta', [False, True])
def test_realesrgan_paired_dataset_matches_jax(folders, meta):
    """Training crops (gt 32) and flips, and validation's whole images,
    from two folders or a ``meta_info`` file: equal to the JAX
    package's."""
    for phase in ('train', 'val'):
        opt = {'name': 'pairs', 'type': 'RealESRGANPairedDataset',
               'phase': phase, 'scale': SCALE, 'io_backend': {'type': 'disk'},
               'dataroot_gt': str(folders / 'pair_gt'),
               'dataroot_lq': str(folders / 'pair_lq'), 'gt_size': 32,
               'use_hflip': True, 'use_rot': True}
        if meta:
            opt['meta_info'] = str(folders / 'meta.txt')
        random.seed(2)
        np.random.seed(2)
        jax_set = jax_build_dataset(dict(opt))
        port = build_dataset(dict(opt), seed=2)
        assert len(port) == len(jax_set) == (2 if meta else 3)
        for i in range(len(port)):
            want, got = jax_set[i], port[i]
            for key in ('lq', 'gt', 'lq_path', 'gt_path'):
                assert np.array_equal(got[key], want[key]), (phase, i, key)


def _synth_inputs(seed=0):
    rng = np.random.RandomState(seed)
    gt = rng.rand(B, GT, GT, 3).astype(np.float32)
    kernels = []
    for _ in range(3):
        k = rng.rand(B, 21, 21).astype(np.float32)
        kernels.append(k / k.sum((1, 2), keepdims=True))
    return gt, kernels


@pytest.fixture(scope='module')
def jax_synths():
    """The JAX synthesizer as it is, and one traced with
    ``degradation_synth``'s ``jnp.round`` replaced by the identity (its
    output before the last rounding)."""
    plain = jax_synth_module.DegradationSynthesizer(dict(DEGRADE))
    unrounded = jax_synth_module.DegradationSynthesizer(dict(DEGRADE))
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith('__')})
    proxy.round = lambda x: x

    def run_unrounded(*args, **kwargs):
        jax_synth_module.jnp = proxy
        try:
            return unrounded._jit_synth(*args, **kwargs)
        finally:
            jax_synth_module.jnp = jnp

    return plain, run_unrounded


def _jax_synth(fn, host, plan, gt, kernels, usm_source=True):
    """The JAX package's jitted synthesis on the port's host inputs."""
    return fn(jax.random.PRNGKey(0), jnp.asarray(gt),
              *(jnp.asarray(k) for k in kernels),
              *(jnp.asarray(host[k]) for k in ('a1h', 'a1w', 'a2h', 'a2w',
                                                'a3h', 'a3w')),
              *(jnp.int32(host[k]) for k in ('h1', 'w1', 'h2', 'w2')),
              *(jnp.asarray(plan[k]) for k in ('noise1_gaussian',
                                               'second_blur',
                                               'noise2_gaussian',
                                               'resize_first')),
              gt_hw=(GT, GT), c1=host['c1'], c2=host['c2'],
              usm_source=usm_source)


def _check_lq(got_lq, want_lq):
    levels = np.abs(got_lq - want_lq) * 255
    assert levels.max() <= 1 + 1e-3
    assert (levels > 0.5).mean() <= ONE_LEVEL_SHARE


CASES = list(itertools.product([False, True], [False, True],
                               ['gaussian', 'poisson'], range(3)))


@pytest.mark.parametrize('resize_first,second_blur,noise,modes', CASES)
def test_synthesis_matches_jax(jax_synths, resize_first, second_blur, noise,
                               modes):
    """Each branch of the synthesis (the last resize before or after the
    JPEG, the second blur or none, Gaussian or Poisson noise in the first
    stage and the other in the second) with each resize mode in each
    stage, up, down and kept scales: ``gt_usm`` within 4e-6, the output
    before the last rounding and ``lq`` at the tolerances of the module
    docstring."""
    gt, kernels = _synth_inputs()
    i = CASES.index((resize_first, second_blur, noise, modes))
    plan = {'s1': (1.3, 0.4, 1)[i % 3], 'mode1': MODES[modes][0],
            'noise1_gaussian': noise == 'gaussian',
            'second_blur': second_blur, 's2': (0.6, 1.1, 1)[i // 3 % 3],
            'mode2': MODES[modes][1], 'noise2_gaussian': noise != 'gaussian',
            'resize_first': resize_first, 'mode3': MODES[modes][2]}
    port = DegradationSynthesizer(dict(DEGRADE), 'cpu', 0)
    host = port.host_inputs(plan, GT, GT)
    plain, run_unrounded = jax_synths
    want_usm, want_lq = _jax_synth(plain._jit_synth, host, plan, gt, kernels)
    _, want_pre = _jax_synth(run_unrounded, host, plan, gt, kernels)
    t = [torch.from_numpy(a) for a in (gt, *kernels)]
    got_usm, got_pre = port.degrade(*t, plan=plan)
    np.testing.assert_allclose(got_usm.numpy(), np.asarray(want_usm),
                               rtol=0, atol=4e-6)
    np.testing.assert_allclose(np.clip(got_pre.numpy(), 0, 1),
                               np.asarray(want_pre), rtol=0,
                               atol=PRE_ROUND_TOL)
    _, got_lq = port(*t, plan=plan)
    assert got_lq.shape == (B, GT // SCALE, GT // SCALE, 3)
    _check_lq(got_lq.numpy(), np.asarray(want_lq))


def test_host_draws_and_matrices_match_jax(jax_synths):
    """Eight calls drawing their own decisions: the port's synthesizer
    seeded 9 draws what the JAX package's draws from python's and numpy's
    generators seeded 9 (every argument its jitted synthesis gets), and
    the two ``lq`` agree."""
    gt, kernels = _synth_inputs(1)
    plain, _ = jax_synths
    captured = []
    real = plain._jit_synth

    def capture(*args, **kwargs):
        captured.append((args, kwargs))
        return real(*args, **kwargs)

    random.seed(9)
    np.random.seed(9)
    plain._jit_synth = capture
    try:
        want = [np.asarray(plain(jax.random.PRNGKey(0), jnp.asarray(gt),
                                 *(jnp.asarray(k) for k in kernels))[1])
                for _ in range(8)]
    finally:
        plain._jit_synth = real
    port = DegradationSynthesizer(dict(DEGRADE), 'cpu', 9)
    t = [torch.from_numpy(a) for a in (gt, *kernels)]
    for (args, kwargs), want_lq in zip(captured, want):
        plan = port.draw()
        host = port.host_inputs(plan, GT, GT)
        names = ('a1h', 'a1w', 'a2h', 'a2w', 'a3h', 'a3w', 'h1', 'w1', 'h2',
                 'w2')
        for name, arg in zip(names, args[5:15]):
            assert np.array_equal(np.asarray(arg), host[name]), name
        flags = ('noise1_gaussian', 'second_blur', 'noise2_gaussian',
                 'resize_first')
        assert [bool(a) for a in args[15:19]] == [plan[k] for k in flags]
        assert (kwargs['c1'], kwargs['c2']) == (host['c1'], host['c2'])
        _check_lq(port(*t, plan=plan)[1].numpy(), want_lq)
    assert len({(p['mode1'], p['resize_first']) for p in
                [DegradationSynthesizer(dict(DEGRADE), 'cpu', s).draw()
                 for s in range(12)]}) > 2


def test_usm_source_flag():
    """``usm_source`` false degrades ``gt`` itself and hands it back as
    ``gt_usm``; true degrades ``usm(gt)``: the same plan gives another
    ``lq``."""
    gt, kernels = _synth_inputs(2)
    t = [torch.from_numpy(a) for a in (gt, *kernels)]
    port = DegradationSynthesizer(dict(DEGRADE), 'cpu', 0)
    plan = port.draw()
    src_raw, lq_raw = port(*t, usm_source=False, plan=plan)
    src_usm, lq_usm = port(*t, usm_source=True, plan=plan)
    assert src_raw is t[0]
    assert not torch.allclose(src_usm, t[0])
    assert not torch.equal(lq_raw, lq_usm)


def test_paired_random_crop_device():
    """One corner for the batch, drawn from the given generator: the lq
    window at (top, left) and the gt window at (top, left) x scale, for
    every gt-sized and lq-sized tensor of the lists; a single tensor in
    gives a single tensor out."""
    ys, xs = np.meshgrid(np.arange(40), np.arange(48), indexing='ij')
    lq = torch.from_numpy(np.stack([ys, xs, ys * 0], -1)[None].repeat(
        2, 0).astype(np.float32))
    gt = lq.repeat_interleave(SCALE, 1).repeat_interleave(SCALE, 2) * SCALE
    state = torch.get_rng_state()
    corners = set()
    for seed in range(6):
        gen = torch.Generator().manual_seed(seed)
        (g1, g2), lq_c = paired_random_crop_device([gt, gt + 1], lq, 64,
                                                   SCALE, gen)
        assert lq_c.shape == (2, 16, 16, 3) and g1.shape == (2, 64, 64, 3)
        top, left = int(lq_c[0, 0, 0, 0]), int(lq_c[0, 0, 0, 1])
        corners.add((top, left))
        assert torch.equal(lq_c, lq[:, top:top + 16, left:left + 16])
        assert torch.equal(g1, gt[:, 4 * top:4 * top + 64,
                                  4 * left:4 * left + 64])
        assert torch.equal(g2, g1 + 1)
        again = paired_random_crop_device(
            gt, lq, 64, SCALE, torch.Generator().manual_seed(seed))
        assert torch.equal(again[0], g1) and torch.equal(again[1], lq_c)
    assert len(corners) > 1
    assert torch.equal(torch.get_rng_state(), state)


def test_training_pair_pool():
    """Queue 6, batch 2: three calls fill it and pass through; from then
    on each returns two pairs that were queued (each lq with its own gt,
    from earlier calls) and queues its own; a batch that does not divide
    the queue raises."""
    pool = TrainingPairPool(6, torch.Generator().manual_seed(0))

    def batch(ids):
        ids = torch.tensor(ids, dtype=torch.float32)
        return ids.view(-1, 1, 1, 1).expand(-1, 2, 2, 3), \
            (ids * 10).view(-1, 1, 1, 1).expand(-1, 8, 8, 3)

    seen = set()
    for call in range(8):
        ids = [2 * call, 2 * call + 1]
        lq, gt = batch(ids)
        out_lq, out_gt = pool(lq.clone(), gt.clone())
        got = [int(v) for v in out_lq[:, 0, 0, 0]]
        assert torch.equal(out_gt[:, 0, 0, 0], out_lq[:, 0, 0, 0] * 10)
        if call < 3:
            assert got == ids
        else:
            assert all(v in seen for v in got), (call, got, seen)
        seen.update(ids)
        queued = {int(v) for v in pool.queue_lr[:, 0, 0, 0]}
        assert set(ids) <= queued
        seen -= set(got) if call >= 3 else set()
    with pytest.raises(ValueError, match='divisible'):
        TrainingPairPool(5)(*batch([0, 1]))
