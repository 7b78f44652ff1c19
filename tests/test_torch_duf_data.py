"""DUF's data path against the JAX package's on the CPU:
``generate_gaussian_kernel`` and ``duf_downsample`` at scales 2, 3 and 4,
and ``VideoTestDUFDataset`` on a Vid4-layout folder, with and without
``cache_data`` and ``use_duf_downsampling``.

Tolerance: ``duf_downsample`` is a 13 x 13 weighted sum in f32 whose order
XLA and PyTorch choose apart, so its values agree within 1e-6 (measured
4.2e-7 on values in [0, 1]); everything else of a sample (``gt``, the
read ``lq``, the keys) is equal bit for bit, and so are the port's samples
with and without ``cache_data``."""
import cv2
import numpy as np
import pytest

from mrefsr_tpu.data import build_dataset as jax_build_dataset
from mrefsr_tpu.data import data_util as jax_data_util
from mrefsr_tpu_torch.data import build_dataset
from mrefsr_tpu_torch.data import data_util

DUF_TOL = 1e-6


@pytest.mark.parametrize('scale', [2, 3, 4])
def test_duf_downsample_matches_jax(scale):
    """Frames (T, H, W, C) and one frame (H, W, C), sizes not multiples of
    the scale."""
    rng = np.random.RandomState(scale)
    np.testing.assert_array_equal(
        data_util.generate_gaussian_kernel(13, 0.4 * scale),
        jax_data_util.generate_gaussian_kernel(13, 0.4 * scale))
    for shape in ((3, 23, 29, 3), (26, 19, 3)):
        x = rng.rand(*shape).astype(np.float32)
        got = data_util.duf_downsample(x, kernel_size=13, scale=scale)
        want = jax_data_util.duf_downsample(x, kernel_size=13, scale=scale)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=DUF_TOL)
    with pytest.raises(ValueError, match='scale'):
        data_util.duf_downsample(x, scale=5)


@pytest.fixture(scope='module')
def vid4(tmp_path_factory):
    """Two clips of 7 frames in Vid4's layout, GT 32 x 40 (a multiple of
    the scale, so a cached and a read sample are the same), LQ by OpenCV's
    area resize."""
    root = tmp_path_factory.mktemp('vid4')
    rng = np.random.RandomState(7)
    for clip in ('calendar', 'city'):
        for kind in ('gt', 'lq'):
            (root / kind / clip).mkdir(parents=True)
        for i in range(7):
            gt = (rng.rand(32, 40, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / 'gt' / clip / f'{i:08d}.png'), gt)
            cv2.imwrite(str(root / 'lq' / clip / f'{i:08d}.png'),
                        cv2.resize(gt, (10, 8),
                                   interpolation=cv2.INTER_AREA))
    return root


def _opt(root, cache, duf):
    return {'name': 'Vid4', 'type': 'VideoTestDUFDataset', 'phase': 'test',
            'scale': 4, 'cache_data': cache, 'dataroot_gt': str(root / 'gt'),
            'dataroot_lq': str(root / 'lq'), 'io_backend': {'type': 'disk'},
            'num_frame': 7, 'padding': 'reflection_circle',
            'use_duf_downsampling': duf}


@pytest.mark.parametrize('duf', [False, True], ids=['read_lq', 'duf'])
def test_video_test_duf_dataset_matches_jax(vid4, duf):
    """Every sample of both clips, 7-frame windows: the keys and ``gt``
    bit for bit, ``lq`` bit for bit when read and within ``DUF_TOL`` when
    made by ``duf_downsample``; the port's samples the same with and
    without ``cache_data``."""
    samples = {}
    for cache in (False, True):
        ours = build_dataset(_opt(vid4, cache, duf))
        theirs = jax_build_dataset(_opt(vid4, cache, duf))
        assert len(ours) == len(theirs) == 14
        samples[cache] = [ours[i] for i in range(len(ours))]
        for got, want in zip(samples[cache], (theirs[i] for i in
                                              range(len(theirs)))):
            assert sorted(got) == sorted(want)
            for key, val in want.items():
                if key == 'lq' and duf:
                    assert got[key].shape == (7, 8, 10, 3)
                    np.testing.assert_allclose(got[key], val, rtol=0,
                                               atol=DUF_TOL)
                elif isinstance(val, np.ndarray):
                    assert got[key].dtype == val.dtype, key
                    np.testing.assert_array_equal(got[key], val, key)
                else:
                    assert got[key] == val, key
    for read, cached in zip(samples[False], samples[True]):
        for key, val in read.items():
            if isinstance(val, np.ndarray):
                np.testing.assert_array_equal(cached[key], val, key)
            else:
                assert cached[key] == val, key
