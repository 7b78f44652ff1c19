"""The port's validation helpers against the JAX package's, on the CPU:
PSNR and SSIM (RGB and Y, with and without a crop border), the BT.601
conversions, ``tensor2img`` on a model's NHWC output, the rank-sharded
``EnlargedSampler`` and ``default_collate``."""
import numpy as np
import pytest
import torch

from mrefsr_tpu.data.data_sampler import EnlargedSampler as JaxSampler
from mrefsr_tpu.data.loader import default_collate as jax_collate
from mrefsr_tpu.metrics import metric_util as jax_metric_util
from mrefsr_tpu.metrics.psnr_ssim import calculate_psnr as jax_psnr
from mrefsr_tpu.metrics.psnr_ssim import calculate_ssim as jax_ssim
from mrefsr_tpu.utils import color_util as jax_color
from mrefsr_tpu.utils.img_util import tensor2img as jax_tensor2img
from mrefsr_tpu_torch.data import EnlargedSampler, default_collate
from mrefsr_tpu_torch.metrics import (calculate_psnr, calculate_ssim,
                                      metric_util)
from mrefsr_tpu_torch.metrics.psnr_ssim import gaussian_kernel_1d
from mrefsr_tpu_torch.utils import color_util, tensor2img


def _pair(kind):
    """Two BGR uint8 images of 60x44: independent noise, a smooth image
    and a slightly perturbed copy, or one image twice (PSNR inf)."""
    rng = np.random.RandomState(0)
    if kind == 'noise':
        return (rng.randint(0, 256, (60, 44, 3)).astype(np.uint8),
                rng.randint(0, 256, (60, 44, 3)).astype(np.uint8))
    yy, xx = np.mgrid[0:60, 0:44]
    smooth = np.stack([np.sin(yy / 7.) + np.cos(xx / 5.),
                       np.cos(yy / 9.) * np.sin(xx / 4.),
                       np.sin((xx + yy) / 11.)], -1) * 60 + 128
    smooth = smooth.astype(np.uint8)
    if kind == 'identical':
        return smooth, smooth.copy()
    noisy = np.clip(smooth.astype(int) + rng.randint(-3, 4, smooth.shape),
                    0, 255).astype(np.uint8)
    return smooth, noisy


KINDS = ('noise', 'smooth', 'identical')


@pytest.mark.parametrize('test_y_channel', [False, True])
@pytest.mark.parametrize('crop_border', [0, 4])
@pytest.mark.parametrize('kind', KINDS)
def test_psnr_matches_jax(kind, crop_border, test_y_channel):
    img, img2 = _pair(kind)
    got = calculate_psnr(img, img2, crop_border,
                         test_y_channel=test_y_channel)
    want = jax_psnr(img, img2, crop_border, test_y_channel=test_y_channel)
    if kind == 'identical':
        assert got == want == float('inf')
    else:
        assert got == pytest.approx(want, rel=1e-10)


@pytest.mark.parametrize('test_y_channel', [False, True])
@pytest.mark.parametrize('crop_border', [0, 4])
@pytest.mark.parametrize('kind', KINDS)
def test_ssim_matches_jax(kind, crop_border, test_y_channel):
    """The valid 11x11 correlation in numpy against ``cv2.filter2D`` and
    its crop: rtol 1e-10."""
    img, img2 = _pair(kind)
    got = calculate_ssim(img, img2, crop_border,
                         test_y_channel=test_y_channel)
    want = jax_ssim(img, img2, crop_border, test_y_channel=test_y_channel)
    assert got == pytest.approx(want, rel=1e-10)


def test_gaussian_window_is_opencvs():
    import cv2
    np.testing.assert_allclose(gaussian_kernel_1d(),
                               cv2.getGaussianKernel(11, 1.5)[:, 0],
                               rtol=1e-14)


def test_metrics_refuse_images_of_other_shapes():
    img, img2 = _pair('noise')
    with pytest.raises(ValueError, match='shapes are different'):
        calculate_psnr(img, img2[:-1], 0)
    with pytest.raises(ValueError, match='shapes are different'):
        calculate_ssim(img, img2[:-1], 0)


@pytest.mark.parametrize('convert', ['bgr2ycbcr', 'rgb2ycbcr'])
@pytest.mark.parametrize('y_only', [False, True])
@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_ycbcr_matches_jax(convert, y_only, dtype):
    img, _ = _pair('noise')
    if dtype == np.float32:
        img = img.astype(np.float32) / 255.
    got = getattr(color_util, convert)(img, y_only=y_only)
    want = getattr(jax_color, convert)(img, y_only=y_only)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


def test_ycbcr_refuses_other_types():
    with pytest.raises(TypeError, match='np.float32 or np.uint8'):
        color_util.bgr2ycbcr(np.zeros((2, 2, 3), np.float64))


@pytest.mark.parametrize('input_order', ['HWC', 'CHW'])
def test_metric_helpers_match_jax(input_order):
    img, _ = _pair('smooth')
    if input_order == 'CHW':
        img = img.transpose(2, 0, 1)
    np.testing.assert_array_equal(
        metric_util.reorder_image(img, input_order),
        jax_metric_util.reorder_image(img, input_order))
    hwc = metric_util.reorder_image(img, input_order)
    np.testing.assert_array_equal(metric_util.to_y_channel(hwc),
                                  jax_metric_util.to_y_channel(hwc))


def test_tensor2img_matches_jax_on_model_outputs():
    """What validation compares: a (1, H, W, 3) RGB output, out of range
    in places and with values on the rounding boundaries, becomes the same
    BGR uint8 image in both packages."""
    rng = np.random.RandomState(3)
    out = rng.uniform(-0.1, 1.1, (1, 20, 24, 3)).astype(np.float32)
    out[0, 0, :6, 0] = np.array([0.5, 1.5, 2.5, 3.5, 254.5, 127.5]) / 255
    got = tensor2img(torch.from_numpy(out))
    want = jax_tensor2img(out)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tensor2img(out), want)   # numpy in


@pytest.mark.parametrize('num_replicas,rank,ratio,epoch', [
    (1, 0, 1, 0), (2, 0, 1, 0), (2, 1, 1, 3), (4, 3, 2, 1), (3, 1, 5, 7),
    (8, 5, 100, 2)])
def test_enlarged_sampler_matches_jax(num_replicas, rank, ratio, epoch):
    dataset = list(range(13))
    got = EnlargedSampler(dataset, num_replicas, rank, ratio)
    want = JaxSampler(dataset, num_replicas, rank, ratio)
    got.set_epoch(epoch)
    want.set_epoch(epoch)
    assert len(got) == len(want)
    assert list(got) == list(want)


def test_enlarged_sampler_ranks_cover_the_enlarged_set():
    dataset = list(range(10))
    shards = []
    for rank in range(4):
        sampler = EnlargedSampler(dataset, 4, rank, ratio=2)
        sampler.set_epoch(5)
        shards.append(list(sampler))
    counts = np.bincount(np.concatenate(shards), minlength=10)
    assert sum(map(len, shards)) == 20 and (counts == 2).all()


def test_default_collate_matches_jax():
    rng = np.random.RandomState(4)
    samples = [{'img': rng.rand(4, 5, 3).astype(np.float32), 'n': i,
                'scale': 0.5 * i, 'flag': bool(i % 2),
                'size': (3 + i, 7), 'path': f'{i}.png',
                'mixed': (1, 'a')} for i in range(3)]
    got = default_collate(samples)
    want = jax_collate(samples)
    assert sorted(got) == sorted(want)
    for key in want:
        assert type(got[key]) is type(want[key]), key
        if isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key] == want[key]
