"""PSNR and SSIM on BGR images in [0, 255], MATLAB-compatible (the port's
copy of ``mrefsr_tpu/metrics/psnr_ssim.py:19-102``, reference
``basicsr/metrics/psnr_ssim.py``): optional crop border and BT.601 Y
channel, float64 arithmetic. ``calculate_psnr_pt`` and
``calculate_ssim_pt`` (the JAX package's ``:105-197``, the reference's
``*_pt``) take NHWC RGB batches in [0, 1] where they lie, the card
included, in float32, and one value an image; handed an HWC BGR uint8
image, as the validation loops hand the registry's metrics, they take it
as a batch of one and return a float, as the JAX package's adapter does.

The JAX package filters SSIM's statistics with ``cv2.filter2D`` and crops
5 pixels a side; that is the valid 11x11 correlation, which is computed
here with numpy, so no border rule is ever read and OpenCV is not needed.
"""
import numpy as np
import torch
import torch.nn.functional as F

from mrefsr_tpu_torch.utils.color_util import _RGB2YCBCR_W
from mrefsr_tpu_torch.utils.registry import METRIC_REGISTRY

from .metric_util import reorder_image, to_y_channel


def _prepare(img, img2, crop_border, input_order, test_y_channel):
    if img.shape != img2.shape:
        raise ValueError(f'Image shapes are different: {img.shape}, '
                         f'{img2.shape}.')
    img = reorder_image(img, input_order=input_order)
    img2 = reorder_image(img2, input_order=input_order)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img = to_y_channel(img)
        img2 = to_y_channel(img2)
    return img.astype(np.float64), img2.astype(np.float64)


@METRIC_REGISTRY.register()
def calculate_psnr(img, img2, crop_border, input_order='HWC',
                   test_y_channel=False, **kwargs):
    """PSNR in dB (``inf`` for identical images; reference
    psnr_ssim.py:11-48)."""
    img, img2 = _prepare(img, img2, crop_border, input_order,
                         test_y_channel)
    mse = np.mean((img - img2)**2)
    if mse == 0:
        return float('inf')
    return 10. * np.log10(255. * 255. / mse)


def gaussian_kernel_1d(size=11, sigma=1.5):
    """``cv2.getGaussianKernel(size, sigma)`` as a flat float64 array:
    ``exp(-x^2 / (2 sigma^2))`` at ``x = i - (size - 1) / 2``, summing
    to 1."""
    x = np.arange(size, dtype=np.float64) - (size - 1) * 0.5
    taps = np.exp(-0.5 / (sigma * sigma) * x * x)
    return taps / taps.sum()


def _filter_valid(img, taps):
    """The valid correlation of a 2-D float64 image with the separable
    window ``outer(taps, taps)``: ``(H - n + 1, W - n + 1)``."""
    n = len(taps)
    h, w = img.shape
    rows = sum(taps[j] * img[:, j:w - n + 1 + j] for j in range(n))
    return sum(taps[i] * rows[i:h - n + 1 + i, :] for i in range(n))


def _ssim(img, img2):
    """SSIM of one channel, with the 11x11 Gaussian window of sigma 1.5
    (reference psnr_ssim.py:172-200)."""
    c1 = (0.01 * 255)**2
    c2 = (0.03 * 255)**2
    taps = gaussian_kernel_1d()
    mu1 = _filter_valid(img, taps)
    mu2 = _filter_valid(img2, taps)
    mu1_sq = mu1**2
    mu2_sq = mu2**2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _filter_valid(img**2, taps) - mu1_sq
    sigma2_sq = _filter_valid(img2**2, taps) - mu2_sq
    sigma12 = _filter_valid(img * img2, taps) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


@METRIC_REGISTRY.register()
def calculate_ssim(img, img2, crop_border, input_order='HWC',
                   test_y_channel=False, **kwargs):
    """SSIM averaged over channels (reference psnr_ssim.py:84-129)."""
    img, img2 = _prepare(img, img2, crop_border, input_order,
                         test_y_channel)
    return np.array([_ssim(img[..., i], img2[..., i])
                     for i in range(img.shape[2])]).mean()


def _batch(img):
    """An NHWC RGB batch in [0, 1] as a float32 tensor; an HWC BGR uint8
    image (numpy or tensor) as a batch of one."""
    img = torch.as_tensor(img)
    if img.dim() == 3:
        img = img.flip(-1).to(torch.float32)[None] / 255.
    return img.to(torch.float32)


def _prepare_pt(img, img2, crop_border, test_y_channel):
    if img.shape != img2.shape:
        raise ValueError(f'Image shapes are different: {tuple(img.shape)}, '
                         f'{tuple(img2.shape)}.')
    if crop_border != 0:
        img = img[:, crop_border:-crop_border, crop_border:-crop_border, :]
        img2 = img2[:, crop_border:-crop_border, crop_border:-crop_border, :]
    if test_y_channel:
        img, img2 = rgb2y_pt(img), rgb2y_pt(img2)
    return img, img2


def rgb2y_pt(img):
    """The BT.601 Y channel of an NHWC RGB batch in [0, 1], in [0, 1]
    (the JAX package's ``rgb2ycbcr_jax(y_only=True)``)."""
    w = torch.as_tensor(_RGB2YCBCR_W[:, :1], dtype=img.dtype,
                        device=img.device)
    return (img @ w + 16.0) / 255.


def _as_result(value, single):
    return float(value.mean()) if single else value


@METRIC_REGISTRY.register()
def calculate_psnr_pt(img, img2, crop_border, test_y_channel=False,
                      **kwargs):
    """PSNR in dB of each image of two NHWC batches in [0, 1]
    (``10 log10(1 / (mse + 1e-8))``, reference psnr_ssim.py:52-81)."""
    single = torch.as_tensor(img).dim() == 3
    img, img2 = _prepare_pt(_batch(img), _batch(img2), crop_border,
                            test_y_channel)
    mse = ((img - img2) ** 2).mean(dim=(1, 2, 3))
    return _as_result(10. * torch.log10(1. / (mse + 1e-8)), single)


@METRIC_REGISTRY.register()
def calculate_ssim_pt(img, img2, crop_border, test_y_channel=False,
                      **kwargs):
    """SSIM of each image of two NHWC batches in [0, 1] (reference
    psnr_ssim.py:133-233): on [0, 255] values, the valid 11x11 Gaussian
    window of sigma 1.5 a channel, the mean over the map and the
    channels."""
    single = torch.as_tensor(img).dim() == 3
    img, img2 = _prepare_pt(_batch(img), _batch(img2), crop_border,
                            test_y_channel)
    img = img.permute(0, 3, 1, 2) * 255.
    img2 = img2.permute(0, 3, 1, 2) * 255.
    c = img.shape[1]
    taps = gaussian_kernel_1d()
    window = torch.as_tensor(np.outer(taps, taps), dtype=torch.float32,
                             device=img.device).expand(c, 1, 11, 11)

    def filt(x):
        return F.conv2d(x, window, groups=c)

    c1 = (0.01 * 255)**2
    c2 = (0.03 * 255)**2
    mu1, mu2 = filt(img), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = filt(img * img) - mu1_sq
    sigma2_sq = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img * img2) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return _as_result(ssim_map.mean(dim=(1, 2, 3)), single)
