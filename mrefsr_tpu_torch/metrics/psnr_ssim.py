"""PSNR and SSIM on BGR images in [0, 255], MATLAB-compatible (the port's
copy of ``mrefsr_tpu/metrics/psnr_ssim.py:19-102``, reference
``basicsr/metrics/psnr_ssim.py``): optional crop border and BT.601 Y
channel, float64 arithmetic.

The JAX package filters SSIM's statistics with ``cv2.filter2D`` and crops
5 pixels a side; that is the valid 11x11 correlation, which is computed
here with numpy, so no border rule is ever read and OpenCV is not needed.
"""
import numpy as np

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


def calculate_ssim(img, img2, crop_border, input_order='HWC',
                   test_y_channel=False, **kwargs):
    """SSIM averaged over channels (reference psnr_ssim.py:84-129)."""
    img, img2 = _prepare(img, img2, crop_border, input_order,
                         test_y_channel)
    return np.array([_ssim(img[..., i], img2[..., i])
                     for i in range(img.shape[2])]).mean()
