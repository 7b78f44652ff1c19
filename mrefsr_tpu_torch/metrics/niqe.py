"""NIQE, the Natural Image Quality Evaluator (copy of
``mrefsr_tpu/metrics/niqe.py``, the reference's basicsr/metrics/niqe.py:
13-197), numpy and scipy on the host. The pristine model's parameters (the
LIVE lab's release) are the package's own data file beside this module,
:data:`PRIS_PARAMS`."""
import math
import os

import numpy as np
from scipy.ndimage import convolve
from scipy.special import gamma

from mrefsr_tpu_torch.utils.matlab_functions import imresize
from mrefsr_tpu_torch.utils.registry import METRIC_REGISTRY

from .metric_util import reorder_image, to_y_channel

# the pristine parameters
PRIS_PARAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'niqe_pris_params.npz')
_PRIS_CACHE = {}


def pris_params():
    """``(mu_pris_param, cov_pris_param, gaussian_window)``, read once."""
    if not _PRIS_CACHE:
        with np.load(PRIS_PARAMS) as f:
            _PRIS_CACHE.update(mu=f['mu_pris_param'],
                               cov=f['cov_pris_param'],
                               window=f['gaussian_window'])
    return _PRIS_CACHE['mu'], _PRIS_CACHE['cov'], _PRIS_CACHE['window']


def estimate_aggd_param(block):
    """The asymmetric generalised Gaussian's ``(alpha, beta_l, beta_r)``
    fitted to ``block`` (reference niqe.py:13-38)."""
    block = block.flatten()
    gam = np.arange(0.2, 10.001, 0.001)
    gam_reciprocal = np.reciprocal(gam)
    r_gam = np.square(gamma(gam_reciprocal * 2)) / (
        gamma(gam_reciprocal) * gamma(gam_reciprocal * 3))
    left_std = np.sqrt(np.mean(block[block < 0] ** 2))
    right_std = np.sqrt(np.mean(block[block > 0] ** 2))
    gammahat = left_std / right_std
    rhat = (np.mean(np.abs(block))) ** 2 / np.mean(block ** 2)
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) \
        / ((gammahat ** 2 + 1) ** 2)
    alpha = gam[np.argmin((r_gam - rhatnorm) ** 2)]
    beta_l = left_std * np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    beta_r = right_std * np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    return alpha, beta_l, beta_r


def compute_feature(block):
    """A block's 18 features (reference niqe.py:41-66)."""
    alpha, beta_l, beta_r = estimate_aggd_param(block)
    feat = [alpha, (beta_l + beta_r) / 2]
    for shift in ([0, 1], [1, 0], [1, 1], [1, -1]):
        shifted_block = np.roll(block, shift, axis=(0, 1))
        alpha, beta_l, beta_r = estimate_aggd_param(block * shifted_block)
        mean = (beta_r - beta_l) * (gamma(2 / alpha) / gamma(1 / alpha))
        feat.extend([alpha, mean, beta_l, beta_r])
    return feat


def niqe(img, mu_pris_param, cov_pris_param, gaussian_window,
         block_size_h=96, block_size_w=96):
    """NIQE of a gray or Y image (h, w) in [0, 255]: the MSCN features of
    each block at two scales (the second by ``imresize`` to half), their
    Gaussian against the pristine one (reference niqe.py:69-140)."""
    if img.ndim != 2:
        raise ValueError('Input image must be a gray or Y (of YCbCr) image '
                         'with shape (h, w).')
    h, w = img.shape
    num_block_h = math.floor(h / block_size_h)
    num_block_w = math.floor(w / block_size_w)
    img = img[0:num_block_h * block_size_h, 0:num_block_w * block_size_w]
    distparam = []
    for scale in (1, 2):
        mu = convolve(img, gaussian_window, mode='nearest')
        sigma = np.sqrt(np.abs(convolve(np.square(img), gaussian_window,
                                        mode='nearest') - np.square(mu)))
        img_normalized = (img - mu) / (sigma + 1)
        feat = []
        for idx_w in range(num_block_w):
            for idx_h in range(num_block_h):
                block = img_normalized[
                    idx_h * block_size_h // scale:
                    (idx_h + 1) * block_size_h // scale,
                    idx_w * block_size_w // scale:
                    (idx_w + 1) * block_size_w // scale]
                feat.append(compute_feature(block))
        distparam.append(np.array(feat))
        if scale == 1:
            img = imresize(img / 255., scale=0.5, antialiasing=True) * 255.
    distparam = np.concatenate(distparam, axis=1)
    mu_distparam = np.nanmean(distparam, axis=0)
    distparam_no_nan = distparam[~np.isnan(distparam).any(axis=1)]
    cov_distparam = np.cov(distparam_no_nan, rowvar=False)
    invcov_param = np.linalg.pinv((cov_pris_param + cov_distparam) / 2)
    quality = np.matmul(
        np.matmul((mu_pris_param - mu_distparam), invcov_param),
        np.transpose(mu_pris_param - mu_distparam))
    return float(np.squeeze(np.sqrt(quality)))


@METRIC_REGISTRY.register()
def calculate_niqe(img, crop_border, input_order='HWC', convert_to='y',
                   **kwargs):
    """NIQE of a BGR image in [0, 255] (reference niqe.py:143-197): the Y
    channel (``convert_to='y'``) or gray, ``crop_border`` pixels off each
    side, rounded as MATLAB reads an image. Lower is better."""
    mu_pris_param, cov_pris_param, gaussian_window = pris_params()
    img = img.astype(np.float32)
    if input_order != 'HW':
        img = reorder_image(img, input_order=input_order)
        if convert_to == 'y':
            img = to_y_channel(img)
        elif convert_to == 'gray':
            import cv2
            img = cv2.cvtColor(img / 255., cv2.COLOR_BGR2GRAY) * 255.
        img = np.squeeze(img)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    img = img.round()
    return niqe(img, mu_pris_param, cov_pris_param, gaussian_window)
