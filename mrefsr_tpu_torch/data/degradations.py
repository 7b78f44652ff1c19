"""Blind-SR degradations (port of ``mrefsr_tpu/data/degradations.py``, the
reference's basicsr/data/degradations.py), in two tiers:

* **host (numpy)**: the blur kernels the dataset draws for each sample
  (:func:`random_mixed_kernels`, :func:`circular_lowpass_kernel`) and the
  noise and JPEG of one HWC image. Copies of the JAX package's functions
  that draw from the ``np_rng`` (``numpy.random.RandomState``) and ``rng``
  (``random.Random``) they are given, where the JAX package draws from
  numpy's and python's global generators: the same seed gives the same
  kernels bit for bit.
* **device (torch)**: batched NHWC noise for the synthesis of
  ``models/degradation_synth.py``, drawn from an explicit
  ``torch.Generator`` on the batch's device (the JAX package draws from
  ``jax.random`` keys, which nothing here can reproduce: the tests hold
  these to their statistics). Each sample draws its own sigma or scale and
  its own gray / colour choice; both noises are computed and the choice
  blends them, as in the JAX package. Poisson noise scales each sample by
  2^ceil(log2(n)), n its count of distinct 8-bit levels, counted in the
  valid region only where a ``valid_mask`` is given (:func:`_unique_vals`).
"""
import math

import numpy as np
import torch

# ------------------------------------------------------------------ #
# ------------------------- blur kernels -------------------------- #
# ------------------------------------------------------------------ #


def sigma_matrix2(sig_x, sig_y, theta):
    """Rotated 2 x 2 covariance matrix (reference degradations.py:16-30)."""
    d_matrix = np.array([[sig_x**2, 0], [0, sig_y**2]])
    u_matrix = np.array([[np.cos(theta), -np.sin(theta)],
                         [np.sin(theta), np.cos(theta)]])
    return np.dot(u_matrix, np.dot(d_matrix, u_matrix.T))


def mesh_grid(kernel_size):
    """Zero-centred mesh grid (reference degradations.py:32-47)."""
    ax = np.arange(-kernel_size // 2 + 1., kernel_size // 2 + 1.)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.hstack((xx.reshape((kernel_size * kernel_size, 1)),
                    yy.reshape(kernel_size * kernel_size, 1))).reshape(
                        kernel_size, kernel_size, 2)
    return xy, xx, yy


def pdf2(sigma_matrix, grid):
    """Unnormalised bivariate Gaussian pdf (reference :50-63)."""
    inverse_sigma = np.linalg.inv(sigma_matrix)
    return np.exp(-0.5 * np.sum(np.dot(grid, inverse_sigma) * grid, 2))


def cdf2(d_matrix, grid):
    """The standard bivariate Gaussian's cdf at ``grid`` skewed by
    ``d_matrix`` (reference :66-81)."""
    from scipy.stats import multivariate_normal
    rv = multivariate_normal([0, 0], [[1, 0], [0, 1]])
    return rv.cdf(np.dot(grid, d_matrix))


def _sigma(sig_x, sig_y, theta, isotropic):
    if isotropic:
        return np.array([[sig_x**2, 0], [0, sig_x**2]])
    return sigma_matrix2(sig_x, sig_y, theta)


def bivariate_Gaussian(kernel_size, sig_x, sig_y, theta, grid=None,
                       isotropic=True):
    """Normalised (an)isotropic Gaussian kernel (reference :84-109)."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    kernel = pdf2(_sigma(sig_x, sig_y, theta, isotropic), grid)
    return kernel / np.sum(kernel)


def bivariate_generalized_Gaussian(kernel_size, sig_x, sig_y, theta, beta,
                                   grid=None, isotropic=True):
    """Generalised Gaussian kernel; beta 1 is the Gaussian (reference
    :112-144)."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    inverse_sigma = np.linalg.inv(_sigma(sig_x, sig_y, theta, isotropic))
    kernel = np.exp(
        -0.5 * np.power(np.sum(np.dot(grid, inverse_sigma) * grid, 2), beta))
    return kernel / np.sum(kernel)


def bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta, grid=None,
                      isotropic=True):
    """Plateau kernel 1 / (1 + x^beta) (reference :147-176)."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    inverse_sigma = np.linalg.inv(_sigma(sig_x, sig_y, theta, isotropic))
    kernel = np.reciprocal(
        np.power(np.sum(np.dot(grid, inverse_sigma) * grid, 2), beta) + 1)
    return kernel / np.sum(kernel)


def _sample_sigmas(sigma_x_range, sigma_y_range, rotation_range, isotropic,
                   np_rng):
    assert sigma_x_range[0] < sigma_x_range[1], 'Wrong sigma_x_range.'
    sigma_x = np_rng.uniform(sigma_x_range[0], sigma_x_range[1])
    if isotropic is False:
        assert sigma_y_range[0] < sigma_y_range[1], 'Wrong sigma_y_range.'
        assert rotation_range[0] < rotation_range[1], 'Wrong rotation_range.'
        sigma_y = np_rng.uniform(sigma_y_range[0], sigma_y_range[1])
        rotation = np_rng.uniform(rotation_range[0], rotation_range[1])
    else:
        sigma_y = sigma_x
        rotation = 0
    return sigma_x, sigma_y, rotation


def _apply_kernel_noise(kernel, noise_range, np_rng):
    if noise_range is not None:
        assert noise_range[0] < noise_range[1], 'Wrong noise range.'
        kernel = kernel * np_rng.uniform(noise_range[0], noise_range[1],
                                         size=kernel.shape)
    return kernel / np.sum(kernel)


def _sample_beta(beta_range, np_rng):
    # reference :263-267: half the draws below 1, half above
    if np_rng.uniform() < 0.5:
        return np_rng.uniform(beta_range[0], 1)
    return np_rng.uniform(1, beta_range[1])


def random_bivariate_Gaussian(kernel_size, sigma_x_range, sigma_y_range,
                              rotation_range, noise_range=None,
                              isotropic=True, *, np_rng):
    """Random Gaussian kernel (reference degradations.py:179-220)."""
    assert kernel_size % 2 == 1, 'Kernel size must be an odd number.'
    sigma_x, sigma_y, rotation = _sample_sigmas(
        sigma_x_range, sigma_y_range, rotation_range, isotropic, np_rng)
    kernel = bivariate_Gaussian(kernel_size, sigma_x, sigma_y, rotation,
                                isotropic=isotropic)
    return _apply_kernel_noise(kernel, noise_range, np_rng)


def random_bivariate_generalized_Gaussian(kernel_size, sigma_x_range,
                                          sigma_y_range, rotation_range,
                                          beta_range, noise_range=None,
                                          isotropic=True, *, np_rng):
    """Random generalised Gaussian kernel (reference :223-272)."""
    assert kernel_size % 2 == 1, 'Kernel size must be an odd number.'
    sigma_x, sigma_y, rotation = _sample_sigmas(
        sigma_x_range, sigma_y_range, rotation_range, isotropic, np_rng)
    beta = _sample_beta(beta_range, np_rng)
    kernel = bivariate_generalized_Gaussian(
        kernel_size, sigma_x, sigma_y, rotation, beta, isotropic=isotropic)
    return _apply_kernel_noise(kernel, noise_range, np_rng)


def random_bivariate_plateau(kernel_size, sigma_x_range, sigma_y_range,
                             rotation_range, beta_range, noise_range=None,
                             isotropic=True, *, np_rng):
    """Random plateau kernel (reference :275-324)."""
    assert kernel_size % 2 == 1, 'Kernel size must be an odd number.'
    sigma_x, sigma_y, rotation = _sample_sigmas(
        sigma_x_range, sigma_y_range, rotation_range, isotropic, np_rng)
    beta = _sample_beta(beta_range, np_rng)
    kernel = bivariate_plateau(kernel_size, sigma_x, sigma_y, rotation, beta,
                               isotropic=isotropic)
    return _apply_kernel_noise(kernel, noise_range, np_rng)


def random_mixed_kernels(kernel_list, kernel_prob, kernel_size=21,
                         sigma_x_range=(0.6, 5), sigma_y_range=(0.6, 5),
                         rotation_range=(-math.pi, math.pi),
                         betag_range=(0.5, 8), betap_range=(0.5, 8),
                         noise_range=None, *, rng, np_rng):
    """One kernel of the type ``rng`` picks by ``kernel_prob``
    (reference :327-389); the plateau kernels take no noise."""
    kernel_type = rng.choices(kernel_list, kernel_prob)[0]
    gen = {'iso': (random_bivariate_Gaussian, None, True),
           'aniso': (random_bivariate_Gaussian, None, False),
           'generalized_iso': (random_bivariate_generalized_Gaussian,
                               betag_range, True),
           'generalized_aniso': (random_bivariate_generalized_Gaussian,
                                 betag_range, False),
           'plateau_iso': (random_bivariate_plateau, betap_range, True),
           'plateau_aniso': (random_bivariate_plateau, betap_range, False)}
    if kernel_type not in gen:
        raise ValueError(f'Unknown kernel type {kernel_type}')
    fn, beta_range, isotropic = gen[kernel_type]
    if kernel_type.startswith('plateau'):
        noise_range = None
    betas = () if beta_range is None else (beta_range,)
    return fn(kernel_size, sigma_x_range, sigma_y_range, rotation_range,
              *betas, noise_range=noise_range, isotropic=isotropic,
              np_rng=np_rng)


def circular_lowpass_kernel(cutoff, kernel_size, pad_to=0):
    """2-D sinc (circular low-pass) filter (reference :392-417)."""
    from scipy import special
    assert kernel_size % 2 == 1, 'Kernel size must be an odd number.'
    with np.errstate(divide='ignore', invalid='ignore'):
        kernel = np.fromfunction(
            lambda x, y: cutoff * special.j1(cutoff * np.sqrt(
                (x - (kernel_size - 1) / 2)**2 +
                (y - (kernel_size - 1) / 2)**2)) / (2 * np.pi * np.sqrt(
                    (x - (kernel_size - 1) / 2)**2 +
                    (y - (kernel_size - 1) / 2)**2)),
            [kernel_size, kernel_size])
    kernel[(kernel_size - 1) // 2,
           (kernel_size - 1) // 2] = cutoff**2 / (4 * np.pi)
    kernel = kernel / np.sum(kernel)
    if pad_to > kernel_size:
        pad_size = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad_size, pad_size), (pad_size, pad_size)))
    return kernel


# ------------------------------------------------------------------ #
# ------------------------ host noise tier ------------------------ #
# ------------------------------------------------------------------ #


def _clip_round(out, clip, rounds, xp=np):
    if clip and rounds:
        return xp.clip((out * 255.0).round(), 0, 255) / 255.
    if clip:
        return xp.clip(out, 0, 1)
    if rounds:
        return (out * 255.0).round() / 255.
    return out


def generate_gaussian_noise(img, sigma=10, gray_noise=False, *, np_rng):
    """HWC float32 Gaussian noise of ``sigma`` / 255 (reference
    :420-437)."""
    if gray_noise:
        noise = np.float32(np_rng.randn(*(img.shape[0:2]))) * sigma / 255.
        return np.expand_dims(noise, axis=2).repeat(3, axis=2)
    return np.float32(np_rng.randn(*(img.shape))) * sigma / 255.


def add_gaussian_noise(img, sigma=10, clip=True, rounds=False,
                       gray_noise=False, *, np_rng):
    """(reference :439-458)"""
    noise = generate_gaussian_noise(img, sigma, gray_noise, np_rng=np_rng)
    return _clip_round(img + noise, clip, rounds)


def random_generate_gaussian_noise(img, sigma_range=(0, 10), gray_prob=0,
                                   *, np_rng):
    """Gaussian noise of a sigma drawn from ``sigma_range``, gray with
    probability ``gray_prob`` (reference :516-522)."""
    sigma = np_rng.uniform(sigma_range[0], sigma_range[1])
    gray_noise = np_rng.uniform() < gray_prob
    return generate_gaussian_noise(img, sigma, gray_noise, np_rng=np_rng)


def random_add_gaussian_noise(img, sigma_range=(0, 1.0), gray_prob=0,
                              clip=True, rounds=False, *, np_rng):
    """(reference :525-534)"""
    noise = random_generate_gaussian_noise(img, sigma_range, gray_prob,
                                           np_rng=np_rng)
    return _clip_round(img + noise, clip, rounds)


def generate_poisson_noise(img, scale=1.0, gray_noise=False, *, np_rng):
    """Shot noise scaled by the image's count of distinct 8-bit levels
    (reference :560-585)."""
    import cv2
    if gray_noise:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    img = np.clip((img * 255.0).round(), 0, 255) / 255.
    vals = len(np.unique(img))
    vals = 2**np.ceil(np.log2(vals))
    out = np.float32(np_rng.poisson(img * vals) / float(vals))
    noise = out - img
    if gray_noise:
        noise = np.repeat(noise[:, :, np.newaxis], 3, axis=2)
    return noise * scale


def add_poisson_noise(img, scale=1.0, clip=True, rounds=False,
                      gray_noise=False, *, np_rng):
    """(reference :587-608)"""
    noise = generate_poisson_noise(img, scale, gray_noise, np_rng=np_rng)
    return _clip_round(img + noise, clip, rounds)


def random_generate_poisson_noise(img, scale_range=(0, 1.0), gray_prob=0,
                                  *, np_rng):
    """Shot noise of a scale drawn from ``scale_range``, gray with
    probability ``gray_prob`` (reference :686-692)."""
    scale = np_rng.uniform(scale_range[0], scale_range[1])
    gray_noise = np_rng.uniform() < gray_prob
    return generate_poisson_noise(img, scale, gray_noise, np_rng=np_rng)


def random_add_poisson_noise(img, scale_range=(0, 1.0), gray_prob=0,
                             clip=True, rounds=False, *, np_rng):
    """(reference :695-704)"""
    noise = random_generate_poisson_noise(img, scale_range, gray_prob,
                                          np_rng=np_rng)
    return _clip_round(img + noise, clip, rounds)


def add_jpg_compression(img, quality=90):
    """A real JPEG round trip through OpenCV (reference :732-749)."""
    import cv2
    img = np.clip(img, 0, 1)
    encode_param = [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)]
    _, encimg = cv2.imencode('.jpg', img * 255., encode_param)
    return np.float32(cv2.imdecode(encimg, 1)) / 255.


def random_add_jpg_compression(img, quality_range=(90, 100), *, np_rng):
    """(reference :751-765)"""
    return add_jpg_compression(
        img, np_rng.uniform(quality_range[0], quality_range[1]))


# ------------------------------------------------------------------ #
# ----------------- device tier (torch, NHWC) --------------------- #
# ------------------------------------------------------------------ #

# torchvision's grayscale weights (RGB)
GRAY_COEFF = (0.2989, 0.587, 0.114)


def _per_sample(x, b, device):
    """A number or a (B,) tensor as (B, 1, 1, 1) float32 on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device) \
        .expand(b).reshape(b, 1, 1, 1)


def _uniform(b, low, high, generator, device):
    return torch.rand(b, generator=generator, device=device) \
        * (high - low) + low


def generate_gaussian_noise_pt(img, sigma=10, gray_noise=0, *, generator):
    """Gaussian noise of ``sigma`` / 255 for NHWC ``img``, colour or gray
    by ``gray_noise`` (a number or a (B,) 0/1 tensor) (reference
    :461-490)."""
    b, h, w, _ = img.shape
    sigma = _per_sample(sigma, b, img.device)
    gray = _per_sample(gray_noise, b, img.device)
    noise = torch.randn(img.shape, generator=generator, device=img.device,
                        dtype=img.dtype) * sigma / 255.
    noise_gray = torch.randn((b, h, w, 1), generator=generator,
                             device=img.device, dtype=img.dtype) \
        * sigma / 255.
    return noise * (1 - gray) + noise_gray * gray


def random_add_gaussian_noise_pt(img, sigma_range=(0, 1.0), gray_prob=0,
                                 clip=True, rounds=False, *, generator):
    """``img`` plus Gaussian noise of a sigma drawn uniformly in
    ``sigma_range`` for each sample, gray with probability ``gray_prob``
    (reference :537-556)."""
    b = img.shape[0]
    sigma = _uniform(b, sigma_range[0], sigma_range[1], generator,
                     img.device)
    gray = (torch.rand(b, generator=generator, device=img.device)
            < gray_prob).float()
    noise = generate_gaussian_noise_pt(img, sigma, gray,
                                       generator=generator)
    return _clip_round(img + noise, clip, rounds, xp=torch)


def _unique_vals(img, valid_mask=None):
    """(B, 1, 1, 1): 2^ceil(log2(n)) for each sample, n its count of
    distinct levels of ``round(img * 255)`` clipped to [0, 255], over the
    pixels where ``valid_mask`` (broadcast to ``img``) is 1, every pixel
    without one: a 256-bin histogram a sample (reference :627-641 counts
    with ``torch.unique`` over the whole image)."""
    b = img.shape[0]
    levels = torch.clamp(torch.round(img * 255.0), 0, 255).long() \
        .reshape(b, -1)
    if valid_mask is None:
        weights = torch.ones(levels.shape, device=img.device)
    else:
        weights = valid_mask.expand(img.shape).reshape(b, -1).float()
    hist = torch.zeros((b, 256), device=img.device).scatter_add_(
        1, levels, weights)
    n_unique = (hist > 0).sum(1).float()
    return (2.0 ** torch.ceil(torch.log2(n_unique))).reshape(b, 1, 1, 1)


def generate_poisson_noise_pt(img, scale=1.0, gray_noise=0, valid_mask=None,
                              *, generator):
    """Shot noise for NHWC ``img`` in [0, 1], colour or on the gray image
    by ``gray_noise``, times ``scale`` (reference :610-656)."""
    b, h, w, c = img.shape
    gray = _per_sample(gray_noise, b, img.device)
    scale = _per_sample(scale, b, img.device)
    img_q = torch.clamp(torch.round(img * 255.0), 0, 255) / 255.
    vals = _unique_vals(img_q, valid_mask)
    out = torch.poisson(img_q * vals, generator=generator) / vals
    noise = out - img_q
    coeff = torch.tensor(GRAY_COEFF, dtype=img.dtype, device=img.device)
    img_gray = (img * coeff).sum(-1, keepdim=True)
    img_gray = torch.clamp(torch.round(img_gray * 255.0), 0, 255) / 255.
    vals_g = _unique_vals(img_gray, valid_mask)
    out_g = torch.poisson(img_gray * vals_g, generator=generator) / vals_g
    noise_gray = (out_g - img_gray).expand(b, h, w, c)
    return (noise * (1 - gray) + noise_gray * gray) * scale


def random_add_poisson_noise_pt(img, scale_range=(0, 1.0), gray_prob=0,
                                clip=True, rounds=False, valid_mask=None, *,
                                generator):
    """``img`` plus shot noise of a scale drawn uniformly in
    ``scale_range`` for each sample, gray with probability ``gray_prob``
    (reference :707-729)."""
    b = img.shape[0]
    scale = _uniform(b, scale_range[0], scale_range[1], generator,
                     img.device)
    gray = (torch.rand(b, generator=generator, device=img.device)
            < gray_prob).float()
    noise = generate_poisson_noise_pt(img, scale, gray, valid_mask,
                                      generator=generator)
    return _clip_round(img + noise, clip, rounds, xp=torch)
