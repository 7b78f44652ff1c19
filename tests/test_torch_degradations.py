"""The port's degradation tier against the JAX package's on the CPU, on
inputs seeded with numpy: the resize matrices (bit for bit) and their
products, ``filter2D``, ``USMSharp``, ``DiffJPEG`` (both roundings, a
quality a sample), the host kernels and host noise (bit for bit under one
seed: the port's ``np_rng`` / ``rng`` against numpy's and python's global
generators), ``_unique_vals`` with and without a mask, and the device
noise, whose draws nothing can match with ``jax.random``'s: held to its
statistics, and to drawing from the generator it is given alone."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.data import degradations as jax_deg
from mrefsr_tpu.ops import resize as jax_resize
from mrefsr_tpu.utils.diffjpeg import DiffJPEG as JaxDiffJPEG
from mrefsr_tpu.utils.img_process_util import USMSharp as JaxUSMSharp
from mrefsr_tpu.utils.img_process_util import filter2D as jax_filter2D
from mrefsr_tpu.utils.img_process_util import usm_sharp as jax_usm_sharp
from mrefsr_tpu_torch.data import degradations as deg
from mrefsr_tpu_torch.ops import resize
from mrefsr_tpu_torch.utils.diffjpeg import DiffJPEG
from mrefsr_tpu_torch.utils.img_process_util import (USMSharp, filter2D,
                                                     usm_sharp)

KERNEL_TYPES = ['iso', 'aniso', 'generalized_iso', 'generalized_aniso',
                'plateau_iso', 'plateau_aniso']


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _images(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize('mode', ['area', 'bilinear', 'bicubic'])
@pytest.mark.parametrize('sizes', [(64, 23), (37, 96), (400, 601),
                                   (5, 5)])
def test_resize_matrices_bit_equal_and_applied(mode, sizes):
    """``resize_matrix_np`` down and up equal to the JAX package's loops
    bit for bit (the align-corners bicubic too); the two products within
    2e-6 of JAX's (measured 4.8e-7: sums in another order)."""
    n_in, n_out = sizes
    want = jax_resize.resize_matrix_np(n_in, n_out, mode)
    got = resize.resize_matrix_np(n_in, n_out, mode)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(resize._resize_matrix_ac_bicubic(n_in, n_out),
                          jax_resize._resize_matrix_ac_bicubic(n_in, n_out))
    if n_in > 100:
        return
    x = _images(1, (2, n_in, 19, 3))
    mw = resize.resize_matrix_np(19, 11, mode)
    want = np.asarray(jax_resize.apply_resize_matrices(
        jnp.asarray(x), jnp.asarray(got), jnp.asarray(mw)))
    out = resize.apply_resize_matrices(torch.from_numpy(x),
                                       torch.from_numpy(got),
                                       torch.from_numpy(mw)).numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize('kernels', [3, 1])
def test_filter2d_matches_jax(kernels):
    """A kernel a sample, and one for the whole batch: within 2e-6
    (measured 7.2e-7)."""
    x = _images(2, (3, 40, 52, 3))
    k = _images(3, (kernels, 21, 21))
    k /= k.sum((1, 2), keepdims=True)
    want = np.asarray(jax_filter2D(jnp.asarray(x), jnp.asarray(k)))
    got = filter2D(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match='kernel size'):
        filter2D(torch.from_numpy(x), torch.zeros(1, 4, 4))


def test_usm_sharp_matches_jax():
    """``USMSharp`` (two 51 x 51 blurs) within 4e-6 (measured 1.1e-6);
    the host ``usm_sharp`` equal to the JAX package's."""
    x = _images(4, (2, 60, 72, 3))
    want = np.asarray(JaxUSMSharp()(jnp.asarray(x)))
    got = USMSharp()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
    np.testing.assert_array_equal(usm_sharp(x[0]), jax_usm_sharp(x[0]))


@pytest.mark.parametrize('differentiable', [False, True])
def test_diffjpeg_matches_jax(differentiable):
    """Three qualities, one a sample (below 50, a fraction, above 50), on
    a canvas that pads to 16: within 1e-6 (measured 1.8e-7; no
    quantisation tie fell apart on these inputs, which would move a whole
    8 x 8 block), and a scalar quality; the differentiable rounding passes
    a gradient."""
    x = _images(5, (3, 40, 52, 3))
    q = np.array([30., 57.5, 95.], np.float32)
    jpeg = DiffJPEG(differentiable)
    want = np.asarray(JaxDiffJPEG(differentiable)(jnp.asarray(x),
                                                  jnp.asarray(q)))
    got = jpeg(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want = np.asarray(JaxDiffJPEG(differentiable)(jnp.asarray(x), 70.))
    np.testing.assert_allclose(jpeg(torch.from_numpy(x), 70.).numpy(), want,
                               rtol=0, atol=1e-6)
    if differentiable:
        t = torch.from_numpy(x).requires_grad_(True)
        jpeg(t, 70.).sum().backward()
        assert float(t.grad.abs().sum()) > 0


def test_host_kernels_bit_equal_under_one_seed():
    """Every kernel type of ``random_mixed_kernels`` (with and without
    kernel noise) and ``circular_lowpass_kernel`` (with padding): the
    port's generators seeded as JAX's globals give the same kernels and
    leave the same streams behind."""
    seed = 11
    np.random.seed(seed)
    random.seed(seed)
    rng, np_rng = random.Random(seed), np.random.RandomState(seed)
    for noise in (None, [0.75, 1.25]):
        for _ in range(30):
            want = jax_deg.random_mixed_kernels(
                KERNEL_TYPES, [1 / 6] * 6, 21, (0.2, 3), (0.2, 3),
                (-np.pi, np.pi), (0.5, 4), (1, 2), noise_range=noise)
            got = deg.random_mixed_kernels(
                KERNEL_TYPES, [1 / 6] * 6, 21, (0.2, 3), (0.2, 3),
                (-np.pi, np.pi), (0.5, 4), (1, 2), noise_range=noise,
                rng=rng, np_rng=np_rng)
            assert np.array_equal(got, want)
    for cutoff, size, pad in ((np.pi / 3, 7, 21), (2.5, 21, 0)):
        assert np.array_equal(deg.circular_lowpass_kernel(cutoff, size, pad),
                              jax_deg.circular_lowpass_kernel(cutoff, size,
                                                              pad))
    assert random.random() == rng.random()
    assert np.random.uniform() == np_rng.uniform()


def test_host_noise_bit_equal_under_one_seed():
    """The host tier's Gaussian (colour, gray), Poisson (colour, gray) and
    JPEG of one HWC image under one seed, each clip / round option."""
    img = _images(6, (24, 20, 3))
    np.random.seed(3)
    np_rng = np.random.RandomState(3)
    for clip, rounds in ((True, False), (False, True), (True, True)):
        want = jax_deg.random_add_gaussian_noise(img, (1, 30), 0.5, clip,
                                                 rounds)
        got = deg.random_add_gaussian_noise(img, (1, 30), 0.5, clip, rounds,
                                            np_rng=np_rng)
        assert np.array_equal(got, want)
        want = jax_deg.random_add_poisson_noise(img, (0.05, 3), 0.5, clip,
                                                rounds)
        got = deg.random_add_poisson_noise(img, (0.05, 3), 0.5, clip,
                                           rounds, np_rng=np_rng)
        assert np.array_equal(got, want)
    for gray in (False, True):
        want = jax_deg.add_gaussian_noise(img, 9, gray_noise=gray)
        got = deg.add_gaussian_noise(img, 9, gray_noise=gray, np_rng=np_rng)
        assert np.array_equal(got, want)
        want = jax_deg.add_poisson_noise(img, 2., gray_noise=gray)
        got = deg.add_poisson_noise(img, 2., gray_noise=gray, np_rng=np_rng)
        assert np.array_equal(got, want)
    want = jax_deg.random_add_jpg_compression(img, (30, 95))
    got = deg.random_add_jpg_compression(img, (30, 95), np_rng=np_rng)
    assert np.array_equal(got, want)


@pytest.mark.parametrize('masked', [False, True])
def test_unique_vals_matches_jax(masked):
    """The per-sample count of 8-bit levels (2^ceil(log2 n)), over the
    valid region only with a mask: equal to JAX's, on images whose
    samples hold 3, 40 and 256 levels inside and others outside."""
    rng = np.random.RandomState(7)
    img = np.stack([rng.randint(0, n, (30, 34, 3)) / 255.
                    for n in (3, 40, 256)]).astype(np.float32)
    img[:, 20:] = 0.9
    mask = np.zeros((1, 30, 34, 1), np.float32)
    mask[:, :20, :27] = 1
    want = np.asarray(jax_deg._unique_vals(
        jnp.asarray(img), jnp.asarray(mask) if masked else None))
    got = deg._unique_vals(torch.from_numpy(img),
                           torch.from_numpy(mask) if masked else None)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (3, 1, 1, 1)


def test_gaussian_noise_statistics():
    """Sigma drawn uniformly in its range for each sample: the noise's
    standard deviation is sigma / 255 (within 3 %), gray noise is the same
    on the three channels, the gray share follows ``gray_prob``, and the
    draws come from the given generator alone (the global one untouched;
    the same seed twice, the same noise)."""
    img = torch.full((64, 48, 48, 3), 0.5)
    state = torch.get_rng_state()
    gen = torch.Generator().manual_seed(0)
    out = deg.random_add_gaussian_noise_pt(img, (5, 25), 0.5, clip=False,
                                           generator=gen)
    assert torch.equal(torch.get_rng_state(), state)
    again = deg.random_add_gaussian_noise_pt(
        img, (5, 25), 0.5, clip=False,
        generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    noise = out - img
    gray = (noise[..., 0] == noise[..., 1]).all(2).all(1)
    assert 20 <= int(gray.sum()) <= 44
    std = noise.std(dim=(1, 2, 3)) * 255
    assert bool(((std > 5 * 0.97) & (std < 25 * 1.03)).all())
    fixed = deg.random_add_gaussian_noise_pt(img, (12, 12), 0., clip=False,
                                             generator=gen) - img
    np.testing.assert_allclose(float(fixed.std() * 255), 12, rtol=0.02)
    assert float(fixed.mean().abs()) < 1e-3
    gray = deg.random_add_gaussian_noise_pt(img, (12, 12), 1., clip=False,
                                            generator=gen) - img
    assert torch.equal(gray[..., 0], gray[..., 2])
    clipped = deg.random_add_gaussian_noise_pt(img, (200, 200), 0.,
                                               generator=gen)
    assert float(clipped.min()) == 0 and float(clipped.max()) == 1


def test_poisson_noise_statistics():
    """Shot noise on a flat image of level v with L levels (2^ceil(log2 n),
    n the distinct levels, here 2 in the valid region): (out + v) L is a
    Poisson count of mean and variance v L, whatever lies outside the
    mask; gray noise is the same on every channel; scale 0 adds nothing;
    the draws come from the given generator alone."""
    level = 100 / 255.
    img = torch.full((8, 32, 40, 3), level)
    img[:, :, 20:] = 30 / 255.
    img[:, 16:] = 0.77     # outside the valid region: not counted
    mask = torch.zeros(1, 32, 40, 1)
    mask[:, :16] = 1
    state = torch.get_rng_state()
    gen = torch.Generator().manual_seed(1)
    noise = deg.generate_poisson_noise_pt(img, 1., 0., mask, generator=gen)
    assert torch.equal(torch.get_rng_state(), state)
    vals = 2.
    counts = (noise[:, :16, :20] + level) * vals
    assert torch.allclose(counts, counts.round(), atol=1e-4)
    np.testing.assert_allclose(float(counts.mean()), level * vals, rtol=0.05)
    np.testing.assert_allclose(float(counts.var()), level * vals, rtol=0.1)
    gray = deg.generate_poisson_noise_pt(img, 1., 1., mask, generator=gen)
    assert torch.equal(gray[..., 0], gray[..., 1])
    assert not torch.equal(noise[..., 0], noise[..., 1])
    zero = deg.random_add_poisson_noise_pt(img, (0., 0.), 0.5,
                                           valid_mask=mask, generator=gen)
    assert torch.equal(zero, img)
