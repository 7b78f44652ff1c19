"""A12's learned and statistical metrics in the port against the JAX
package on the CPU:

* MATLAB's ``imresize`` (cubic, antialiased) at reductions and
  enlargements, HWC and HW: bit for bit (both are the same numpy);
* NIQE on a 208 x 208 image, Y and gray, with a cropped border, directly
  and through ``calculate_metric``: equal to the last bit;
* FID's Frechet distance on seeded Gaussians (64 dimensions), one with
  singular covariances (the ``eps`` branch): rtol 1e-10; the Inception
  features (resize to 299, ``count_include_pad=False`` pools) of two
  64 x 64 images from the same seeded flax variables, within 1e-4 of the
  largest feature (measured 3.6e-7), through ``extract_inception_features``
  on a ``.pth`` in the ``pt_inception`` layout (its ``AuxLogits`` and
  ``fc`` heads dropped);
* LPIPS: ``LPIPSVgg`` on two pairs of 32 x 32 images from seeded
  variables, rtol 1e-5 (measured 2.3e-6), and ``calculate_lpips`` on BGR
  uint8 images from an official-layout ``vgg.pth`` and a torchvision
  ``vgg16`` state dict written from them, rtol 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs.inception import InceptionV3 as JaxInceptionV3
from mrefsr_tpu.metrics import calculate_fid as jax_calculate_fid
from mrefsr_tpu.metrics import calculate_lpips as jax_calculate_lpips
from mrefsr_tpu.metrics import calculate_niqe as jax_calculate_niqe
from mrefsr_tpu.metrics.lpips import LPIPSVgg as JaxLPIPSVgg
from mrefsr_tpu.utils.matlab_functions import imresize as jax_imresize
from mrefsr_tpu_torch.archs.vgg_arch import NAMES
from mrefsr_tpu_torch.convert import (state_dict_from_flax_with_counts,
                                      lpips_state_dict_from_flax)
from mrefsr_tpu_torch.metrics import (LPIPSVgg, calculate_fid,
                                      calculate_lpips, calculate_metric,
                                      calculate_niqe,
                                      extract_inception_features,
                                      load_patched_inception_v3)
from mrefsr_tpu_torch.utils.matlab_functions import imresize
from test_torch_hifacegan import _seeded_variables
from test_torch_video_zoo import close


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize('shape,scale', [((37, 29, 3), 0.5),
                                         ((40, 52, 3), 0.25),
                                         ((17, 23), 0.73),
                                         ((12, 9, 3), 2.0)])
def test_imresize(shape, scale):
    img = np.random.RandomState(0).rand(*shape).astype(np.float32)
    got = imresize(img, scale)
    np.testing.assert_array_equal(got, jax_imresize(img, scale))
    assert got.dtype == np.float32 and got.ndim == len(shape)


def _niqe_image():
    rng = np.random.RandomState(0)
    x = np.linspace(0, 255, 208)[None, :] * np.ones((208, 1))
    img = (x[:, :, None] + rng.randn(208, 208, 3) * 25).clip(0, 255)
    return img.astype(np.float32)


@pytest.mark.parametrize('kwargs', [{'convert_to': 'y', 'crop_border': 0},
                                    {'convert_to': 'gray', 'crop_border': 4}])
def test_niqe(kwargs):
    img = _niqe_image()
    want = jax_calculate_niqe(img, **kwargs)
    assert np.isfinite(want)
    assert calculate_niqe(img, **kwargs) == want
    assert calculate_metric({'img': img}, {'type': 'calculate_niqe',
                                           **kwargs}) == want


def test_fid_math():
    rng = np.random.RandomState(1)
    a, b = rng.randn(200, 64), rng.randn(200, 64) * 1.3 + 0.2
    stats = [(x.mean(0), np.cov(x, rowvar=False)) for x in (a, b)]
    (mu1, s1), (mu2, s2) = stats
    want = jax_calculate_fid(mu1, s1, mu2, s2)
    np.testing.assert_allclose(calculate_fid(mu1, s1, mu2, s2), want,
                               rtol=1e-10)
    got = calculate_metric({'mu1': mu1, 'sigma1': s1, 'mu2': mu2,
                            'sigma2': s2}, {'type': 'calculate_fid'})
    np.testing.assert_allclose(got, want, rtol=1e-10)
    low = rng.randn(10, 64)                        # rank 9 covariances
    s3 = np.cov(low, rowvar=False)
    np.testing.assert_allclose(calculate_fid(mu1, s3, mu2, s3),
                               jax_calculate_fid(mu1, s3, mu2, s3),
                               rtol=1e-10)
    assert calculate_fid(mu1, s1, mu1, s1) == pytest.approx(0, abs=1e-6)


def test_inception_features(tmp_path):
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    module = JaxInceptionV3(output_blocks=(3,), resize_input=True,
                            normalize_input=False)
    variables = _seeded_variables(module, [x], 4)
    want = np.asarray(jax.jit(module.apply)(variables, x)[0]).reshape(2, -1)
    state = state_dict_from_flax_with_counts(variables)
    state['fc.weight'] = torch.zeros(1008, 2048)
    state['AuxLogits.fc.weight'] = torch.zeros(1008, 768)
    path = tmp_path / 'pt_inception.pth'
    torch.save(state, path)
    net = load_patched_inception_v3(str(path), device='cpu')
    got = extract_inception_features(iter([x[:1], x[1:]]), net)
    assert got.shape == (2, 2048)
    close(got, want, 1e-4, 'inception features')
    seeded = load_patched_inception_v3(device='cpu')
    feats = extract_inception_features([x], seeded)
    assert np.isfinite(feats).all() and feats.std() > 0


def _lpips_pair():
    module = JaxLPIPSVgg()
    rng = np.random.RandomState(3)
    x, y = (rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
            for _ in range(2))
    variables = _seeded_variables(module, [x, y], 5)
    lins = {k: np.abs(v) for k, v in variables['params'].items()
            if k.startswith('lin')}           # the learned heads are >= 0
    variables['params'].update(lins)
    return module, variables, x, y


def test_lpips_net():
    module, variables, x, y = _lpips_pair()
    want = np.asarray(jax.jit(module.apply)(variables, x, y))
    net = LPIPSVgg()
    net.load_state_dict(lpips_state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = net(*(torch.from_numpy(v).permute(0, 3, 1, 2)
                    for v in (x, y))).numpy()
    assert got.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_calculate_lpips_from_local_files(tmp_path):
    """The official ``vgg.pth`` (heads ``lin{i}.model.1.weight`` (1, C, 1,
    1)) and a torchvision ``vgg16`` (``features.<i>``, a classifier too)
    written from the seeded variables; both packages' ``calculate_lpips``
    on two BGR uint8 images with a cropped border."""
    _, variables, _, _ = _lpips_pair()
    state = lpips_state_dict_from_flax(variables)
    heads = {k: v for k, v in state.items() if k.startswith('lin')}
    index = {name: i for i, name in enumerate(NAMES['vgg16'])}
    trunk = {f'features.{index[k.split(".")[2]]}.{k.split(".")[3]}': v
             for k, v in state.items() if k.startswith('vgg.')}
    trunk['classifier.0.weight'] = torch.zeros(4, 4)
    lpips_path, vgg_path = tmp_path / 'vgg.pth', tmp_path / 'vgg16.pth'
    torch.save(heads, lpips_path)
    torch.save(trunk, vgg_path)
    rng = np.random.RandomState(6)
    img, img2 = ((rng.rand(40, 36, 3) * 255).astype(np.uint8)
                 for _ in range(2))
    kwargs = {'crop_border': 2, 'lpips_weights': str(lpips_path),
              'vgg16_weights': str(vgg_path)}
    want = jax_calculate_lpips(img, img2, **kwargs)
    got = calculate_lpips(img, img2, device='cpu', **kwargs)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got = calculate_metric({'img': img, 'img2': img2},
                           {'type': 'calculate_lpips', 'device': 'cpu',
                            **kwargs})
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match='lpips_weights'):
        calculate_lpips(img, img2)
