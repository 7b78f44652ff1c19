"""The port's archs against the JAX package's, module by module, on the
CPU, with the flax init carried across by ``mrefsr_tpu_torch.convert``.

Tolerance: max |port - jax| <= 1e-4 * max |jax| (relative to the output's
size: f32 sums in another order, through a few layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs import contras_extractor_arch as jax_contras
from mrefsr_tpu.archs import corres_generation_arch as jax_corres
from mrefsr_tpu.archs import ref_mrapa_restoration_arch as jax_mrapa
from mrefsr_tpu.archs import vgg_arch as jax_vgg
from mrefsr_tpu.ops import interpolate as jax_interpolate
from mrefsr_tpu_torch.archs import (contras_extractor_arch,
                                    corres_generation_arch,
                                    ref_mrapa_restoration_arch, vgg_arch)
from mrefsr_tpu_torch.convert import state_dict_from_flax


def _port(cls, variables, *args, **kwargs):
    """Build a port module without drawing on the global RNG and load the
    flax variables into it, strictly."""
    with torch.device('meta'):
        module = cls(*args, **kwargs)
    module.to_empty(device='cpu')
    module.load_state_dict(state_dict_from_flax(variables['params']),
                           strict=True)
    return module.eval()


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _nhwc(t):
    return t.movedim(-3, -1)


def test_vgg_feature_extractor_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.rand(2, 20, 18, 3).astype(np.float32)
    layers = ('relu1_1', 'relu2_1', 'relu3_1')
    jax_net = jax_vgg.VGGFeatureExtractor(layer_name_list=layers)
    variables = jax_net.init(jax.random.PRNGKey(0), jnp.asarray(img))
    want = jax_net.apply(variables, jnp.asarray(img))
    net = _port(vgg_arch.VGGFeatureExtractor, variables, layers)
    with torch.no_grad():
        got = net(_nchw(img))
    assert sorted(got) == sorted(layers)
    for name in layers:
        _close(_nhwc(got[name]), want[name])
    assert got['relu3_1'].shape[-2:] == (5, 4)  # floor-mode pooling


def test_vgg_tower_taps_match_jax():
    rng = np.random.RandomState(1)
    img = rng.randn(1, 9, 11, 3).astype(np.float32)
    taps = ('conv1_2', 'pool1', 'conv2_1')
    jax_net = jax_vgg.VGGTower('vgg16', tap_layers=taps, last_layer='conv2_1')
    variables = jax_net.init(jax.random.PRNGKey(1), jnp.asarray(img))
    want = jax_net.apply(variables, jnp.asarray(img))
    net = _port(vgg_arch.VGGTower, variables, 'vgg16', taps, 'conv2_1')
    with torch.no_grad():
        got = net(_nchw(img))
    for name in taps:
        _close(_nhwc(got[name]), want[name])


def test_contras_multi_extractor_matches_jax():
    rng = np.random.RandomState(2)
    img1 = rng.rand(1, 16, 16, 3).astype(np.float32)
    refs = rng.rand(1, 3, 16, 16, 3).astype(np.float32)
    jax_net = jax_contras.ContrasMultiExtractorSep()
    variables = jax_net.init(jax.random.PRNGKey(2), jnp.asarray(img1),
                             jnp.asarray(refs))
    want = jax_net.apply(variables, jnp.asarray(img1), jnp.asarray(refs))
    net = _port(contras_extractor_arch.ContrasMultiExtractorSep, variables)
    with torch.no_grad():
        got = net(_nchw(img1), _nchw(refs))
    _close(_nhwc(got['dense_features1']), want['dense_features1'])
    _close(_nhwc(got['dense_features2']), want['dense_features2'])
    assert got['dense_features2'].shape == (1, 3, 256, 4, 4)


def test_compute_pre_offsets_matches_jax():
    rng = np.random.RandomState(3)
    feat_in = rng.randn(3, 7, 8, 16).astype(np.float32)
    feat_ref = rng.randn(3, 7, 8, 16).astype(np.float32)
    got = corres_generation_arch.compute_pre_offsets(
        torch.from_numpy(feat_in), torch.from_numpy(feat_ref))
    for i in range(3):
        want = jax_corres.compute_pre_offsets(jnp.asarray(feat_in[i]),
                                              jnp.asarray(feat_ref[i]))
        for level in ('relu1_1', 'relu2_1', 'relu3_1'):
            np.testing.assert_array_equal(got[level][i].numpy(),
                                          np.asarray(want[level]))


@pytest.mark.parametrize('dg', [2, 8])
def test_dyn_agg_matches_jax(dg):
    """Non-zero conv_offset_mask weights make the sampling fractional."""
    rng = np.random.RandomState(4)
    n, h, w, c = 2, 6, 5, 16
    x = rng.randn(n, h, w, c).astype(np.float32)
    feat = rng.randn(n, h, w, c).astype(np.float32)
    pre = rng.randint(-3, 4, size=(n, h, w, 9, 2)).astype(np.float32)
    jax_net = jax_mrapa.DynAgg(c, c, 3, deform_groups=dg)
    args = [jnp.asarray(a) for a in (x, feat, pre)]
    variables = jax_net.init(jax.random.PRNGKey(4), *args)
    com = variables['params']['conv_offset_mask']
    com['kernel'] = jnp.asarray(
        rng.randn(*com['kernel'].shape).astype(np.float32) * 0.05)
    com['bias'] = jnp.asarray(
        rng.uniform(-1, 1, com['bias'].shape).astype(np.float32))
    want = jax_net.apply(variables, *args)
    net = _port(ref_mrapa_restoration_arch.DynAgg, variables, c, c, 3,
                deform_groups=dg)
    with torch.no_grad():
        got = net(_nchw(x), _nchw(feat), torch.from_numpy(pre))
    _close(_nhwc(got), want)


@pytest.mark.parametrize('h,w', [(6, 7), (8, 8)])
def test_mrapa_fusion_matches_jax(h, w):
    """H, W not multiples of 4 exercise the reflect pad and the crop."""
    rng = np.random.RandomState(5)
    b, t, nf, ref_nf = 1, 3, 8, 16
    target = rng.randn(b, h, w, nf).astype(np.float32)
    refs = rng.randn(b, t, h, w, ref_nf).astype(np.float32)
    jax_net = jax_mrapa.MRAPAFusion(nf=nf, ref_nf=ref_nf)
    variables = jax_net.init(jax.random.PRNGKey(5), jnp.asarray(target),
                             jnp.asarray(refs))
    # a larger scale than the 0.02 init, so the attention is not uniform
    variables = jax.tree_util.tree_map(lambda v: v * 10, variables)
    want = jax_net.apply(variables, jnp.asarray(target), jnp.asarray(refs))
    net = _port(ref_mrapa_restoration_arch.MRAPAFusion, variables, nf=nf,
                ref_nf=ref_nf)
    with torch.no_grad():
        got = net(_nchw(target), _nchw(refs))
    _close(_nhwc(got), want)


def test_bilinear_x4_base_matches_jax_at_borders():
    rng = np.random.RandomState(6)
    x = rng.rand(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jax_interpolate(jnp.asarray(x), scale_factor=4,
                                      mode='bilinear', align_corners=False))
    got = torch.nn.functional.interpolate(
        _nchw(x), scale_factor=4, mode='bilinear', align_corners=False)
    got = _nhwc(got).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    border = np.ones(want.shape[1:3], bool)
    border[2:-2, 2:-2] = False
    np.testing.assert_allclose(got[:, border], want[:, border], rtol=0,
                               atol=1e-6)
