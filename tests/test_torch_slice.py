"""The port's 5-ref eval forward against the JAX package's, end to end.

Same weights (flax init carried across by ``mrefsr_tpu_torch.convert``)
and the same numpy inputs go through ``__graft_entry__``'s flagship
forward and through the port's ``MultiRefRestorationModel``
(``feed_data`` -> ``test`` -> ``get_current_visuals``) on the CPU.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import __graft_entry__ as graft
from mrefsr_tpu.convert import flax_to_torch
from mrefsr_tpu.ops import feature_match_index as jax_match
from mrefsr_tpu_torch.archs.corres_generation_arch import \
    compute_pre_offsets
from mrefsr_tpu_torch.models import build_model
from mrefsr_tpu_torch.ops import feature_match_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NGF, N_BLOCKS, GROUPS, T, GT = 16, 2, 8, 5, 32


def _opt(ngf, n_blocks, groups):
    return {
        'model_type': 'MultiRefRestorationModel', 'manual_seed': 10,
        'network_g': {'type': 'MRAPARestorationNet', 'ngf': ngf,
                      'n_blocks': n_blocks, 'groups': groups},
        'network_map': {'type': 'CorrespondenceGenerationArch',
                        'patch_size': 3, 'stride': 1,
                        'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                        'vgg_type': 'vgg19'},
        'network_extractor': {'type': 'ContrasMultiExtractorSep'},
        'path': {},
    }


def _with_offset_weights(vars_g, rng):
    """Non-zero conv_offset_mask weights and biases, so that DCN sampling
    is fractional (a fresh net samples at integer positions only)."""
    def perturb(path, leaf):
        keys = [getattr(k, 'key', str(k)) for k in path]
        if 'conv_offset_mask' not in keys:
            return leaf
        scale = 0.01 if keys[-1] == 'kernel' else 1.0
        return jnp.asarray(rng.uniform(-scale, scale, leaf.shape),
                           jnp.float32)
    return jax.tree_util.tree_map_with_path(perturb, vars_g)


@pytest.fixture(scope='module')
def slice_run():
    rng = np.random.RandomState(0)
    batch = {
        'img_in': rng.rand(1, GT, GT, 3).astype(np.float32),
        'img_in_lq': rng.rand(1, GT // 4, GT // 4, 3).astype(np.float32),
        'img_in_up': rng.rand(1, GT, GT, 3).astype(np.float32),
        'img_ref_list': rng.rand(1, T, GT, GT, 3).astype(np.float32),
    }
    ex, net_map, net_g = graft._flagship(ngf=NGF, n_blocks=N_BLOCKS,
                                         groups=GROUPS)
    args = [jnp.asarray(batch[k])
            for k in ('img_in_up', 'img_ref_list', 'img_in_lq')]
    vars_ex, vars_map, vars_g = graft._init_vars(ex, net_map, net_g, *args)
    vars_g = _with_offset_weights(vars_g, rng)
    out_jax = np.asarray(graft._forward_fn(ex, net_map, net_g)(
        vars_ex, vars_map, vars_g, *args))
    feats = ex.apply(vars_ex, args[0], args[1])

    model = build_model(_opt(NGF, N_BLOCKS, GROUPS), device='cpu')
    model.load_from_flax(vars_ex, vars_map, vars_g)
    return batch, feats, out_jax, model


def test_match_indices_agree(slice_run):
    batch, feats, _, model = slice_run
    d1 = np.asarray(feats['dense_features1'])[0]
    d2 = np.asarray(feats['dense_features2'])[0]

    def unit(f):
        return f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-12)

    idx_jax = np.stack([np.asarray(jax_match(
        jnp.asarray(unit(d1)), jnp.asarray(unit(d2[t])),
        norm_input=True)[0]) for t in range(T)])
    with torch.inference_mode():
        refs = torch.from_numpy(batch['img_ref_list']).permute(0, 1, 4, 2, 3)
        ours = model.net_extractor(
            torch.from_numpy(batch['img_in_up']).permute(0, 3, 1, 2), refs)
        f1 = ours['dense_features1'].permute(0, 2, 3, 1)
        f2 = ours['dense_features2'][0].permute(0, 2, 3, 1)
        idx = feature_match_index(
            (f1 / (f1.norm(dim=-1, keepdim=True) + 1e-12)).expand(T, -1, -1,
                                                                 -1),
            f2 / (f2.norm(dim=-1, keepdim=True) + 1e-12), norm_input=True)[0]
    np.testing.assert_allclose(f2.numpy(), d2, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(idx.numpy(), idx_jax)


def test_composed_forward_matches_jax(slice_run):
    batch, _, out_jax, model = slice_run
    model.feed_data(batch)
    model.test()
    visuals = model.get_current_visuals()
    rlt = visuals['rlt']
    assert rlt.dtype == np.float32 and rlt.shape == (1, GT, GT, 3)
    np.testing.assert_array_equal(visuals['img_in_lq'], batch['img_in_lq'])
    np.testing.assert_allclose(rlt, out_jax, rtol=0, atol=1e-4)
    # at init the net adds little to the bilinear base; its own part must
    # agree to 0.1 % of its size as well
    lq = torch.from_numpy(batch['img_in_lq']).permute(0, 3, 1, 2)
    base = torch.nn.functional.interpolate(
        lq, scale_factor=4, mode='bilinear').permute(0, 2, 3, 1).numpy()
    resid = np.abs(out_jax - base).max()
    assert resid > 1e-4
    assert np.abs(rlt - out_jax).max() <= 1e-3 * resid


def test_pre_offsets_are_fractional_in_dcn(slice_run):
    """The carried conv_offset_mask weights move sampling off the grid."""
    _, _, _, model = slice_run
    dyn = model.net_g.dyn_agg_restore.small_dyn_agg
    bias = dyn.conv_offset_mask.bias[:2 * GROUPS * 9]
    frac = (bias - bias.round()).abs()
    assert float(frac.max()) > 0.1


def test_cufed5_network_blocks_build():
    """The shipped CUFED5 eval options build through the port's
    build_model, with every parameter named and shaped as the JAX
    package's converted parameters."""
    with open(os.path.join(REPO, 'options/test/test_5ref_cufed5.yml')) as f:
        opt = yaml.safe_load(f)
    opt = {k: opt[k] for k in ('model_type', 'manual_seed', 'network_g',
                               'network_map', 'network_extractor')}
    opt['path'] = {}
    model = build_model(opt, device='cpu')
    ex, net_map, net_g = graft._flagship(**{
        k: opt['network_g'][k] for k in ('ngf', 'n_blocks', 'groups')})
    gt = 16
    zeros = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
    shapes = jax.eval_shape(
        lambda: graft._init_vars(ex, net_map, net_g, zeros(1, gt, gt, 3),
                                 zeros(1, 2, gt, gt, 3),
                                 zeros(1, gt // 4, gt // 4, 3)))
    for net, variables in zip(
            (model.net_extractor, model.net_map, model.net_g), shapes):
        want = flax_to_torch(jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.float32(0), s.shape),
            variables['params']))
        got = net.state_dict()
        assert sorted(got) == sorted(want)
        for key, val in got.items():
            assert tuple(val.shape) == want[key].shape, key
    assert model.net_g.dyn_agg_restore.small_dyn_agg.deform_groups == 8
    assert len(model.net_g.dyn_agg_restore.body_large) == 16


def test_compute_pre_offsets_layout():
    """(N, H, W, 9, 2) per level, (x, y) last, tap 0 unshifted."""
    rng = np.random.RandomState(3)
    feat = torch.from_numpy(rng.randn(2, 6, 7, 4).astype(np.float32))
    pre = compute_pre_offsets(feat, feat)
    assert pre['relu3_1'].shape == (2, 6, 7, 9, 2)
    assert pre['relu2_1'].shape == (2, 12, 14, 9, 2)
    assert pre['relu1_1'].shape == (2, 24, 28, 9, 2)
    # a map matched against itself has zero flow inside the patch grid
    assert float(pre['relu3_1'][:, :4, :5, 0].abs().max()) == 0.0


def test_pretrained_pth_files_load(tmp_path):
    """``path.pretrain_network_*`` files in the reference format
    (``{'params': state_dict}``, ``module.`` prefixes, the extractor's
    mean/std buffers) replace the seeded weights."""
    src = build_model(_opt(8, 1, 2), device='cpu')
    ex_sd = {f'module.{k}': v
             for k, v in src.net_extractor.state_dict().items()}
    ex_sd['feature_extraction_image1.mean'] = torch.zeros(1, 3, 1, 1)
    ex_sd['feature_extraction_image1.std'] = torch.ones(1, 3, 1, 1)
    torch.save({'params': ex_sd}, tmp_path / 'ex.pth')
    torch.save({'params': src.net_g.state_dict()}, tmp_path / 'g.pth')
    opt = _opt(8, 1, 2)
    opt['manual_seed'] = 11
    opt['path'] = {'pretrain_network_feature_extractor':
                   str(tmp_path / 'ex.pth'),
                   'pretrain_network_g': str(tmp_path / 'g.pth'),
                   'strict_load': True}
    loaded = build_model(opt, device='cpu')
    fresh = build_model(dict(opt, path={}), device='cpu')
    for net in ('net_extractor', 'net_g'):
        want = getattr(src, net).state_dict()
        got = getattr(loaded, net).state_dict()
        for key in want:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
        assert any(not torch.equal(getattr(fresh, net).state_dict()[k],
                                   want[k]) for k in want)
