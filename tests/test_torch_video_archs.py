"""The port's video nets against the JAX package's on the CPU, at small
width: SpyNet, BasicVSR, BasicVSR++ (with and without mirror extension),
EDVR (with and without TSA, and with the pre-deblurring module on a
high-resolution input), and ``PredeblurModule``. The same seeded flax
parameter tree (``torch_video_params``: live offset convs, not the zero
init) goes through ``convert.load_from_flax`` into the port, strictly, and
the same frames through both.

Tolerance: max |port - jax| <= 1e-4 * max |jax| (f32 sums in another
order through recurrent propagation, the deformable convs and the flow
warps; the port's warp goes through normalised coordinates).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs import basicvsr_arch as jax_basicvsr
from mrefsr_tpu.archs import basicvsrpp_arch as jax_basicvsrpp
from mrefsr_tpu.archs import edvr_arch as jax_edvr
from mrefsr_tpu.archs import spynet_arch as jax_spynet
from mrefsr_tpu_torch.archs import (basicvsr_arch, basicvsrpp_arch,
                                    build_network, edvr_arch, spynet_arch)
from mrefsr_tpu_torch.convert import load_from_flax, load_torch_state_dict
from torch_video_params import random_params


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tensors here are tiny, and the test workers of one run share
    the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port(cls, params, **kwargs):
    """The port net from ``meta``, seeded, then the flax tree, strictly."""
    with torch.device('meta'):
        net = cls(**kwargs)
    net.to_empty(device='cpu')
    net.init_weights(torch.Generator().manual_seed(0))
    return load_from_flax(net, params).eval()


def _close(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def _frames(seed, b, t, h, w):
    """Smooth frames that move by a pixel or two between neighbours, so
    that the flows are not all zero."""
    rng = np.random.RandomState(seed)
    base = rng.rand(b, h + 8, w + 8, 3).astype(np.float32)
    base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 2)) / 3
    return np.stack([base[:, i:i + h, 2 * i % 5:2 * i % 5 + w]
                     for i in range(t)], axis=1)


def _video_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3)))


def test_spynet_matches_jax():
    """40 x 56 frames: resized to 64 x 64 and back, flows scaled."""
    x = _frames(0, 1, 2, 40, 56)
    ref, supp = x[:, 0], x[:, 1]
    jax_net = jax_spynet.SpyNet()
    params = random_params(jax_net, (jnp.asarray(ref), jnp.asarray(supp)), 1)
    want = jax.jit(jax_net.apply)({'params': params}, jnp.asarray(ref),
                                  jnp.asarray(supp))
    net = _port(spynet_arch.SpyNet, params)
    with torch.no_grad():
        got = net(*(torch.from_numpy(a).permute(0, 3, 1, 2)
                    for a in (ref, supp)))
    _close(got.permute(0, 2, 3, 1), want)
    assert float(got.abs().max()) > 0.1


def test_basicvsr_matches_jax():
    x = _frames(2, 1, 3, 64, 64)
    jax_net = jax_basicvsr.BasicVSR(num_feat=8, num_block=1)
    params = random_params(jax_net, (jnp.asarray(x),), 3)
    want = jax.jit(jax_net.apply)({'params': params}, jnp.asarray(x))
    net = _port(basicvsr_arch.BasicVSR, params, num_feat=8, num_block=1)
    with torch.no_grad():
        got = net(_video_nchw(x))
    assert got.shape == (1, 3, 3, 256, 256)
    _close(got.permute(0, 1, 3, 4, 2), want)


@pytest.fixture(scope='module')
def basicvsrpp():
    """Frames, the JAX net and its seeded tree, and the port net."""
    x = _frames(4, 1, 3, 64, 64)
    jax_net = jax_basicvsrpp.BasicVSRPlusPlus(mid_channels=8, num_blocks=1)
    params = random_params(jax_net, (jnp.asarray(x),), 5)
    net = _port(basicvsrpp_arch.BasicVSRPlusPlus, params, mid_channels=8,
                num_blocks=1)
    return x, jax_net, params, net


@pytest.mark.parametrize('mirror', [False, True])
def test_basicvsrpp_matches_jax(basicvsrpp, mirror):
    """The second-order propagation, both flows' deform groups and the
    reconstruction's branch order; with ``is_mirror_extended`` the forward
    flows are the backward ones reversed."""
    x, jax_net, params, net = basicvsrpp
    want = jax.jit(jax_net.apply, static_argnames='is_mirror_extended')(
        {'params': params}, jnp.asarray(x), is_mirror_extended=mirror)
    with torch.no_grad():
        got = net(_video_nchw(x), is_mirror_extended=mirror)
    assert got.shape == (1, 3, 3, 256, 256)
    _close(got.permute(0, 1, 3, 4, 2), want)


def test_basicvsrpp_offsets_leave_the_flow(basicvsrpp):
    """The live offset conv moves the samples off the flows: the mask and
    residue are not the zero-init constants (else the test above would
    hold the deformable conv at the flow positions only)."""
    _, _, params, net = basicvsrpp
    last = params['deform_align.backward_1']['conv_offset.6']['kernel']
    assert np.abs(last).max() > 0.01
    assert float(net.deform_align['backward_1'].conv_offset[6]
                 .weight.abs().max()) > 0.01


def test_basicvsrpp_refuses_small_inputs(basicvsrpp):
    _, _, _, net = basicvsrpp
    with pytest.raises(AssertionError, match='at least 64'):
        net(torch.zeros((1, 2, 3, 32, 64)))


@pytest.mark.parametrize('case', ['tsa', 'no_tsa', 'predeblur_hr_in'])
def test_edvr_matches_jax(case):
    """PCD alignment with the frames folded into the batch, TSA fusion or
    a 1x1 conv, and the pre-deblurring module on a 4x input."""
    kwargs = dict(num_feat=8, num_frame=5, deformable_groups=2,
                  num_extract_block=1, num_reconstruct_block=1,
                  with_tsa=case != 'no_tsa')
    size = 32
    if case == 'predeblur_hr_in':
        kwargs.update(with_predeblur=True, hr_in=True)
        size = 64
    x = _frames(6, 2, 5, size, size)
    jax_net = jax_edvr.EDVR(**kwargs)
    params = random_params(jax_net, (jnp.asarray(x),), 7)
    want = jax.jit(jax_net.apply)({'params': params}, jnp.asarray(x))
    net = _port(edvr_arch.EDVR, params, **kwargs)
    with torch.no_grad():
        got = net(_video_nchw(x))
    _close(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize('hr_in', [False, True])
def test_predeblur_module_matches_jax(hr_in):
    x = _frames(8, 2, 1, 32, 32)[:, 0]
    jax_net = jax_edvr.PredeblurModule(num_feat=8, hr_in=hr_in)
    params = random_params(jax_net, (jnp.asarray(x),), 9)
    want = jax_net.apply({'params': params}, jnp.asarray(x))
    with torch.device('meta'):
        net = edvr_arch.PredeblurModule(num_feat=8, hr_in=hr_in)
    net = load_from_flax(net.to_empty(device='cpu'), params).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), want)


# a few of the reference's torch names, as a published checkpoint has them
REFERENCE_KEYS = {
    'SpyNet': ('basic_module.5.basic_module.8.bias', 'mean', 'std'),
    'BasicVSR': ('spynet.basic_module.0.basic_module.0.weight',
                 'backward_trunk.main.2.0.conv1.weight', 'fusion.weight',
                 'upconv2.weight', 'conv_last.bias'),
    'BasicVSRPlusPlus': ('deform_align.forward_2.conv_offset.6.weight',
                         'deform_align.backward_1.weight',
                         'backbone.forward_2.main.0.weight',
                         'reconstruction.main.2.4.conv2.bias',
                         'feat_extract.main.2.4.conv1.weight',
                         'spynet.mean'),
    'EDVR': ('pcd_align.dcn_pack.l3.conv_offset.weight',
             'pcd_align.offset_conv3.l2.weight', 'pcd_align.feat_conv.l1.bias',
             'pcd_align.cas_dcnpack.weight', 'fusion.spatial_attn_add2.bias',
             'feature_extraction.0.conv1.weight',
             'reconstruction.0.conv2.weight'),
}
SMALL = {'SpyNet': {}, 'BasicVSR': dict(num_feat=8, num_block=1),
         'BasicVSRPlusPlus': dict(mid_channels=8, num_blocks=1),
         'EDVR': dict(num_feat=8, deformable_groups=2, num_extract_block=1,
                      num_reconstruct_block=1)}


@pytest.mark.parametrize('name', sorted(REFERENCE_KEYS))
def test_checkpoints_load_strictly_with_reference_names(tmp_path, name):
    """Each registered net: its state dict holds the reference's names, a
    reference-format ``.pth`` of it loads into a fresh net with
    ``strict=True`` and gives the same outputs' weights back."""
    with torch.device('meta'):
        net = build_network({'type': name, **SMALL[name]})
    net.to_empty(device='cpu')
    net.init_weights(torch.Generator().manual_seed(1))
    state = net.state_dict()
    assert set(REFERENCE_KEYS[name]) <= set(state)
    path = tmp_path / f'{name}.pth'
    torch.save({'params': state}, path)
    other = build_network({'type': name, **SMALL[name]})
    other.load_state_dict(load_torch_state_dict(str(path)), strict=True)
    for key, val in other.state_dict().items():
        assert torch.equal(val, state[key]), key


def test_seeded_init_is_the_references():
    """Fresh weights as the reference draws them: offset convs zero (masks
    0.5, offsets on the flows), residual blocks scaled by 0.1, SpyNet's
    ImageNet constants; the same seed gives the same weights."""
    def make(seed):
        with torch.device('meta'):
            net = basicvsrpp_arch.BasicVSRPlusPlus(mid_channels=8,
                                                   num_blocks=1)
        net.to_empty(device='cpu')
        net.init_weights(torch.Generator().manual_seed(seed))
        return net

    net = make(3)
    align = net.deform_align['forward_1']
    assert float(align.conv_offset[6].weight.abs().max()) == 0
    assert float(align.conv_offset[0].weight.abs().max()) > 0
    assert float(align.bias.abs().max()) == 0
    block = net.backbone['forward_1'].main[2][0].conv1.weight
    fan_in = block[0].numel()
    assert 0.05 < float(block.std()) * np.sqrt(fan_in / 2) / 0.1 < 2
    torch.testing.assert_close(net.spynet.std.flatten(),
                               torch.tensor([0.229, 0.224, 0.225]))
    again = make(3).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in net.state_dict().items())
