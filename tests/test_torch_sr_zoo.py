"""The SR zoo's nets against the JAX package's on the CPU: RRDBNet at
scales 1, 2 and 4, EDSR, RCAN, SRVGGNetCompact with each activation,
ECBSR (``with_idt`` on and off, 1 and 3 channels, its edge masks taking no
gradient), RIDNet, and SwinIR under each upsampler, both
``resi_connection``s, ``ape``, an input larger than ``img_size`` and not
square, a window no larger than the resolution, and stochastic depth; with
``pixel_unshuffle`` against the JAX one, and each net's state dict through
the JAX package's ``torch_to_flax`` and back through the port's
``convert`` unchanged.

Each net takes seeded flax variables (``seeded_variables``: the flax
``init``'s tree, numpy values) through the port's ``convert``; its output
and every parameter's gradient of ``sum(out * cot)`` are held against
``jax.grad``'s, as a share of the JAX tensor's largest entry: outputs 1e-5
(measured at most 6.2e-7, RCAN), gradients 1e-4 (measured at most 6.6e-6,
SwinIR): f32 sums in another order; a gradient that is zero (a bias
behind a ReLU that is off everywhere) against 1e-3 of the net's largest
gradient instead of its own. A parameter whose JAX gradient is
exactly zero (ECBSR's masks) must be a buffer of the port net, with no
gradient. One jitted ``jax.value_and_grad`` a case."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu import convert as jax_convert
from mrefsr_tpu.archs import ecbsr_arch as jax_ecbsr
from mrefsr_tpu.archs import edsr_arch as jax_edsr
from mrefsr_tpu.archs import rcan_arch as jax_rcan
from mrefsr_tpu.archs import ridnet_arch as jax_ridnet
from mrefsr_tpu.archs import rrdbnet_arch as jax_rrdbnet
from mrefsr_tpu.archs import srvgg_arch as jax_srvgg
from mrefsr_tpu.archs import swinir_arch as jax_swinir
from mrefsr_tpu.ops import pixel_unshuffle as jax_pixel_unshuffle
from mrefsr_tpu_torch.archs import build_network, swinir_arch
from mrefsr_tpu_torch.convert import net_state_dict_from_flax
from mrefsr_tpu_torch.ops import pixel_unshuffle
from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY
from test_torch_video_zoo import (close, nchw, nhwc, port_net,
                                  seeded_variables)

OUT_TOL, GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-3


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def check_net(jax_net, x, name, kwargs, seed, train=False, generator=None,
              before_jax=None):
    """The port net ``name(**kwargs)`` against ``jax_net`` on NHWC ``x``
    from the same seeded variables: output and every gradient. With
    ``train`` the port net runs in training mode with ``generator`` (its
    stochastic depth), and ``before_jax()`` patches the JAX net's draws to
    match just before its one trace. Returns the largest relative
    errors."""
    variables = seeded_variables(jax_net, [x], seed)
    net = port_net(ARCH_REGISTRY.get(name), variables, **kwargs)
    xj = jnp.asarray(x)
    want_shape = jax.eval_shape(lambda v: jax_net.apply(v, xj),
                                variables).shape
    cot = np.random.RandomState(99).randn(*want_shape).astype(np.float32)

    def loss(params):
        out = jax_net.apply({'params': params}, xj)
        return jnp.sum(out * cot), out

    if before_jax is not None:
        before_jax()
    (_, want), want_grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables['params'])
    net.train(train)
    if train:
        net.generator = generator
    got = net(nchw(x))
    errs = {'out': close(nhwc(got), want, OUT_TOL, f'{name} out')}
    (got * nchw(cot)).sum().backward()
    want_grads = {k: v.numpy() for k, v in net_state_dict_from_flax(
        net, jax.tree_util.tree_map(np.asarray, want_grads)).items()}
    named = dict(net.named_parameters())
    buffers = dict(net.named_buffers())
    errs['grad'] = 0.
    floor = GRAD_FLOOR * max(np.abs(v).max() for v in want_grads.values())
    for key, val in want_grads.items():
        if key in named:
            errs['grad'] = max(errs['grad'], close(
                named[key].grad, val, GRAD_TOL, f'{name} {key}', floor))
        else:
            assert key in buffers and not np.any(val), key
    assert set(named) <= set(want_grads)
    return errs


def build_network_meta(name, kwargs):
    with torch.device('meta'):
        return build_network({'type': name, **kwargs})


def images(seed, b, h, w, c=3, scale=1.):
    return (np.random.RandomState(seed).rand(b, h, w, c) * scale).astype(
        np.float32)


@pytest.mark.parametrize('scale', [2, 4])
def test_pixel_unshuffle_matches_jax(scale):
    """The port's NCHW unshuffle on the transposed NHWC data the JAX
    function takes: the channel order ``c * r^2 + i * r + j``."""
    x = images(scale, 2, 8, 12, 3)
    got = pixel_unshuffle(nchw(x), scale)
    np.testing.assert_array_equal(
        nhwc(got), np.asarray(jax_pixel_unshuffle(jnp.asarray(x), scale)))


@pytest.mark.parametrize('scale', [1, 2, 4])
def test_rrdbnet_matches_jax(scale):
    kwargs = dict(num_in_ch=3, num_out_ch=3, scale=scale, num_feat=8,
                  num_block=2, num_grow_ch=4)
    check_net(jax_rrdbnet.RRDBNet(**kwargs), images(scale, 2, 16, 20),
              'RRDBNet', kwargs, seed=scale)


@pytest.mark.parametrize('name,kwargs', [
    ('EDSR', dict(num_feat=8, num_block=2, upscale=3, res_scale=0.1)),
    ('RCAN', dict(num_feat=16, num_group=2, num_block=2, squeeze_factor=4,
                  upscale=4, res_scale=0.5))], ids=['EDSR', 'RCAN'])
def test_edsr_rcan_match_jax(name, kwargs):
    """EDSR at x3 (one conv and a shuffle by 3), RCAN at x4 (two steps by
    2), both with a residual scale below 1."""
    cls = {'EDSR': jax_edsr.EDSR, 'RCAN': jax_rcan.RCAN}[name]
    check_net(cls(**kwargs), images(5, 2, 12, 10), name, kwargs, seed=6)


@pytest.mark.parametrize('act_type', ['relu', 'prelu', 'leakyrelu'])
def test_srvgg_matches_jax(act_type):
    kwargs = dict(num_feat=8, num_conv=3, upscale=4, act_type=act_type)
    check_net(jax_srvgg.SRVGGNetCompact(**kwargs), images(7, 2, 12, 10),
              'SRVGGNetCompact', kwargs, seed=8)


@pytest.mark.parametrize('channels,with_idt,act_type', [
    (3, True, 'prelu'), (1, False, 'relu'), (1, True, 'softplus')])
def test_ecbsr_matches_jax(channels, with_idt, act_type):
    """With ``num_channel`` 16 = ``num_out_ch * scale^2`` at 1 channel x4
    the last block takes the identity too where ``with_idt``. Each edge
    branch's ``mask`` is a buffer without gradient; JAX's is exactly 0."""
    kwargs = dict(num_in_ch=channels, num_out_ch=channels, num_block=2,
                  num_channel=16 if channels == 1 else 8, with_idt=with_idt,
                  act_type=act_type, scale=4 if channels == 1 else 2)
    check_net(jax_ecbsr.ECBSR(**kwargs), images(9, 2, 10, 12, channels),
              'ECBSR', kwargs, seed=10)
    net = build_network_meta('ECBSR', kwargs)
    masks = [k for k, _ in net.named_buffers() if k.endswith('.mask')]
    assert len(masks) == 3 * 4
    assert not any(k.endswith('.mask') for k, _ in net.named_parameters())


def test_ridnet_matches_jax():
    """Inputs in [0, 255], as the RIDNet script feeds them."""
    kwargs = dict(in_channels=3, mid_channels=16, out_channels=3,
                  num_block=2)
    check_net(jax_ridnet.RIDNet(**kwargs), images(11, 2, 12, 14, 3, 255.),
              'RIDNet', kwargs, seed=12)


SWINIR = dict(embed_dim=12, depths=(2, 2), num_heads=(2, 3), window_size=4,
              mlp_ratio=2.)
SWINIR_CASES = {
    'pixelshuffle': (dict(img_size=16, upscale=2, upsampler='pixelshuffle'),
                     (16, 16, 3)),
    'direct_3conv_larger': (dict(img_size=16, upscale=3,
                                 upsampler='pixelshuffledirect',
                                 resi_connection='3conv'), (24, 20, 3)),
    'nearest_conv_ape': (dict(img_size=16, upscale=4,
                              upsampler='nearest+conv', ape=True),
                         (16, 16, 3)),
    'denoise_gray_one_window': (dict(img_size=8, window_size=8, upscale=1,
                                     in_chans=1, img_range=255.,
                                     upsampler=''), (16, 24, 1)),
}


@pytest.mark.parametrize('case', sorted(SWINIR_CASES))
def test_swinir_matches_jax(case):
    """Each upsampler; ``3conv`` on an input larger than ``img_size`` and
    not square (its shifted masks computed for that size); ``ape``; one
    channel, ``img_range`` 255 and an ``img_size`` no larger than the
    window (one unshifted window of 8 at 16 x 24). In eval, as the JAX net
    runs without a ``droppath`` key."""
    kwargs, (h, w, c) = SWINIR_CASES[case]
    kwargs = {**SWINIR, **kwargs}
    check_net(jax_swinir.SwinIR(**kwargs), images(13, 2, h, w, c), 'SwinIR',
              kwargs, seed=14)


def _torch_drawn_drop_path(seed):
    """A stand-in for the JAX block's ``_drop_path`` that draws each mask
    as the port's ``drop_path`` does, from a CPU generator seeded with
    ``seed``, in call order."""
    gen = torch.Generator().manual_seed(seed)

    def drop(self, v):
        if self.drop_path <= 0.:
            return v
        keep = 1.0 - self.drop_path
        mask = torch.empty((v.shape[0],) + (1,) * (v.ndim - 1)).bernoulli_(
            keep, generator=gen).numpy()
        return v * jnp.asarray(mask, v.dtype) / keep

    return drop


def test_swinir_drop_path_matches_jax(monkeypatch):
    """Training mode with a generator: the JAX net, its per-block rates
    (linear to ``drop_path_rate`` over every block) and its two drops a
    block, with the port's masks, gives the port's output and gradients."""
    kwargs = {**SWINIR, 'img_size': 16, 'upscale': 2,
              'upsampler': 'pixelshuffledirect', 'drop_path_rate': 0.5}
    check_net(jax_swinir.SwinIR(**kwargs), images(15, 4, 16, 16), 'SwinIR',
              kwargs, seed=16, train=True,
              generator=torch.Generator().manual_seed(21),
              before_jax=lambda: monkeypatch.setattr(
                  jax_swinir.SwinTransformerBlock, '_drop_path',
                  _torch_drawn_drop_path(21)))


def test_swinir_drop_path_is_seeded_and_off_in_eval():
    """Eval, or training without a generator, is the identity (the same
    output as ``drop_path_rate`` 0); training with one is a function of
    its seed, and another seed drops other samples."""
    kwargs = {**SWINIR, 'img_size': 16, 'upscale': 2,
              'upsampler': 'pixelshuffledirect', 'drop_path_rate': 0.5}
    with torch.device('meta'):
        net = swinir_arch.SwinIR(**kwargs)
    net.to_empty(device='cpu')
    net.init_weights(torch.Generator().manual_seed(0))
    x = nchw(images(17, 4, 16, 16))
    with torch.no_grad():
        plain = swinir_arch.SwinIR(**{**kwargs, 'drop_path_rate': 0.})
        plain.load_state_dict(net.state_dict())
        want = plain.eval()(x)
        outs = {}
        for train, seed in ((False, 1), (True, None), (True, 1), (True, 1),
                            (True, 2)):
            net.train(train)
            net.generator = None if seed is None \
                else torch.Generator().manual_seed(seed)
            outs.setdefault((train, seed), []).append(net(x))
    assert torch.equal(outs[(False, 1)][0], want)
    assert torch.equal(outs[(True, None)][0], want)
    first, again = outs[(True, 1)]
    assert torch.equal(first, again) and not torch.equal(first, want)
    assert not torch.equal(outs[(True, 2)][0], first)


ROUND_TRIP = {
    'RRDBNet': dict(num_in_ch=3, num_out_ch=3, scale=2, num_feat=8,
                    num_block=1, num_grow_ch=4),
    'EDSR': dict(num_feat=8, num_block=1, upscale=2),
    'RCAN': dict(num_feat=16, num_group=1, num_block=1, squeeze_factor=4),
    'SRVGGNetCompact': dict(num_feat=8, num_conv=1, act_type='prelu'),
    'ECBSR': dict(num_in_ch=3, num_out_ch=3, num_block=1, num_channel=8,
                  with_idt=True, act_type='prelu', scale=2),
    'RIDNet': dict(in_channels=3, mid_channels=16, out_channels=3,
                   num_block=1),
    'SwinIR': {**SWINIR, 'img_size': 16, 'upsampler': 'pixelshuffle',
               'ape': True, 'resi_connection': '3conv'},
}


@pytest.mark.parametrize('name', sorted(ROUND_TRIP))
def test_state_dict_round_trips_through_flax(name):
    """A seeded port net's state dict (SwinIR's ``relative_position_index``
    and ``attn_mask`` buffers left out, as the JAX package's
    ``swinir_rename`` leaves them) through the JAX package's
    ``torch_to_flax`` and the port's ``state_dict_from_flax`` comes back
    unchanged: ECBSR's OIHW branches and masks, the PReLU slopes, RIDNet's
    mean shifts, SwinIR's ``qkv`` / ``proj`` and bias tables; and loads
    strictly into a fresh net beside its buffers."""
    with torch.device('meta'):
        net = build_network({'type': name, **ROUND_TRIP[name]})
    net.to_empty(device='cpu')
    net.init_weights(torch.Generator().manual_seed(3))
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    flax = jax_convert.torch_to_flax(state, rename=jax_swinir.swinir_rename)
    assert set(flax) == {'params'}
    back = net_state_dict_from_flax(net, flax['params'])
    kept = {k for k in state if jax_swinir.swinir_rename(k) is not None}
    assert set(back) == kept
    for key in kept:
        np.testing.assert_array_equal(back[key].numpy(), state[key], key)
    fresh = build_network({'type': name, **ROUND_TRIP[name]})
    for key, val in fresh.state_dict().items():
        back.setdefault(key, val)
    fresh.load_state_dict(back, strict=True)
    for key, val in fresh.state_dict().items():
        np.testing.assert_array_equal(val.numpy(), state[key], key)
