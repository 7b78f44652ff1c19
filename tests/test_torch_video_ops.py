"""The port's video ops against the JAX package's on the CPU:
``flow_warp`` and ``resize_flow`` (``ops/warp.py``), ``interpolate``
(``ops/resize.py``), and the two modules that carry conv groups into the
deformable conv, ``DCNv2Pack`` and ``DynAgg`` with ``groups=2``.

Tolerances: ``flow_warp`` 1e-5 x max |out|: the port samples through
``F.grid_sample``'s normalised coordinates (the reference's formula), the
JAX package at the pixel positions, and the round trip moves a position
by a few ulps of its size; the gradient in the flow 1e-4 x its max (it
comes back through the normalisation's scale). ``interpolate`` 1e-5 x max
|out| (at most 16 taps in another order); modules 1e-4 x max |out| (a conv
and the deformable conv, in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs import arch_util as jax_arch_util
from mrefsr_tpu.archs import ref_mrapa_restoration_arch as jax_mrapa
from mrefsr_tpu.ops import warp as jax_warp
from mrefsr_tpu.ops.resize import interpolate as jax_interpolate
from mrefsr_tpu_torch.archs import arch_util, ref_mrapa_restoration_arch
from mrefsr_tpu_torch.convert import state_dict_from_flax
from mrefsr_tpu_torch.ops import flow_warp, interpolate, resize_flow
from torch_video_params import random_params


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tensors here are tiny, and the test workers of one run share
    the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _warp_case(seed, n=2, h=11, w=13, c=5, spread=4.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    flow = (rng.randn(n, h, w, 2) * spread).astype(np.float32)
    return x, flow


@pytest.mark.parametrize('padding_mode', ['zeros', 'border'])
@pytest.mark.parametrize('align_corners', [True, False])
def test_flow_warp_matches_jax(padding_mode, align_corners):
    """Fractional flows of a few pixels, many of them leaving the map."""
    x, flow = _warp_case(0)
    kw = dict(padding_mode=padding_mode, align_corners=align_corners)
    want = jax_warp.flow_warp(jnp.asarray(x), jnp.asarray(flow), **kw)
    got = flow_warp(torch.from_numpy(x), torch.from_numpy(flow), **kw)
    _close(got, want, 1e-5)


def test_flow_warp_with_integer_flows_is_a_shift():
    """An integer flow inside the map copies x at the shifted pixels."""
    x, _ = _warp_case(1)
    flow = np.zeros(x.shape[:3] + (2,), np.float32)
    flow[..., 0], flow[..., 1] = 2, -1                  # dx 2, dy -1
    got = flow_warp(torch.from_numpy(x), torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got[:, 1:, :-2], x[:, :-1, 2:], rtol=0,
                               atol=1e-5)
    assert np.all(got[:, :, -2:] == 0) and np.all(got[:, 0] == 0)


def test_flow_warp_gradient_matches_jax():
    """Gradients in x and in the flow through the bilinear sampling."""
    x, flow = _warp_case(2, spread=1.5)
    cot = np.random.RandomState(3).randn(*x.shape).astype(np.float32)
    want = jax.grad(lambda a, f: (jax_warp.flow_warp(a, f) * cot).sum(),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(flow))
    xt, ft = (torch.from_numpy(a).requires_grad_() for a in (x, flow))
    (flow_warp(xt, ft) * torch.from_numpy(cot)).sum().backward()
    _close(xt.grad, want[0], 1e-5)
    _close(ft.grad, want[1], 1e-4)


@pytest.mark.parametrize('size_type,sizes', [('ratio', (2.0, 0.5)),
                                             ('ratio', (0.4, 1.7)),
                                             ('shape', (7, 20))])
def test_resize_flow_matches_jax(size_type, sizes):
    _, flow = _warp_case(4)
    want = jax_warp.resize_flow(jnp.asarray(flow), size_type, sizes)
    got = resize_flow(torch.from_numpy(flow), size_type, sizes)
    _close(got, want, 1e-5)


@pytest.mark.parametrize('mode,scale,align_corners', [
    ('bilinear', 2, False), ('bilinear', 0.5, False),
    ('bicubic', 0.25, False), ('bilinear', 2, True), ('nearest', 2, False),
    ('bicubic', 3, False)])
def test_interpolate_matches_jax(mode, scale, align_corners):
    """Odd sizes (18 x 13 by 0.25 is 4 x 3; torch's own scale_factor would
    map by 4, the JAX package by 18 / 4): the port passes the size."""
    x = np.random.RandomState(5).randn(2, 18, 13, 3).astype(np.float32)
    kw = dict(scale_factor=scale, mode=mode, align_corners=align_corners)
    want = jax_interpolate(jnp.asarray(x), **kw)
    got = interpolate(torch.from_numpy(x), **kw)
    assert got.shape == (2, int(18 * scale), int(13 * scale), 3)
    _close(got, want, 1e-5)


def test_interpolate_takes_a_size():
    x = np.random.RandomState(6).rand(1, 9, 10, 2).astype(np.float32)
    want = jax_interpolate(jnp.asarray(x), size=(16, 7), mode='bilinear')
    got = interpolate(torch.from_numpy(x), size=(16, 7), mode='bilinear')
    _close(got, want, 1e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port(module, params):
    module.load_state_dict(state_dict_from_flax(params), strict=True)
    return module.eval()


@pytest.mark.parametrize('groups,dg', [(2, 4), (2, 1), (1, 4)])
def test_dcnv2pack_matches_jax(groups, dg):
    """Offsets and masks from a live ``conv_offset`` (seeded, not the zero
    init), conv groups into the deformable conv."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 9, 10, 16).astype(np.float32)
    feat = rng.randn(2, 9, 10, 16).astype(np.float32)
    jax_net = jax_arch_util.DCNv2Pack(16, 8, groups=groups,
                                      deformable_groups=dg)
    params = random_params(jax_net, (jnp.asarray(x), jnp.asarray(feat)), 8,
                           scale=2.0)
    assert params['kernel'].shape == (3, 3, 16 // groups, 8)
    want = jax_net.apply({'params': params}, jnp.asarray(x),
                         jnp.asarray(feat))
    with torch.device('meta'):
        net = arch_util.DCNv2Pack(16, 8, groups=groups, deformable_groups=dg)
    net = _port(net.to_empty(device='cpu'), params)
    assert net.weight.shape == (8, 16 // groups, 3, 3)
    with torch.no_grad():
        got = net(_nchw(x), _nchw(feat)).permute(0, 2, 3, 1)
    _close(got, want, 1e-4)


def test_dynagg_with_groups_matches_jax():
    rng = np.random.RandomState(9)
    x = rng.randn(2, 8, 9, 16).astype(np.float32)
    feat = rng.randn(2, 8, 9, 16).astype(np.float32)
    pre = (rng.randn(2, 8, 9, 9, 2) * 2).astype(np.float32)
    jax_net = jax_mrapa.DynAgg(16, 16, groups=2, deform_groups=4)
    inputs = tuple(jnp.asarray(a) for a in (x, feat, pre))
    params = random_params(jax_net, inputs, 10)
    want = jax_net.apply({'params': params}, *inputs)
    with torch.device('meta'):
        net = ref_mrapa_restoration_arch.DynAgg(16, 16, groups=2,
                                                deform_groups=4)
    net = _port(net.to_empty(device='cpu'), params)
    assert net.weight.shape == (16, 8, 3, 3)
    with torch.no_grad():
        got = net(_nchw(x), _nchw(feat), torch.from_numpy(pre))
    _close(got.permute(0, 2, 3, 1), want, 1e-4)
