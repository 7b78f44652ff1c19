"""The port's flow alignment against the JAX package's, on the CPU, where
the port runs the plain version of its CUDA kernels: ``deform_sample``
forward and gradients, ``FlowAgg``, and
``MRAPARestorationNet(alignment='flow')`` with the flax init carried
across by ``mrefsr_tpu_torch.convert``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs import ref_mrapa_restoration_arch as jax_mrapa
from mrefsr_tpu.ops import dcn as jax_dcn
from mrefsr_tpu_torch.archs import ref_mrapa_restoration_arch as mrapa
from mrefsr_tpu_torch.convert import state_dict_from_flax
from mrefsr_tpu_torch.ops import dcn


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tensors here are tiny, and the test workers of one run share
    the host's cores: more threads per process only get in each other's
    way."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _case(seed, n=2, h=7, w=9, c=16, dg=4, spread=1.5):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    flow = (rng.randn(n, h, w, dg, 2) * spread).astype(np.float32)
    cot = rng.randn(n, h, w, c).astype(np.float32)
    return x, flow, cot


def _forward_both(x, flow):
    want = jax_dcn.deform_sample(jnp.asarray(x), jnp.asarray(flow))
    got = dcn.deform_sample(torch.from_numpy(x), torch.from_numpy(flow))
    return got.numpy(), np.asarray(want)


def _grads_both(x, flow, cot):
    want = jax.grad(lambda a, f: (jax_dcn.deform_sample(a, f)
                                  * jnp.asarray(cot)).sum(),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(flow))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, flow)]
    (dcn.deform_sample(*args) * torch.from_numpy(cot)).sum().backward()
    return [a.grad.numpy() for a in args], [np.asarray(g) for g in want]


def _assert_grads_close(got, want):
    """Each gradient within 1e-5 of its own largest entry (f32 sums in
    another order)."""
    for name, g, w in zip(('x', 'flow'), got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize('dg', [1, 4])
@pytest.mark.parametrize('spread', [0.7, 4.0, 40.0])
def test_deform_sample_matches_jax(dg, spread):
    """Fractional flows (0.7), many samples leaving the image (4.0) and
    far out of range (40.0)."""
    x, flow, _ = _case(0, dg=dg, spread=spread)
    got, want = _forward_both(x, flow)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_deform_sample_integer_flow_is_a_gather():
    """With integer flows the warp copies ``x`` at the shifted positions
    bit for bit (the row gather ``out[s, m] = table[s, idx[s, m]]``), and
    zero where the position is outside."""
    x, _, _ = _case(1, n=1, dg=2)
    n, h, w, c = x.shape
    rng = np.random.RandomState(2)
    flow = rng.randint(-3, 4, size=(n, h, w, 2, 2)).astype(np.float32)
    got, want = _forward_both(x, flow)
    np.testing.assert_array_equal(got, want)
    expect = np.zeros_like(x)
    for y in range(h):
        for xx in range(w):
            for g in range(2):
                sy = y + int(flow[0, y, xx, g, 0])
                sx = xx + int(flow[0, y, xx, g, 1])
                if 0 <= sy < h and 0 <= sx < w:
                    expect[0, y, xx, g * 8:(g + 1) * 8] = \
                        x[0, sy, sx, g * 8:(g + 1) * 8]
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize('spread', [0.7, 4.0])
def test_deform_sample_gradients_match_jax(spread):
    x, flow, cot = _case(3, spread=spread)
    got, want = _grads_both(x, flow, cot)
    assert all(np.abs(w).max() > 0 for w in want)
    _assert_grads_close(got, want)


def test_deform_sample_gradients_at_integer_and_border_flows_match_jax():
    """Integer flows (one-sided differences, as a fresh net has them) and
    samples at exactly -1 and H - 1 (W - 1)."""
    x, flow, cot = _case(4, n=1, h=5, w=6, c=8, dg=2)
    got, want = _grads_both(x, np.round(flow), cot)
    assert np.abs(want[1]).max() > 0
    _assert_grads_close(got, want)
    oy = np.arange(5, dtype=np.float32)[:, None, None]
    ox = np.arange(6, dtype=np.float32)[None, :, None]
    for ty, tx in [(-1.0, 2.0), (4.0, 2.5), (1.5, -1.0), (2.0, 5.0),
                   (-1.0, 5.0)]:
        flow[0, ..., 0] = ty - oy
        flow[0, ..., 1] = tx - ox
        _assert_grads_close(*_grads_both(x, flow, cot))
    # by hand: at flow 0, d out[y, x, c] / d dy is x[y + 1, x, c] - x[y, x, c]
    flow[:] = 0
    f = torch.from_numpy(flow).requires_grad_()
    (dcn.deform_sample(torch.from_numpy(x), f)
     * torch.from_numpy(cot)).sum().backward()
    want_dy = (cot[0, 2, 3, :4] * (x[0, 3, 3, :4] - x[0, 2, 3, :4])).sum()
    np.testing.assert_allclose(f.grad[0, 2, 3, 0, 0].item(), want_dy,
                               rtol=1e-4)


def test_deform_sample_checks_its_shapes():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match='flow shape'):
        dcn.deform_sample(x, torch.zeros(1, 4, 5, 2, 2))
    with pytest.raises(ValueError, match='divide'):
        dcn.deform_sample(x, torch.zeros(1, 4, 4, 3, 2))
    with pytest.raises(RuntimeError, match='cuda or cpu'):
        dcn.deform_sample(x.to('meta'),
                          torch.zeros(1, 4, 4, 2, 2, device='meta'))


def _port(cls, variables, *args, **kwargs):
    with torch.device('meta'):
        module = cls(*args, **kwargs)
    module.to_empty(device='cpu')
    module.load_state_dict(state_dict_from_flax(variables['params']),
                           strict=True)
    return module.eval()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _close(got, want):
    """max |port - jax| <= 1e-4 * max |jax|: f32 sums in another order,
    through a few layers."""
    want = np.asarray(want)
    got = got.detach().movedim(-3, -1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize('dg', [2, 8])
def test_flow_agg_matches_jax(dg):
    """Non-zero conv_flow_gate weights make the flow fractional and the
    gates differ from 0.5."""
    rng = np.random.RandomState(5)
    n, h, w, c = 2, 6, 5, 16
    x = rng.randn(n, h, w, c).astype(np.float32)
    feat = rng.randn(n, h, w, c).astype(np.float32)
    pre = rng.randint(-3, 4, size=(n, h, w, 9, 2)).astype(np.float32)
    jax_net = jax_mrapa.FlowAgg(c, c, deform_groups=dg)
    args = [jnp.asarray(a) for a in (x, feat, pre)]
    variables = jax_net.init(jax.random.PRNGKey(5), *args)
    head = variables['params']['conv_flow_gate']
    head['kernel'] = jnp.asarray(
        rng.randn(*head['kernel'].shape).astype(np.float32) * 0.05)
    head['bias'] = jnp.asarray(
        rng.uniform(-1, 1, head['bias'].shape).astype(np.float32))
    want = jax_net.apply(variables, *args)
    net = _port(mrapa.FlowAgg, variables, c, c, deform_groups=dg)
    with torch.no_grad():
        got = net(_nchw(x), _nchw(feat), torch.from_numpy(pre))
    _close(got, want)


def test_flow_net_matches_jax():
    """``MRAPARestorationNet(alignment='flow')``: the flax parameters load
    strictly (same names and shapes) and the forward agrees."""
    rng = np.random.RandomState(6)
    b, t, lq, ngf, groups = 1, 2, 4, 8, 2
    x = rng.rand(b, lq, lq, 3).astype(np.float32)
    pre, feats = {}, {}
    for level, c, s in (('relu3_1', 256, 1), ('relu2_1', 128, 2),
                        ('relu1_1', 64, 4)):
        pre[level] = rng.randint(-2, 3, size=(b, t, lq * s, lq * s, 9, 2)
                                 ).astype(np.float32)
        feats[level] = rng.randn(b, t, lq * s, lq * s, c).astype(np.float32)
    jax_net = jax_mrapa.MRAPARestorationNet(ngf=ngf, n_blocks=1,
                                            groups=groups, alignment='flow')
    args = (jnp.asarray(x), {k: jnp.asarray(v) for k, v in pre.items()},
            {k: jnp.asarray(v) for k, v in feats.items()})
    variables = jax_net.init(jax.random.PRNGKey(6), *args)

    def perturb(path, leaf):
        keys = [getattr(k, 'key', str(k)) for k in path]
        if 'conv_flow_gate' not in keys:
            return leaf
        scale = 0.01 if keys[-1] == 'kernel' else 1.0
        return jnp.asarray(rng.uniform(-scale, scale, leaf.shape),
                           jnp.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    want = jax_net.apply(variables, *args)
    net = _port(mrapa.MRAPARestorationNet, variables, ngf=ngf, n_blocks=1,
                groups=groups, alignment='flow', ref_unroll=5)
    names = [n for n, _ in net.named_parameters()]
    assert 'dyn_agg_restore.small_flow_agg.conv_flow_gate.weight' in names
    assert not any('dyn_agg.' in n for n in names)
    with torch.no_grad():
        got = net(_nchw(x), {k: torch.from_numpy(v) for k, v in pre.items()},
                  {k: _nchw(v) for k, v in feats.items()})
    _close(got, want)


def test_flow_net_starts_at_the_pre_offsets():
    """``init_weights`` zeroes ``conv_flow_gate``; an unknown alignment is
    refused."""
    net = mrapa.MRAPARestorationNet(ngf=8, n_blocks=1, groups=2,
                                    alignment='flow')
    net.init_weights(torch.Generator().manual_seed(0))
    agg = net.dyn_agg_restore.medium_flow_agg
    assert float(agg.conv_flow_gate.weight.abs().max()) == 0.0
    assert float(agg.conv_flow_gate.bias.abs().max()) == 0.0
    assert float(agg.conv_after_warp.weight.abs().max()) > 0.0
    with pytest.raises(ValueError, match='alignment'):
        mrapa.MRAPARestorationNet(alignment='warp')
