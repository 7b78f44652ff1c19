"""``mrefsr_tpu_torch.ops.fused_act`` against ``mrefsr_tpu.ops.fused_act`` on
the CPU: the same numpy inputs go through the JAX op (channels last) and
the port's plain version (channel axis 1), forward, gradient and
second-order gradient, 4-D and 2-D, with and without a bias, and at exact
zeros, where the derivative must be JAX's 1 and not ``F.leaky_relu``'s
slope. The CUDA kernels cannot run here; the ``autograd.Function``s around
them are held against JAX with stand-ins written in PyTorch."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.ops import fused_leaky_relu as jax_fused_leaky_relu
from mrefsr_tpu_torch.ops import (fused_act, fused_leaky_relu,
                                  fused_leaky_relu_ref)

SCALE = np.float32(2 ** 0.5)


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tensors here are tiny, and the test workers of one run share
    the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _to_torch(a):
    """Channels last -> channel axis 1."""
    t = torch.from_numpy(a)
    return t.permute(0, 3, 1, 2) if a.ndim == 4 else t


def _to_numpy(t, like):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if like.ndim == 4 else t).numpy()


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _jax_orders(x, bias, cot):
    """Output; gradients in x and bias for the cotangent; the gradient of
    ``sum(grad_x ** 2) + sum(grad_bias ** 2)`` in the cotangent."""
    has_bias = bias is not None

    def fn(x, bias):
        return jax_fused_leaky_relu(x, bias if has_bias else None)

    def grads(cot):
        return jax.grad(lambda x, b: jnp.sum(fn(x, b) * cot),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(
                            bias if has_bias else np.zeros(x.shape[-1],
                                                           np.float32)))

    def second_loss(cot):
        gx, gb = grads(cot)
        return jnp.sum(gx ** 2) + (jnp.sum(gb ** 2) if has_bias else 0.)

    gx, gb = grads(jnp.asarray(cot))
    out = fn(jnp.asarray(x), None if not has_bias else jnp.asarray(bias))
    second = jax.grad(second_loss)(jnp.asarray(cot))
    return [np.asarray(v) for v in (out, gx, gb if has_bias else None,
                                    second) if v is not None]


def _torch_orders(fn, x, bias, cot):
    xt = _to_torch(x).requires_grad_()
    inputs = [xt]
    if bias is not None:
        inputs.append(torch.from_numpy(bias).requires_grad_())
    cot_t = _to_torch(cot).requires_grad_()
    out = fn(*inputs)
    grads = torch.autograd.grad(out, inputs, cot_t, create_graph=True)
    second, = torch.autograd.grad(sum((g ** 2).sum() for g in grads), cot_t)
    res = [_to_numpy(out, x), _to_numpy(grads[0], x)]
    if bias is not None:
        res.append(grads[1].detach().numpy())
    return res + [_to_numpy(second, x)]


SHAPES = {'4d': (2, 5, 6, 8), '2d': (3, 16), '4d_odd': (1, 3, 7, 5)}


def _inputs(shape, with_bias, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    bias = rng.randn(shape[-1]).astype(np.float32) if with_bias else None
    return x, bias, rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize('with_bias', [True, False], ids=['bias', 'no_bias'])
@pytest.mark.parametrize('shape', sorted(SHAPES))
def test_plain_version_matches_jax_to_second_order(shape, with_bias):
    x, bias, cot = _inputs(SHAPES[shape], with_bias)
    want = _jax_orders(x, bias, cot)
    got = _torch_orders(fused_leaky_relu, x, bias, cot)    # CPU: plain path
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)
    np.testing.assert_array_equal(got[0], want[0])           # bit-equal


def test_other_slope_and_scale_match_jax():
    x, bias, _ = _inputs(SHAPES['4d'], True, seed=1)
    want = np.asarray(jax_fused_leaky_relu(
        jnp.asarray(x), jnp.asarray(bias), negative_slope=0.1, scale=1.5))
    got = fused_leaky_relu(_to_torch(x), torch.from_numpy(bias), 0.1, 1.5)
    _close(_to_numpy(got, x), want)


def _planted():
    """A tensor with exact zeros in half its channels, and a zero bias."""
    x, _, cot = _inputs(SHAPES['4d'], False, seed=2)
    x[..., ::2] = 0.0
    x[0, 0] = -0.0
    return x, np.zeros(x.shape[-1], np.float32), cot


def test_derivative_at_exact_zero_follows_jax():
    """``jax.nn.leaky_relu`` is ``where(x >= 0, x, slope * x)``: derivative
    1 at 0 (and at -0.0). ATen's ``leaky_relu`` backward gives the slope
    there, so the plain version must not be ``F.leaky_relu``."""
    x, bias, cot = _planted()
    want = _jax_orders(x, bias, cot)
    got = _torch_orders(fused_leaky_relu_ref, x, bias, cot)
    for g, w in zip(got, want):
        _close(g, w)
    at_zero = x == 0
    assert at_zero.sum() > 100
    np.testing.assert_array_equal(got[1][at_zero], (cot * SCALE)[at_zero])
    np.testing.assert_array_equal(want[1][at_zero], (cot * SCALE)[at_zero])
    xt = _to_torch(x).requires_grad_()
    aten, = torch.autograd.grad(
        torch.nn.functional.leaky_relu(xt, 0.2) * float(SCALE), xt,
        _to_torch(cot))
    assert not np.allclose(_to_numpy(aten, x)[at_zero],
                           (cot * SCALE)[at_zero])


def _stand_in_kernels(monkeypatch):
    """PyTorch stand-ins for the two CUDA kernels, with their contracts:
    flat memory, the channel from the element's index; the backward kernel
    ``res = (a + b[channel]) * scale * (out >= 0 ? 1 : slope)`` from the
    saved output alone (``a``, ``b`` may be absent), and where asked its
    sum over all but the channel axis, as the kernel takes it: each of
    ``splits`` blocks sums a contiguous share of a channel's elements into
    ``partial``, then the partials are summed in split order. Returns the
    list of launches."""
    launched = []
    tensors = {}

    def _flat(t):
        """The tensor's memory, in memory order."""
        return torch.as_strided(t, (t.numel(),), (1,))

    def _channel(total, inner, channels):
        return (torch.arange(total) // inner) % channels

    class _Forward:
        def __call__(self, x_ptr, bias_ptr, out_ptr, total, inner, channels,
                     slope, scale, stream):
            launched.append('fwd')
            x, bias, out = (tensors.get(p) for p in (x_ptr, bias_ptr,
                                                     out_ptr))
            flat = _flat(x)
            if bias is not None:
                flat = flat + bias[_channel(total, inner, channels)]
            _flat(out).copy_(torch.where(flat >= 0, flat, flat * slope)
                             * scale)

    class _Backward:
        def __init__(self, name):
            self.name = name

        def __call__(self, a_ptr, b_ptr, out_ptr, res_ptr, partial_ptr,
                     sum_ptr, total, inner, channels, splits, slope, scale,
                     stream):
            launched.append(self.name)
            a, b, out, res, partial, grad_bias = (
                tensors.get(p) for p in (a_ptr, b_ptr, out_ptr, res_ptr,
                                         partial_ptr, sum_ptr))
            assert res.stride() == out.stride()
            assert splits == fused_act.splits(total, inner, channels)
            ch = _channel(total, inner, channels)
            g = torch.zeros(total) if a is None else _flat(a).clone()
            if a is not None:
                assert a.stride() == out.stride()
            if b is not None:
                assert b.shape == (channels,)
                g = g + b[ch]
            g = g * scale
            r = torch.where(_flat(out) >= 0, g, g * slope)
            _flat(res).copy_(r)
            if grad_bias is None:
                return
            assert (partial is None) == (splits == 1)
            for c in range(channels):
                mine = r[ch == c]
                share = -(-mine.numel() // splits)
                parts = [mine[s * share:(s + 1) * share].sum()
                         for s in range(splits)]
                total_c = parts[0]
                for s in range(1, splits):
                    partial[s, c] = parts[s]
                    total_c = total_c + parts[s]
                grad_bias[c] = total_c

    real_data_ptr = torch.Tensor.data_ptr

    def data_ptr(t):
        ptr = real_data_ptr(t)
        tensors[ptr] = t
        return ptr

    monkeypatch.setattr(torch.Tensor, 'data_ptr', data_ptr)
    monkeypatch.setattr(fused_act, 'launch',
                        lambda kernel, device, *args: kernel(*args, 0))
    monkeypatch.setattr(fused_act, '_check_cuda', lambda *a: None)
    monkeypatch.setattr(fused_act, 'fused_leaky_relu_fwd_kernel', _Forward())
    monkeypatch.setattr(fused_act, 'fused_leaky_relu_bwd_kernel',
                        _Backward('bwd'))
    monkeypatch.setattr(fused_act, 'fused_leaky_relu_bwd2_kernel',
                        _Backward('bwd2'))
    return launched


def _sums_from(module, monkeypatch):
    """Record every ``torch.sum`` / ``Tensor.sum`` called from ``module``'s
    own code; returns the list it fills."""
    calls = []
    real_sum, real_method = torch.sum, torch.Tensor.sum

    def recorded(real):
        def fn(*args, **kwargs):
            if sys._getframe(1).f_code.co_filename == module.__file__:
                calls.append(args[0].shape)
            return real(*args, **kwargs)
        return fn

    monkeypatch.setattr(torch, 'sum', recorded(real_sum))
    monkeypatch.setattr(torch.Tensor, 'sum', recorded(real_method))
    return calls


def _case_inputs(case):
    if case == 'planted_zeros':
        return _planted()
    return _inputs(SHAPES['2d' if case == '2d' else '4d'], case != 'no_bias',
                   seed=3)


def _through_function(case):
    def fn(xt, *bias_t):
        if case == 'channels_last':
            xt = xt.contiguous(memory_format=torch.channels_last)
        elif case == 'strided':
            xt = xt.transpose(2, 3).contiguous().transpose(2, 3)
        return fused_act._FusedLeakyReLU.apply(
            xt, bias_t[0] if bias_t else None, 0.2, float(SCALE))
    return fn


@pytest.mark.parametrize('case', ['4d', '2d', 'channels_last', 'no_bias',
                                  'strided', 'planted_zeros'])
def test_functions_around_the_kernels_match_jax(monkeypatch, case):
    """The Functions the CUDA path uses, with stand-ins for the kernels:
    the channel index for NCHW, channels-last and 2-D memory, a
    non-contiguous input, the backward from the saved output, grad bias
    from the backward kernel (no ``torch.sum``), and the double backward
    with gg_x and gg_bias in one launch, against JAX."""
    launched = _stand_in_kernels(monkeypatch)
    sums = _sums_from(fused_act, monkeypatch)
    x, bias, cot = _case_inputs(case)
    want = _jax_orders(x, bias, cot)
    got = _torch_orders(_through_function(case), x, bias, cot)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)
    assert launched == ['fwd', 'bwd', 'bwd2']
    assert sums == []


@pytest.mark.parametrize('case', ['4d', 'channels_last', '2d'])
def test_grad_bias_over_several_splits_matches_jax(monkeypatch, case):
    """With a channel's elements shared by several blocks (the split rule
    made small), grad bias is the partials' sum in split order, and the
    orders still agree with JAX."""
    monkeypatch.setattr(fused_act, 'SPLIT_ELEMENTS', 8)
    monkeypatch.setattr(fused_act, 'SPLIT_ROWS', 8)
    monkeypatch.setattr(fused_act, 'SPLIT_BLOCKS', 64)
    x, bias, cot = _inputs((6, 3, 4, 8) if case != '2d' else (200, 5), True,
                           seed=4)
    numel = x.size
    inner = 1 if case != '4d' else x.shape[1] * x.shape[2]
    assert fused_act.splits(numel, inner, bias.shape[0]) > 1
    launched = _stand_in_kernels(monkeypatch)
    want = _jax_orders(x, bias, cot)
    got = _torch_orders(_through_function(case), x, bias, cot)
    for g, w in zip(got, want):
        _close(g, w)
    assert launched == ['fwd', 'bwd', 'bwd2']


def test_backward_without_a_graph_launches_the_kernel_itself(monkeypatch):
    """Where no graph of the backward is built (``create_graph=False``),
    the backward launches the kernel without another Function; a third
    order goes through the backward kernel again and counts with the
    double backward's entry point."""
    launched = _stand_in_kernels(monkeypatch)
    x, bias, cot = _case_inputs('4d')
    xt = _to_torch(x).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    ct = _to_torch(cot)
    with monkeypatch.context() as m:
        m.setattr(fused_act._FusedLeakyReLUBackward, 'apply', None)
        m.setattr(fused_act._FusedLeakyReLUDoubleBackward, 'apply', None)
        out = fused_act._FusedLeakyReLU.apply(xt, bt, 0.2, float(SCALE))
        gx, gb = torch.autograd.grad(out, (xt, bt), ct)
    xr = xt.detach().requires_grad_()
    br = bt.detach().requires_grad_()
    wx, wb = torch.autograd.grad(fused_leaky_relu_ref(xr, br), (xr, br), ct)
    _close(gx.numpy(), wx.numpy())
    _close(gb.numpy(), wb.numpy())
    assert launched == ['fwd', 'bwd']

    # third order: d/d(cot) of sum(d/d(cot) of sum(grad_x ** 2) * w)
    def third(fn, xin, bin_):
        cotg = ct.clone().requires_grad_()
        gx, gb = torch.autograd.grad(fn(xin, bin_), (xin, bin_), cotg,
                                     create_graph=True)
        second, = torch.autograd.grad((gx ** 2).sum() + (gb ** 2).sum(),
                                      cotg, create_graph=True)
        w = torch.linspace(-1, 1, second.numel()).reshape(second.shape)
        return torch.autograd.grad((second * w).sum(), cotg)[0]

    launched.clear()
    got = third(lambda a, b: fused_act._FusedLeakyReLU.apply(
        a, b, 0.2, float(SCALE)), xt, bt)
    want = third(fused_leaky_relu_ref, xr, br)
    _close(got.numpy(), want.numpy())
    # the forward, the backward (order 1) and the double backward (2) with
    # graphs; then the third order's pass: the double backward's backward
    # (the backward kernel, order 3) and the backward's backward (2)
    assert launched == ['fwd', 'bwd', 'bwd2', 'bwd2', 'bwd2']


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match=r'\(N, C, ...\)'):
        fused_leaky_relu(torch.zeros(4))
    with pytest.raises(ValueError, match='bias shape'):
        fused_leaky_relu(torch.zeros((2, 4, 3, 3)), torch.zeros(3))
