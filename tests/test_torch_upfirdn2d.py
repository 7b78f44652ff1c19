"""``mrefsr_tpu_torch.ops.upfirdn2d`` against ``mrefsr_tpu.ops.upfirdn2d``
on the CPU: the same numpy inputs go through the JAX op (NHWC) and the
port's plain version (NCHW), forward, gradient and second-order gradient.
The CUDA kernel cannot run here; its arithmetic (the gather) and the
``autograd.Function`` around it (which op is the gradient of which) are
held against the plain version through stand-ins written in PyTorch."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.ops import upfirdn2d as jax_upfirdn2d
from mrefsr_tpu_torch.ops import upfirdn2d, upfirdn2d_ref

# the package exports the function under its module's name
ops_upfirdn2d = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')

FIR4 = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64
# (case, FIR, (N, H, W, C), up, down, pad): the three modes of the StyleGAN2
# path (at the odd 2H + 1 size the transposed conv leaves), a stride, a
# negative pad, a non-square map with a non-square filter
CASES = {
    'smooth_after_up_conv': (FIR4 * 4, (2, 9, 9, 3), 1, 1, (1, 1)),
    'smooth_before_3x3_down_conv': (FIR4, (2, 8, 8, 3), 1, 1, (2, 2)),
    'smooth_before_1x1_down_conv': (FIR4, (2, 8, 8, 3), 1, 1, (1, 1)),
    'upsample_skip': (FIR4 * 4, (2, 5, 5, 3), 2, 1, (2, 1)),
    'downsample': (FIR4, (1, 9, 7, 2), 1, 2, (1, 1)),
    'negative_pad': (FIR4, (1, 9, 11, 2), 1, 1, (-1, 2)),
    'up3_down2_crop': (np.random.RandomState(5).randn(3, 5).astype(
        np.float32), (2, 7, 6, 2), 3, 2, (2, -1)),
}


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tensors here are tiny, and the test workers of one run share
    the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want):
    """atol 1e-5 x max |want|: both sum at most 16 f32 products per sample,
    in another order."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _jax_orders(fir, x, cot, up, down, pad):
    """JAX's output, its gradient for the cotangent, and the gradient of
    ``sum(gradient ** 2)`` in the cotangent (the op is linear in ``x``, so
    the second order lives in the cotangent)."""
    fir = jnp.asarray(fir)

    def grad_x(cot):
        return jax.grad(lambda x: jnp.sum(
            jax_upfirdn2d(x, fir, up, down, pad) * cot))(jnp.asarray(x))

    out = jax_upfirdn2d(jnp.asarray(x), fir, up, down, pad)
    second = jax.grad(lambda c: jnp.sum(grad_x(c) ** 2))(jnp.asarray(cot))
    return [np.asarray(v) for v in (out, grad_x(jnp.asarray(cot)), second)]


def _torch_orders(fn, fir, x, cot, up, down, pad):
    x = _nchw(x).requires_grad_()
    cot = _nchw(cot).requires_grad_()
    out = fn(x, torch.from_numpy(fir), up, down, pad)
    grad, = torch.autograd.grad(out, x, cot, create_graph=True)
    second, = torch.autograd.grad((grad ** 2).sum(), cot)
    return [_nhwc(v) for v in (out, grad, second)]


def _inputs(name):
    fir, shape, up, down, pad = CASES[name]
    rng = np.random.RandomState(len(name))
    x = rng.randn(*shape).astype(np.float32)
    out_shape = jax.eval_shape(
        lambda x: jax_upfirdn2d(x, jnp.asarray(fir), up, down, pad),
        jax.ShapeDtypeStruct(shape, jnp.float32)).shape
    cot = rng.randn(*out_shape).astype(np.float32)
    return fir, x, cot, up, down, pad


@pytest.mark.parametrize('name', sorted(CASES))
def test_plain_version_matches_jax_to_second_order(name):
    args = _inputs(name)
    want = _jax_orders(*args)
    got = _torch_orders(upfirdn2d, *args)       # CPU tensors: the plain path
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)
    assert np.abs(want[2]).max() > 0


def _gather(x, fir, up, down, pads, order):
    """The CUDA kernel's loop, written out in PyTorch: per output sample,
    the taps that fall on a real input sample, no zero-stuffed or padded
    map. Same contract as ``_upfirdn2d_cuda``."""
    n, c, h, w = x.shape
    kh, kw = fir.shape
    y0, y1, x0, x1 = pads
    out_h = (h * up + y0 + y1 - kh) // down + 1
    out_w = (w * up + x0 + x1 - kw) // down + 1
    out = x.new_zeros((n, c, out_h, out_w))
    oy = torch.arange(out_h) * down - y0
    ox = torch.arange(out_w) * down - x0
    for ky in range(kh):
        uy = oy + ky
        ok_y = (uy >= 0) & (uy < h * up) & (uy % up == 0)
        iy = torch.div(uy, up, rounding_mode='floor').clamp(0, h - 1)
        for kx in range(kw):
            ux = ox + kx
            ok_x = (ux >= 0) & (ux < w * up) & (ux % up == 0)
            ix = torch.div(ux, up, rounding_mode='floor').clamp(0, w - 1)
            tap = fir[kh - 1 - ky, kw - 1 - kx].to(x.dtype)
            hit = (ok_y[:, None] & ok_x[None, :]).to(x.dtype)
            out = out + tap * hit * x[:, :, iy][:, :, :, ix]
    return out


@pytest.mark.parametrize('name', sorted(CASES))
def test_the_kernels_gather_matches_the_plain_version(name):
    fir, x, _, up, down, pad = _inputs(name)
    x = _nchw(x)
    want = upfirdn2d_ref(x, torch.from_numpy(fir), up, down, pad)
    got = _gather(x, torch.from_numpy(fir), up, down,
                  ops_upfirdn2d._pads4(pad), 0)
    assert got.shape == want.shape
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize('name', sorted(CASES))
def test_function_backward_is_the_transposed_op(monkeypatch, name):
    """The Function the CUDA path uses, with the gather standing in for
    the kernel: its backward (the same op with up and down swapped, the
    FIR flipped and the transposed pads) and its double backward agree
    with JAX's autodiff, and the three orders reach the three entry
    points."""
    orders = []

    def stand_in(x, fir, up, down, pads, order):
        orders.append(order)
        return _gather(x, fir, up, down, pads, order)

    monkeypatch.setattr(ops_upfirdn2d, '_upfirdn2d_cuda', stand_in)

    def through_function(x, fir, up, down, pad):
        return ops_upfirdn2d._UpFirDn2d.apply(
            x, fir, up, down, ops_upfirdn2d._pads4(pad), 0)

    args = _inputs(name)
    got = _torch_orders(through_function, *args)
    for g, w in zip(got, _jax_orders(*args)):
        assert g.shape == w.shape
        _close(g, w)
    assert orders == [0, 1, 2]


def test_transposed_pads_give_back_the_input_size():
    for name in sorted(CASES):
        fir, shape, up, down, pad = CASES[name]
        pads = ops_upfirdn2d._pads4(pad)
        hw = shape[1:3]
        out_hw = [ops_upfirdn2d._out_size(s, k, up, down, p0, p1)
                  for s, k, p0, p1 in zip(hw, fir.shape, pads[::2],
                                          pads[1::2])]
        t_fir, t_up, t_down, t_pads = ops_upfirdn2d._transposed(
            hw, out_hw, torch.from_numpy(fir), up, down, pads)
        assert (t_up, t_down) == (down, up)
        back = [ops_upfirdn2d._out_size(s, k, t_up, t_down, p0, p1)
                for s, k, p0, p1 in zip(out_hw, fir.shape, t_pads[::2],
                                        t_pads[1::2])]
        assert back == list(hw), name
        np.testing.assert_array_equal(t_fir.numpy(), fir[::-1, ::-1])


def test_resampling_helpers_match_jax():
    """``_smooth``, ``upfirdn_upsample`` and ``upfirdn_downsample`` pick
    the same pads and gains as the JAX package's."""
    from mrefsr_tpu.archs import stylegan2_arch as jax_arch
    from mrefsr_tpu_torch.archs import stylegan2_arch as arch
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 9, 3).astype(np.float32)
    k_jax = jax_arch.make_resample_kernel((1, 3, 3, 1))
    k = arch.make_resample_kernel((1, 3, 3, 1))
    np.testing.assert_allclose(k.numpy(), np.asarray(k_jax), rtol=1e-7)
    for call in (lambda m, k, x: m._smooth(x, k, 2, 1, 3),
                 lambda m, k, x: m._smooth(x, k, 1, 2, 3),
                 lambda m, k, x: m._smooth(x, k, 1, 2, 1),
                 lambda m, k, x: m.upfirdn_upsample(x, k),
                 lambda m, k, x: m.upfirdn_downsample(x, k)):
        want = np.asarray(call(jax_arch, k_jax, jnp.asarray(x)))
        got = _nhwc(call(arch, k, _nchw(x)))
        assert got.shape == want.shape
        _close(got, want)


def test_bad_arguments_raise():
    x = torch.zeros((1, 2, 4, 4))
    fir = torch.ones((4, 4))
    with pytest.raises(ValueError, match=r'\(N, C, H, W\)'):
        upfirdn2d(x[0], fir)
    with pytest.raises(ValueError, match=r'\(kh, kw\)'):
        upfirdn2d(x, fir[0])
    with pytest.raises(ValueError, match='no output'):
        upfirdn2d(x, fir, pad=(-1, -1))
    with pytest.raises(ValueError, match='pad must be'):
        upfirdn2d(x, fir, pad=(1, 1, 1))
    with pytest.raises(ValueError, match='>= 1'):
        upfirdn2d(x, fir, up=0)
    assert upfirdn2d(x, fir, pad=(2, 1, 0, 3)).shape == (1, 2, 4, 4)
