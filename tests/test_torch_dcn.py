"""The port's modulated deformable conv (``mrefsr_tpu_torch.ops.dcn``)
against the JAX package's, forward and gradients, on the CPU, where the
port runs the plain version of its CUDA kernels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.ops import dcn as jax_dcn
from mrefsr_tpu_torch.ops import dcn


def _case(seed, n, h, w, c, cout, dg, k=3, stride=1, padding=1,
          dilation=1, spread=1.5):
    rng = np.random.RandomState(seed)
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    x = rng.randn(n, h, w, c).astype(np.float32)
    offset = (rng.randn(n, ho, wo, dg, k * k, 2) * spread).astype(np.float32)
    mask = rng.rand(n, ho, wo, dg, k * k).astype(np.float32)
    weight = (rng.randn(k, k, c, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, offset, mask, weight, bias


def _both(x, offset, mask, weight, bias, **kw):
    want = jax_dcn.modulated_deform_conv2d(
        *(jnp.asarray(a) for a in (x, offset, mask, weight)),
        None if bias is None else jnp.asarray(bias), **kw)
    got = dcn.modulated_deform_conv2d(
        *(torch.from_numpy(a) for a in (x, offset, mask, weight)),
        None if bias is None else torch.from_numpy(bias), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize('dg', [1, 8])
@pytest.mark.parametrize('spread', [0.7, 4.0, 40.0])
def test_mdcn_matches_jax(dg, spread):
    """Fractional and negative offsets (spread 0.7), many samples leaving
    the image (4.0), and far out of range (40.0)."""
    x, offset, mask, weight, bias = _case(0, 2, 7, 9, 16, 12, dg,
                                          spread=spread)
    got, want = _both(x, offset, mask, weight, bias, deform_groups=dg)
    assert got.shape == (2, 7, 9, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('stride,padding,dilation', [(2, 1, 1), (1, 2, 2),
                                                     (1, 0, 1)])
def test_mdcn_geometry_matches_jax(stride, padding, dilation):
    x, offset, mask, weight, bias = _case(1, 1, 8, 6, 8, 5, 2,
                                          stride=stride, padding=padding,
                                          dilation=dilation)
    got, want = _both(x, offset, mask, weight, None, stride=stride,
                      padding=padding, dilation=dilation, deform_groups=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_mdcn_corners_on_the_border():
    """Sampling positions exactly at -1 and at H (W): one bilinear corner
    inside, weight 0 or 1, the rest outside."""
    n, h, w, c, dg = 1, 5, 6, 8, 2
    x, offset, mask, weight, bias = _case(2, n, h, w, c, 4, dg)
    oy = np.arange(h)[:, None, None, None] - 1 \
        + (np.arange(9) // 3)[None, None, None, :]
    ox = np.arange(w)[None, :, None, None] - 1 \
        + (np.arange(9) % 3)[None, None, None, :]
    targets = [(-1.0, -1.0), (float(h), float(w)), (-1.0, w - 1.0),
               (h - 1.0, -1.0), (-0.5, w - 0.5)]
    for ty, tx in targets:
        offset[0, ..., 0] = ty - oy
        offset[0, ..., 1] = tx - ox
        got, want = _both(x, offset, mask, weight, bias, deform_groups=dg)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # at exactly (-1, -1) and (H, W) nothing is inside: bias alone
    offset[0, ..., 0] = -1.0 - oy
    offset[0, ..., 1] = -1.0 - ox
    got, _ = _both(x, offset, mask, weight, bias, deform_groups=dg)
    np.testing.assert_allclose(got, np.broadcast_to(bias, got.shape),
                               rtol=0, atol=1e-6)


def test_mdcn_chunked_rows_match_one_chunk(monkeypatch):
    """Row chunks (the column scratch cap) do not change the result."""
    x, offset, mask, weight, bias = _case(3, 2, 6, 5, 8, 4, 2)
    args = [torch.from_numpy(a) for a in (x, offset, mask, weight, bias)]
    whole = dcn.modulated_deform_conv2d(*args, deform_groups=2)
    monkeypatch.setattr(dcn, 'COL_CAP_BYTES', 7 * 9 * 8 * 4)
    chunked = dcn.modulated_deform_conv2d(*args, deform_groups=2)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)


def test_mdcn_groups_raise():
    x, offset, mask, weight, bias = _case(4, 1, 4, 4, 8, 8, 2)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        dcn.modulated_deform_conv2d(
            torch.from_numpy(x), torch.from_numpy(offset),
            torch.from_numpy(mask), torch.from_numpy(weight[:, :, :4]),
            groups=2, deform_groups=2)


def test_offset_mask_from_conv_out_matches_jax():
    """Numbered channels show the (o1 | o2) -> interleaved (dy, dx) and
    the mask third landing where the JAX package puts them."""
    dg, k = 8, 9
    out = np.broadcast_to(np.arange(3 * dg * k, dtype=np.float32),
                          (2, 3, 4, 3 * dg * k)).copy()
    out += np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4, 1) * 1000
    off, mask = dcn.offset_mask_from_conv_out(torch.from_numpy(out), dg)
    off_j, mask_j = jax_dcn.offset_mask_from_conv_out(jnp.asarray(out), dg)
    np.testing.assert_array_equal(off.numpy(), np.asarray(off_j))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    assert off.shape == (2, 3, 4, dg, k, 2)
    assert off[0, 0, 0, 1, 2].tolist() == [2 * k + 4, 2 * k + 5]


def _grads_both(x, offset, mask, weight, bias, cot, **kw):
    """Gradients of ``sum(out * cot)`` in (x, offset, mask, weight, bias)
    from ``jax.grad`` and from the port's autograd."""
    def loss(*args):
        return (jax_dcn.modulated_deform_conv2d(*args, **kw)
                * jnp.asarray(cot)).sum()
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, offset, mask, weight, bias)))
    args = [torch.from_numpy(a).requires_grad_() for a in
            (x, offset, mask, weight, bias)]
    (dcn.modulated_deform_conv2d(*args, **kw)
     * torch.from_numpy(cot)).sum().backward()
    return [a.grad.numpy() for a in args], [np.asarray(g) for g in want]


def _assert_grads_close(got, want):
    """Each gradient within 1e-5 of its own largest entry (f32 sums in
    another order); a gradient that is all zero must be exactly so."""
    for name, g, w in zip(('x', 'offset', 'mask', 'weight', 'bias'), got,
                          want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize('spread', [0.7, 4.0])
def test_mdcn_gradients_match_jax(spread):
    x, offset, mask, weight, bias = _case(5, 2, 7, 9, 16, 12, 4,
                                          spread=spread)
    cot = np.random.RandomState(6).randn(2, 7, 9, 12).astype(np.float32)
    got, want = _grads_both(x, offset, mask, weight, bias, cot,
                            deform_groups=4)
    assert all(np.abs(w).max() > 0 for w in want)
    _assert_grads_close(got, want)


def test_mdcn_gradients_at_integer_offsets_match_jax():
    """Integer offsets, as a fresh net has them: every sample sits on a
    pixel (wy1 = 0) and the gradient in the offset is the one-sided
    difference towards the next pixel, not a symmetric one and not zero."""
    x, offset, mask, weight, bias = _case(7, 1, 6, 6, 8, 4, 2)
    offset = np.round(offset)
    cot = np.random.RandomState(8).randn(1, 6, 6, 4).astype(np.float32)
    got, want = _grads_both(x, offset, mask, weight, bias, cot,
                            deform_groups=2)
    _assert_grads_close(got, want)
    # by hand for one sample well inside the image: tap 4 of pixel (2, 2)
    # with a zero offset reads x[2, 2]; d/dfy is x[3, 2] - x[2, 2]
    offset[:] = 0
    args = [torch.from_numpy(a) for a in (x, offset, mask, weight, bias)]
    args[1].requires_grad_()
    (dcn.modulated_deform_conv2d(*args, deform_groups=2)
     * torch.from_numpy(cot)).sum().backward()
    w2d = weight.reshape(9, 8, 4)
    g_col = (cot[0, 2, 2] * w2d[4]).sum(-1)              # (C,)
    want_fy = (g_col[:4] * (x[0, 3, 2, :4] - x[0, 2, 2, :4])).sum() \
        * mask[0, 2, 2, 0, 4]
    np.testing.assert_allclose(args[1].grad[0, 2, 2, 0, 4, 0].item(),
                               want_fy, rtol=1e-4)


def test_mdcn_gradients_on_the_border_match_jax():
    """Samples at exactly -1 and H - 1 (W - 1): one corner row (column)
    outside the image."""
    n, h, w, c, dg = 1, 5, 6, 8, 2
    x, offset, mask, weight, bias = _case(9, n, h, w, c, 4, dg)
    oy = np.arange(h)[:, None, None, None] - 1 \
        + (np.arange(9) // 3)[None, None, None, :]
    ox = np.arange(w)[None, :, None, None] - 1 \
        + (np.arange(9) % 3)[None, None, None, :]
    cot = np.random.RandomState(10).randn(n, h, w, 4).astype(np.float32)
    for ty, tx in [(-1.0, 2.0), (h - 1.0, 2.5), (1.5, -1.0),
                   (2.0, w - 1.0), (-1.0, w - 1.0)]:
        offset[0, ..., 0] = ty - oy
        offset[0, ..., 1] = tx - ox
        got, want = _grads_both(x, offset, mask, weight, bias, cot,
                                deform_groups=dg)
        _assert_grads_close(got, want)
