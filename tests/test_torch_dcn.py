"""The port's deformable convs (``mrefsr_tpu_torch.ops.dcn``: DCNv2 with
conv groups 1 and > 1, DCNv1) against the JAX package's, forward and
gradients, on the CPU, where the port runs the plain version of its CUDA
kernels; and the ``autograd.Function`` of the CUDA path with PyTorch
stand-ins for the kernels' C entry points.

Tolerances: outputs atol 1e-5 (values about 1, sums of at most 9 * 16
products in another order); each gradient within 1e-5 of its own largest
entry."""
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
    """Conv groups must divide C and Cout, and the weight take C / groups
    input channels."""
    x, offset, mask, weight, bias = _case(4, 1, 4, 4, 8, 8, 2)
    args = [torch.from_numpy(a) for a in (x, offset, mask)]
    for w, groups, dg in ((weight[:, :, :4], 3, 2),     # 3 does not divide 8
                          (weight, 2, 2),               # weight takes 8, not 4
                          (weight[:, :, :2, :6], 4, 2)):  # 4 does not divide 6
        with pytest.raises(ValueError, match='divide'):
            dcn.modulated_deform_conv2d(*args, torch.from_numpy(w),
                                        groups=groups, deform_groups=dg)


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


# ------------------------------------ conv groups > 1 (K3) and DCNv1 (K5)
def _grouped(seed, groups, dg, padding=1, n=2, h=7, w=9, c=16, cout=12,
             spread=1.5):
    """Inputs with a ``(3, 3, C / groups, Cout)`` weight."""
    x, offset, mask, weight, bias = _case(seed, n, h, w, c, cout, dg,
                                          padding=padding, spread=spread)
    weight = (np.random.RandomState(seed + 100).randn(3, 3, c // groups, cout)
              * 0.1).astype(np.float32)
    return x, offset, mask, weight, bias


@pytest.mark.parametrize('groups,dg', [(2, 2), (2, 1), (4, 8), (4, 4)])
def test_mdcn_groups_match_jax(groups, dg):
    """Conv groups 2 and 4 with deform groups inside one conv group, across
    two (dg 1) and finer than them: forward and ``jax.grad`` of every
    input."""
    x, offset, mask, weight, bias = _grouped(11, groups, dg)
    kw = dict(groups=groups, deform_groups=dg)
    got, want = _both(x, offset, mask, weight, bias, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    cot = np.random.RandomState(12).randn(*want.shape).astype(np.float32)
    got, want = _grads_both(x, offset, mask, weight, bias, cot, **kw)
    assert all(np.abs(w).max() > 0 for w in want)
    _assert_grads_close(got, want)


def test_mdcn_groups_chunked_rows_match_one_chunk(monkeypatch):
    """Row chunks of the group-major columns do not change the result."""
    x, offset, mask, weight, bias = _grouped(13, 2, 2, n=2, h=6, w=5, c=8,
                                             cout=4)
    args = [torch.from_numpy(a) for a in (x, offset, mask, weight, bias)]
    whole = dcn.modulated_deform_conv2d(*args, groups=2, deform_groups=2)
    monkeypatch.setattr(dcn, 'COL_CAP_BYTES', 7 * 9 * 8 * 4)
    chunked = dcn.modulated_deform_conv2d(*args, groups=2, deform_groups=2)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)


def _v1_both(x, offset, weight, cot, **kw):
    """DCNv1's output and gradients in (x, offset, weight), JAX and port."""
    def loss(*args):
        return (jax_dcn.deform_conv2d(*args, **kw) * jnp.asarray(cot)).sum()
    jargs = [jnp.asarray(a) for a in (x, offset, weight)]
    want = [np.asarray(jax_dcn.deform_conv2d(*jargs, **kw)),
            *(np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
                *jargs))]
    args = [torch.from_numpy(a).requires_grad_() for a in (x, offset, weight)]
    out = dcn.deform_conv2d(*args, **kw)
    (out * torch.from_numpy(cot)).sum().backward()
    return [out.detach().numpy(), *(a.grad.numpy() for a in args)], want


@pytest.mark.parametrize('groups,dg', [(1, 2), (2, 2), (4, 1)])
def test_deform_conv2d_matches_jax(groups, dg):
    """DCNv1 at its default padding 0 (a 3x3 conv shrinks 7x9 to 5x7):
    forward and ``jax.grad`` of x, offset and weight."""
    x, offset, _, weight, _ = _grouped(14, groups, dg, padding=0)
    assert offset.shape[1:3] == (5, 7)
    cot = np.random.RandomState(15).randn(2, 5, 7, 12).astype(np.float32)
    got, want = _v1_both(x, offset, weight, cot, groups=groups,
                         deform_groups=dg)
    assert got[0].shape == (2, 5, 7, 12)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for name, g, w in zip(('x', 'offset', 'weight'), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_deform_conv2d_is_the_modulated_conv_with_a_ones_mask():
    """The plain version of DCNv1 is the modulated conv with mask 1 and no
    bias, bit for bit, at any padding."""
    x, offset, mask, weight, _ = _grouped(16, 2, 2, padding=1)
    t = [torch.from_numpy(a) for a in (x, offset, weight)]
    ones = torch.ones(mask.shape)
    want = dcn.modulated_deform_conv2d(t[0], t[1], ones, t[2], groups=2,
                                       deform_groups=2)
    for fn in (dcn.deform_conv2d, dcn.deform_conv2d_ref):
        got = fn(*t, padding=1, groups=2, deform_groups=2)
        assert torch.equal(got, want)


# the C entry points of mdcn.cu and mdcn_bf16.cu, by the Kernel objects
# that launch them
_ENTRY = {'mdcn_im2col_kernel': ('im2col', True),
          'mdcn_im2col_groups_kernel': ('im2col', True),
          'deform_im2col_kernel': ('im2col', False),
          'mdcn_col2im_kernel': ('col2im', True),
          'mdcn_col2im_scatter_kernel': ('col2im', True),
          'mdcn_col2im_groups_kernel': ('col2im', True),
          'mdcn_col2im_groups_scatter_kernel': ('col2im', True),
          'deform_col2im_kernel': ('col2im', False),
          'deform_col2im_scatter_kernel': ('col2im', False),
          'mdcn_fused_fwd_bf16_kernel': ('fused_fwd', True),
          'mdcn_fused_dgrad_bf16_kernel': ('fused_dgrad', True),
          'mdcn_fused_dgrad_scatter_bf16_kernel': ('fused_dgrad', True),
          'mdcn_fused_wgrad_bf16_kernel': ('fused_wgrad', True),
          'mdcn_fused_wgrad_sum_bf16_kernel': ('fused_wgrad_sum', True)}


def _sample_grads(grad_col, x, offset, mask, row0, rows, geom, groups=1):
    """The col2im arithmetic, by autograd through the plain im2col: the
    gradients of x, the offset and (with a mask) the mask of the columns
    of rows ``[row0, row0 + rows)`` under the cotangent ``grad_col``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in
               (x, offset) + (() if mask is None else (mask,))]
        col = dcn._im2col_ref(*ins[:2], None if mask is None else ins[2],
                              row0, rows, geom, groups)
        return torch.autograd.grad(col, ins, grad_col.reshape(col.shape))


def fused_dgrad_math(go, x, offset, mask, weight, geom, round_col=True):
    """The contract of ``mdcn_fused_dgrad``: the grad columns ``go . W^T``
    summed in f32 and rounded to bf16, then the col2im arithmetic in f32.
    Returns grad x, grad offset, grad mask. With ``round_col`` False the
    grad columns stay f32 (the columns of a widened x and mask, whose
    cotangent is not rounded), and grad x and grad mask are rounded
    once at the end."""
    rows, cout = go.shape
    grad_col = go.float() @ weight.reshape(-1, cout).float().t()
    if round_col:
        return _sample_grads(grad_col.to(x.dtype), x, offset, mask, 0, rows,
                             geom)
    gx, goff, gmask = _sample_grads(grad_col, x.float(), offset,
                                    mask.float(), 0, rows, geom)
    return gx.to(x.dtype), goff, gmask.to(mask.dtype)


def fused_patch_of_rows(n, ho, wo):
    """The 8 x 8 output patch of each row of the flattened (N, Ho, Wo), as
    ``mdcn_bf16.cu`` numbers them: item-major, then row-major over the
    map."""
    tiles_x, tiles_y = -(-wo // 8), -(-ho // 8)
    oy = torch.arange(ho)[:, None] // 8
    ox = torch.arange(wo)[None, :] // 8
    per_item = (oy * tiles_x + ox).reshape(-1)
    return (torch.arange(n)[:, None] * tiles_x * tiles_y
            + per_item[None, :]).reshape(-1)


def _fused_geom(args):
    """The fused entry points' trailing ints: rows, h, w, c, cout, ho, wo,
    kh, kw, sh, sw, ph, pw, dh, dw, dg, then the stream."""
    (rows, h, w, c, cout, ho, wo, kh, kw, sh, sw, ph, pw, dh, dw,
     _dg, _stream) = args
    return rows, cout, ((kh, kw), (sh, sw), (ph, pw), (dh, dw), (ho, wo))


def _stand_in_kernels(monkeypatch):
    """PyTorch stand-ins for the C entry points of ``csrc/mdcn.cu`` and
    ``csrc/mdcn_bf16.cu``, with their contracts: pointers in, the geometry
    as ints. mdcn.cu: columns group-major; the backward writes its rows of
    grad offset (and grad mask) and adds into grad x, by autograd through
    the plain im2col. mdcn_bf16.cu: the forward rounds the columns once,
    sums their product with the weight in f32, rounds, adds the bias and
    rounds; dgrad writes grad offset and grad mask by
    :func:`fused_dgrad_math` (and adds grad x in its scatter variant);
    wgrad writes the f32 partials of grad weight and, in the row after,
    grad bias of each slice of 8 x 8 output patches; the sum adds the
    slices in order. Returns the names of the entry points launched."""
    launched = []
    tensors = {}
    real_data_ptr = torch.Tensor.data_ptr

    def data_ptr(t):
        ptr = real_data_ptr(t)
        tensors[ptr] = t
        return ptr

    def fused_fwd(x, offset, mask, wt, bias, out, *rest):
        rows, cout, geom = _fused_geom(rest)
        col = dcn._im2col_ref(x, offset, mask, 0, rows, geom)
        y = (col.reshape(rows, -1).float() @ wt.float().t()).to(x.dtype)
        out.view(rows, cout).copy_(y if bias is None else y + bias)

    def fused_dgrad(go, x, offset, mask, weight, grad_offset, grad_mask,
                    *rest):
        grad_x = rest[0] if len(rest) == 18 else None
        _, _, geom = _fused_geom(rest[-17:])
        gx, goff, gmask = fused_dgrad_math(go, x, offset, mask, weight, geom)
        grad_offset.copy_(goff)
        grad_mask.copy_(gmask)
        if grad_x is not None:
            grad_x.add_(gx)

    def fused_wgrad(go, x, offset, mask, partial, splits, split_patches,
                    *rest):
        rows, _, geom = _fused_geom(rest)
        col = dcn._im2col_ref(x, offset, mask, 0, rows, geom)
        col = col.reshape(rows, -1).float()
        patch = fused_patch_of_rows(x.shape[0], *geom[4])
        for s in range(splits):
            sel = (patch >= s * split_patches) \
                & (patch < (s + 1) * split_patches)
            partial[s, :-1] = col[sel].t() @ go[sel].float()
            partial[s, -1] = go[sel].float().sum(0)

    def fused_wgrad_sum(partial, grad_w, splits, n, _stream):
        total = partial[0].clone()
        for s in range(1, splits):
            total += partial[s]
        grad_w.view(-1).copy_(total.view(-1)[:n])

    # each fused entry point with its number of pointer arguments
    fused = {'fused_fwd': (fused_fwd, 6), 'fused_dgrad': (fused_dgrad, 7),
             'fused_wgrad': (fused_wgrad, 5),
             'fused_wgrad_sum': (fused_wgrad_sum, 2)}

    def entry(name, kind, masked):
        scatter = 'scatter' in name

        def launch(*args):
            launched.append(name)
            if kind in fused:
                fn, n_ptrs = fused[kind]
                n_ptrs += scatter
                fn(*[tensors.get(p) for p in args[:n_ptrs]], *args[n_ptrs:])
                return
            n_ptrs = (4 if masked else 3) if kind == 'im2col' else \
                (6 if masked else 4) + scatter
            ptrs = [tensors[p] for p in args[:n_ptrs]]
            (row0, rows, h, w, c, ho, wo, kh, kw, sh, sw, ph, pw, dh, dw, dg,
             groups, _stream) = args[n_ptrs:]
            geom = ((kh, kw), (sh, sw), (ph, pw), (dh, dw), (ho, wo))
            if kind == 'im2col':
                x, offset, mask = ptrs[0], ptrs[1], \
                    ptrs[2] if masked else None
                ptrs[-1].copy_(dcn._im2col_ref(x, offset, mask, row0, rows,
                                               geom, groups))
                return
            grad_col, x, offset = ptrs[:3]
            mask = ptrs[3] if masked else None
            outs = ptrs[3 + masked:]
            grads = _sample_grads(grad_col, x, offset, mask, row0, rows,
                                  geom, groups)
            for out, grad in zip(outs[:1 + masked], grads[1:]):
                flat, g = out.view(-1, *out.shape[3:]), \
                    grad.view(-1, *out.shape[3:])
                flat[row0:row0 + rows] = g[row0:row0 + rows]
            if scatter:
                outs[-1].add_(grads[0])
        return launch

    class _NoDevice:
        def __init__(self, *_):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.Tensor, 'data_ptr', data_ptr)
    monkeypatch.setattr(torch.cuda, 'device', _NoDevice)
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda: _Stream)
    for name, (kind, masked) in _ENTRY.items():
        monkeypatch.setattr(dcn, name, entry(name, kind, masked))
    return launched


@pytest.mark.parametrize('groups,dg,masked,grad_x', [
    (1, 2, True, False), (1, 4, True, True), (2, 2, True, True),
    (4, 1, True, False), (1, 2, False, True), (2, 2, False, False)])
def test_function_around_the_kernels_matches_jax(monkeypatch, groups, dg,
                                                 masked, grad_x):
    """The Function the CUDA path uses, with stand-ins for the kernels:
    the group-major columns and the batched matmuls around them, each
    chunk's recomputed columns, and which entry point each variant
    launches (K2 with groups 1, K3 with groups > 1, K5 without a mask;
    the scatter only where x needs a gradient), against JAX."""
    launched = _stand_in_kernels(monkeypatch)
    monkeypatch.setattr(dcn, 'COL_CAP_BYTES', 40 * 9 * 16 * 4)  # 40 rows
    pad = 1 if masked else 0
    x, offset, mask, weight, bias = _grouped(17, groups, dg, padding=pad)
    cot = np.random.RandomState(18).randn(
        *offset.shape[:3], 12).astype(np.float32)
    kw = dict(padding=pad, groups=groups, deform_groups=dg)
    inputs = (x, offset, mask, weight, bias) if masked else (x, offset,
                                                             weight)
    jfn = jax_dcn.modulated_deform_conv2d if masked else \
        jax_dcn.deform_conv2d
    want = jax.grad(lambda *a: (jfn(*a, **kw) * jnp.asarray(cot)).sum(),
                    argnums=tuple(range(len(inputs))))(
        *(jnp.asarray(a) for a in inputs))
    want_out = np.asarray(jfn(*(jnp.asarray(a) for a in inputs), **kw))

    args = [torch.from_numpy(a).requires_grad_(i > 0 or grad_x)
            for i, a in enumerate(inputs)]
    geom = dcn._geometry(args[0], args[1], args[2] if masked else None,
                         args[-2 if masked else -1], 1, pad, 1, groups, dg)
    if masked:
        out = dcn._ModulatedDeformConv2d.apply(*args, geom, groups)
    else:
        out = dcn._ModulatedDeformConv2d.apply(args[0], args[1], None,
                                               args[2], None, geom, groups)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0,
                               atol=1e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    for i, (a, w) in enumerate(zip(args, want)):
        if i == 0 and not grad_x:
            assert a.grad is None
            continue
        w = np.asarray(w)
        np.testing.assert_allclose(a.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=i)
    prefix = ('mdcn' if masked else 'deform')
    groups_tag = '_groups' if masked and groups > 1 else ''
    im2col = f'{prefix}_im2col{groups_tag}_kernel'
    col2im = (f'{prefix}_col2im{groups_tag}'
              f'{"_scatter" if grad_x else ""}_kernel')
    # each chunk forward, then each recomputed for grad weight and col2im
    chunks = len(dcn._row_chunks(out.shape[0] * out.shape[1] * out.shape[2],
                                 9, 16, 4))
    assert chunks > 1
    assert launched == [im2col] * chunks + [im2col, col2im] * chunks


def test_cuda_checks_name_the_column_store_width():
    """The column stores are float4s: C / groups must be a multiple of 4,
    as C and C / deform_groups are."""
    x = torch.zeros((1, 4, 4, 24))
    offset = torch.zeros((1, 4, 4, 2, 9, 2))
    dcn._check_cuda_inputs('mdcn', x, offset, None, groups=3)   # C/G = 8
    with pytest.raises(ValueError, match='C/groups'):
        dcn._check_cuda_inputs('mdcn', x, offset, None, groups=4)


@pytest.mark.parametrize('n, ho, wo, c, cout', [
    (30, 40, 40, 256, 256), (30, 80, 80, 128, 128), (30, 160, 160, 64, 64),
    (5, 125, 125, 256, 256), (2, 7, 9, 16, 72)])
def test_wgrad_slices_hold_every_patch_once(n, ho, wo, c, cout):
    """The bf16 wgrad's slices of 8 x 8 output patches, cut from the shapes
    alone (so the ordered sum of their partials is the same on any card):
    every patch in one slice, no slice empty, and no more than
    ``WGRAD_WAVES`` waves of blocks on the H100's 132 SMs unless one slice
    is all there is."""
    splits, per = dcn._wgrad_slices(n, ho, wo, 9, c, cout)
    patches = n * -(-ho // 8) * -(-wo // 8)
    assert (splits - 1) * per < patches <= splits * per
    blocks = splits * 9 * -(-c // 64)
    per_sm = 1 if cout > 128 else 2
    assert splits == 1 or blocks <= dcn.WGRAD_WAVES * 132 * per_sm
