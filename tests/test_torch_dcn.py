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
    summed in f32 and rounded to x's type (bf16; f32 as they are), then the
    col2im arithmetic in f32.
    Returns grad x, grad offset, grad mask (None without a mask). With
    ``round_col`` False the grad columns stay f32 (the columns of a widened
    x and mask, whose cotangent is not rounded), and grad x and grad mask
    are rounded once at the end."""
    rows, cout = go.shape
    grad_col = go.float() @ weight.reshape(-1, cout).float().t()
    if round_col:
        grads = _sample_grads(grad_col.to(x.dtype), x, offset, mask, 0, rows,
                              geom)
        return (*grads, None) if mask is None else grads
    gx, goff, gmask = _sample_grads(grad_col, x.float(), offset,
                                    mask.float(), 0, rows, geom)
    return gx.to(x.dtype), goff, gmask.to(mask.dtype)


def fused_patch_of_rows(n, ho, wo):
    """The 8 x 8 output patch of each row of the flattened (N, Ho, Wo), as
    ``mdcn_fused.cuh`` numbers them: item-major, then row-major over the
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
    """PyTorch stand-ins for the C entry points of the fused kernels
    (``csrc/mdcn_fused.cu``, ``csrc/mdcn_bf16.cu``) behind every Kernel of
    ``dcn.FUSED_KERNELS`` (K2, K3 and K5) and ``dcn.mdcn_fused_split_kernel``
    (launches named ``'mdcn_fused_split'``), with their contracts: pointers
    in, the geometry as ints; the mask pointer null for DCNv1 (a mask of
    ones: dgrad's grad-mask pointer null with it, nothing written there);
    the weight ``(K * C, Cout)``, for K3 the block-diagonal expansion of
    the grouped one, all of C a row, and at f32 the forward's and dgrad's
    weight its TF32 hi and lo planes, which the split writes (its plain
    version, ``dcn._split_tf32_ref``) and which add up to it exactly. The
    forward rounds the columns once to x's type, sums their product with
    the weight in f32, rounds to x's type and adds the bias there (at f32: the f32 sum plus the bias); dgrad
    writes grad offset and grad mask by :func:`fused_dgrad_math` (and adds
    grad x in its scatter variant); wgrad writes the f32 partials of the
    whole ``(K * C, Cout)`` grad weight and, in the row after, grad bias of
    each slice of 8 x 8 output patches; the sum adds the slices in order.
    Returns the names (keys of ``dcn.FUSED_KERNELS``) of the entry points
    launched."""
    launched = []
    tensors = {}
    real_data_ptr = torch.Tensor.data_ptr

    def data_ptr(t):
        ptr = real_data_ptr(t)
        tensors[ptr] = t
        return ptr

    def weight_of(w, x):
        """The weight a forward or dgrad entry point reads: at f32 the sum
        of its two planes (exact), at bf16 itself."""
        if x.dtype != torch.float32:
            return w
        assert w.shape[0] == 2
        return w[0] + w[1]

    def fused_split(w, planes, n, _stream):
        assert w.dtype == planes.dtype == torch.float32
        assert planes.shape == (2, *w.shape) and w.numel() == n
        planes.copy_(dcn._split_tf32_ref(w))

    def fused_fwd(x, offset, mask, wt, bias, out, *rest):
        rows, cout, geom = _fused_geom(rest)
        kh, kw = geom[0]
        wt = weight_of(wt, x)
        assert wt.shape == (cout, kh * kw * x.shape[3])
        col = dcn._im2col_ref(x, offset, mask, 0, rows, geom)
        y = (col.reshape(rows, -1).float() @ wt.float().t()).to(x.dtype)
        out.view(rows, cout).copy_(y if bias is None else y + bias)

    def fused_dgrad(go, x, offset, mask, weight, grad_offset, grad_mask,
                    *rest):
        grad_x = rest[0] if len(rest) == 18 else None
        _, cout, geom = _fused_geom(rest[-17:])
        assert (mask is None) == (grad_mask is None)
        weight = weight_of(weight, x)
        assert weight.shape == (*geom[0], x.shape[3], cout)
        gx, goff, gmask = fused_dgrad_math(go, x, offset, mask, weight, geom)
        grad_offset.copy_(goff)
        if mask is not None:
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

    # each part with its stand-in and number of pointer arguments
    parts = {'fwd': (fused_fwd, 6), 'dgrad': (fused_dgrad, 7),
             'dgrad_scatter': (fused_dgrad, 8),
             'wgrad': (fused_wgrad, 5), 'wgrad_sum': (fused_wgrad_sum, 2)}

    def entry(name, part):
        fn, n_ptrs = parts[part]

        def launch(*args):
            launched.append(name)
            fn(*[tensors.get(p) for p in args[:n_ptrs]], *args[n_ptrs:])
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
    for prefix in dcn.VARIANTS.values():
        for suffix in ('', '_bf16'):
            for part in parts:
                name = f'{prefix}_{part}{suffix}'
                monkeypatch.setitem(dcn.FUSED_KERNELS, name,
                                    entry(name, part))
    parts['split'] = (fused_split, 2)
    monkeypatch.setattr(dcn, 'mdcn_fused_split_kernel',
                        entry('mdcn_fused_split', 'split'))
    return launched


def fused_launches(groups, masked, grad_x, suffix=''):
    """The entry points one forward and one backward of the CUDA path
    launch: the fused ones of K2, K3 or K5, the scatter only for grad x;
    at f32 the weight's split before the forward and before dgrad."""
    prefix = dcn.VARIANTS[dcn._variant(True if masked else None, groups)]
    scatter = '_scatter' if grad_x else ''
    split = [] if suffix else ['mdcn_fused_split']
    return [*split, f'{prefix}_fwd{suffix}',
            *split, f'{prefix}_dgrad{scatter}{suffix}',
            f'{prefix}_wgrad{suffix}', f'{prefix}_wgrad_sum{suffix}']


def apply_function(args, masked, groups, dg, pad):
    """The CUDA path's Function on ``args`` (x, offset, mask, weight, bias,
    or x, offset, weight for DCNv1)."""
    geom = dcn._geometry(args[0], args[1], args[2] if masked else None,
                         args[-2 if masked else -1], 1, pad, 1, groups, dg)
    if masked:
        return dcn._ModulatedDeformConv2d.apply(*args, geom, groups)
    return dcn._ModulatedDeformConv2d.apply(args[0], args[1], None, args[2],
                                            None, geom, groups)


@pytest.mark.parametrize('groups,dg,masked,grad_x', [
    (1, 2, True, False), (1, 4, True, True), (2, 2, True, True),
    (4, 1, True, False), (1, 2, False, True), (2, 2, False, False)])
def test_function_around_the_kernels_matches_jax(monkeypatch, groups, dg,
                                                 masked, grad_x):
    """The Function the CUDA path uses, with stand-ins for the kernels:
    which entry points each variant launches, against JAX. K2 (groups 1,
    with a mask), K3 (groups > 1, on the block-diagonal weight) and K5 (no
    mask: a null mask pointer): one fused forward however small the column
    cap, then dgrad (its scatter only where x needs a gradient), wgrad and
    the sum of its partials, each through its own Kernels; Cout 16, since
    the fused kernels need 8 | Cout."""
    launched = _stand_in_kernels(monkeypatch)
    monkeypatch.setattr(dcn, 'COL_CAP_BYTES', 40 * 9 * 16 * 4)  # 40 rows
    pad = 1 if masked else 0
    cout = 16
    x, offset, mask, weight, bias = _grouped(17, groups, dg, padding=pad,
                                             cout=cout)
    cot = np.random.RandomState(18).randn(
        *offset.shape[:3], cout).astype(np.float32)
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
    out = apply_function(args, masked, groups, dg, pad)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0,
                               atol=1e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    for i, (a, w) in enumerate(zip(args, want)):
        if i == 0 and not grad_x:
            assert a.grad is None
            continue
        w = np.asarray(w)
        assert a.grad.shape == w.shape
        np.testing.assert_allclose(a.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=i)
    assert launched == fused_launches(groups, masked, grad_x)


def k3_against_k2_slices(monkeypatch, groups, dg, masked, dtype, tol):
    """K3 (or a grouped K5) at ``groups`` through the CUDA path's Function,
    against ``groups`` calls of K2 (K5 with groups 1) on the channel
    slices: x's and the weight's channels of each group, the deform groups
    split with them, the bias's and grad out's output channels; output and
    every gradient, each within ``tol`` of its largest entry. Both run the
    stand-ins: the block-diagonal weight against the slices."""
    launched = _stand_in_kernels(monkeypatch)
    pad = 1 if masked else 0
    c, cout = 32, 16 * groups
    x, offset, mask, weight, bias = _grouped(21, groups, dg, padding=pad,
                                             c=c, cout=cout)
    cot = np.random.RandomState(22).randn(
        *offset.shape[:3], cout).astype(np.float32)

    def run(x, offset, mask, weight, bias, cot, g, d):
        arrays = [x, offset, mask, weight, bias] if masked else [x, offset,
                                                                 weight]
        args = [torch.from_numpy(np.ascontiguousarray(a))
                .to(torch.float32 if i == 1 else dtype).requires_grad_()
                for i, a in enumerate(arrays)]
        out = apply_function(args, masked, g, d, pad)
        out.backward(torch.from_numpy(np.ascontiguousarray(cot)).to(dtype))
        return [out.detach().float()] + [a.grad.float() for a in args]

    whole = run(x, offset, mask, weight, bias, cot, groups, dg)
    parts = []
    for q in range(groups):
        ch = slice(q * c // groups, (q + 1) * c // groups)
        dgs = slice(q * dg // groups, (q + 1) * dg // groups)
        outs = slice(q * cout // groups, (q + 1) * cout // groups)
        parts.append(run(x[..., ch], offset[..., dgs, :, :],
                         mask[..., dgs, :], weight[..., outs], bias[outs],
                         cot[..., outs], 1, dg // groups))
    # where each tensor's slices join: out, x, offset, (mask,) weight,
    # (bias)
    dims = [-1, -1, -3, -2, -1, -1] if masked else [-1, -1, -3, -1]
    for i, (got, dim) in enumerate(zip(whole, dims)):
        want = torch.cat([p[i] for p in parts], dim)
        assert got.shape == want.shape, i
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= tol, (i, err)
    suffix = '_bf16' if dtype == torch.bfloat16 else ''
    assert launched == (fused_launches(groups, masked, True, suffix)
                        + fused_launches(1, masked, True, suffix) * groups)


@pytest.mark.parametrize('groups,dg,masked', [
    (2, 2, True), (2, 4, True), (4, 4, True), (2, 2, False)])
def test_k3_is_k2_on_the_channel_slices(monkeypatch, groups, dg, masked):
    """K3 at G (or DCNv1 at G) on the block-diagonal weight equals G K2 (K5)
    calls on the channel slices, at f32: the zeros off the blocks add
    nothing, and grad weight is the diagonal blocks (f32 sums in another
    order: 1e-5 of each tensor's largest entry)."""
    k3_against_k2_slices(monkeypatch, groups, dg, masked, torch.float32,
                         1e-5)


@pytest.mark.parametrize('grad_x', [False, True])
def test_mdcn_f32_function_launches_the_fused_entry_points(monkeypatch,
                                                           grad_x):
    """The Function of the CUDA path at f32 (K2), with PyTorch stand-ins
    for the C entry points: one launch of the weight's TF32 split and one
    of the fused forward per call however small the column cap (no chunks,
    no column matrix, no matmul); then one of the split and one of dgrad
    (its scatter variant only where x needs a gradient) and one of wgrad;
    then one of the ordered sum of the grad-weight and grad-bias partials; none of mdcn.cu's entry points or the bf16 ones;
    and agreement with ``jax.grad`` at f32's 1e-5 of each gradient's
    largest entry (the stand-ins sum exact f32 products, in another order
    than XLA's)."""
    _check_f32_function_launches(monkeypatch, grad_x, cout=16)


def test_mdcn_f32_function_splits_a_wide_layer(monkeypatch):
    """A layer wider than 64 output channels, which the kernels pad to a
    tile 128 wide, launches the same entry points and agrees with JAX."""
    _check_f32_function_launches(monkeypatch, False, cout=72)


def _check_f32_function_launches(monkeypatch, grad_x, cout):
    launched = _stand_in_kernels(monkeypatch)
    monkeypatch.setattr(dcn, 'COL_CAP_BYTES', 40 * 9 * 16 * 4)  # 40 rows
    assert len(dcn._row_chunks(2 * 7 * 9, 9, 16, 4)) > 1
    inputs = _case(19, 2, 7, 9, 16, cout, 2)
    cot = np.random.RandomState(20).randn(2, 7, 9, cout).astype(np.float32)
    args = [torch.from_numpy(a).requires_grad_(i > 0 or grad_x)
            for i, a in enumerate(inputs)]
    geom = dcn._geometry(*args[:4], 1, 1, 1, 1, 2)
    out = dcn._ModulatedDeformConv2d.apply(*args, geom, 1)
    assert launched == ['mdcn_fused_split', 'mdcn_fused_fwd']
    (out * torch.from_numpy(cot)).sum().backward()
    assert launched == fused_launches(1, True, grad_x)
    kw = dict(deform_groups=2)
    want_out = jax_dcn.modulated_deform_conv2d(
        *(jnp.asarray(a) for a in inputs), **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=0, atol=1e-5)
    want = jax.grad(
        lambda *a: (jax_dcn.modulated_deform_conv2d(*a, **kw)
                    * jnp.asarray(cot)).sum(),
        argnums=tuple(range(5)))(*(jnp.asarray(a) for a in inputs))
    for i, (a, w) in enumerate(zip(args, want)):
        if i == 0 and not grad_x:
            assert a.grad is None
            continue
        assert a.grad.dtype == torch.float32
        w = np.asarray(w)
        np.testing.assert_allclose(a.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=i)


def test_f32_fused_kernels_state_their_vector_width():
    """At f32 a fused K2 thread loads runs of 4 channels: C and C /
    deform_groups multiples of 4, and for the backward a deform group's
    runs of 4 a power of two <= 8 (C / deform_groups 4 to 32: MRAPA's 8,
    16 and 32, BasicVSR++'s 8); the weight, bias and grad out f32 like x,
    the offset f32."""
    x = torch.zeros((1, 4, 4, 64))
    offset = torch.zeros((1, 4, 4, 8, 9, 2))
    mask = torch.zeros((1, 4, 4, 8, 9))
    weight = torch.zeros((3, 3, 64, 64))
    for dg in (16, 8, 4, 2):                        # cg 4, 8, 16, 32
        dcn._check_fused_inputs(x, offset[..., :dg, :, :], mask[..., :dg, :],
                                weight, weight[0, 0, 0], weight[0, 0],
                                backward=True)
    with pytest.raises(ValueError, match='power of two <= 8'):
        dcn._check_fused_inputs(x, offset[..., :1, :, :], mask[..., :1, :],
                                weight, backward=True)          # 16 runs
    with pytest.raises(ValueError, match='power of two <= 8'):
        dcn._check_fused_inputs(x[..., :48], offset[..., :4, :, :],
                                mask[..., :4, :], weight[:, :, :48],
                                backward=True)                  # 3 runs
    with pytest.raises(ValueError, match='multiples of 4'):
        dcn._check_fused_inputs(x[..., :24], offset[..., :4, :, :],
                                mask[..., :4, :], weight[:, :, :24])  # cg 6
    with pytest.raises(TypeError, match='float32 weight'):
        dcn._check_fused_inputs(x, offset, mask, weight.to(torch.bfloat16))


def test_cuda_checks_name_the_column_store_width():
    """The column stores are float4s: C and C / deform_groups must be
    multiples of 4. Conv groups set no rule of their own: K3 runs on the
    block-diagonal weight, whose rows are all of x's C, so C / groups may
    be 6 (C 24, groups 4)."""
    x = torch.zeros((1, 4, 4, 24))
    offset = torch.zeros((1, 4, 4, 6, 9, 2))
    dcn._check_cuda_inputs('mdcn', x, offset[..., :2, :, :], None)  # cg 12
    with pytest.raises(ValueError, match='C/deform_groups'):
        dcn._check_cuda_inputs('mdcn', x, offset[..., :4, :, :], None)
    weight = torch.zeros((3, 3, 6, 8))
    geom = dcn._geometry(x, offset[..., :2, :, :], None, weight, 1, 1, 1, 4,
                         2)
    dcn._check_fused_inputs(x, offset[..., :2, :, :], None, weight)
    assert dcn._block_diagonal(weight, 4).shape == (3, 3, 24, 8)
    assert geom[4] == (4, 4)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('n, ho, wo, c, cout', [
    (30, 40, 40, 256, 256), (30, 80, 80, 128, 128), (30, 160, 160, 64, 64),
    (5, 125, 125, 256, 256), (2, 7, 9, 16, 72)])
def test_wgrad_slices_hold_every_patch_once(n, ho, wo, c, cout, dtype):
    """The fused wgrad's slices of 8 x 8 output patches, cut from the
    shapes alone (so the ordered sum of their partials is the same on any
    card): every patch in one slice, no slice empty, and no more than
    ``WGRAD_WAVES`` waves of blocks of (tap, 8 runs of 16 bytes: 64 bf16 or
    32 f32 channels) on the H100's 132 SMs unless one slice is all there
    is."""
    splits, per = dcn._wgrad_slices(n, ho, wo, 9, c, cout, dtype)
    patches = n * -(-ho // 8) * -(-wo // 8)
    assert (splits - 1) * per < patches <= splits * per
    blocks = splits * 9 * -(-c // (8 * (16 // dtype.itemsize)))
    per_sm = 1 if cout > 128 else 2
    assert splits == 1 or blocks <= dcn.WGRAD_WAVES * 132 * per_sm
