"""``mrefsr_tpu_torch.ops.upfirdn2d`` against ``mrefsr_tpu.ops.upfirdn2d``
on the CPU: the same numpy inputs go through the JAX op (NHWC) and the
port's plain version (NCHW), forward, gradient and second-order gradient.
The CUDA kernels cannot run here; their arithmetic (the gather, and the
tile kernel's index rules walked tile by tile with the wrapper's own
``tile_geometry``), the wrapper's choice between them and the
``autograd.Function`` around them (which op is the gradient of which) are
held against the plain version and JAX through stand-ins written in
PyTorch."""
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


def _tile_walk(x, fir, up, down, pads):
    """The tile kernel's index rules, walked tile by tile in PyTorch with
    the wrapper's ``tile_geometry``: each block's window staged with zeros
    outside the plane, then each thread's strip of ``rows`` outputs
    down one column, from the window alone (vectorised over the block's
    planes and columns). A window read out of its bounds raises."""
    n, c, h, w = x.shape
    planes = n * c
    xp = x.reshape(planes, h, w)
    y0, y1, x0, x1 = pads
    out_h = (h * up + y0 + y1 - 4) // down + 1
    out_w = (w * up + x0 + x1 - 4) // down + 1
    rows, tw, rg, pb, nx, ny, rows_in, cols_in = \
        ops_upfirdn2d.tile_geometry(planes, out_h, out_w, up, down)
    assert rows in ops_upfirdn2d.TILE_STRIPS
    assert tw * rg * pb <= ops_upfirdn2d.TILE_THREADS
    assert pb * rows_in * cols_in <= ops_upfirdn2d.TILE_MAX_WINDOW
    if (rows_in, cols_in) == (0, 0):    # direct: x itself, zero outside
        rows_in, cols_in = ops_upfirdn2d.tile_window(up, down, rg * rows,
                                                     tw)
    taps = torch.flip(fir, [0, 1]).to(x.dtype)     # taps[ky, kx]
    out = x.new_full((planes, out_h, out_w), float('nan'))
    th = rg * rows
    for p0 in range(0, planes, pb):
        ps = slice(p0, min(planes, p0 + pb))
        for ty in range(ny):
            for tx in range(nx):
                oy0, ox0 = ty * th, tx * tw
                if up == 2:
                    iy0, ix0 = (oy0 - y0 + 1) >> 1, (ox0 - x0 + 1) >> 1
                else:
                    iy0, ix0 = oy0 * down - y0, ox0 * down - x0
                win = x.new_zeros((ps.stop - p0, rows_in, cols_in))
                r0, r1 = max(iy0, 0), min(iy0 + rows_in, h)
                c0, c1 = max(ix0, 0), min(ix0 + cols_in, w)
                if r0 < r1 and c0 < c1:
                    win[:, r0 - iy0:r1 - iy0, c0 - ix0:c1 - ix0] = \
                        xp[ps, r0:r1, c0:c1]
                cx = torch.arange(tw)
                cx = cx[ox0 + cx < out_w]        # threads past the edge return
                for ry in range(rg):
                    oy = oy0 + ry * rows
                    if oy >= out_h:
                        continue
                    acc = [0.0] * rows
                    if up == 1:
                        for rr in range((rows - 1) * down + 4):
                            r = ry * rows * down + rr
                            assert r < rows_in
                            vals = [win[:, r, cx * down + kx]
                                    for kx in range(4)]
                            for k in range(rows):
                                ky = rr - k * down
                                if 0 <= ky < 4:
                                    for kx in range(4):
                                        acc[k] = acc[k] + taps[ky, kx] \
                                            * vals[kx]
                    else:
                        tcol = ox0 + cx - x0
                        qx = tcol & 1
                        col = ((tcol + 1) >> 1) - ix0
                        trow = oy - y0
                        q = trow & 1
                        row0 = ((trow + 1) >> 1) - iy0
                        for rr in range(rows // 2 + 2):
                            r = row0 + rr
                            uses = [k for k in range(rows) if 0 <= rr - (
                                (k + 1) // 2 if q == 0 else k // 2) < 2]
                            if not uses:
                                continue
                            assert r < rows_in
                            v0, v1 = win[:, r, col], win[:, r, col + 1]
                            for k in uses:
                                j = rr - ((k + 1) // 2 if q == 0 else k // 2)
                                ky = 2 * j + ((q + k) & 1)
                                acc[k] = acc[k] + taps[ky, qx] * v0 \
                                    + taps[ky, 2 + qx] * v1
                    for k in range(min(rows, out_h - oy)):
                        out[ps, oy + k, ox0 + cx] = acc[k]
    assert not torch.isnan(out).any()
    return out.reshape(n, c, out_h, out_w)


def _tile_walk_cases():
    """(label, x shape, up, down, pads): every StyleGAN2 case of CASES and
    its transpose (the backward), output widths and heights one below, at
    and one above a tile's edge, and many small planes in one block."""
    cases = []
    for name in sorted(CASES):
        fir, shape, up, down, pad = CASES[name]
        if ops_upfirdn2d.route(torch.from_numpy(fir), up, down) != 'tile':
            continue
        n, h, w, c = shape
        pads = ops_upfirdn2d._pads4(pad)
        out_hw = [ops_upfirdn2d._out_size(s, 4, up, down, p0, p1)
                  for s, p0, p1 in ((h, *pads[:2]), (w, *pads[2:]))]
        _, t_up, t_down, t_pads = ops_upfirdn2d._transposed(
            (h, w), out_hw, torch.from_numpy(fir), up, down, pads)
        cases.append((name, (n, c, h, w), up, down, pads))
        cases.append((f'{name}_transposed', (n, c, *out_hw), t_up, t_down,
                      t_pads))
    # one below, at and one above a tile's edge: 128 columns at (1, 1) and
    # up 2, 63 at down 2 (a window row of at most 128 floats), and 32 rows
    # (two strips of 16)
    for (h, w), (up, down) in (
            ((63, 127), (1, 1)), ((64, 128), (1, 1)), ((65, 129), (1, 1)),
            ((63, 62), (1, 2)), ((64, 63), (1, 2)), ((65, 64), (1, 2)),
            ((63, 127), (2, 1)), ((64, 128), (2, 1)), ((65, 129), (2, 1))):
        if up == 2:
            shape, pads = ((h + 1) // 2, (w + 1) // 2), (2, 1 - h % 2, 2,
                                                         1 - w % 2)
        else:
            shape, pads = ((h - 1) * down + 2, (w - 1) * down + 2), \
                (1, 1, 1, 1)
        cases.append((f'edge_{up}{down}_{h}x{w}', (1, 2, *shape), up, down,
                      pads))
    cases.append(('odd_pads_up2', (1, 2, 9, 7), 2, 1, (1, 2, 3, 0)))
    cases.append(('small_planes', (5, 9, 4, 5), 1, 1, (2, 2, 2, 2)))
    cases.append(('small_planes_down2', (3, 20, 8, 8), 1, 2, (1, 1, 1, 1)))
    return cases


@pytest.mark.parametrize('mode', ['staged', 'direct'])
@pytest.mark.parametrize('label, shape, up, down, pads', _tile_walk_cases(),
                         ids=[c[0] for c in _tile_walk_cases()])
def test_tile_walk_matches_the_plain_version(monkeypatch, label, shape, up,
                                             down, pads, mode):
    """The tile kernel's design (window origins, halos, parity phases, the
    plane packing) walked with the wrapper's geometry gives the op, with a
    staged window and reading x directly."""
    for knob in ('TILE_DIRECT_OUTPUTS', 'TILE_DIRECT_PLANE'):
        monkeypatch.setattr(ops_upfirdn2d, knob,
                            0 if mode == 'staged' else 2 ** 40)
    rng = np.random.RandomState(sum(shape) + up + 2 * down)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    fir = torch.from_numpy(FIR4 * (4 if up == 2 else 1))
    want = upfirdn2d_ref(x, fir, up, down, pads)
    got = _tile_walk(x, fir, up, down, pads)
    assert got.shape == want.shape
    _close(got.numpy(), want.numpy())


def test_tile_geometry_covers_every_output_within_its_limits():
    """Every StyleGAN2 shape of the serving and training paths (widths 4 to
    1025, 3 to 512 channels) gets a geometry that covers its output with
    at most 256 threads and 32 KB of window a block; large planes are
    staged, small planes and small calls read x directly; the smallest
    calls get strips of one or two rows, for threads."""
    for planes, out_hw, (up, down), staged in (
            (16 * 32, (1024, 1024), (1, 1), True),
            (16 * 3, (1024, 1024), (2, 1), True),
            (8 * 128, (257, 257), (1, 1), True),
            (16 * 256, (128, 128), (1, 1), False),
            (8 * 3, (128, 128), (1, 2), False),
            (8 * 512, (9, 9), (1, 1), False),
            (8 * 3, (4, 4), (1, 2), False),
            (8 * 512, (4, 4), (1, 1), False),
            (16 * 512, (1025, 1025), (1, 1), True)):
        rows, tw, rg, pb, nx, ny, rows_in, cols_in = \
            ops_upfirdn2d.tile_geometry(planes, *out_hw, up, down)
        th = rg * rows
        assert rows in ops_upfirdn2d.TILE_STRIPS
        assert nx * tw >= out_hw[1] and (nx - 1) * tw < out_hw[1]
        assert ny * th >= out_hw[0] and (ny - 1) * th < out_hw[0]
        assert tw <= ops_upfirdn2d.TILE_MAX_COLS
        assert cols_in <= ops_upfirdn2d.TILE_ROW_FLOATS
        assert tw * rg * pb <= ops_upfirdn2d.TILE_THREADS
        assert pb <= ops_upfirdn2d.TILE_MAX_PLANES
        assert pb * rows_in * cols_in <= ops_upfirdn2d.TILE_MAX_WINDOW
        assert (rows_in, cols_in) == (ops_upfirdn2d.tile_window(
            up, down, th, tw) if staged else (0, 0))
        threads = planes * out_hw[1] * -(-out_hw[0] // rows)
        assert rows == 1 or threads >= ops_upfirdn2d.TILE_MIN_THREADS
        if planes * out_hw[0] * out_hw[1] < 2 ** 14:
            assert rows <= 2


def _stand_in_kernels(monkeypatch):
    """PyTorch stand-ins for the three C entry points, with their contract:
    pointers to contiguous planes, the FIR by value, the tile kernel's
    geometry or None for the gather. The tile entry checks the geometry
    against ``tile_geometry`` and computes with :func:`_tile_walk`; the
    gather with :func:`_gather`. Returns the list of calls, ``(order,
    (up, down), took the tile kernel)``."""
    calls, tensors = [], {}
    real_data_ptr = torch.Tensor.data_ptr

    def data_ptr(t):
        ptr = real_data_ptr(t)
        tensors[ptr] = t
        return ptr

    class _Entry:
        def __init__(self, order):
            self.order = order

        def __call__(self, x_ptr, out_ptr, fir_values, planes, h, w, kh, kw,
                     up, down, y0, y1, x0, x1, tile, stream):
            x, out = tensors[x_ptr], tensors[out_ptr]
            assert x.is_contiguous() and out.is_contiguous()
            assert x.shape[0] * x.shape[1] == planes
            fir = torch.tensor(list(fir_values)).reshape(kh, kw)
            pads = (y0, y1, x0, x1)
            calls.append((self.order, (up, down), tile is not None))
            if tile is None:
                out.copy_(_gather(x, fir, up, down, pads, self.order))
                return
            assert tuple(tile) == ops_upfirdn2d.tile_geometry(
                planes, out.shape[2], out.shape[3], up, down)
            out.copy_(_tile_walk(x, fir, up, down, pads))

    monkeypatch.setattr(torch.Tensor, 'data_ptr', data_ptr)
    monkeypatch.setattr(ops_upfirdn2d, 'upfirdn2d_kernels',
                        tuple(_Entry(order) for order in range(3)))
    monkeypatch.setattr(ops_upfirdn2d, '_check_cuda', lambda x: None)
    monkeypatch.setattr(ops_upfirdn2d, 'launch',
                        lambda kernel, device, *args: kernel(*args, 0))
    return calls


@pytest.mark.parametrize('name', sorted(CASES))
def test_wrapper_routes_stylegan2_cases_to_the_tile_kernel(monkeypatch,
                                                           name):
    """Through the CUDA path's Function with stand-ins for the C entry
    points: the 4x4 FIR at (up, down) = (1, 1), (2, 1) and (1, 2) goes to
    the tile kernel, forward, backward and double backward (whose
    transposes are such cases too), every other case to the gather; all
    three orders agree with JAX."""
    calls = _stand_in_kernels(monkeypatch)

    def through_function(x, fir, up, down, pad):
        return ops_upfirdn2d._UpFirDn2d.apply(
            x, fir, up, down, ops_upfirdn2d._pads4(pad), 0)

    args = _inputs(name)
    got = _torch_orders(through_function, *args)
    for g, w in zip(got, _jax_orders(*args)):
        assert g.shape == w.shape
        _close(g, w)
    fir, _, _, up, down, _ = args
    tile = fir.shape == (4, 4) and (up, down) in ops_upfirdn2d.TILE_CASES
    assert calls == [(0, (up, down), tile), (1, (down, up), tile),
                     (2, (up, down), tile)]
    assert ops_upfirdn2d.route(torch.from_numpy(fir), up, down) == (
        'tile' if tile else 'general')
