"""The walk of K2's grad-x scatter dgrad (``mdcn_fused_dgrad_scatter``,
``csrc/mdcn_fused.cuh``) emulated in plain PyTorch, on the CPU: its blocks
of 8 x 8 output pixels with their offsets and masks staged, its steps
(tap-major: a tap, then its chunks of BK channels), a sample's (group, tap)
among the staged ones, and each (pixel, run of N channels) sample's four
corners reduced into grad x, channel for channel. Held to autograd of the
plain version, ``dcn.modulated_deform_conv2d_ref``, at small shapes with
f32's and bf16's chunk widths (BK 32, N 4; BK 64, N 8), a last chunk
shorter than BK and ragged patches: f32, grad x within 1e-5 of its largest
entry (the same products and corner weights, summed in another order). And
the bf16 lanes' trade of half runs (``deform_bilinear.cuh``'s
``scatter_corners``) emulated lane by lane: the pairs' reductions add the
same values at the same addresses as each lane's own would."""
import numpy as np
import pytest
import torch

from mrefsr_tpu_torch.ops import dcn

torch.set_num_threads(2)

PATCH = dcn.PATCH
RUNS_K = 8          # runs of N channels in a chunk: BK = 8 N


def _walk_grad_x(x, offset, mask, weight, cot, n_run):
    """Grad x as the scatter's walk adds it: blocks, taps, chunks, runs,
    each sample at its (group, tap) of the block's staged offsets and
    masks, its corners."""
    n, h, w, c = x.shape
    _, ho, wo, dg, taps, _ = offset.shape
    cout = weight.shape[3]
    bk, cg = RUNS_K * n_run, c // dg
    gcol = (cot.reshape(-1, cout) @ weight.reshape(taps * c, cout).t()) \
        .reshape(n, ho, wo, taps, c)
    grad_x = torch.zeros_like(x)
    for item in range(n):
        for py in range(0, ho, PATCH):
            for px in range(0, wo, PATCH):
                oy = torch.arange(py, min(py + PATCH, ho))
                ox = torch.arange(px, min(px + PATCH, wo))
                # the block's staged offsets and masks: [pixels][dg * K]
                off_s = offset[item][oy][:, ox].reshape(
                    len(oy), len(ox), dg * taps, 2)
                msk_s = mask[item][oy][:, ox].reshape(len(oy), len(ox),
                                                      dg * taps)
                for k in range(taps):
                    ky, kx = divmod(k, 3)
                    for ci in range(-(-c // bk)):
                        for r in range(RUNS_K):
                            c0 = ci * bk + r * n_run
                            if c0 >= c:
                                continue
                            og = (c0 // cg) * taps + k     # step_of's og
                            fy = (oy - 1 + ky)[:, None] + off_s[:, :, og, 0]
                            fx = (ox - 1 + kx)[None, :] + off_s[:, :, og, 1]
                            m = msk_s[:, :, og]
                            y0, x0 = torch.floor(fy), torch.floor(fx)
                            wy1, wx1 = fy - y0, fx - x0
                            g = gcol[item][oy][:, ox][:, :, k,
                                                      c0:c0 + n_run]
                            for dy, dx, wt in (
                                    (0, 0, (1 - wy1) * (1 - wx1)),
                                    (0, 1, (1 - wy1) * wx1),
                                    (1, 0, wy1 * (1 - wx1)),
                                    (1, 1, wy1 * wx1)):
                                cy, cx = y0.long() + dy, x0.long() + dx
                                inside = (cy >= 0) & (cy < h) & (cx >= 0) \
                                    & (cx < w)
                                val = g * (m * wt)[..., None]
                                for e in range(n_run):
                                    grad_x[item].index_put_(
                                        (cy[inside], cx[inside],
                                         torch.full_like(cy[inside],
                                                         c0 + e)),
                                        val[..., e][inside],
                                        accumulate=True)
    return grad_x


def _inputs(seed, n, h, w, c, dg, cout=8):
    """Offsets a mix of small ones (uniform on [-1.5, 1.5]) and randn x 4."""
    rng = np.random.RandomState(seed)
    near = rng.uniform(-1.5, 1.5, (n, h, w, dg, 9, 2))
    wide = rng.randn(n, h, w, dg, 9, 2) * 4
    pick = rng.rand(n, h, w, dg, 9, 1) < 0.5
    arrays = (rng.randn(n, h, w, c), np.where(pick, wide, near),
              rng.rand(n, h, w, dg, 9), rng.randn(3, 3, c, cout) * 0.1,
              rng.randn(n, h, w, cout))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


@pytest.mark.parametrize('c,dg,n_run,h,w', [
    (16, 2, 4, 12, 12),     # one chunk of two groups (f32's BK 32)
    (48, 6, 4, 10, 9),      # chunks of 32 and 16 channels, ragged patches
    (64, 8, 8, 9, 12),      # bf16's BK 64: one chunk of 8 groups
    (128, 16, 8, 8, 8)])    # bf16, two chunks (BasicVSR++'s C and dg)
def test_scatter_walk_matches_autograd(c, dg, n_run, h, w):
    """Grad x as the walk adds it equal to autograd's."""
    x, offset, mask, weight, cot = _inputs(c + dg, 1, h, w, c, dg)
    got = _walk_grad_x(x, offset, mask, weight, cot, n_run)
    xg = x.clone().requires_grad_()
    want = torch.autograd.grad(dcn.modulated_deform_conv2d_ref(
        xg, offset, mask, weight, deform_groups=dg), xg, cot)[0]
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-5, err


def _paired(ok, addr, vals):
    """The two reductions each lane issues under the bf16 pairs' trade:
    lane l and l ^ 1 swap halves (the odd lane sends its lower 4 values,
    the even its upper), then reduce the even lane's 32 bytes, then the
    odd lane's; ``(ok, address in floats, 4 values)`` a reduction."""
    out = []
    for lane in range(len(ok)):
        odd, partner = lane & 1, lane ^ 1
        got = vals[partner][:4] if odd == 0 else vals[partner][4:]
        if odd:
            first = (ok[partner], addr[partner] + 4, got)
            second = (ok[lane], addr[lane] + 4, vals[lane][4:])
        else:
            first = (ok[lane], addr[lane], vals[lane][:4])
            second = (ok[partner], addr[partner], got)
        out += [first, second]
    return out


def test_bf16_pairs_reduce_what_each_lane_would():
    """Per corner, a warp's paired reductions are each lane's two half
    runs (at its address and 4 floats on), the same values, and the first
    of a pair's two covers one lane's 32 bytes whole."""
    rng = np.random.RandomState(3)
    ok = rng.rand(32) < 0.7
    addr = rng.randint(0, 1000, 32) * 8
    vals = [tuple(rng.randn(8).round(3)) for _ in range(32)]
    got = sorted((a, v) for k, a, v in _paired(ok, addr, vals) if k)
    want = sorted((a, v) for lane in range(32) if ok[lane]
                  for a, v in ((addr[lane], vals[lane][:4]),
                               (addr[lane] + 4, vals[lane][4:])))
    assert got == want
    reds = _paired(ok, addr, vals)
    for lane in range(0, 32, 2):   # the pair's first reductions
        assert reds[2 * lane + 2][1] == reds[2 * lane][1] + 4
