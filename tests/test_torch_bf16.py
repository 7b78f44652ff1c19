"""The port's bf16 path against the JAX package's bf16 path, on the CPU:
K1 (``feature_match_index``) and K6 (its sharded form, 2 ranks over gloo),
K2 (``modulated_deform_conv2d``), K3 (the same with conv groups), K5
(``deform_conv2d``) and K4 (``deform_sample``) with every gradient, the 5-ref eval with ``val.mixed_precision: bfloat16`` and the
stage-3 training step with ``train.mixed_precision: bfloat16`` for both
alignments, from the same seeded numpy inputs and the same flax weights;
and the shipped bf16 configs, accepted.

On the CPU the port runs its kernels' plain versions, which round where
the CUDA kernels round: K1 sums the exact f32 products of bf16 values in
f32; K2 to K5 sample bf16 corners in f32 and round each result to bf16
once. The JAX package takes the corner weights, their products and the sum
of the corners in bf16 (its dcn.py:171-178) and rounds the output of
every op, so the two differ by a few bf16 ulps; the tolerances below are
stated in units of the bf16 epsilon, ``EPS`` = 2 ** -7, against each
tensor's largest entry.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_torch_dcn
import torch_dist_worker as worker
from mrefsr_tpu.convert import flax_to_torch
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu.ops import correlation as jax_corr
from mrefsr_tpu.ops import dcn as jax_dcn
from mrefsr_tpu.ops import feature_match_index as jax_match
from mrefsr_tpu_torch.models import build_model
from mrefsr_tpu_torch.ops import correlation, dcn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 2.0 ** -7                     # bf16's machine epsilon
BF = torch.bfloat16


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The test workers of one run share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(t):
    return t.detach().float().numpy()


def _rel(got, want):
    """max |got - want| over max |want|, in f32."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------- K1
def _unit_bf16(rng, *shape):
    """Features as the matching sees them: per-position unit vectors, in
    bf16."""
    f = rng.randn(*shape).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    return np.asarray(jnp.asarray(f, jnp.bfloat16).astype(jnp.float32))


def _plain_scores(fin, fref):
    """The f32 scores the port's plain version ranks, (pairs, n_in, n_ref),
    from bf16 features."""
    pin = correlation.sample_patches(fin).float()
    pref = correlation.sample_patches(fref)
    pref = pref / correlation.add_scalar(
        correlation.l2_norm(pref, -1, keepdim=True), 1e-5)
    return torch.matmul(pin, pref.float().transpose(-1, -2))


# index equality is required where the plain scores' best and second best
# differ by more than this share of their largest magnitude: the f32 rule
# (1e-4) is kept, since the two versions sum the same exact products
K1_IDX_GAP = 1e-4
K1_VAL_TOL = 1e-6                   # relative to max |val|: f32 sum order


@pytest.mark.parametrize('norm_input', [True, False])
def test_feature_match_bf16_matches_jax(norm_input):
    """Three pairs of 14x13 bf16 maps of 16 channels (d 144): the value
    within K1_VAL_TOL of the JAX package's, and the same index wherever
    the top-2 gap of the plain scores exceeds K1_IDX_GAP."""
    rng = np.random.RandomState(0)
    fin, fref = _unit_bf16(rng, 2, 3, 14, 13, 16)
    idx_jax, val_jax = zip(*(jax_match(
        jnp.asarray(fin[p], jnp.bfloat16), jnp.asarray(fref[p], jnp.bfloat16),
        norm_input=norm_input) for p in range(3)))
    idx_jax, val_jax = np.stack(idx_jax), np.stack(val_jax)
    assert val_jax.dtype == np.float32
    tin, tref = (torch.from_numpy(a).to(BF) for a in (fin, fref))
    idx, val = correlation.feature_match_index(tin, tref,
                                               norm_input=norm_input)
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    assert _rel(val.numpy(), val_jax) <= K1_VAL_TOL
    top2 = torch.topk(_plain_scores(tin, tref), 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).reshape(idx.shape).numpy()
    clear = gap > K1_IDX_GAP * float(top2.abs().max())
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[clear], idx_jax[clear])
    # on near-ties both pick a patch within the gap of the best
    assert (idx.numpy() == idx_jax).mean() > 0.99


def test_feature_match_bf16_ties_go_to_the_lowest_index():
    """Entries in {-1, 0, 1}, exact in bf16, with the ref normalisation
    off: every score is an exact integer, ties are common, and the port
    and the JAX package both return the lowest index of each maximum."""
    rng = np.random.RandomState(1)
    fin = rng.randint(-1, 2, (2, 15, 16, 2)).astype(np.float32)
    fref = rng.randint(-1, 2, (2, 15, 16, 2)).astype(np.float32)
    tin, tref = (torch.from_numpy(a).to(BF) for a in (fin, fref))
    idx, val = correlation.feature_match_index(tin, tref, is_norm=False,
                                               chunk=64)
    scores = torch.matmul(correlation.sample_patches(tin).float(),
                          correlation.sample_patches(tref).float()
                          .transpose(1, 2)).numpy()
    best = scores.max(-1)
    tied = (scores == best[..., None]).sum(-1) > 1
    assert tied.sum() > 100
    lowest = (scores == best[..., None]).argmax(-1)
    np.testing.assert_array_equal(idx.numpy().reshape(lowest.shape), lowest)
    np.testing.assert_array_equal(val.numpy().reshape(best.shape), best)
    for p in range(2):
        i_jax, v_jax = jax_match(jnp.asarray(fin[p], jnp.bfloat16),
                                 jnp.asarray(fref[p], jnp.bfloat16),
                                 is_norm=False, chunk=64)
        np.testing.assert_array_equal(idx.numpy()[p], np.asarray(i_jax))
        np.testing.assert_array_equal(val.numpy()[p], np.asarray(v_jax))


def test_bf16_norms_round_as_xla_does():
    """The ref-patch and per-position norms: bit for bit the JAX
    package's bf16 ``x / (norm(x) + eps)``."""
    rng = np.random.RandomState(2)
    x = rng.randn(40, 300).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    for eps in (1e-5, 1e-12):
        want = jax.jit(lambda t: t / (jnp.linalg.norm(
            t, axis=1, keepdims=True) + eps))(xb)
        t = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(BF)
        got = t / correlation.add_scalar(
            correlation.l2_norm(t, 1, keepdim=True), eps)
        np.testing.assert_array_equal(_np(got),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize('input_stride', [1, 2])
@pytest.mark.parametrize('ref_stride', [1, 2])
def test_bf16_prologue_rounds_as_jax_does(input_stride, ref_stride):
    """The K1 prologue's plain version at bf16 (the CUDA prologue is held
    to it on the card): the input patches, the ref patches over their norm
    + 1e-5 and the input norms bit for bit the JAX package's bf16
    ``sample_patches`` / ``norm + 1e-5`` / divide (correlation.py:20,
    :70-71, :101), jitted as ``feature_match_index`` is, at patch size 3
    and the strides of the sharded tests."""
    rng = np.random.RandomState(5)
    fin, fref = _unfold_inputs(rng)
    pin, pref, norm = correlation._prologue_ref(
        torch.from_numpy(fin).to(BF), torch.from_numpy(fref).to(BF), 3,
        input_stride, ref_stride, True)
    assert pin.dtype == pref.dtype == norm.dtype == BF

    @jax.jit
    def jax_prologue(a, b):
        pin_j = jax_corr.sample_patches(a, 3, input_stride)
        pref_j = jax_corr.sample_patches(b, 3, ref_stride)
        pref_j = pref_j / (jnp.linalg.norm(pref_j, axis=1, keepdims=True)
                           + 1e-5)
        return pin_j, pref_j, jnp.linalg.norm(pin_j, axis=1)

    for p in range(2):
        got = jax_prologue(jnp.asarray(fin[p], jnp.bfloat16),
                           jnp.asarray(fref[p], jnp.bfloat16))
        for ours, want in zip((pin[p], pref[p], norm[p]), got):
            assert want.dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                _np(ours), np.asarray(want.astype(jnp.float32)))


def _unfold_inputs(rng):
    """Two pairs of unequal bf16 maps of 32 channels (d 288), on a scale
    where the sums of squares spread over many bf16 roundings."""
    fin = rng.randn(2, 11, 10, 32).astype(np.float32)
    fref = rng.randn(2, 12, 9, 32).astype(np.float32) * 3
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)  # noqa: E731
                              .astype(jnp.float32))
    return bf(fin), bf(fref)


@pytest.fixture(scope='module')
def sharded_reports(tmp_path_factory):
    """K6 at bf16 on 2 ranks: a ref of 18 rows in two overlapping bands of
    10, with the normalisation, and the tie case of
    test_torch_sharded_match.py."""
    rng = np.random.RandomState(3)
    fin = torch.from_numpy(_unit_bf16(rng, 14, 16, 8)).to(BF)
    fref = torch.from_numpy(_unit_bf16(rng, 18, 16, 8)).to(BF)
    tie_in = rng.randint(-1, 2, (18, 16, 2)).astype(np.float32)
    tie_ref = rng.randint(-1, 2, (18, 16, 2)).astype(np.float32)
    tie_ref[2:5] = tie_ref[12:15]
    tie_in[6:9, 3:6] = tie_ref[12:15, 7:10]
    cases = {
        'norm': {'feat_in': fin, 'feat_ref': fref,
                 'bands': [(0, 10), (8, 18)],
                 'kwargs': {'norm_input': True, 'chunk': 64}},
        'tie': {'feat_in': torch.from_numpy(tie_in).to(BF),
                'feat_ref': torch.from_numpy(tie_ref).to(BF),
                'bands': [(0, 10), (8, 18)],
                'kwargs': {'is_norm': False, 'chunk': 64}}}
    reports = worker.spawn('sharded_match', {'cases': cases},
                           tmp_path_factory.mktemp('k6_bf16'), 2)
    return cases, reports


@pytest.mark.parametrize('name', ['norm', 'tie'])
def test_sharded_match_bf16_matches_k1_bf16(sharded_reports, name):
    """Every rank's answer, kernel path and plain, is K1's at bf16 on the
    whole ref: the same index, ties across the band boundary to the lowest
    global index, and the value within K1_VAL_TOL."""
    cases, reports = sharded_reports
    case = cases[name]
    want_idx, want_val = correlation.feature_match_index(
        case['feat_in'], case['feat_ref'], **case['kwargs'])
    for report in reports:
        for version in ('kernel', 'plain'):
            idx, val = report[name][version]
            assert val.dtype == torch.float32
            torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
            assert _rel(val.numpy(), want_val.numpy()) <= K1_VAL_TOL
        assert report['kernel_launches'] == 0          # CPU ranks


# ------------------------------------------------------------- K2 and K4
# forward and every gradient against the JAX package's bf16 function:
# within DCN_TOL of each tensor's largest entry, where the JAX function's
# bf16 corner weights and sums move its results by up to a bf16 ulp.
# Measured with these inputs: forward 0.64-0.97 EPS, gradients 0.59-1.19
# EPS. The bias gradient is apart: JAX sums it over the positions in bf16
# (XLA reduces a bf16 broadcast's cotangent in bf16: -1.203 where the f32
# sum of the cotangent is -0.8146, here), the port in f32; it is held to
# the f32 sum of the cotangent within half a bf16 ulp, and to JAX's within
# BIAS_GRAD_TOL (measured up to 2.8 EPS).
DCN_TOL = 2 * EPS
BIAS_GRAD_TOL = 6 * EPS


def _dcn_case(seed, n=2, h=7, w=9, c=16, cout=12, dg=2, spread=1.5):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c)
    offset = rng.randn(n, h, w, dg, 9, 2) * spread
    mask = rng.rand(n, h, w, dg, 9)
    weight = rng.randn(3, 3, c, cout) * 0.1
    bias = rng.randn(cout)
    cot = rng.randn(n, h, w, cout)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    # bf16 x, mask, weight, bias and cotangent; f32 offset (JAX's promotion
    # of a bf16 residual plus the f32 pre-offset)
    return (bf(x), offset.astype(np.float32), bf(mask), bf(weight), bf(bias),
            bf(cot))


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(BF)
    return torch.from_numpy(a)


def _check_against_jax(fn_jax, fn_port, inputs, cot):
    out_jax, vjp = jax.vjp(fn_jax, *(jnp.asarray(a) for a in inputs))
    grads_jax = vjp(jnp.asarray(cot))
    args = [_to_torch(a).requires_grad_() for a in inputs]
    out = fn_port(*args)
    assert out.dtype == BF and out_jax.dtype == jnp.bfloat16
    grads = torch.autograd.grad(out, args, _to_torch(cot))
    errs = {'out': _rel(_np(out), out_jax.astype(jnp.float32))}
    for i, (g, gj) in enumerate(zip(grads, grads_jax)):
        assert str(g.dtype).split('.')[-1] == str(gj.dtype), i
        errs[i] = _rel(_np(g), np.asarray(gj.astype(jnp.float32)))
    if len(inputs) == 5:
        _check_bias_grad(_np(grads[4]), errs.pop(4), cot)
    assert max(errs.values()) <= DCN_TOL, errs
    return errs


def _check_bias_grad(got, err_jax, cot):
    exact = cot.astype(np.float32).reshape(-1, cot.shape[-1]).sum(0)
    assert _rel(got, exact) <= EPS / 2
    assert err_jax <= BIAS_GRAD_TOL


@pytest.mark.parametrize('spread', [0.7, 4.0])
def test_mdcn_bf16_matches_jax(spread):
    """DCNv2, 2 deform groups of 8 channels: the output bf16, the grads
    of x, mask, weight and bias bf16, of the offset f32."""
    *inputs, cot = _dcn_case(0, spread=spread)
    kw = dict(deform_groups=2)
    _check_against_jax(
        lambda *a: jax_dcn.modulated_deform_conv2d(*a, **kw),
        lambda *a: dcn.modulated_deform_conv2d(*a, **kw), inputs, cot)


@pytest.mark.parametrize('spread', [0.7, 4.0])
def test_deform_sample_bf16_matches_jax(spread):
    x, offset, *_ = _dcn_case(1, spread=spread)
    flow = offset[..., 0, :]
    cot = np.asarray(jnp.asarray(np.random.RandomState(2).randn(*x.shape),
                                 jnp.bfloat16))
    _check_against_jax(jax_dcn.deform_sample, dcn.deform_sample, (x, flow),
                       cot)


def test_deform_sample_bf16_copies_x_at_integer_flows():
    """Integer flows copy x bit for bit, in bf16 too (P1's gather)."""
    x, offset, *_ = _dcn_case(3)
    flow = np.round(offset[..., 0, :] * 2)
    got = dcn.deform_sample(_to_torch(x), torch.from_numpy(flow))
    want = jax_dcn.deform_sample(jnp.asarray(x), jnp.asarray(flow))
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize('grad_x', [False, True])
def test_mdcn_bf16_function_launches_the_bf16_entry_points(monkeypatch,
                                                            grad_x):
    """The Function of the CUDA path at bf16, with PyTorch stand-ins for
    the C entry points (test_torch_dcn.py): one launch of the fused
    forward per call however small the column cap (no chunks, no column
    matrix); then one of dgrad (its scatter variant only where x needs a
    gradient) and one of wgrad; then one of the ordered sum of the
    grad-weight and grad-bias partials; none of the f32 entry points or
    K3's and K5's; and agreement with the JAX package as the plain
    version."""
    _check_function_launches(monkeypatch, grad_x, cout=16)


def test_mdcn_bf16_function_splits_a_wide_layer(monkeypatch):
    """A layer wider than 64 output channels, which the kernels pad to a
    tile 128 wide, launches the same entry points and agrees with JAX."""
    _check_function_launches(monkeypatch, False, cout=72)


def _check_function_launches(monkeypatch, grad_x, cout):
    launched = test_torch_dcn._stand_in_kernels(monkeypatch)
    monkeypatch.setattr(dcn, 'COL_CAP_BYTES', 40 * 9 * 16 * 2)  # 40 rows
    *inputs, cot = _dcn_case(4, cout=cout)      # the kernels': 8 | Cout
    args = [_to_torch(a).requires_grad_(i > 0 or grad_x)
            for i, a in enumerate(inputs)]
    geom = dcn._geometry(*args[:4], 1, 1, 1, 1, 2)
    assert len(dcn._row_chunks(2 * 7 * 9, 9, 16, 2)) > 1
    out = dcn._ModulatedDeformConv2d.apply(*args, geom, 1)
    assert launched == ['mdcn_fused_fwd_bf16']
    (out.float() * _to_torch(cot).float()).sum().backward()
    assert launched == test_torch_dcn.fused_launches(1, True, grad_x,
                                                     '_bf16')
    out_jax, vjp = jax.vjp(
        lambda *a: jax_dcn.modulated_deform_conv2d(*a, deform_groups=2),
        *(jnp.asarray(a) for a in inputs))
    assert _rel(_np(out), out_jax.astype(jnp.float32)) <= DCN_TOL
    for i, (a, gj) in enumerate(zip(args, vjp(jnp.asarray(cot)))):
        if i == 0 and not grad_x:
            assert a.grad is None
            continue
        assert a.grad.dtype == a.dtype
        err = _rel(_np(a.grad), np.asarray(gj.astype(jnp.float32)))
        if i == 4:
            _check_bias_grad(_np(a.grad), err, cot)
        else:
            assert err <= DCN_TOL, i


@pytest.mark.parametrize('agg', ['DynAgg', 'FlowAgg'])
def test_aggregation_hands_the_kernels_the_promoted_dtypes(monkeypatch, agg):
    """At bf16, DynAgg adds its bf16 offset residual to the f32 pre-offsets
    and FlowAgg its flow residual: JAX's promotion makes the offset (flow)
    f32, which ``jax.make_jaxpr`` shows as an f32 add; the port hands K2
    (K4) the same: x and the mask bf16, the offset (flow) f32."""
    from mrefsr_tpu.archs import ref_mrapa_restoration_arch as jax_arch
    from mrefsr_tpu_torch.archs import ref_mrapa_restoration_arch as arch
    from mrefsr_tpu_torch.models.base_model import cast_tensors
    c, dg = 16, 2
    bf = jnp.bfloat16
    x = jnp.zeros((1, 6, 6, c), bf)
    pre = jnp.zeros((1, 6, 6, 9, 2), jnp.float32)
    module = (jax_arch.DynAgg(c, c, 3, deform_groups=dg) if agg == 'DynAgg'
              else jax_arch.FlowAgg(c, c, deform_groups=dg))
    variables = module.init(jax.random.PRNGKey(0), x.astype(jnp.float32),
                            x.astype(jnp.float32), pre)
    variables = jax.tree_util.tree_map(lambda v: v.astype(bf), variables)
    jaxpr = str(jax.make_jaxpr(module.apply)(variables, x, x, pre))
    shape = '6,6,2,9,2' if agg == 'DynAgg' else '6,6,2,2'
    adds = [line for line in jaxpr.replace(' ', '').splitlines()
            if f'[1,{shape}]=add' in line]
    assert adds and all(':f32[' in line for line in adds), adds

    seen = {}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            seen[name] = [a.dtype for a in args if torch.is_tensor(a)]
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(arch, 'modulated_deform_conv2d', spy(
        'mdcn', arch.modulated_deform_conv2d))
    monkeypatch.setattr(arch, 'deform_sample', spy('sample',
                                                   arch.deform_sample))
    with torch.device('meta'):
        net = (arch.DynAgg(c, c, 3, deform_groups=dg) if agg == 'DynAgg'
               else arch.FlowAgg(c, c, deform_groups=dg))
    net.to_empty(device='cpu')
    for p in net.parameters():
        torch.nn.init.normal_(p, std=0.1)
    xt = torch.zeros((1, c, 6, 6), dtype=BF)
    out = torch.func.functional_call(net, cast_tensors(net, BF),
                                     (xt, xt, torch.zeros((1, 6, 6, 9, 2))))
    assert out.dtype == BF
    if agg == 'DynAgg':   # x, offset, mask, weight, bias
        assert seen['mdcn'] == [BF, torch.float32, BF, BF, BF]
    else:                 # x, flow
        assert seen['sample'] == [BF, torch.float32]


def _grouped_dcn_case(seed, groups, dg, padding=1, cout=16):
    """:func:`_dcn_case` for K3 and K5: a ``(3, 3, C / groups, Cout)``
    weight, and the offset, mask and cotangent of the output map that
    ``padding`` gives (7x9 -> 5x7 at padding 0)."""
    rng = np.random.RandomState(seed)
    n, h, w, c = 2, 7, 9, 16
    ho, wo = h + 2 * padding - 2, w + 2 * padding - 2
    x = rng.randn(n, h, w, c)
    offset = rng.randn(n, ho, wo, dg, 9, 2) * 1.5
    mask = rng.rand(n, ho, wo, dg, 9)
    weight = rng.randn(3, 3, c // groups, cout) * 0.1
    bias = rng.randn(cout)
    cot = rng.randn(n, ho, wo, cout)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    return (bf(x), offset.astype(np.float32), bf(mask), bf(weight), bf(bias),
            bf(cot))


@pytest.mark.parametrize('groups,dg', [(2, 2), (2, 1), (4, 4)])
def test_mdcn_groups_bf16_matches_jax(groups, dg):
    """K3 at bf16 (conv groups 2 and 4, deform groups inside one conv
    group, across two, and as fine): the output and every gradient within
    DCN_TOL of ``jax.vjp`` of the JAX package's bf16 function, grad bias
    within BIAS_GRAD_TOL and half a bf16 ulp of the exact f32 sum."""
    *inputs, cot = _grouped_dcn_case(30, groups, dg)
    kw = dict(groups=groups, deform_groups=dg)
    _check_against_jax(
        lambda *a: jax_dcn.modulated_deform_conv2d(*a, **kw),
        lambda *a: dcn.modulated_deform_conv2d(*a, **kw), inputs, cot)


@pytest.mark.parametrize('groups,dg', [(1, 2), (2, 2)])
def test_deform_conv2d_bf16_matches_jax(groups, dg):
    """K5 (DCNv1, no mask, no bias) at bf16 and its default padding 0:
    the output and the gradients of x, the offset and the weight within
    DCN_TOL of the JAX package's bf16 ``jax.vjp``."""
    x, offset, _, weight, _, cot = _grouped_dcn_case(31, groups, dg,
                                                     padding=0)
    kw = dict(groups=groups, deform_groups=dg)
    errs = _check_against_jax(
        lambda *a: jax_dcn.deform_conv2d(*a, **kw),
        lambda *a: dcn.deform_conv2d(*a, **kw), (x, offset, weight), cot)
    assert set(errs) == {'out', 0, 1, 2}


@pytest.mark.parametrize('groups,dg,masked,grad_x', [
    (2, 2, True, True), (4, 2, True, False), (1, 2, False, True),
    (2, 2, False, False)])
def test_function_around_the_kernels_matches_jax_bf16(monkeypatch, groups,
                                                      dg, masked, grad_x):
    """The bf16 twin of test_torch_dcn's stand-in test for K3 (on the
    block-diagonal weight) and K5 (a null mask pointer): one fused forward
    of the variant's own bf16 entry points however small the column cap,
    then dgrad (its scatter only for grad x), wgrad and the ordered sum;
    the output and every gradient within DCN_TOL of the JAX package's
    bf16 ``jax.vjp``, grad bias as in :func:`_check_bias_grad`. (A bf16
    kernel thread loads 8 channels: a deform group holds 8 of the 16.)"""
    launched = test_torch_dcn._stand_in_kernels(monkeypatch)
    monkeypatch.setattr(dcn, 'COL_CAP_BYTES', 40 * 9 * 16 * 2)  # 40 rows
    pad = 1 if masked else 0
    x, offset, mask, weight, bias, cot = _grouped_dcn_case(
        32, groups, dg, padding=pad)
    inputs = (x, offset, mask, weight, bias) if masked else (x, offset,
                                                             weight)
    kw = dict(padding=pad, groups=groups, deform_groups=dg)
    jfn = jax_dcn.modulated_deform_conv2d if masked else \
        jax_dcn.deform_conv2d
    out_jax, vjp = jax.vjp(lambda *a: jfn(*a, **kw),
                           *(jnp.asarray(a) for a in inputs))
    args = [_to_torch(a).requires_grad_(i > 0 or grad_x)
            for i, a in enumerate(inputs)]
    out = test_torch_dcn.apply_function(args, masked, groups, dg, pad)
    assert out.dtype == BF
    assert _rel(_np(out), out_jax.astype(jnp.float32)) <= DCN_TOL
    (out.float() * _to_torch(cot).float()).sum().backward()
    for i, (a, gj) in enumerate(zip(args, vjp(jnp.asarray(cot)))):
        if i == 0 and not grad_x:
            assert a.grad is None
            continue
        assert a.grad.dtype == a.dtype
        err = _rel(_np(a.grad), np.asarray(gj.astype(jnp.float32)))
        if i == 4:
            _check_bias_grad(_np(a.grad), err, cot)
        else:
            assert err <= DCN_TOL, (i, err)
    assert launched == test_torch_dcn.fused_launches(groups, masked, grad_x,
                                                     '_bf16')


@pytest.mark.parametrize('groups,dg,masked', [
    (2, 2, True), (4, 4, True), (2, 2, False)])
def test_k3_is_k2_on_the_channel_slices_bf16(monkeypatch, groups, dg,
                                             masked):
    """test_torch_dcn's K3-against-K2-slices check at bf16: the same bf16
    products in another f32 order, each result rounded once, so at most a
    rounding apart (DCN_TOL)."""
    test_torch_dcn.k3_against_k2_slices(monkeypatch, groups, dg, masked, BF,
                                        DCN_TOL)


def test_k3_and_k5_launch_their_own_bf16_entry_points():
    """K3 and K5 take bf16 on the fused walk: each type's Kernels call that
    type's C entry points (``mdcn_bf16.cu``'s ``*_bf16_launch`` at bf16,
    ``mdcn_fused.cu``'s at f32), and each TPU kernel has Kernel objects of
    its own, so that K2's, K3's and K5's launches count apart."""
    seen = set()
    for variant in ('k2', 'k3', 'k5'):
        assert dcn._variant(*{'k2': (True, 1), 'k3': (True, 2),
                               'k5': (None, 1)}[variant]) == variant
        for dtype, library, suffix in ((BF, 'mdcn_bf16', '_bf16_launch'),
                                       (torch.float32, 'mdcn_fused',
                                        '_launch')):
            kernels = dcn._fused_kernels(dtype, variant)
            assert [k.library for k in kernels] == [library] * 5
            assert all(k.symbol.endswith(suffix) for k in kernels)
            assert not seen & {id(k) for k in kernels}
            seen |= {id(k) for k in kernels}
    assert dcn._variant(None, 4) == 'k5'


def test_bf16_kernels_state_their_vector_width():
    """At bf16 a kernel thread loads 8 channels: C, C / deform_groups and
    C / groups multiples of 8, and (K4's backward) a deform group's runs of
    8 a power of two <= 32; the offset stays f32. The fused K2 kernels
    also take a bf16 weight, bias and grad out on x's device, Cout a
    multiple of 8 and at most 256 (the widest output tile), deform_groups
    * kh * kw at most 144 (the offsets a block stages), and for the
    backward a deform group's runs of 8 a power of two <= 8 (summed by
    shuffles within a chunk of 64 channels)."""
    x = torch.zeros((1, 4, 4, 64), dtype=BF)
    offset = torch.zeros((1, 4, 4, 8, 9, 2))
    mask = torch.zeros((1, 4, 4, 8, 9), dtype=BF)
    weight = torch.zeros((3, 3, 64, 64), dtype=BF)
    dcn._check_cuda_inputs('mdcn', x, offset, mask, backward=True)  # cg 8
    dcn._check_fused_inputs(x, offset, mask, weight, weight[0, 0, 0],
                            weight[0, 0], backward=True)
    with pytest.raises(ValueError, match='multiples of 8'):
        dcn._check_fused_inputs(x[..., :48], offset[..., :4, :, :],
                                mask[..., :4, :], weight[:, :, :48])  # cg 12
    with pytest.raises(ValueError, match='power of two <= 32'):
        dcn._check_cuda_inputs('deform_sample', x[..., :48],
                               offset[..., :2, 0, :], backward=True)  # 3
    with pytest.raises(TypeError, match='float32 coordinates'):
        dcn._check_fused_inputs(x, offset.to(BF), mask, weight)
    with pytest.raises(TypeError, match='one type'):
        dcn._check_fused_inputs(x, offset, mask.float(), weight)
    with pytest.raises(TypeError, match='bfloat16 weight'):
        dcn._check_fused_inputs(x, offset, mask, weight.float())
    with pytest.raises(ValueError, match='must lie on'):
        dcn._check_fused_inputs(x, offset, mask, weight.to('meta'))
    with pytest.raises(ValueError, match='Cout to be a multiple of 8'):
        dcn._check_fused_inputs(x, offset, mask, weight[..., :12])
    with pytest.raises(ValueError, match='Cout at most 256'):
        dcn._check_fused_inputs(x, offset, mask,
                                torch.zeros((3, 3, 64, 264), dtype=BF))
    with pytest.raises(ValueError, match=r'deform_groups \* kh \* kw'):
        dcn._check_fused_inputs(x, torch.zeros((1, 4, 4, 8, 25, 2)),
                                torch.zeros((1, 4, 4, 8, 25), dtype=BF),
                                torch.zeros((5, 5, 64, 64), dtype=BF))
    wide = torch.zeros((1, 4, 4, 256), dtype=BF)          # cg 128: 16 runs
    dcn._check_fused_inputs(wide, offset[..., :2, :, :], mask[..., :2, :],
                            torch.zeros((3, 3, 256, 64), dtype=BF))
    with pytest.raises(ValueError, match='power of two <= 8'):
        dcn._check_fused_inputs(wide, offset[..., :2, :, :],
                                mask[..., :2, :],
                                torch.zeros((3, 3, 256, 64), dtype=BF),
                                backward=True)
    with pytest.raises(ValueError, match='power of two <= 8'):
        dcn._check_fused_inputs(x[..., :48], offset[..., :2, :, :],
                                mask[..., :2, :], weight[:, :, :48],
                                backward=True)            # cg 24: 3 runs


# grad offset and grad mask of the fused dgrad's arithmetic against JAX's
# bf16 vjp, by mean |err| / mean |JAX| over the tensor, with grad_col
# rounded to bf16 (as the kernel does) and not: the rounded one is closer
# for both tensors at both spreads (seed 4, C 16, Cout 16, 2 groups;
# measured: offset 0.00495 against 0.00515 at spread 0.7, 0.00483
# against 0.00499 at 4.0; mask 0.00526 against 0.00554, 0.00527 against
# 0.00553). Held by max entry the two are within noise of each other.
@pytest.mark.parametrize('spread', [0.7, 4.0])
def test_fused_dgrad_rounds_grad_col_where_jax_does(spread):
    *inputs, cot = _dcn_case(4, spread=spread, cout=16)
    _, vjp = jax.vjp(
        lambda *a: jax_dcn.modulated_deform_conv2d(*a, deform_groups=2),
        *(jnp.asarray(a) for a in inputs))
    want = [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(cot))[1:3]]
    x, offset, mask, weight, _ = (_to_torch(a) for a in inputs)
    geom = dcn._geometry(x, offset, mask, weight, 1, 1, 1, 1, 2)
    go = _to_torch(cot).reshape(-1, 16)
    errs = {}
    for rounded in (True, False):
        _, g_off, g_mask = test_torch_dcn.fused_dgrad_math(
            go, x, offset, mask, weight, geom, round_col=rounded)
        assert g_off.dtype == torch.float32 and g_mask.dtype == BF
        errs[rounded] = [float(np.abs(_np(g) - w).mean() / np.abs(w).mean())
                         for g, w in zip((g_off, g_mask), want)]
    assert all(r < u for r, u in zip(errs[True], errs[False])), errs


# ---------------------------------------------------------------- models
def _opt(alignment='dcn', train_mp=None, val_mp=None, is_train=True):
    """The JAX package's tiny multi-ref options
    (tests/test_models/test_multi_ref_model.py:9-57): ngf 8, 1 block, 2
    deform groups."""
    opt = {
        'name': 'test_bf16', 'model_type': 'MultiRefRestorationModel',
        'scale': 4, 'crop_border': 4, 'num_gpu': 1, 'manual_seed': 10,
        'is_train': is_train, 'dist': False, 'rank': 0, 'world_size': 1,
        'network_g': {'type': 'MRAPARestorationNet', 'ngf': 8,
                      'n_blocks': 1, 'groups': 2, 'alignment': alignment},
        'network_map': {'type': 'CorrespondenceGenerationArch',
                        'patch_size': 3, 'stride': 1,
                        'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                        'vgg_type': 'vgg19'},
        'network_extractor': {'type': 'ContrasMultiExtractorSep'},
        'path': {},
        'train': {
            'lr_g': 1e-4, 'lr_offset': 1e-4, 'lr_relu3_offset': 1e-6,
            'lr_relu2_offset': 1e-5, 'weight_decay_g': 0,
            'beta_g': [0.9, 0.999],
            'scheduler': {'type': 'MultiStepLR',
                          'milestones': [300000, 400000], 'gamma': 0.5},
            'total_iter': 10, 'warmup_iter': -1, 'net_g_pretrain_steps': 0,
            'pixel_criterion': 'L1Loss', 'pixel_weight': 1.0},
        'val': {'val_freq': 5, 'save_img': False},
    }
    if train_mp:
        opt['train']['mixed_precision'] = train_mp
    if val_mp:
        opt['val']['mixed_precision'] = val_mp
    return opt


def _batch(rng, b=1, t=5, gt=32):
    lq = gt // 4
    return {
        'img_in': rng.rand(b, gt, gt, 3).astype(np.float32),
        'img_in_lq': rng.rand(b, lq, lq, 3).astype(np.float32),
        'img_in_up': rng.rand(b, gt, gt, 3).astype(np.float32),
        'img_ref_list': rng.rand(b, t, gt, gt, 3).astype(np.float32),
    }


def _live_offsets(vars_g, rng):
    """Non-zero offset heads (conv_offset_mask, conv_flow_gate), so that
    sampling is fractional (a fresh net samples whole pixels only)."""
    def perturb(path, leaf):
        keys = [getattr(k, 'key', str(k)) for k in path]
        if not {'conv_offset_mask', 'conv_flow_gate'} & set(keys):
            return leaf
        scale = 0.01 if keys[-1] == 'kernel' else 1.0
        return jnp.asarray(rng.uniform(-scale, scale, leaf.shape),
                           jnp.float32)
    return dict(vars_g, params=jax.tree_util.tree_map_with_path(
        perturb, vars_g['params']))


def _torch_named(tree):
    return {k: np.asarray(v) for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


# the eval output (about [0, 1]) against the JAX bf16 eval: both round
# every activation to bf16, in other places (the DCN corners above, and
# the convolutions' sums: oneDNN's against XLA's). Measured: max 4.2e-3
# (0.54 EPS), mean 5.3e-4 (0.068 EPS), where the JAX package's own bf16
# eval is max 4.8e-3, mean 9.9e-4 from its f32 eval.
EVAL_MAX_TOL, EVAL_MEAN_TOL = EPS, EPS / 8


@pytest.fixture(scope='module')
def eval_run():
    """The JAX model's bf16 eval, and the port's bf16 and f32 evals (the
    port's f32 eval is the JAX package's within 1e-4: test_torch_slice.py),
    of one batch of T 5 refs at gt 32, from one flax init with live offset
    heads."""
    batch = _batch(np.random.RandomState(7))
    jax_bf = jax_build_model(_opt(val_mp='bfloat16', is_train=False))
    jax_bf.feed_data(batch)
    jax_bf.vars_g = _live_offsets(jax_bf.vars_g, np.random.RandomState(8))
    jax_bf.test()
    out = {'jax_bf16': np.asarray(jax_bf.output)}
    for name, mp in (('f32', None), ('bf16', 'bfloat16')):
        model = build_model(_opt(val_mp=mp, is_train=False), device='cpu')
        model.load_from_flax(jax_bf.vars_extractor, jax_bf.vars_map,
                             jax_bf.vars_g)
        model.feed_data(batch)
        model.test()
        out[name] = model.get_current_visuals()['rlt']
        out[f'{name}_model'] = model
    return out


def test_bf16_eval_matches_jax_bf16(eval_run):
    got, want = eval_run['bf16'], eval_run['jax_bf16']
    assert got.dtype == np.float32 and got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= EVAL_MAX_TOL and diff.mean() <= EVAL_MEAN_TOL, \
        (diff.max(), diff.mean())


def test_bf16_eval_is_within_the_jax_gate_of_f32(eval_run):
    """The JAX test's bounds of the bf16 eval against the f32 eval
    (tests/test_models/test_multi_ref_model.py:446-447): max 0.1, mean
    0.02. Measured: max 3.6e-3, mean 8.7e-4; the JAX package's own bf16
    eval, max 4.8e-3, mean 9.9e-4."""
    diff = np.abs(eval_run['bf16'] - eval_run['f32'])
    assert diff.max() < 0.1 and diff.mean() < 0.02
    assert diff.max() > 0                                     # bf16 ran


def test_bf16_eval_keeps_f32_weights(eval_run):
    """The bf16 copies are the model's own business: the nets keep f32
    parameters, and a second request reuses the cast copies."""
    model = eval_run['bf16_model']
    for net in model._nets():
        assert {p.dtype for p in net.parameters()} == {torch.float32}
    cached = {k: v[1] for k, v in model._cast_cache.items()}
    assert len(cached) == 3
    model.test()
    assert all(model._cast_cache[k][1] is v for k, v in cached.items())
    np.testing.assert_array_equal(model.get_current_visuals()['rlt'],
                                  eval_run['bf16'])


# The training step, from weights with live offset heads. bf16 gradients
# are noisy: every activation and every cotangent is rounded to bf16, in
# other places in the two frameworks, and that moves ReLU gates and the L1
# loss's signs. With these inputs the JAX package's own bf16 gradients are
# a median 17 % (by norm) from its f32 ones, and the port's f32 gradients
# within 1e-5 of JAX's f32 ones. So the port's bf16 gradients are held to
# JAX's bf16 ones by norm, ||g - g_jax|| / ||g_jax|| per tensor: the
# median over the tensors of more than one element within
# TRAIN_GRAD_MEDIAN, every such tensor within TRAIN_GRAD_WORST, and the
# median of the one-element tensors (PReLU slopes: sums over every
# position that cancel) within TRAIN_GRAD_ONE. Measured (dcn / flow):
# medians 0.090 / 0.080, worst 0.248 / 0.251, one-element medians 0.19 /
# 0.23. The losses (L1 of the f32 output) within TRAIN_LOSS_RTOL of JAX's
# over 3 steps: measured 7e-6 at the first, up to 8.5e-5 at the third.
TRAIN_LOSS_RTOL = 3e-4
TRAIN_GRAD_MEDIAN, TRAIN_GRAD_WORST, TRAIN_GRAD_ONE = 0.15, 0.5, 0.5
T_TRAIN, GT_TRAIN, B_TRAIN, STEPS = 3, 32, 2, 3


def _jax_bf16_grad_fn(jax_model, batch):
    """JAX's bf16 loss and gradient at the model's current weights: the
    casts of its bf16 training step
    (mrefsr_tpu/models/multi_ref_restoration_model.py:342-375)."""
    bf = jnp.bfloat16

    def cast(tree):
        return jax.tree_util.tree_map(
            lambda v: v.astype(bf) if v.dtype == jnp.float32 else v, tree)

    args = [jnp.asarray(batch[k]).astype(bf)
            for k in ('img_in_up', 'img_ref_list', 'img_in_lq')]

    def loss_fn(params, vars_ex, vars_map):
        out = jax_model._forward(cast(params), cast(vars_ex), cast(vars_map),
                                 *args)
        return jax_model.cri_pix(out.astype(jnp.float32),
                                 jnp.asarray(batch['img_in']))

    return jax.jit(jax.value_and_grad(loss_fn))


@pytest.fixture(scope='module', params=['dcn', 'flow'])
def train_run(request, tmp_path_factory):
    alignment = request.param
    batch = _batch(np.random.RandomState(0), b=B_TRAIN, t=T_TRAIN,
                   gt=GT_TRAIN)
    opt = _opt(alignment, train_mp='bfloat16')
    jax_model = jax_build_model(opt)
    jax_model.feed_data(batch)
    jax_model.vars_g = _live_offsets(jax_model.vars_g,
                                     np.random.RandomState(9))
    model = build_model(opt, device='cpu')
    model.load_from_flax(jax_model.vars_extractor, jax_model.vars_map,
                         jax_model.vars_g)
    start = {k: v.clone() for k, v in model.net_g.state_dict().items()}
    grad_fn = _jax_bf16_grad_fn(jax_model, batch)
    loss_jax, grads_jax = grad_fn(jax_model.vars_g['params'],
                                  jax_model.vars_extractor,
                                  jax_model.vars_map)
    model.feed_data(batch)
    loss = model.cri_pix(model._forward(
        model.match_img_in, model.img_ref_list, model.img_in_lq), model.gt)
    loss.backward()
    grads = {n: p.grad for n, p in model.net_g.named_parameters()}
    model.net_g.zero_grad(set_to_none=True)
    losses, losses_jax = [], []
    for step in range(1, STEPS + 1):
        jax_model.feed_data(batch)
        jax_model.optimize_parameters(step)
        losses_jax.append(float(jax_model.get_current_log()['l_pix']))
        model.feed_data(batch)
        model.optimize_parameters(step)
        losses.append(float(model.get_current_log()['l_pix']))
    root = tmp_path_factory.mktemp(f'save_{alignment}')
    model.opt['path'] = {'models': str(root / 'models'),
                         'training_states': str(root / 'states')}
    model.save(0, STEPS)
    return {'alignment': alignment, 'model': model, 'root': root,
            'fresh': ((float(loss), float(loss_jax)),
                      (grads, _torch_named(grads_jax))),
            'losses': (losses, losses_jax),
            'start': start,
            'params': ({k: v.detach().clone() for k, v in
                        model.net_g.state_dict().items()},
                       _torch_named(jax_model.vars_g['params']))}


def test_bf16_gradients_match_jax_by_name(train_run):
    (loss, loss_jax), (got, want) = train_run['fresh']
    assert loss == pytest.approx(loss_jax, rel=TRAIN_LOSS_RTOL)
    assert sorted(got) == sorted(want)
    rel, rel_one = {}, []
    for name, ref in want.items():
        assert got[name].dtype == torch.float32, name      # master grads
        err = np.linalg.norm(got[name].numpy() - ref) / np.linalg.norm(ref)
        if ref.size == 1:
            rel_one.append(err)
        else:
            rel[name] = err
    assert np.median(list(rel.values())) <= TRAIN_GRAD_MEDIAN
    assert max(rel.values()) <= TRAIN_GRAD_WORST, max(rel, key=rel.get)
    assert np.median(rel_one) <= TRAIN_GRAD_ONE


def test_bf16_loss_trajectory_matches_jax(train_run):
    got, want = train_run['losses']
    np.testing.assert_allclose(got, want, rtol=TRAIN_LOSS_RTOL)


def test_bf16_parameters_after_three_steps_match_jax(train_run):
    """Adam's first steps move each parameter by about its learning rate
    whatever the gradient's size, so where bf16 noise gives a small
    gradient the other sign the two frameworks step apart by 2 lr. Every
    entry within 2 lr a step of JAX's; 90 % of all entries within a tenth
    of a step (the f32 test holds 99 % of each tensor); the update of the
    whole net at cosine 0.98 or more with JAX's, and of each tensor of more
    than one element at 0.8 or more. Measured (dcn / flow): 4.7e-4 /
    4.1e-4 at most, 96.4 / 97.5 %, cosines 0.995 / 0.997 and 0.887 /
    0.933 at worst."""
    got, want = train_run['params']
    start = train_run['start']
    lr = 1e-4
    ours, theirs = [], []
    for name in want:
        diff = np.abs(got[name].numpy() - want[name])
        assert diff.max() <= 2 * lr * STEPS, name
        ours.append(got[name].numpy().ravel() - start[name].numpy().ravel())
        theirs.append(want[name].ravel() - start[name].numpy().ravel())
        if want[name].size > 1:
            assert _cosine(ours[-1], theirs[-1]) >= 0.8, name
    ours, theirs = np.concatenate(ours), np.concatenate(theirs)
    assert (np.abs(ours - theirs) <= 0.1 * lr).mean() >= 0.9
    assert _cosine(ours, theirs) >= 0.98


def _cosine(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_bf16_training_keeps_f32_state(train_run):
    """Master parameters, gradients and Adam's moments are f32; the
    checkpoint is f32 and loads strictly into a model built for f32."""
    model = train_run['model']
    for p in model.net_g.parameters():
        assert p.dtype == torch.float32
        state = model.optimizer_g.state[p]
        assert state['exp_avg'].dtype == state['exp_avg_sq'].dtype \
            == torch.float32
    pth = train_run['root'] / 'models' / f'net_g_{STEPS}.pth'
    saved = torch.load(pth, weights_only=True)['params']
    assert {v.dtype for v in saved.values()} == {torch.float32}
    opt = _opt(train_run['alignment'], is_train=False)
    opt['path'] = {'pretrain_network_g': str(pth), 'strict_load': True}
    f32 = build_model(opt, device='cpu')
    for name, val in f32.net_g.state_dict().items():
        torch.testing.assert_close(val, model.net_g.state_dict()[name],
                                   rtol=0, atol=0)


def test_no_autocast_on_the_bf16_path(monkeypatch):
    """The casts are the model's own: ``torch.autocast`` is never
    entered."""
    def refuse(*args, **kwargs):
        raise AssertionError('torch.autocast was entered')
    monkeypatch.setattr(torch.autocast, '__enter__', refuse)
    model = build_model(_opt('flow', 'bfloat16', 'bfloat16'), device='cpu')
    model.feed_data(_batch(np.random.RandomState(5), t=2, gt=16))
    model.test()
    model.optimize_parameters(1)
    assert np.isfinite(model.get_current_log()['l_pix'])


# ---------------------------------------------------- the shipped configs
# sections of a shipped YAML the model does not read, by name: the data
# pipeline, the logger and the launcher (read by the CLIs: see
# test_shipped_data_keys_are_accepted below and tests/test_torch_cli.py),
# and the pretrained files, which are not in the repository
NOT_FED = {'datasets', 'logger', 'dist_params', 'path', 'name', 'num_gpu'}
SHIPPED = {
    'options/train/stage3_5ref_restoration_mse.yml': ('train', 'dcn'),
    'options/train/stage3_5ref_restoration_mse_flow.yml': ('train', 'flow'),
    'options/train/stage3_5ref_restoration_mse_lp.yml': ('train', 'dcn'),
    'options/test/test_5ref_cufed5_serving.yml': ('val', 'dcn')}


@pytest.mark.parametrize('path', sorted(SHIPPED))
def test_shipped_bf16_configs_are_accepted(path):
    """The YAML's model sections as shipped, with the widths cut to ngf 8,
    1 block, 2 deform groups (``network_g`` alone) so that a request runs
    here: the model builds on the CPU with the YAML's bf16 setting and
    answers a request (and takes a step) in f32 out."""
    with open(os.path.join(REPO, path)) as f:
        shipped = yaml.safe_load(f)
    section, alignment = SHIPPED[path]
    assert shipped[section]['mixed_precision'] == 'bfloat16'
    dropped = set(shipped) - {'model_type', 'scale', 'crop_border',
                              'manual_seed', 'network_g', 'network_map',
                              'network_extractor', 'train', 'val'}
    assert dropped <= NOT_FED, dropped
    opt = {k: v for k, v in shipped.items() if k not in NOT_FED}
    opt['network_g'] = dict(opt['network_g'], ngf=8, n_blocks=1, groups=2)
    assert opt['network_g'].get('alignment', 'dcn') == alignment
    opt['is_train'] = section == 'train'
    opt['path'] = {}
    model = build_model(opt, device='cpu')
    want = {section: BF, 'val' if section == 'train' else 'train':
            torch.float32}
    assert model.eval_dtype == want['val']
    assert model.train_dtype == want['train']
    model.feed_data(_batch(np.random.RandomState(6), t=2, gt=16))
    model.test()
    assert model.output.dtype == torch.float32
    assert torch.isfinite(model.output).all()
    if section == 'train':
        model.optimize_parameters(1)
        assert np.isfinite(model.get_current_log()['l_pix'])


@pytest.mark.parametrize('path', sorted(p for p in SHIPPED
                                        if p.startswith('options/train')))
def test_shipped_data_keys_are_accepted(path, tmp_path):
    """The training set's keys of the shipped YAMLs as the CLI reads them:
    ``prefetch_mode: device`` gives the background device prefetcher, its
    queue twice ``steps_per_dispatch``; ``output_dtype: uint8`` ships uint8
    samples; ``decode_cache_size`` sizes the decode cache. Other values of
    ``prefetch_mode`` and ``output_dtype`` are refused by name."""
    import logging
    from types import SimpleNamespace

    import torch_cli_data
    from mrefsr_tpu_torch.data import (BackgroundDevicePrefetcher,
                                       build_dataset)
    from mrefsr_tpu_torch.models.multi_ref_restoration_model import \
        MultiRefRestorationModel
    from mrefsr_tpu_torch.train import _prefetcher
    with open(os.path.join(REPO, path)) as f:
        shipped = yaml.safe_load(f)
    train_set = shipped['datasets']['train']
    assert (train_set['prefetch_mode'], train_set['output_dtype'],
            train_set['decode_cache_size'],
            shipped['train']['steps_per_dispatch']) == ('device', 'uint8',
                                                        4096, 16)
    folder, ann = torch_cli_data.write_lmr(str(tmp_path), samples=1)
    train_set = dict(train_set, dataroot_in=folder, dataroot_ref=folder,
                     ann_file=ann, gt_size=32, scale=shipped['scale'])
    dataset = build_dataset(train_set, seed=0)
    assert dataset._cache_size == 4096
    sample = dataset[0]
    assert {v.dtype for v in sample.values()} == {np.dtype(np.uint8)}
    model = SimpleNamespace(
        device=torch.device('cpu'),
        device_input_keys=MultiRefRestorationModel.device_input_keys)
    opt = dict(shipped, datasets={'train': train_set})
    logger = logging.getLogger('mrefsr_tpu_torch')
    prefetcher = _prefetcher(opt, model, [sample], logger)
    assert isinstance(prefetcher, BackgroundDevicePrefetcher)
    assert prefetcher.depth == 32
    prefetcher.close()
    with pytest.raises(ValueError, match='prefetch_mode'):
        _prefetcher(dict(opt, datasets={'train': dict(
            train_set, prefetch_mode='tpu')}), model, [sample], logger)
    with pytest.raises(ValueError, match='output_dtype'):
        build_dataset(dict(train_set, output_dtype='float16'))


def test_unknown_mixed_precision_raises():
    with pytest.raises(ValueError, match='bfloat16 or unset'):
        build_model(_opt(train_mp='float16'), device='cpu')
    with pytest.raises(ValueError, match='bfloat16 or unset'):
        build_model(_opt(val_mp='fp8'), device='cpu')
