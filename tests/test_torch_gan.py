"""The port's GAN phase against the JAX package's, on the CPU: the
discriminator and its batch norm, every loss of the phase (values and
gradients by ``jax.grad``), ``MultiRefRestorationModel``'s pixel -> GAN
trajectory for both alignments from one flax init, the f32 rule under
``train.mixed_precision: bfloat16``, two gloo ranks against one process on
the global batch, and save / resume with the discriminator."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from mrefsr_tpu.archs.discriminator_arch import \
    ImageDiscriminator as JaxDiscriminator
from mrefsr_tpu.convert import flax_to_torch
from mrefsr_tpu.losses import legacy_losses as jax_legacy
from mrefsr_tpu.losses import losses as jax_losses
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu_torch.archs.discriminator_arch import ImageDiscriminator
from mrefsr_tpu_torch.convert import (state_dict_from_flax,
                                      state_dict_from_flax_variables)
from mrefsr_tpu_torch.losses import legacy_losses, losses
from mrefsr_tpu_torch.models import base_model, build_model
from mrefsr_tpu_torch.parallel.batch_norm import BatchNorm2d, frozen_stats

LR = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The test workers of one run share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _torch_named(tree):
    return {k: np.asarray(v) for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _torch_stats(batch_stats):
    """A flax ``batch_stats`` tree as the port's buffer names."""
    out = {}
    for key, val in state_dict_from_flax_variables(
            {'params': {}, 'batch_stats': jax.tree_util.tree_map(
                np.asarray, batch_stats)}).items():
        out[key] = val.numpy()
    return out


def _plain_norms(net):
    """``net`` with every :class:`BatchNorm2d` swapped for torch's
    ``nn.BatchNorm2d`` (momentum 0.1, eps 1e-5) holding the same values."""
    for module in list(net.modules()):
        for name, child in list(module.named_children()):
            if isinstance(child, BatchNorm2d):
                plain = torch.nn.BatchNorm2d(child.weight.numel(),
                                             momentum=0.1, eps=1e-5)
                plain.load_state_dict(child.state_dict())
                setattr(module, name, plain.to(child.weight.device))
    return net


# ----------------------------------------------------------- discriminator
@pytest.fixture(scope='module')
def disc():
    """flax's ImageDiscriminator (ndf 4) in train mode on a (2, 32, 32, 3)
    batch: the last block's norm sees n = 2 values a channel."""
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    net = JaxDiscriminator(in_nc=3, ndf=4)
    variables = net.init(jax.random.PRNGKey(3), jnp.asarray(x))
    out, updates = net.apply(variables, jnp.asarray(x), train=True,
                             mutable=['batch_stats'])
    return {'x': x, 'variables': variables, 'out': np.asarray(out),
            'stats': _torch_stats(updates['batch_stats']),
            'eval': np.asarray(net.apply(variables, jnp.asarray(x)))}


def _port_disc(variables):
    net = ImageDiscriminator(in_nc=3, ndf=4)
    net.load_state_dict(state_dict_from_flax_variables(variables),
                        strict=True)
    return net


def test_discriminator_names_follow_the_torch_sequential(disc):
    keys = set(ImageDiscriminator(ndf=4).state_dict())
    for block in range(1, 6):
        for i in (0, 3):
            assert f'conv_block{block}.{i}.weight' in keys
        for i in (1, 4):
            assert f'conv_block{block}.{i}.running_var' in keys
            assert f'conv_block{block}.{i}.num_batches_tracked' in keys
    assert {'out_block.1.weight', 'out_block.3.bias'} <= keys
    assert set(state_dict_from_flax_variables(disc['variables'])) \
        == keys - {k for k in keys if k.endswith('num_batches_tracked')}


# Measured: output within 3e-7, the running statistics within 2e-7
# (relative to each buffer's largest entry).
D_TOL = 1e-5


def test_discriminator_train_mode_matches_flax(disc):
    """The output, the new running mean and the new running variance of
    one training-mode forward, against flax's ``mutable=['batch_stats']``
    apply."""
    net = _port_disc(disc['variables']).train()
    out = net(_nchw(disc['x'])).detach().numpy()
    np.testing.assert_allclose(out, disc['out'], rtol=D_TOL, atol=D_TOL)
    state = net.state_dict()
    for key, want in disc['stats'].items():
        got = state[key].numpy()
        assert np.abs(got - want).max() <= D_TOL * np.abs(want).max(), key
    assert all(int(v) == 1 for k, v in state.items()
               if k.endswith('num_batches_tracked'))


def test_discriminator_eval_mode_uses_the_running_statistics(disc):
    net = _port_disc(disc['variables']).eval()
    with torch.no_grad():
        out = net(_nchw(disc['x'])).numpy()
    np.testing.assert_allclose(out, disc['eval'], rtol=D_TOL, atol=D_TOL)


def test_plain_batch_norm_fails_the_running_variance(disc):
    """torch's ``nn.BatchNorm2d`` stores the unbiased variance: with n = 2
    in the last block its running variance is off by 0.1 * v, which the
    tolerance above does not pass."""
    net = _plain_norms(_port_disc(disc['variables'])).train()
    net(_nchw(disc['x']))
    key = 'conv_block5.4.running_var'
    got, want = net.state_dict()[key].numpy(), disc['stats'][key]
    assert np.abs(got - want).max() > 100 * D_TOL * np.abs(want).max()


def test_frozen_stats_normalise_by_the_batch_and_write_nothing(disc):
    net = _port_disc(disc['variables']).train()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with frozen_stats(net):
        out = net(_nchw(disc['x'])).detach().numpy()
    np.testing.assert_allclose(out, disc['out'], rtol=D_TOL, atol=D_TOL)
    for key, val in net.state_dict().items():
        torch.testing.assert_close(val, before[key], rtol=0, atol=0)
    assert all(m.update_stats for m in net.modules()
               if isinstance(m, BatchNorm2d))


# ------------------------------------------------------------------ losses
def _grad_check(got, want, tol):
    """``got`` within ``tol`` of ``want``, relative to ``want``'s largest
    entry."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.fixture(scope='module')
def images():
    rng = np.random.RandomState(1)
    return {'x': rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1,
            'gt': rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1,
            'mask': rng.rand(2, 32, 32, 1).astype(np.float32)}


# The JAX side's Charbonnier gradient d / sqrt(d^2 + eps) came out up to
# 3e-4 of its largest entry off in one run of the whole suite (the same
# test alone: 1.8e-7), where the persistent compilation cache handed XLA's
# CPU code compiled elsewhere; the port's is exact division.
MASKED_GRAD_TOL = {'charbonnier_loss': 1e-3}


@pytest.mark.parametrize('name', ['l1_loss', 'mse_loss', 'charbonnier_loss'])
@pytest.mark.parametrize('masked', [False, True])
def test_masked_losses_match_jax(images, name, masked):
    mask = images['mask'] if masked else None
    want, want_grad = jax.value_and_grad(
        lambda x: getattr(jax_legacy, name)(
            x, jnp.asarray(images['gt']),
            None if mask is None else jnp.asarray(mask)))(
        jnp.asarray(images['x']))
    x = _t(images['x'], True)
    got = getattr(legacy_losses, name)(
        x, _t(images['gt']), None if mask is None else _t(mask))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    _grad_check(x.grad, want_grad, MASKED_GRAD_TOL.get(name, 1e-6))


def test_charbonnier_and_masked_tv_match_jax(images):
    jx, gt, mask = (jnp.asarray(images[k]) for k in ('x', 'gt', 'mask'))
    for jax_fn, fn in (
            (lambda x: jax_losses.CharbonnierLoss(0.5)(x, gt),
             lambda x: losses.CharbonnierLoss(0.5)(x, _t(images['gt']))),
            (lambda x: jax_legacy.MaskedTVLoss(0.7)(x, mask),
             lambda x: legacy_losses.MaskedTVLoss(0.7)(x, _t(images['mask']))),
            (lambda x: jax_legacy.MaskedTVLoss()(x),
             lambda x: legacy_losses.MaskedTVLoss()(x))):
        want, want_grad = jax.value_and_grad(jax_fn)(jx)
        x = _t(images['x'], True)
        got = fn(x)
        got.backward()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        _grad_check(x.grad, want_grad, 1e-6)


def _vgg_pair(jax_loss, port_loss, seed=0):
    """Seeded flax VGG variables for ``jax_loss``, the same weights in
    ``port_loss.vgg``."""
    variables = jax_loss.vgg.init(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, 32, 32, 3), jnp.float32))
    port_loss.vgg.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables['params'])), strict=True)
    return variables


# Measured with these inputs: values within 4.4e-6 (relative), gradients
# within 6.9e-7 of their largest entry (VGG19 to relu5_1 sums its
# convolutions in another order than XLA).
VGG_TOL = 1e-5
PERCEPTUAL = {'layer_weights': {'relu1_1': 1.0, 'relu2_1': 0.5,
                                'relu5_1': 1.0},
              'perceptual_weight': 1.0, 'style_weight': 0.5}


@pytest.mark.parametrize('criterion', ['l1', 'l2', 'fro'])
@pytest.mark.parametrize('kind', ['legacy', 'modern', 'multi'])
def test_perceptual_losses_match_jax(images, criterion, kind):
    """The legacy loss (``norm_img``), the modern one (``range_norm``) and
    the legacy sum over a stacked axis: both terms and the gradient of
    their sum in ``x``."""
    kwargs = dict(PERCEPTUAL, criterion=criterion)
    x_np, gt_np = images['x'], images['gt']
    if kind == 'modern':
        jax_loss = jax_losses.PerceptualLoss(range_norm=True, **kwargs)
        port_loss = losses.PerceptualLoss(range_norm=True, **kwargs)
    elif kind == 'legacy':
        jax_loss = jax_legacy.PerceptualLoss(**kwargs)
        port_loss = legacy_losses.PerceptualLoss(**kwargs)
    else:
        jax_loss = jax_legacy.PerceptualLossMultiInputs(**kwargs)
        port_loss = legacy_losses.PerceptualLossMultiInputs(**kwargs)
        x_np, gt_np = x_np.reshape(1, 2, 32, 32, 3), gt_np.reshape(
            1, 2, 32, 32, 3)
    variables = _vgg_pair(jax_loss, port_loss)

    def total(x):
        p, s = jax_loss(x, jnp.asarray(gt_np), variables)
        return p + s, (p, s)

    (_, (want_p, want_s)), want_grad = jax.value_and_grad(
        total, has_aux=True)(jnp.asarray(x_np))
    x = _t(x_np, True)
    p, s = port_loss(x, _t(gt_np))
    (p + s).backward()
    np.testing.assert_allclose(float(p), float(want_p), rtol=VGG_TOL)
    np.testing.assert_allclose(float(s), float(want_s), rtol=VGG_TOL)
    _grad_check(x.grad, want_grad, VGG_TOL)


def test_gram_mat_matches_jax():
    f = np.random.RandomState(2).rand(2, 5, 6, 7).astype(np.float32)
    np.testing.assert_allclose(losses.gram_mat(_t(f)).numpy(),
                               np.asarray(jax_losses.gram_mat(jnp.asarray(f))),
                               rtol=1e-6)


@pytest.fixture(scope='module')
def penalty_case():
    """A flax discriminator at 64 x 64 (its last norm sees n = 8 values:
    at n = 2 the input gradient of a normalised pair depends on eps / d^3
    and amplifies rounding), the interpolation key and JAX's draw."""
    rng = np.random.RandomState(3)
    real = rng.rand(2, 64, 64, 3).astype(np.float32)
    fake = rng.rand(2, 64, 64, 3).astype(np.float32)
    net = JaxDiscriminator(in_nc=3, ndf=4)
    variables = net.init(jax.random.PRNGKey(4), jnp.asarray(real))
    key = jax.random.PRNGKey(5)
    alpha = np.asarray(jax.random.uniform(key, (2, 1, 1, 1), jnp.float32))
    weight = rng.rand(2, 64, 64, 1).astype(np.float32)
    return {'real': real, 'fake': fake, 'net': net, 'variables': variables,
            'key': key, 'alpha': alpha, 'weight': weight}


# Measured: the penalties within 1e-6 (relative), the discriminator's
# gradients (the double backward) within 5.1e-5 of each tensor's largest
# entry, but for the conv biases before a train-mode norm: their gradient
# is exactly 0, and both frameworks' are rounding noise, at most 1.3e-6 of
# their conv weight's largest gradient here.
PENALTY_TOL, PENALTY_GRAD_TOL, NOISE_TOL = 1e-5, 2e-4, 1e-5


def _pre_norm_bias(name):
    """A conv bias feeding a train-mode norm: its gradient is exactly 0
    (the norm takes any shift out), so each framework's is rounding noise
    and an Adam step on it has a random sign."""
    parts = name.split('.')
    return parts[0].startswith('conv_block') and parts[1] in ('0', '3') \
        and parts[2] == 'bias'


@pytest.mark.parametrize('form', ['legacy', 'modern', 'modern_weight'])
def test_gradient_penalties_match_jax(penalty_case, form):
    c = penalty_case
    net, variables = c['net'], c['variables']
    weight = c['weight'] if form == 'modern_weight' else None

    def jax_penalty(params):
        def disc_fn(z):
            return net.apply({'params': params,
                              'batch_stats': variables['batch_stats']}, z,
                             train=True, mutable=['batch_stats'])[0]
        real, fake = jnp.asarray(c['real']), jnp.asarray(c['fake'])
        if form == 'legacy':
            return jax_legacy.GradientPenaltyLoss(10.)(disc_fn, real, fake,
                                                       c['key'])
        return jax_losses.gradient_penalty_loss(
            disc_fn, real, fake, c['key'],
            None if weight is None else jnp.asarray(weight))

    want, want_grads = jax.value_and_grad(jax_penalty)(variables['params'])
    port = _port_disc(variables).train()

    def disc_fn(z):
        return port(z.permute(0, 3, 1, 2))

    with frozen_stats(port):
        if form == 'legacy':
            got = legacy_losses.GradientPenaltyLoss(10.)(
                disc_fn, _t(c['real']), _t(c['fake']), alpha=_t(c['alpha']))
        else:
            got = losses.gradient_penalty_loss(
                disc_fn, _t(c['real']), _t(c['fake']), alpha=_t(c['alpha']),
                weight=None if weight is None else _t(weight))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=PENALTY_TOL)
    want_grads = _torch_named(want_grads)
    grads = {name: p.grad.numpy() for name, p in port.named_parameters()}
    for name, grad in grads.items():
        if _pre_norm_bias(name):
            weight = grads[name[:-len('bias')] + 'weight']
            assert np.abs(grad).max() <= NOISE_TOL * np.abs(weight).max(), \
                name
            continue
        _grad_check(grad, want_grads[name], PENALTY_GRAD_TOL)


def test_gradient_penalty_draws_from_a_generator(penalty_case):
    c = penalty_case
    port = _port_disc(c['variables']).train()

    def penalty(seed):
        with frozen_stats(port):
            return float(legacy_losses.GradientPenaltyLoss()(
                lambda z: port(z.permute(0, 3, 1, 2)), _t(c['real']),
                _t(c['fake']), generator=torch.Generator().manual_seed(seed)))

    assert penalty(1) == penalty(1) != penalty(2)
    with pytest.raises(ValueError, match='alpha'):
        legacy_losses.GradientPenaltyLoss()(port, _t(c['real']),
                                            _t(c['fake']))


LAYERS = (('relu1_1', 32, 64), ('relu2_1', 16, 128), ('relu3_1', 8, 256))


@pytest.mark.parametrize('weights', ['none', 'array', 'dict'])
def test_texture_loss_matches_jax(images, weights):
    """Without weights, with one weight map (padded once, bicubic with
    ``align_corners=True`` to each layer) and with a dict of maps."""
    rng = np.random.RandomState(4)
    maps = {k: rng.rand(2, s, s, c).astype(np.float32) for k, s, c in LAYERS}
    if weights == 'array':
        w = rng.rand(2, 6, 6, 1).astype(np.float32)
    elif weights == 'dict':
        w = {k: rng.rand(2, s - 2, s - 2, 1).astype(np.float32)
             for k, s, _ in LAYERS}
    else:
        w = 0
    use = weights != 'none'
    jax_loss = jax_legacy.TextureLoss(use_weights=use, loss_weight=0.5)
    port_loss = legacy_losses.TextureLoss(use_weights=use, loss_weight=0.5)
    variables = _vgg_pair(jax_loss, port_loss)
    jw = jax.tree_util.tree_map(jnp.asarray, w)
    want, want_grad = jax.value_and_grad(
        lambda x: jax_loss(x, {k: jnp.asarray(v) for k, v in maps.items()},
                           variables, jw))(jnp.asarray(images['x']))
    x = _t(images['x'], True)
    tw = w if weights == 'none' else jax.tree_util.tree_map(_t, w)
    got = port_loss(x, {k: _t(v) for k, v in maps.items()}, tw)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=VGG_TOL)
    _grad_check(x.grad, want_grad, VGG_TOL)


@pytest.mark.parametrize('criterion', ['l1', 'l2', 'fro'])
def test_map_loss_matches_jax(images, criterion):
    rng = np.random.RandomState(5)
    swapped = {k: rng.rand(2, s, s, c).astype(np.float32)
               for k, s, c in LAYERS}
    jax_loss = jax_legacy.MapLoss(map_weight=0.3, criterion=criterion)
    port_loss = legacy_losses.MapLoss(map_weight=0.3, criterion=criterion)
    variables = _vgg_pair(jax_loss, port_loss)
    gt = (images['gt'] + 1) / 2
    want, want_grads = jax.value_and_grad(
        lambda f: jax_loss(f, jnp.asarray(gt), variables))(
        {k: jnp.asarray(v) for k, v in swapped.items()})
    feats = {k: _t(v, True) for k, v in swapped.items()}
    got = port_loss(feats, _t(gt))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=VGG_TOL)
    for k in feats:
        _grad_check(feats[k].grad, want_grads[k], VGG_TOL)


# ------------------------------------------------------------ the GAN step
GT, B, T = 64, 2, 2


def _opt(alignment, pretrain=1, percep=False, **train):
    """The JAX model tests' GAN options (ngf 8, 1 block, 2 deform groups,
    ndf 4, wgan, gan_weight 1e-5, penalty 10) with the alternation of a
    skipped G turn: ``net_d_steps`` 2, ``net_d_init_steps`` 1."""
    opt = worker.gan_opt(alignment, '', dist=False, pretrain=pretrain)
    if percep:
        opt['train']['perceptual_opt'] = {
            'layer_weights': {'relu5_1': 1.0}, 'perceptual_weight': 1e-2}
        opt['train']['style_opt'] = {
            'layer_weights': {'relu1_1': 1.0, 'relu2_1': 1.0,
                              'relu3_1': 1.0},
            'perceptual_weight': 0., 'style_weight': 1.0}
    opt['train'].update(train)
    return opt


def _batch(rng):
    return {'img_in': rng.rand(B, GT, GT, 3).astype(np.float32),
            'img_in_lq': rng.rand(B, GT // 4, GT // 4, 3).astype(np.float32),
            'img_in_up': rng.rand(B, GT, GT, 3).astype(np.float32),
            'img_ref_list': rng.rand(B, T, GT, GT, 3).astype(np.float32)}


def _port_state(model):
    net_d = {k: v.detach().numpy().copy()
             for k, v in model.net_d.state_dict().items()}
    return {'g': {k: v.detach().numpy().copy()
                  for k, v in model.net_g.state_dict().items()},
            'd': {k: v for k, v in net_d.items() if 'running' not in k
                  and 'num_batches' not in k},
            'stats': {k: v for k, v in net_d.items() if 'running' in k},
            'tracked': {int(v) for k, v in net_d.items()
                        if k.endswith('num_batches_tracked')}}


def _jax_state(model):
    return {'g': _torch_named(model.vars_g['params']),
            'd': _torch_named(model.vars_d['params']),
            'stats': _torch_stats(model.vars_d['batch_stats'])}


# the trajectory of each alignment: steps 1 (pixel), 2 (GAN, G skipped:
# (2 - 1) % 2 != 0), 3 (GAN with G), and for dcn 4 and 5 as 2 and 3
STEPS = {'dcn': 5, 'flow': 3}


def run_trajectory(alignment):
    """Both models from one flax init on one batch of B 2, T 2 at gt 64
    (the discriminator's last norm sees n = 8 values a channel; at gt 32,
    n = 2 makes its input gradient depend on eps / d^3, and the penalty
    amplifies rounding until the trajectories part), the port's penalty
    fed JAX's interpolation weights. ``flow`` also trains the perceptual
    and style losses on the seeded VGG19."""
    percep = alignment == 'flow'
    batch = _batch(np.random.RandomState(0))
    jax_model = jax_build_model(_opt(alignment, percep=percep))
    jax_model.feed_data(batch)                              # lazy init
    model = build_model(_opt(alignment, percep=percep), device='cpu')
    model.load_from_flax(
        jax_model.vars_extractor, jax_model.vars_map, jax_model.vars_g,
        jax_model.vars_d, vgg=jax_model.vgg_variables,
        vgg_style=jax_model.vgg_style_variables)
    keys, next_rng = [], jax_model.next_rng

    def recorded():
        keys.append(next_rng())
        return keys[-1]

    jax_model.next_rng = recorded
    model.penalty_alpha = lambda b, step: torch.from_numpy(np.asarray(
        jax.random.uniform(keys[-1], (b, 1, 1, 1), jnp.float32)))
    # the plain-norm model: torch's BatchNorm2d in the discriminator
    plain = build_model(_opt(alignment, percep=percep), device='cpu')
    plain.load_from_flax(
        jax_model.vars_extractor, jax_model.vars_map, jax_model.vars_g,
        jax_model.vars_d, vgg=jax_model.vgg_variables,
        vgg_style=jax_model.vgg_style_variables)
    _plain_norms(plain.net_d)
    plain.penalty_alpha = model.penalty_alpha
    steps = []
    for step in range(1, STEPS[alignment] + 1):
        jax_model.feed_data(batch)
        jax_model.optimize_parameters(step)
        model.feed_data(batch)
        model.optimize_parameters(step)
        record = {'jax_log': {k: float(v) for k, v in
                              jax_model.get_current_log().items()},
                  'log': model.get_current_log(),
                  'jax': _jax_state(jax_model), 'port': _port_state(model),
                  'rates': model.get_current_learning_rate()}
        if step <= 2:
            plain.feed_data(batch)
            plain.optimize_parameters(step)
            record['plain'] = _port_state(plain)
        steps.append(record)
    return {'alignment': alignment, 'steps': steps}


@pytest.fixture(scope='module')
def trajectory():
    """The ``dcn`` run of :func:`run_trajectory`; ``flow``'s is in
    test_torch_gan_flow.py, so that the two JAX compiles run in two test
    workers."""
    return run_trajectory('dcn')


# Measured over the trajectories: the logged losses within 3e-6
# (relative), the penalty within 4.5e-4 by the third step (it follows the
# generator's output, whose parameters part by Adam steps of noise-level
# gradients); the norms' running variances within 2e-6 of their largest
# entry.
LOG_RTOL, PENALTY_RTOL, VAR_TOL = 1e-4, 2e-3, 1e-4


def test_gan_logs_match_jax(trajectory):
    """Every logged loss of every step, under the JAX names; the pixel
    step logs ``l_pix``, a GAN step without ``g_turn`` zero G losses."""
    for step, record in enumerate(trajectory['steps'], 1):
        want, got = record['jax_log'], record['log']
        assert sorted(got) == sorted(want), step
        for key in want:
            tol = PENALTY_RTOL if key == 'l_grad_penalty' else LOG_RTOL
            np.testing.assert_allclose(got[key], want[key], rtol=tol,
                                       atol=1e-12, err_msg=f'{step} {key}')
        if step >= 2:
            g_turn = step % 2 == 1
            assert (got['l_g_gan'] != 0) == g_turn
    keys = set(trajectory['steps'][1]['log'])
    want = {'l_d_real', 'l_d_fake', 'out_d_real', 'out_d_fake',
            'l_grad_penalty', 'l_g_pix', 'l_g_gan'}
    if trajectory['alignment'] == 'flow':
        want |= {'l_g_percep', 'l_g_style'}
    assert keys == want


def _updates(step):
    """(generator, discriminator) updates after ``step`` steps."""
    gan = max(step - 1, 0)
    return 1 + gan // 2, gan


def test_gan_parameters_match_jax(trajectory):
    """After every step, each parameter of G and D: Adam's first steps
    move an entry by about its learning rate whatever the gradient's size,
    so every entry within 2 * lr * updates of the JAX value and 99 % of
    each tensor's entries within a tenth of one step; the pre-norm conv
    biases only the former."""
    for step, record in enumerate(trajectory['steps'], 1):
        g_updates, d_updates = _updates(step)
        for net, updates in (('g', g_updates), ('d', d_updates)):
            got, want = record['port'][net], record['jax'][net]
            assert sorted(got) == sorted(want)
            for name in want:
                diff = np.abs(got[name] - want[name])
                assert diff.max() <= 2 * LR * max(updates, 1) + 1e-7, \
                    (step, name)
                if not (net == 'd' and _pre_norm_bias(name)):
                    assert (diff <= 0.1 * LR + 1e-7).mean() >= 0.99, \
                        (step, name)


def test_gan_running_statistics_match_jax(trajectory):
    """The discriminator's norms: written exactly twice a GAN step (real,
    then fake), never in a pixel step; the running variance within
    ``VAR_TOL``, the running mean within the drift of the pre-norm biases
    (2 * lr * updates) besides."""
    for step, record in enumerate(trajectory['steps'], 1):
        _, d_updates = _updates(step)
        assert record['port']['tracked'] == {2 * d_updates}, step
        got, want = record['port']['stats'], record['jax']['stats']
        assert sorted(got) == sorted(want)
        for key in want:
            err = np.abs(got[key] - want[key]).max()
            if key.endswith('running_var'):
                assert err <= VAR_TOL * np.abs(want[key]).max(), (step, key)
            else:
                assert err <= 2 * LR * d_updates + VAR_TOL * np.abs(
                    want[key]).max(), (step, key)


def test_plain_batch_norm_fails_the_gan_step(trajectory):
    """torch's ``nn.BatchNorm2d`` in the discriminator writes its running
    statistics in the penalty's pass too (three writes in a GAN step
    without G, not two) and stores the unbiased variance: after the first
    GAN step its running variances leave the JAX package's."""
    record = trajectory['steps'][1]
    assert record['plain']['tracked'] == {3}
    got, want = record['plain']['stats'], record['jax']['stats']
    errs = [np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
            for k in want if k.endswith('running_var')]
    assert max(errs) > 100 * VAR_TOL


def test_gan_schedules_count_each_optimizer_s_updates(trajectory):
    """The rates the log shows are net_g's; the schedule's milestones lie
    past the run, so they stay at the base rates."""
    for record in trajectory['steps']:
        assert record['rates'] == [1e-4, 1e-4, 1e-6, 1e-5]


def test_update_counts_follow_the_jax_optax_counts():
    """Iteration i trains net_g with schedule(count) where count is the
    number of its updates before i, and net_d with the number of GAN steps
    before i: with pretrain 2, net_d_steps 3, net_d_init_steps 4 and a
    milestone at every step the rates show the counts."""
    opt = _opt('dcn', pretrain=2, net_d_steps=3, net_d_init_steps=4,
               scheduler={'type': 'MultiStepLR',
                          'milestones': list(range(1, 40)), 'gamma': 0.5})
    opt['network_g'].update(ngf=8, n_blocks=1)
    model = build_model(opt, device='cpu')
    g_count = d_count = 0
    for step in range(1, 20):
        model.update_learning_rate(step)
        assert model.schedulers[0].get_last_lr()[0] == pytest.approx(
            1e-4 * 0.5 ** g_count), step
        k = step - 2
        if k > 0:
            assert model.schedulers[1].get_last_lr()[0] == pytest.approx(
                1e-4 * 0.5 ** d_count), step
            d_count += 1
            g_count += k % 3 == 0 and k > 4
        else:
            g_count += 1


# ------------------------------------------------------------------ bf16
def test_gan_step_runs_f32_under_bf16_mixed_precision(monkeypatch):
    """``train.mixed_precision: bfloat16`` leaves a GAN step in f32: two
    GAN steps (pretrain 0, G on both) give bit for bit the numbers of the
    options without the key, and cast no parameter to bf16."""
    batch = _batch(np.random.RandomState(1))

    def run(mp):
        opt = _opt('dcn', pretrain=0, net_d_steps=1, net_d_init_steps=0)
        if mp:
            opt['train']['mixed_precision'] = mp
        model = build_model(opt, device='cpu')
        logs = []
        for step in (1, 2):
            model.feed_data(batch)
            model.optimize_parameters(step)
            logs.append(model.get_current_log())
        return logs, _port_state(model)

    want_logs, want = run(None)

    def refuse(*_):
        raise AssertionError('a GAN step cast to bf16')

    monkeypatch.setattr(base_model, 'cast_tensors', refuse)
    logs, got = run('bfloat16')
    assert logs == want_logs
    for net in ('g', 'd', 'stats'):
        for key in want[net]:
            np.testing.assert_array_equal(got[net][key], want[net][key])


# ------------------------------------------------------------ two ranks
@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('gan_ddp')
    rng = np.random.RandomState(2)
    spec = {'batches': [{k: torch.from_numpy(v) for k, v in
                         worker.batch(rng, 2, gt=GT).items()}]}
    return worker.spawn('ddp_gan', spec, tmp, world=2)


# Measured at the first step, from the same weights: the discriminator's
# gradients within 6.4e-6 of each tensor's largest entry, the generator's
# within 1.7e-5 (the ranks sum the norms' statistics, the losses' means and
# the gradients in another order than one process). The second step's
# gradients are not compared: Adam's first step moves an entry by its
# learning rate whatever its gradient's size, so a noise-level gradient of
# the other sign parts the two runs' weights by 2 lr, and two different
# forwards flip ReLU gates (chip_smoke.py's TRAIN_GRAD_REL_TOL note).
RANK_TOL = 1e-4


def test_two_ranks_are_one_process_on_the_global_batch(ranks):
    """Two gloo ranks of batch 1 and one process of batch 2, from the same
    seeded weights, over one GAN step with G: the discriminator's
    gradients (through the penalty's double backward and the rank
    reduction of the norms' sums), its running statistics and parameters,
    the generator's gradients and the logs. A tensor whose gradient is at
    noise level against its net's (a fresh offset head's) is held to the
    net's scale."""
    for rank in ranks:
        for net in ('d_grads', 'g_grads'):
            (got,), (want,) = rank[net], rank['single_' + net]
            assert sorted(got) == sorted(want)
            floor = 1e-6 * max(v.abs().max() for v in want.values())
            for name, val in want.items():
                if net == 'd_grads' and _pre_norm_bias(name):
                    continue
                scale = max(val.abs().max(), floor)
                err = (got[name] - val).abs().max() / scale
                assert err <= RANK_TOL, (net, name)
        for key, val in rank['single_d_state'].items():
            got = rank['d_state'][key]
            if key.endswith('num_batches_tracked'):
                assert int(got) == int(val) == 2
                continue
            if 'running' in key or not _pre_norm_bias(key):
                assert (got - val).abs().max() <= RANK_TOL * max(
                    val.abs().max(), 1e-3) + 2 * LR, key
        for key, val in rank['single_log'].items():
            assert rank['log'][key] == pytest.approx(val, rel=RANK_TOL,
                                                     abs=1e-9), key
    # every rank holds the same discriminator
    for key, val in ranks[0]['d_state'].items():
        torch.testing.assert_close(ranks[1]['d_state'][key], val, rtol=0,
                                   atol=0)


# --------------------------------------------------------- save / resume
def test_save_and_resume_with_the_discriminator(tmp_path):
    """``save`` at a GAN step writes ``net_d_<iter>.pth`` and a ``.state``
    of two optimizers and two schedulers, G then D; a model resumed from
    the files takes the next step as the unbroken one, bit for bit."""
    root = str(tmp_path)
    opt = _opt('dcn', pretrain=1, net_d_steps=1, net_d_init_steps=0)
    opt['path'] = {'models': f'{root}/models',
                   'training_states': f'{root}/training_states'}
    batch = _batch(np.random.RandomState(3))
    model = build_model(opt, device='cpu')
    for step in (1, 2):
        model.feed_data(batch)
        model.optimize_parameters(step)
    model.save(0, 2)
    state = torch.load(f'{root}/training_states/2.state', weights_only=True)
    assert len(state['optimizers']) == len(state['schedulers']) == 2
    assert len(state['optimizers'][0]['param_groups']) == 4   # G's groups
    assert len(state['optimizers'][1]['param_groups']) == 1   # D's
    saved_d = torch.load(f'{root}/models/net_d_2.pth', weights_only=True)
    assert sorted(saved_d['params']) == sorted(model.net_d.state_dict())
    model.feed_data(batch)
    model.optimize_parameters(3)
    want_log, want = model.get_current_log(), _port_state(model)

    resumed_opt = dict(opt, path=dict(
        opt['path'], pretrain_network_g=f'{root}/models/net_g_2.pth',
        pretrain_network_d=f'{root}/models/net_d_2.pth'))
    resumed = build_model(resumed_opt, device='cpu')
    resumed.resume_training(resumed.load_training_state(
        f'{root}/training_states/2.state'))
    for got, want_opt in zip(resumed.optimizers, state['optimizers']):
        assert got.state_dict()['param_groups'] == want_opt['param_groups']
    resumed.feed_data(batch)
    resumed.optimize_parameters(3)
    assert resumed.get_current_log() == want_log
    got = _port_state(resumed)
    for net in ('g', 'd', 'stats'):
        for key in want[net]:
            np.testing.assert_array_equal(got[net][key], want[net][key])
    with pytest.raises(ValueError, match='optimizers'):
        resumed.resume_training({'optimizers': state['optimizers'][:1],
                                 'schedulers': state['schedulers'][:1]})


def test_pretrain_network_d_naming_a_missing_file_raises(tmp_path):
    opt = _opt('dcn')
    opt['path'] = {'pretrain_network_d': str(tmp_path / 'nowhere.pth')}
    with pytest.raises(FileNotFoundError, match='pretrain_network_d'):
        build_model(opt, device='cpu')


def test_gan_options_without_a_gan_loss_raise():
    opt = _opt('dcn')
    del opt['train']['gan_type']
    with pytest.raises(ValueError, match='gan_type'):
        build_model(opt, device='cpu')
    opt = _opt('dcn', pixel_weight=0)
    with pytest.raises(ValueError, match='pixel_weight'):
        build_model(opt, device='cpu')
    opt = _opt('dcn', pretrain=0, pixel_weight=0)
    assert build_model(opt, device='cpu').cri_pix is None
