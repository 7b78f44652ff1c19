"""The port's ``StyleGAN2Model`` against the JAX package's on the CPU, at
the sizes of ``tests/test_models/test_stylegan2_model.py``: the GAN loss,
the discriminator's loss with R1 and the generator's loss with the
path-length penalty (values and every parameter's gradient) from the same
weights, images, codes and noise; one Adam + EMA update from the same
gradients; the save / resume round trip; the inference module. The JAX
losses are taken piece by piece (no whole-step ``jax.jit``): its step draws
its own noise, which the port cannot reproduce."""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrefsr_tpu.losses.losses import GANLoss as JaxGANLoss
from mrefsr_tpu.losses.losses import g_path_regularize as jax_path_regularize
from mrefsr_tpu.losses.losses import r1_penalty as jax_r1_penalty
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu_torch.convert import stylegan2_state_dict_from_flax
from mrefsr_tpu_torch.inference import inference_stylegan2
from mrefsr_tpu_torch.losses import GANLoss, build_loss
from mrefsr_tpu_torch.models import build_model
from mrefsr_tpu_torch.models.stylegan2_model import EMA_DECAY

SIZE, FEAT, B = 32, 16, 4


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tensors here are tiny, and the test workers of one run share
    the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _opt(root, g_every=4, d_every=16):
    return {
        'name': 'test_sg2', 'model_type': 'StyleGAN2Model', 'scale': 1,
        'num_gpu': 1, 'manual_seed': 0, 'is_train': True, 'dist': False,
        'rank': 0, 'world_size': 1,
        'network_g': {'type': 'StyleGAN2Generator', 'out_size': SIZE,
                      'num_style_feat': FEAT, 'num_mlp': 2,
                      'channel_multiplier': 1, 'narrow': 0.125},
        'network_d': {'type': 'StyleGAN2Discriminator', 'out_size': SIZE,
                      'channel_multiplier': 1, 'narrow': 0.125,
                      'stddev_group': 2},
        'path': {'pretrain_network_g': None, 'pretrain_network_d': None,
                 'models': os.path.join(root, 'models'),
                 'training_states': os.path.join(root, 'states'),
                 'visualization': os.path.join(root, 'visualization')},
        'val': {'num_val_samples': 4},
        'train': {
            'optim_g': {'type': 'Adam', 'lr': 2e-3},
            'optim_d': {'type': 'Adam', 'lr': 2e-3},
            'scheduler': {'type': 'MultiStepLR', 'milestones': [1000],
                          'gamma': 1.0},
            'gan_opt': {'type': 'GANLoss', 'gan_type': 'wgan_softplus',
                        'loss_weight': 1.0},
            'r1_reg_weight': 10., 'path_reg_weight': 2.,
            'net_g_reg_every': g_every, 'net_d_reg_every': d_every,
            'mixing_prob': 0.9, 'path_batch_shrink': 2, 'total_iter': 6,
            'warmup_iter': -1},
        'datasets': {},
    }


# ---------------------------------------------------------------- GAN loss
@pytest.mark.parametrize('is_disc', [True, False], ids=['disc', 'gen'])
@pytest.mark.parametrize('target_is_real', [True, False],
                         ids=['real', 'fake'])
@pytest.mark.parametrize('gan_type', ['vanilla', 'lsgan', 'wgan',
                                      'wgan_softplus', 'hinge'])
def test_gan_loss_matches_jax(gan_type, target_is_real, is_disc):
    x = (np.random.RandomState(0).randn(6, 1) * 3).astype(np.float32)
    kwargs = dict(real_label_val=0.9, fake_label_val=0.1, loss_weight=0.3)
    want = JaxGANLoss(gan_type, **kwargs)(jnp.asarray(x), target_is_real,
                                          is_disc)
    xt = torch.from_numpy(x).requires_grad_()
    got = GANLoss(gan_type, **kwargs)(xt, target_is_real, is_disc)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    grad_want = jax.grad(lambda v: JaxGANLoss(gan_type, **kwargs)(
        v, target_is_real, is_disc))(jnp.asarray(x))
    grad, = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_want),
                               rtol=1e-5, atol=1e-7)


def test_build_loss_and_unknown_types():
    assert isinstance(build_loss({'type': 'GANLoss', 'gan_type': 'hinge'}),
                      GANLoss)
    with pytest.raises(NotImplementedError, match='not implemented'):
        GANLoss('wgan_gp')
    assert isinstance(build_loss({'type': 'MultiScaleGANLoss',
                                  'gan_type': 'hinge'}), GANLoss)
    with pytest.raises(KeyError, match='not ported'):
        build_loss({'type': 'NoSuchLoss', 'gan_type': 'hinge'})


# ------------------------------------------------------ losses and updates
def _liven(params, rng):
    """Seeded values for the noise strengths and activation biases flax
    starts at zero (an activation's bias is its module's only
    parameter)."""
    def walk(node):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val)
            elif (key == 'bias' and set(node) == {'bias'}) \
                    or (key == 'weight' and val.shape == (1,)):
                node[key] = (rng.randn(*val.shape) * 0.3).astype(np.float32)
    walk(params)
    return params


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _named(tree):
    """A flax tree of parameters (or of their gradients: the layout
    changes are permutations) by torch name."""
    return {k: v.numpy() for k, v in stylegan2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


@pytest.fixture(scope='module')
def both(tmp_path_factory):
    """The JAX model and the port's from the same (livened) flax weights,
    with the inputs both losses take."""
    root = str(tmp_path_factory.mktemp('sg2'))
    rng = np.random.RandomState(0)
    real = (rng.rand(B, SIZE, SIZE, 3) * 2 - 1).astype(np.float32)
    jax_model = jax_build_model(_opt(root))
    jax_model.feed_data({'gt': real})                       # lazy init
    params_g = _liven(jax.tree_util.tree_map(
        np.array, jax_model.variables['params']), rng)
    params_d = _liven(jax.tree_util.tree_map(
        np.array, jax_model.vars_d['params']), rng)
    model = build_model(_opt(root), device='cpu')
    model.load_from_flax(params_g, params_d)
    model.feed_data({'gt': real})
    num_layers = model.net_g.num_layers

    def noises(n):
        return [rng.randn(n, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2),
                          1).astype(np.float32) for i in range(num_layers)]

    inputs = {
        'real': real,
        'fake': (rng.rand(B, SIZE, SIZE, 3) * 2 - 1).astype(np.float32),
        'styles': [rng.randn(B, FEAT).astype(np.float32) for _ in range(2)],
        'noise': noises(B),
        'path_styles': [rng.randn(B // 2, FEAT).astype(np.float32)
                        for _ in range(2)],
        'path_noise': noises(B // 2),
        'inject_index': 3, 'mean_path_length': 0.3,
        'path_key': jax.random.PRNGKey(11)}
    return jax_model, model, params_g, params_d, inputs


def _hold_gradients(got, want):
    """``test_torch_train.py``'s rule: each tensor's gradient against that
    tensor's largest entry, within 1e-3 for at least 95 % of the tensors
    and within 5e-2 for all (a leaky-ReLU gate that falls on the other
    side of 0 in the two frameworks moves the gradients before it)."""
    assert sorted(got) == sorted(want)
    rel = {}
    for name in want:
        scale = np.abs(want[name]).max()
        err = np.abs(got[name] - want[name]).max()
        rel[name] = err / scale if scale else float(err > 0)
    assert max(rel.values()) <= 5e-2, max(rel, key=rel.get)
    loose = sorted(name for name, v in rel.items() if v > 1e-3)
    assert len(loose) <= 0.05 * len(rel), loose
    assert all(np.abs(v).max() > 0 for v in want.values())


def test_d_loss_with_r1_matches_jax(both):
    jax_model, model, _, params_d, inputs = both
    net_d, cri = jax_model.net_d, jax_model.cri_gan
    real, fake = jnp.asarray(inputs['real']), jnp.asarray(inputs['fake'])

    def d_loss_fn(params):
        """``stylegan2_model.py``'s ``d_loss_fn`` with ``do_r1``."""
        def apply(img):
            return net_d.apply({'params': params}, img)
        l_d = cri(apply(real), True, is_disc=True) \
            + cri(apply(fake), False, is_disc=True)
        l_d_r1 = jax_r1_penalty(apply, real)
        return l_d + (jax_model.r1_reg_weight / 2 * l_d_r1
                      * jax_model.net_d_reg_every), l_d_r1

    (want, want_r1), grads = jax.value_and_grad(d_loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params_d))
    model.net_d.requires_grad_(True).zero_grad(set_to_none=True)
    got, log = model.d_loss(_nchw(inputs['real']), _nchw(inputs['fake']),
                            do_r1=True)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(log['l_d_r1']), float(want_r1),
                               rtol=1e-5)
    assert float(want_r1) > 0 and float(log['l_d']) == float(got)
    _hold_gradients({name: p.grad.numpy() for name, p in
                     model.net_d.named_parameters()}, _named(grads))
    no_r1, log = model.d_loss(_nchw(inputs['real']), _nchw(inputs['fake']),
                              do_r1=False)
    assert float(log['l_d_r1']) == 0 and float(no_r1) < float(got)


def test_g_loss_with_path_penalty_matches_jax(both):
    jax_model, model, params_g, params_d, inputs = both
    net_g, net_d, cri = jax_model.net_g, jax_model.net_d, jax_model.cri_gan
    index, mpl = inputs['inject_index'], inputs['mean_path_length']
    as_jnp = lambda values: [jnp.asarray(v) for v in values]  # noqa: E731
    shrunk = B // 2
    img_noise = np.asarray(jax.random.normal(
        inputs['path_key'], (shrunk, SIZE, SIZE, 3), jnp.float32))

    def g_loss_fn(params):
        """``stylegan2_model.py``'s ``g_loss_fn`` with ``do_path``, the
        injected noise given."""
        fake, _ = net_g.apply({'params': params}, as_jnp(inputs['styles']),
                              noise=as_jnp(inputs['noise']),
                              inject_index=index)
        l_g = cri(net_d.apply({'params': params_d}, fake), True,
                  is_disc=False)
        _, latents = net_g.apply(
            {'params': params}, as_jnp(inputs['path_styles']),
            noise=as_jnp(inputs['path_noise']), inject_index=index,
            return_latents=True)

        def img_from_latents(z):
            return net_g.apply({'params': params}, [z],
                               noise=as_jnp(inputs['path_noise']),
                               input_is_latent=True)[0]

        l_g_path, path_lengths, new_mpl = jax_path_regularize(
            img_from_latents, latents, jnp.float32(mpl), inputs['path_key'])
        total = l_g + (jax_model.path_reg_weight
                       * jax_model.net_g_reg_every * l_g_path)
        return total, (l_g, l_g_path, path_lengths, new_mpl)

    (want, aux), grads = jax.value_and_grad(g_loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params_g))

    def torch_noise(noise):
        return [_nchw(n) for n in noise]

    model.net_g.zero_grad(set_to_none=True)
    model.mean_path_length = torch.tensor(mpl)
    got, log, new_mpl = model.g_loss(
        [torch.from_numpy(s) for s in inputs['styles']], index,
        noise=torch_noise(inputs['noise']),
        path={'styles': [torch.from_numpy(s) for s in inputs['path_styles']],
              'noise': torch_noise(inputs['path_noise']),
              'img_noise': _nchw(img_noise)})
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for value, wanted in zip((log['l_g'], log['l_g_path'],
                              log['path_length'], new_mpl), aux):
        np.testing.assert_allclose(float(value), float(wanted), rtol=1e-5)
    assert float(new_mpl) == pytest.approx(
        mpl + 0.01 * (float(log['path_length']) - mpl), rel=1e-6)
    assert not new_mpl.requires_grad
    _hold_gradients({name: p.grad.numpy() for name, p in
                     model.net_g.named_parameters()}, _named(grads))


def test_adam_and_ema_update_match_optax(both):
    """Two updates of net_g, net_d and the EMA from the same gradients:
    the JAX model's own ``optax.adam`` transforms (lazy-regularization
    rates and betas) against the port's ``torch.optim.Adam``."""
    jax_model, model, params_g, params_d, _ = both
    rng = np.random.RandomState(5)
    for params, tx, net, optimizer, every in (
            (params_g, jax_model.tx, model.net_g, model.optimizer_g, 4),
            (params_d, jax_model.tx_d, model.net_d, model.optimizer_d, 16)):
        ratio = every / (every + 1)
        assert optimizer.param_groups[0]['lr'] == pytest.approx(2e-3 * ratio)
        assert optimizer.param_groups[0]['betas'] == (0 ** ratio,
                                                      0.99 ** ratio)
        params = jax.tree_util.tree_map(jnp.asarray, params)
        ema = params
        state = tx.init(params)
        net.requires_grad_(True)
        for step in range(2):
            grads = jax.tree_util.tree_map(
                lambda p: rng.randn(*p.shape).astype(np.float32) * 0.1,
                params)
            updates, state = tx.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            ema = jax.tree_util.tree_map(
                lambda e, p: e * EMA_DECAY + p * (1 - EMA_DECAY), ema,
                params)
            by_name = _named(grads)
            for name, p in net.named_parameters():
                p.grad = torch.from_numpy(by_name[name].copy())
            model.update_learning_rate(step + 1)
            optimizer.step()
            if net is model.net_g:
                model.ema_update(model.net_g_ema, model.net_g, EMA_DECAY)
        want = _named(params)
        for name, p in net.named_parameters():
            # Adam's first steps move every entry by about lr
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=0, atol=1e-3 * 2e-3, err_msg=name)
        if net is model.net_g:
            want = _named(ema)
            for name, p in model.net_g_ema.named_parameters():
                np.testing.assert_allclose(p.numpy(), want[name], rtol=1e-6,
                                           atol=1e-7, err_msg=name)
        net.zero_grad(set_to_none=True)
    assert EMA_DECAY == 0.5 ** (32 / 10000)


# -------------------------------------------------------- the model's steps
@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """Four iterations with a penalty every second (path) and fourth (R1)
    step, then a save."""
    root = str(tmp_path_factory.mktemp('sg2_steps'))
    opt = _opt(root, g_every=2, d_every=4)
    model = build_model(opt, device='cpu')
    rng = np.random.RandomState(1)
    batch = {'gt': (rng.rand(B, SIZE, SIZE, 3) * 2 - 1).astype(np.float32)}
    logs = {}
    for it in range(1, 5):
        model.feed_data(batch)
        model.optimize_parameters(it)
        logs[it] = model.get_current_log()
    model.save(0, 4)
    return opt, model, batch, logs


def test_penalties_fall_on_their_iterations(trained):
    _, model, _, logs = trained
    for it, log in logs.items():
        assert all(math.isfinite(v) for v in log.values()), (it, log)
        assert {'l_d', 'real_score', 'fake_score', 'l_d_r1', 'l_g'} \
            <= set(log)
        assert ('l_g_path' in log) == (it % 2 == 0)
        assert (log['l_d_r1'] > 0) == (it % 4 == 0)
    assert 0 < float(model.mean_path_length) < 1
    assert model.get_current_learning_rate() == [
        pytest.approx(2e-3 * 2 / 3)]
    ema = model.net_g_ema.state_dict()
    live = model.net_g.state_dict()
    assert any(not torch.equal(ema[k], live[k]) for k in ema)
    assert not any(p.requires_grad for p in model.net_g_ema.parameters())


def test_sampling_and_validation(trained):
    opt, model, _, _ = trained
    model.test()
    assert model.output.shape == (4, SIZE, SIZE, 3)
    first = model.output.clone()
    model.test()                  # the codes are fixed, the noise is drawn
    assert torch.isfinite(model.output).all()
    assert not torch.equal(first, model.output)
    model.nondist_validation(None, 4, None, True)
    import cv2
    img = cv2.imread(os.path.join(opt['path']['visualization'], 'train',
                                  'train_4.png'))
    assert img.shape == (2 * SIZE + 2, 2 * SIZE + 2, 3)
    assert model.get_current_visuals()['result'].shape == (4, SIZE, SIZE, 3)
    with pytest.raises(ValueError, match='dataloader'):
        model.nondist_validation([], 4, None, True)


def test_save_and_resume_round_trip(trained):
    """``net_g_<iter>.pth`` holds ``params`` and ``params_ema``,
    ``net_d_<iter>.pth`` ``params``, ``<iter>.state`` both optimizers. A
    fresh model that loads them and takes over the random state takes the
    same fifth step."""
    opt, model, batch, _ = trained
    models = opt['path']['models']
    ckpt = torch.load(os.path.join(models, 'net_g_4.pth'),
                      weights_only=True)
    assert sorted(ckpt) == ['params', 'params_ema']
    assert sorted(ckpt['params']) == sorted(model.net_g.state_dict())
    opt2 = _opt(os.path.dirname(models), g_every=2, d_every=4)
    opt2['path'].update(
        pretrain_network_g=os.path.join(models, 'net_g_4.pth'),
        pretrain_network_d=os.path.join(models, 'net_d_4.pth'))
    other = build_model(opt2, device='cpu')
    state = other.load_training_state(os.path.join(
        opt['path']['training_states'], '4.state'))
    assert state['iter'] == 4 and len(state['optimizers']) == 2
    other.resume_training(state)
    for label in ('net_g', 'net_g_ema', 'net_d'):
        mine = getattr(model, label).state_dict()
        theirs = getattr(other, label).state_dict()
        assert all(torch.equal(mine[k], theirs[k]) for k in mine), label
    for mine, theirs in zip(model.optimizers, other.optimizers):
        a, b = mine.state_dict(), theirs.state_dict()
        assert a['param_groups'] == b['param_groups']
        for key, entry in a['state'].items():
            for field, value in entry.items():
                assert torch.equal(value, b['state'][key][field]), field
    # the random state and the running path length are not in the files
    other.generator.set_state(model.generator.get_state())
    other.rng.setstate(model.rng.getstate())
    other.mean_path_length = model.mean_path_length.clone()
    for m in (model, other):
        m.feed_data(batch)
        m.optimize_parameters(5)
    assert model.get_current_log() == other.get_current_log()
    for label in ('net_g', 'net_g_ema', 'net_d'):
        mine = getattr(model, label).state_dict()
        theirs = getattr(other, label).state_dict()
        assert all(torch.equal(mine[k], theirs[k]) for k in mine), label


def test_eval_model_samples_without_training_settings(tmp_path):
    opt = _opt(str(tmp_path))
    opt['is_train'] = False
    del opt['train'], opt['network_d']
    model = build_model(opt, device='cpu')
    assert model.net_g_ema is model.net_g
    model.nondist_validation(None, 0, None, True)
    assert os.path.isfile(tmp_path / 'visualization' / 'test'
                          / 'test_test_sg2.png')
    with pytest.raises(RuntimeError, match='is_train'):
        model.optimize_parameters(1)


# ------------------------------------------------------ the inference module
def test_inference_module_on_the_cpu(tmp_path, monkeypatch):
    """``python -m mrefsr_tpu_torch.inference.inference_stylegan2`` at a
    tiny size (16x16; the widths are the published ones): the checkpoint's
    ``params_ema`` is what samples, the mean latent is the style MLP's
    alone, and the grids are the files under ``samples/``."""
    monkeypatch.chdir(tmp_path)
    argv = ['--size', '16', '--sample', '4', '--pics', '2',
            '--truncation_mean', '64', '--seed', '7', '--device', 'cpu']
    args = inference_stylegan2.parse_args(argv)
    args.seed = 99                            # other weights than the run's
    net = inference_stylegan2.build_generator(args, torch.device('cpu'))
    ckpt = tmp_path / 'g.pth'
    torch.save({'params': {k: torch.zeros_like(v)
                           for k, v in net.state_dict().items()},
                'params_ema': net.state_dict()}, ckpt)
    grids = inference_stylegan2.main(argv + ['--ckpt', str(ckpt)])
    assert len(grids) == 2 and not np.array_equal(grids[0], grids[1])
    import cv2
    for i, grid in enumerate(grids):
        assert grid.shape == (2 * 16 + 2, 2 * 16 + 2, 3)
        assert grid.dtype == np.uint8 and grid.std() > 0
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / 'samples' / f'{i:06d}.png')), grid)
    generator = torch.Generator().manual_seed(7)
    want = net.style_mlp(torch.randn((64, 512), generator=generator)).mean(
        0, keepdim=True)
    got = inference_stylegan2.mean_latent(
        net, args, torch.Generator().manual_seed(7))
    torch.testing.assert_close(got, want)
    args.truncation = 1.0
    assert inference_stylegan2.mean_latent(net, args, generator) is None
    # the same command again gives the same grids
    again = inference_stylegan2.main(argv + ['--ckpt', str(ckpt)])
    np.testing.assert_array_equal(again[0], grids[0])


def test_inference_module_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        inference_stylegan2.main(['--size', '16'])
