"""The port's ``VideoRecurrentGANModel`` (``BasicVSR`` num_feat 8, one
block, T 3, lq 40, against ``VGGStyleDiscriminator`` num_feat 4 on the
160 x 160 frames) against the JAX package's on the CPU: one step's
gradients of both nets by name (the clip's frames through the
discriminator as a batch), the perceptual loss on the frames, the flow
learning rate and ``fix_flow``, and a checkpoint of ``net_d`` and both
optimizers that resumes bit for bit."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.convert import flax_to_torch
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu.parallel import replicate
from mrefsr_tpu_torch.convert import nhwc_dense_to_nchw, state_dict_from_flax
from mrefsr_tpu_torch.models import build_model
from torch_video_params import random_params

NET_G = {'type': 'BasicVSR', 'num_feat': 8, 'num_block': 1,
         'spynet_path': None}
NET_D = {'type': 'VGGStyleDiscriminator', 'num_in_ch': 3, 'num_feat': 4,
         'input_size': 160}
LR, T, LQ = 1e-4, 3, 40
# each gradient against its tensor's largest entry (measured 5.8e-4:
# ReLU gates within rounding of 0 pass or stop a term by the order of the
# sums before them, through the recurrence and the flow warps)
GRAD_TOL = 1e-2


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _opt(root='/nonexistent', **train):
    """BasicSR's ``train_BasicVSR_REDS.yml`` block with a vanilla GAN loss
    of weight 5e-3 and ``net_d`` at Adam 1e-4: ``lr_flow`` 2.5e-5 (the
    GAN YAMLs' absolute flow rate), ``fix_flow`` 2."""
    return {'name': 'vrgan_test', 'model_type': 'VideoRecurrentGANModel',
            'scale': 4, 'num_gpu': 1, 'manual_seed': 0, 'is_train': True,
            'dist': False, 'rank': 0, 'world_size': 1,
            'network_g': dict(NET_G), 'network_d': dict(NET_D),
            'path': {'pretrain_network_g': None, 'strict_load_g': True,
                     'models': f'{root}/models',
                     'training_states': f'{root}/states'},
            'train': {'ema_decay': 0.9,
                      'optim_g': {'type': 'Adam', 'lr': LR,
                                  'betas': [0.9, 0.99]},
                      'optim_d': {'type': 'Adam', 'lr': LR,
                                  'betas': [0.9, 0.99]},
                      'scheduler': {'type': 'MultiStepLR',
                                    'milestones': [100], 'gamma': 0.5},
                      'total_iter': 10, 'warmup_iter': -1,
                      'pixel_opt': {'type': 'CharbonnierLoss',
                                    'loss_weight': 1.0, 'reduction': 'mean'},
                      'gan_opt': {'type': 'GANLoss', 'gan_type': 'vanilla',
                                  'loss_weight': 5e-3},
                      'lr_flow': 2.5e-5, 'fix_flow': 2, **train},
            'datasets': {}}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    base = rng.rand(1, LQ + 8, LQ + 8, 3).astype(np.float32)
    return {'lq': np.stack([base[:, i:i + LQ, 2 * i:2 * i + LQ]
                            for i in range(T)], 1),
            'gt': rng.rand(1, T, 4 * LQ, 4 * LQ, 3).astype(np.float32)}


def _torch_named(tree):
    return {k: np.asarray(v) for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


@pytest.fixture(scope='module')
def pair():
    """The JAX model and the port's from the same seeded variables."""
    batch = _batch()
    jax_model = jax_build_model(_opt())
    params = random_params(jax_model.net_g, [batch['lq']], seed=5)
    params_d = random_params(jax_model.net_d, [batch['gt'][:, 0]], seed=6)
    shapes = jax.eval_shape(lambda x: jax_model.net_d.init(
        jax.random.PRNGKey(0), x), batch['gt'][:, 0])['batch_stats']
    stats = {k: {'mean': np.zeros(v['mean'].shape, np.float32),
                 'var': np.ones(v['var'].shape, np.float32)}
             for k, v in dict(shapes).items()}
    jax_model.variables = replicate({'params': params}, jax_model.mesh)
    vars_d = {'params': params_d, 'batch_stats': stats}
    model = build_model(_opt(), device='cpu')
    model.load_from_flax({'params': params})
    model.load_net_d_from_flax(vars_d)
    return {'batch': batch, 'jax': jax_model, 'model': model,
            'params': params, 'vars_d': vars_d}


def test_one_steps_gradients_match_jax(pair):
    """The generator's loss (Charbonnier + GAN through ``net_d`` in
    training mode on the T frames as a batch) and the discriminator's
    (real frames, then the detached fake ones): every parameter's gradient
    of both against ``jax.grad`` of the JAX model's own terms, by name."""
    jm, model, batch = pair['jax'], pair['model'], pair['batch']
    lq, gt = jnp.asarray(batch['lq']), jnp.asarray(batch['gt'])
    flat = (lambda x: x.reshape((-1,) + x.shape[-3:]))
    vars_d = pair['vars_d']

    def g_loss(p):
        out = jm.net_g.apply({'params': p}, lq)
        fake, _ = jm._apply_d(vars_d, flat(out), train=True)
        return jm.cri_pix(out, gt) + jm.cri_gan(fake, True, is_disc=False), out

    (_, out), grads_g = jax.jit(jax.value_and_grad(g_loss, has_aux=True))(
        pair['params'])

    def d_loss(pd):
        dv = dict(vars_d, params=pd)
        real, dv = jm._apply_d(dv, flat(gt))
        fake, dv = jm._apply_d(dv, flat(jax.lax.stop_gradient(out)))
        return jm.cri_gan(real, True, is_disc=True) + jm.cri_gan(
            fake, False, is_disc=True)

    grads_d = jax.jit(jax.grad(d_loss))(vars_d['params'])

    model.feed_data(batch)
    output = model._run(model.net_g, torch.float32, False, model.lq)
    losses = model.g_losses(output)
    assert list(losses) == ['l_g_pix', 'l_g_gan']
    sum(losses.values()).backward()
    model.net_d.requires_grad_(True)
    d = model.d_losses(output.detach())
    (d['l_d_real'] + d['l_d_fake']).backward()
    want_d = _torch_named(grads_d)
    want_d['linear1.weight'] = nhwc_dense_to_nchw(want_d['linear1.weight'],
                                                  32)
    for net, want in ((model.net_g, _torch_named(grads_g)),
                      (model.net_d, want_d)):
        named = dict(net.named_parameters())
        assert set(named) == set(want)
        floor = 1e-3 * max(np.abs(v).max() for v in want.values())
        for name, value in want.items():
            err = np.abs(named[name].grad.numpy() - value).max() / max(
                np.abs(value).max(), floor)
            assert err <= GRAD_TOL, (name, err)
    model.net_d.requires_grad_(False)
    model.net_g.zero_grad(set_to_none=True)
    model.net_d.zero_grad(set_to_none=True)


def test_perceptual_loss_takes_the_frames_as_a_batch(pair):
    """With a VGG19 perceptual and style loss the generator's terms hold
    ``l_g_percep`` and ``l_g_style`` of the T frames as a batch, within
    rtol 1e-5 of the JAX loss on the flattened clips (measured 9.1e-7),
    the same VGG weights in both."""
    opt = _opt()
    opt['train']['perceptual_opt'] = {
        'type': 'PerceptualLoss', 'layer_weights': {'conv5_4': 1.0},
        'vgg_type': 'vgg19', 'use_input_norm': True,
        'perceptual_weight': 1.0, 'style_weight': 0.5, 'criterion': 'l1'}
    jm = jax_build_model(opt)
    model = build_model(opt, device='cpu')
    variables = jm.cri_perceptual.vgg.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    model.cri_perceptual.vgg.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables['params'])),
        strict=True)
    rng = np.random.RandomState(8)
    out = rng.rand(1, T, 64, 64, 3).astype(np.float32)
    gt = rng.rand(1, T, 64, 64, 3).astype(np.float32)
    percep, style = jm.cri_perceptual(jnp.asarray(out.reshape(-1, 64, 64, 3)),
                                      jnp.asarray(gt.reshape(-1, 64, 64, 3)),
                                      variables)
    model.gt = torch.from_numpy(gt)
    with torch.no_grad():
        losses = dict(model.losses(torch.from_numpy(out), model.gt))
    np.testing.assert_allclose(float(losses['l_percep']), float(percep),
                               rtol=1e-5)
    np.testing.assert_allclose(float(losses['l_style']), float(style),
                               rtol=1e-5)
    assert model.g_loss_keys() == ['l_g_pix', 'l_g_percep', 'l_g_style',
                                   'l_g_gan']


def test_flow_rate_and_fix_flow(pair):
    """``lr_flow`` is the flow group's absolute rate (as the JAX package's
    ``_flow_multi_transform``); a ``fix_flow`` of 2 freezes ``spynet`` for
    iteration 1, a bool freezes nothing."""
    model = pair['model']
    assert [g['lr'] for g in model.optimizer_g.param_groups] == [LR, 2.5e-5]
    assert pair['jax'].base_lrs == [LR, 2.5e-5]
    assert model.frozen(1) and not model.frozen(2)
    assert not model.freeze_keep('spynet.basic_module.0.basic_module.0.bias')
    unfrozen = build_model(_opt(fix_flow=True), device='cpu')
    assert unfrozen.freeze_keep is None and not unfrozen.frozen(1)


def test_checkpoint_resumes_bit_for_bit(pair, tmp_path):
    """Two steps (the first with SpyNet frozen), ``save``, then a model
    built from ``net_g`` / ``net_d`` and the ``.state`` (both optimizers
    and schedulers) takes the third step exactly as the saved one does;
    the EMA comes back from ``params_ema``."""
    model = build_model(_opt(tmp_path), device='cpu')
    src = pair['model']
    model.net_g.load_state_dict(src.net_g.state_dict())
    model.net_g_ema.load_state_dict(src.net_g.state_dict())
    model.net_d.load_state_dict(src.net_d.state_dict())
    spynet = {k: v.clone() for k, v in model.net_g.state_dict().items()
              if k.startswith('spynet')}
    for step in (1, 2):
        model.feed_data(_batch(step))
        model.optimize_parameters(step)
        if step == 1:
            assert all(torch.equal(v, model.net_g.state_dict()[k])
                       for k, v in spynet.items())
    assert all(np.isfinite(v) for v in model.get_current_log().values())
    model.save(0, 2)
    opt = _opt(tmp_path)
    opt['path'].update(
        pretrain_network_g=str(tmp_path / 'models' / 'net_g_2.pth'),
        pretrain_network_d=str(tmp_path / 'models' / 'net_d_2.pth'))
    resumed = build_model(opt, device='cpu')
    resumed.resume_training(resumed.load_training_state(
        str(tmp_path / 'states' / '2.state')))
    twin = copy.deepcopy(model)
    for m in (twin, resumed):
        m.feed_data(_batch(3))
        m.optimize_parameters(3)
    for net in ('net_g', 'net_d', 'net_g_ema'):
        a = getattr(twin, net).state_dict()
        b = getattr(resumed, net).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), net
    assert twin.get_current_log() == resumed.get_current_log()
