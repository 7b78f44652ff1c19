"""The port's ``SRGANModel`` (``MSRResNet`` num_feat 4, one block, x4,
against ``VGGStyleDiscriminator`` num_feat 4 on 160 x 160) against the
JAX package's on the CPU, from the same flax variables: a 3-step
trajectory in which step 1 is the discriminator's alone
(``net_d_init_iters`` 1) and steps 2-3 alternate as the JAX step does, the
EMA, each optimizer's schedule on its own count of updates, and the
discriminator's running statistics; then ``save`` and a resume that
carries on bit for bit. The JAX step compiles once."""
import copy

import jax
import numpy as np
import pytest
import torch

from mrefsr_tpu.convert import flax_to_torch
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu.parallel import replicate
from mrefsr_tpu_torch.convert import nhwc_dense_to_nchw
from mrefsr_tpu_torch.models import build_model
from torch_video_params import random_params

NET_G = {'type': 'MSRResNet', 'num_in_ch': 3, 'num_out_ch': 3,
         'num_feat': 4, 'num_block': 1, 'upscale': 4}
NET_D = {'type': 'VGGStyleDiscriminator', 'num_in_ch': 3, 'num_feat': 4,
         'input_size': 160}
LR_G, LR_D, DECAY, STEPS, B, GT = 1e-4, 1e-4, 0.9, 3, 2, 160


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _opt(root='/nonexistent'):
    """BasicSR's ``train_MSRGAN_x4.yml`` train block (L1 1e-2, vanilla GAN
    5e-3, Adam 1e-4 for both nets) without the perceptual loss, an EMA of
    0.9, ``net_d_init_iters`` 1 and a MultiStepLR halving after one update
    (which count each optimizer runs on shows in its rate)."""
    return {'name': 'srgan_test', 'model_type': 'SRGANModel', 'scale': 4,
            'num_gpu': 1, 'manual_seed': 0, 'is_train': True,
            'dist': False, 'rank': 0, 'world_size': 1,
            'network_g': dict(NET_G), 'network_d': dict(NET_D),
            'path': {'pretrain_network_g': None, 'strict_load_g': True,
                     'models': f'{root}/models',
                     'training_states': f'{root}/states'},
            'train': {'ema_decay': DECAY,
                      'optim_g': {'type': 'Adam', 'lr': LR_G,
                                  'betas': [0.9, 0.99]},
                      'optim_d': {'type': 'Adam', 'lr': LR_D,
                                  'betas': [0.9, 0.99]},
                      'scheduler': {'type': 'MultiStepLR', 'milestones': [1],
                                    'gamma': 0.5},
                      'total_iter': 10, 'warmup_iter': -1,
                      'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1e-2,
                                    'reduction': 'mean'},
                      'gan_opt': {'type': 'GANLoss', 'gan_type': 'vanilla',
                                  'real_label_val': 1.0,
                                  'fake_label_val': 0.0,
                                  'loss_weight': 5e-3},
                      'net_d_iters': 1, 'net_d_init_iters': 1},
            'datasets': {}}


def _torch_named(tree):
    return {k: np.asarray(v) for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _jax_d_state(vars_d):
    """The JAX discriminator's variables under the port's names and
    layout (``linear1`` read NCHW)."""
    out = _torch_named(vars_d['params'])
    out['linear1.weight'] = nhwc_dense_to_nchw(out['linear1.weight'], 32)
    for key, val in _torch_named(vars_d['batch_stats']).items():
        base, _, leaf = key.rpartition('.')
        out[f'{base}.running_{leaf}'] = val
    return out


def _state(net):
    return {k: v.detach().clone().numpy() for k, v in
            net.state_dict().items() if not k.endswith('batches_tracked')}


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp('srgan')
    rng = np.random.RandomState(0)
    batch = {'lq': rng.rand(B, GT // 4, GT // 4, 3).astype(np.float32),
             'gt': rng.rand(B, GT, GT, 3).astype(np.float32)}
    jax_model = jax_build_model(_opt(root))
    params = random_params(jax_model.net_g, [batch['lq']], seed=1)
    params_d = random_params(jax_model.net_d, [batch['gt']], seed=2)
    shapes = jax.eval_shape(lambda x: jax_model.net_d.init(
        jax.random.PRNGKey(0), x), batch['gt'])['batch_stats']
    stats = jax.tree_util.tree_map(
        lambda s: np.ones(s.shape, np.float32), dict(shapes))
    stats = {k: {'mean': v['mean'] * 0, 'var': v['var']}
             for k, v in stats.items()}
    mesh = jax_model.mesh
    jax_model.variables = replicate({'params': params}, mesh)
    jax_model.ema_variables = replicate({'params': params}, mesh)
    jax_model.opt_state = replicate(jax_model.tx.init(params), mesh)
    jax_model.vars_d = replicate({'params': params_d,
                                  'batch_stats': stats}, mesh)
    jax_model.opt_state_d = replicate(jax_model.tx_d.init(params_d), mesh)

    model = build_model(_opt(root), device='cpu')
    model.load_from_flax({'params': params})
    model.load_net_d_from_flax({'params': params_d, 'batch_stats': stats})
    start = _state(model.net_g)
    records = []
    for step in range(1, STEPS + 1):
        jax_model.feed_data(batch)
        jax_model.optimize_parameters(step)
        model.feed_data(batch)
        model.optimize_parameters(step)
        records.append({
            'log': (model.get_current_log(),
                    {k: float(v) for k, v in
                     jax_model.get_current_log().items()}),
            'g': (_state(model.net_g),
                  _torch_named(jax_model.variables['params'])),
            'd': (_state(model.net_d), _jax_d_state(jax_model.vars_d)),
            'lr': ([s.get_last_lr()[0] for s in model.schedulers],)})
    return {'root': root, 'batch': batch, 'model': model,
            'jax': jax_model, 'records': records, 'start': start}


def test_losses_and_turns_match_jax(run):
    """Each step's logged terms within rtol 1e-5 (measured 5.4e-6); step 1
    trains the discriminator alone, its generator terms 0 in both."""
    for step, rec in enumerate(run['records'], start=1):
        got, want = rec['log']
        assert sorted(got) == sorted(want), step
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-5,
                                       atol=1e-9, err_msg=f'{step} {key}')
        assert (got['l_g_gan'] == 0) == (step == 1)


def test_trajectory_matches_jax(run):
    """After each step every parameter of both nets within lr of JAX's and
    99.9 % of each tensor's entries within lr / 10 (measured: at most
    0.054 lr in ``net_d``, 6e-4 lr in ``net_g``, every entry within lr /
    10), the discriminator's running statistics within 1e-5 of their
    largest entry (measured 1.2e-6): written by the discriminator
    step's real and fake passes only. Step 1 leaves ``net_g`` as it was."""
    for step, rec in enumerate(run['records'], start=1):
        for part, lr in (('g', LR_G), ('d', LR_D)):
            got, want = rec[part]
            assert set(want) <= set(got)
            for name, value in want.items():
                diff = np.abs(got[name] - value)
                if 'running' in name:
                    assert diff.max() <= 1e-5 * np.abs(value).max(), name
                    continue
                assert diff.max() <= lr, (step, part, name, diff.max())
                assert (diff <= lr / 10).mean() >= 0.999, (step, name)
    start = run['start']
    first, second = run['records'][0]['g'][0], run['records'][1]['g'][0]
    assert all(np.array_equal(start[k], first[k]) for k in start)
    assert any(not np.array_equal(first[k], second[k]) for k in first)


def test_each_schedule_counts_its_own_updates(run):
    """MultiStepLR halving after one update: ``net_d`` steps every
    iteration (halved from iteration 2), ``net_g`` from iteration 2 (halved
    from 3); Adam's counts likewise; the EMA against JAX's within lr
    (measured 6e-4 lr)."""
    lrs = [rec['lr'][0] for rec in run['records']]
    assert lrs == [[LR_G, LR_D], [LR_G, LR_D / 2], [LR_G / 2, LR_D / 2]]
    model = run['model']
    assert {int(s['step']) for s in model.optimizer_g.state.values()} \
        == {STEPS - 1}
    assert {int(s['step']) for s in model.optimizer_d.state.values()} \
        == {STEPS}
    ema = _state(model.net_g_ema)
    for name, value in _torch_named(
            run['jax'].ema_variables['params']).items():
        assert np.abs(ema[name] - value).max() <= LR_G, name


def test_save_and_resume_carry_on_bit_for_bit(run):
    """``save`` writes ``net_g`` (with ``params_ema``), ``net_d`` and one
    ``.state`` of both optimizers and schedulers; a model resumed from them
    takes the next step exactly as the saved one."""
    model, root = run['model'], run['root']
    model.save(0, STEPS)
    assert (root / 'models' / f'net_d_{STEPS}.pth').is_file()
    opt = _opt(root)
    opt['path'].update(pretrain_network_g=str(root / 'models' /
                                              f'net_g_{STEPS}.pth'),
                       pretrain_network_d=str(root / 'models' /
                                              f'net_d_{STEPS}.pth'))
    resumed = build_model(opt, device='cpu')
    resumed.resume_training(resumed.load_training_state(
        str(root / 'states' / f'{STEPS}.state')))
    twin = copy.deepcopy(model)
    for m in (twin, resumed):
        m.feed_data(run['batch'])
        m.optimize_parameters(STEPS + 1)
    for net in ('net_g', 'net_d', 'net_g_ema'):
        a, b = _state(getattr(twin, net)), _state(getattr(resumed, net))
        assert all(np.array_equal(a[k], b[k]) for k in a), net
    assert twin.get_current_log() == resumed.get_current_log()


def test_ldl_waits_for_real_esrgan():
    """Real-ESRGAN (ROADMAP A10) brought LDL's artifact map:
    ``train.ldl_opt`` builds, and its term comes after the pixel one;
    without an EMA it raises, since the map compares with the EMA net's
    output (the step itself is held to JAX's in
    ``test_torch_realesrgan_model.py``)."""
    opt = _opt()
    opt['train']['ldl_opt'] = {'type': 'L1Loss', 'loss_weight': 1.0}
    model = build_model(opt, device='cpu')
    assert model.cri_ldl is not None
    assert model.g_loss_keys() == ['l_g_pix', 'l_g_ldl', 'l_g_gan']
    opt['train']['ema_decay'] = 0
    with pytest.raises(ValueError, match='ema_decay'):
        build_model(opt, device='cpu')
