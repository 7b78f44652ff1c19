"""The SR zoo's models and loss against the JAX package's on the CPU, from
the same flax variables:

* ``ESRGANModel`` (RRDBNet num_feat 4, one block, x4, against
  ``VGGStyleDiscriminator`` num_feat 4 on 160 x 160): step 1 trains the
  discriminator alone (``net_d_init_iters`` 1), step 2 both nets with the
  relativistic terms; each step's logged terms by name, both nets'
  parameters and the discriminator's running statistics, which its two
  passes (real, then fake) write and the generator's two passes do not;
* ``SwinIRModel`` (SwinIR embed 8, window 4, an EMA): two steps, then
  ``test()`` of the EMA net on an LQ of 13 x 10, reflect-padded to the
  window and cropped back; and its stochastic depth, seeded by the step;
* ``SwinIRGANModel``: one step, with ``drop_path_rate`` 0.1 that neither
  GAN step draws from;
* ``WeightedTVLoss`` with and without a weight, ``mean`` and ``sum``.

The steps are plain SGD (lr 1e-2): an update is the gradient times the
rate, so each parameter's update is held against JAX's: 2e-3 of its
largest entry (measured 4.3e-4), or of 1e-3 of the net's largest update
where that is larger (a relativistic loss depends only on differences of
the discriminator's outputs, so the shift of its last bias has a zero
gradient and its other biases tiny ones: Adam, which divides a gradient by
its size, would step on their rounding; ``SRGANModel``'s Adam is held in
``test_torch_srgan_model.py``). The norms start at scale about 1
(:func:`_unit_scales`). Logged terms rtol 5e-5 (measured 6.6e-6,
``out_d_fake``, a mean of two outputs); running statistics 1e-5 of their
largest entry (measured 1.8e-6); the test output 1e-5 of its largest
entry (measured 4.6e-7); the loss rtol 1e-6 (measured 3.7e-7). Each JAX
step compiles once."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.convert import flax_to_torch
from mrefsr_tpu.losses import build_loss as jax_build_loss
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu.parallel import replicate
from mrefsr_tpu_torch.convert import nhwc_dense_to_nchw
from mrefsr_tpu_torch.losses import build_loss
from mrefsr_tpu_torch.models import build_model
from test_torch_video_zoo import close
from torch_video_params import random_params

LR, LOG_RTOL, UPDATE_TOL, UPDATE_FLOOR, STATS_TOL = 1e-2, 5e-5, 2e-3, 1e-3, \
    1e-5
NET_D = {'type': 'VGGStyleDiscriminator', 'num_in_ch': 3, 'num_feat': 4,
         'input_size': 160}
SWINIR = {'type': 'SwinIR', 'img_size': 16, 'in_chans': 3, 'embed_dim': 8,
          'depths': [2], 'num_heads': [2], 'window_size': 4,
          'mlp_ratio': 2., 'upscale': 4, 'img_range': 1.,
          'upsampler': 'pixelshuffledirect', 'resi_connection': '1conv',
          'drop_path_rate': 0.}


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _opt(model_type, net_g, d_init=None, root='/nonexistent', ema=0.):
    train = {'ema_decay': ema,
             'optim_g': {'type': 'SGD', 'lr': LR},
             'scheduler': {'type': 'MultiStepLR', 'milestones': [10],
                           'gamma': 0.5},
             'total_iter': 10, 'warmup_iter': -1,
             'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0 if d_init
                           is None else 1e-2, 'reduction': 'mean'}}
    opt = {'name': 'zoo_test', 'model_type': model_type, 'scale': 4,
           'num_gpu': 1, 'manual_seed': 0, 'is_train': True, 'dist': False,
           'rank': 0, 'world_size': 1, 'network_g': dict(net_g),
           'path': {'pretrain_network_g': None, 'strict_load_g': True,
                    'models': f'{root}/models',
                    'training_states': f'{root}/states'},
           'train': train, 'datasets': {}}
    if d_init is not None:
        opt['network_d'] = dict(NET_D)
        train.update(
            optim_d={'type': 'SGD', 'lr': LR},
            gan_opt={'type': 'GANLoss', 'gan_type': 'vanilla',
                     'real_label_val': 1.0, 'fake_label_val': 0.0,
                     'loss_weight': 5e-3},
            net_d_iters=1, net_d_init_iters=d_init)
    return opt


def _torch_named(tree):
    return {k: np.asarray(v) for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _jax_d_state(vars_d):
    out = _torch_named(vars_d['params'])
    out['linear1.weight'] = nhwc_dense_to_nchw(out['linear1.weight'], 32)
    for key, val in _torch_named(vars_d['batch_stats']).items():
        base, _, leaf = key.rpartition('.')
        out[f'{base}.running_{leaf}'] = val
    return out


def _state(net):
    return {k: v.detach().clone().numpy() for k, v in
            net.state_dict().items() if not k.endswith('batches_tracked')
            and not k.endswith(('relative_position_index', 'attn_mask'))}


def _unit_scales(params, parent=''):
    """Every norm's scale near 1, as a net starts (the seeded values'
    N(0, 0.01) would leave SwinIR's output about constant and each
    discriminator norm's output within rounding of the leaky ReLU's kink:
    the norms' f32 variance, E[x^2] - E[x]^2 in both packages, and the
    gradients then go to the order of the sums)."""
    rng = np.random.RandomState(3)

    def unit(key, val):
        if isinstance(val, dict):
            return _unit_scales(val, key)
        if key == 'scale' or (key == 'weight' and parent.startswith('norm')):
            return (1 + 0.1 * rng.randn(*val.shape)).astype(np.float32)
        return val

    return {k: unit(k, v) for k, v in params.items()}


def _pair(opt, batch):
    """The JAX model and the port's from the same seeded variables (the
    norms at scale about 1, the discriminator's statistics at mean 0,
    variance 1)."""
    jax_model = jax_build_model(copy.deepcopy(opt))
    mesh = jax_model.mesh
    params = _unit_scales(random_params(jax_model.net_g, [batch['lq']],
                                        seed=1))
    jax_model.variables = replicate({'params': params}, mesh)
    jax_model.ema_variables = replicate({'params': params}, mesh)
    jax_model.opt_state = replicate(jax_model.tx.init(params), mesh)
    model = build_model(copy.deepcopy(opt), device='cpu')
    model.load_from_flax({'params': params})
    if 'network_d' in opt:
        params_d = _unit_scales(random_params(jax_model.net_d,
                                              [batch['gt']], seed=2))
        shapes = jax.eval_shape(lambda x: jax_model.net_d.init(
            jax.random.PRNGKey(0), x), batch['gt'])['batch_stats']
        stats = {k: {'mean': np.zeros(v['mean'].shape, np.float32),
                     'var': np.ones(v['var'].shape, np.float32)}
                 for k, v in dict(shapes).items()}
        jax_model.vars_d = replicate({'params': params_d,
                                      'batch_stats': stats}, mesh)
        jax_model.opt_state_d = replicate(jax_model.tx_d.init(params_d),
                                          mesh)
        model.load_net_d_from_flax({'params': params_d,
                                    'batch_stats': stats})
    return jax_model, model


def _steps(jax_model, model, batch, steps):
    """``steps`` steps of both models; each step's logs and states, the
    port's states before the first step leading."""
    records = [{'g': (_state(model.net_g),) * 2}]
    if model.opt.get('network_d'):
        records[0]['d'] = (_state(model.net_d),) * 2
    for step in range(1, steps + 1):
        jax_model.feed_data(batch)
        jax_model.optimize_parameters(step)
        model.feed_data(batch)
        model.optimize_parameters(step)
        rec = {'log': (model.get_current_log(),
                       {k: float(v) for k, v in
                        jax_model.get_current_log().items()}),
               'g': (_state(model.net_g),
                     _torch_named(jax_model.variables['params']))}
        if model.opt.get('network_d'):
            rec['d'] = (_state(model.net_d), _jax_d_state(jax_model.vars_d))
        records.append(rec)
    return records


def _check_records(records):
    """Each step's logged terms, each parameter's update (the step's change
    in each package) and each running statistic against JAX's."""
    for step in range(1, len(records)):
        rec, prev = records[step], records[step - 1]
        got, want = rec['log']
        assert sorted(got) == sorted(want), step
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=LOG_RTOL,
                                       atol=1e-9, err_msg=f'{step} {key}')
        for part in ('g', 'd'):
            if part not in rec:
                continue
            got, want = rec[part]
            assert set(want) == set(got), (part, set(want) ^ set(got))
            updates = {k: (got[k] - prev[part][0][k],
                           v - prev[part][1][k]) for k, v in want.items()
                       if 'running' not in k}
            floor = UPDATE_FLOOR * max(np.abs(w).max()
                                       for _, w in updates.values())
            if floor == 0:       # a step that leaves the net as it was
                assert not any(np.any(g) for g, _ in updates.values())
                continue
            for name, (got_u, want_u) in updates.items():
                close(got_u, want_u, UPDATE_TOL, f'{step} {part} {name}',
                      floor)
            for name in (k for k in want if 'running' in k):
                close(got[name], want[name], STATS_TOL,
                      f'{step} {part} {name}')


def _gan_batch(b=2):
    rng = np.random.RandomState(0)
    return {'lq': rng.rand(b, 40, 40, 3).astype(np.float32),
            'gt': rng.rand(b, 160, 160, 3).astype(np.float32)}


RRDB = {'type': 'RRDBNet', 'num_in_ch': 3, 'num_out_ch': 3, 'scale': 4,
        'num_feat': 4, 'num_block': 1, 'num_grow_ch': 4}


def test_esrgan_steps_match_jax():
    """Step 1 off the generator's turn (its terms 0 in both, ``net_g``
    as it was), step 2 on it: the relativistic terms by name, both nets,
    and the discriminator's running statistics."""
    batch = _gan_batch()
    opt = _opt('ESRGANModel', RRDB, d_init=1)
    jax_model, model = _pair(opt, batch)
    records = _steps(jax_model, model, batch, 2)
    _check_records(records)
    start, records = records[0]['g'][0], records[1:]
    logs = [rec['log'][0] for rec in records]
    assert sorted(logs[0]) == ['l_d_fake', 'l_d_real', 'l_g_gan', 'l_g_pix',
                               'out_d_fake', 'out_d_real']
    assert logs[0]['l_g_gan'] == 0 and logs[1]['l_g_gan'] > 0
    first = records[0]['g'][0]
    assert all(np.array_equal(start[k], first[k]) for k in start)
    stats = records[0]['d'][0]['bn0_1.running_mean']
    assert np.abs(stats).max() > 0


def _swinir_batch(b=2):
    rng = np.random.RandomState(3)
    return {'lq': rng.rand(b, 16, 16, 3).astype(np.float32),
            'gt': rng.rand(b, 64, 64, 3).astype(np.float32)}


def test_swinir_model_steps_and_test_match_jax():
    """Two steps (the EMA at 0.9), then ``test()`` of the EMA net on an LQ
    of 13 x 10: padded to 16 x 12, cropped back to 52 x 40."""
    batch = _swinir_batch()
    opt = _opt('SwinIRModel', SWINIR, ema=0.9)
    opt['val'] = {}
    jax_model, model = _pair(opt, batch)
    _check_records(_steps(jax_model, model, batch, 2))
    lq = np.random.RandomState(4).rand(1, 13, 10, 3).astype(np.float32)
    for m in (jax_model, model):
        m.feed_data({'lq': lq})
        m.test()
    want = np.asarray(jax_model.output)
    got = model.output.numpy()
    assert got.shape == want.shape == (1, 52, 40, 3)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_swinir_gan_step_matches_jax():
    """One generator and discriminator step; ``drop_path_rate`` 0.1 draws
    nothing in the GAN step of either package."""
    batch = _gan_batch()
    net_g = {**SWINIR, 'drop_path_rate': 0.1}
    jax_model, model = _pair(_opt('SwinIRGANModel', net_g, d_init=0), batch)
    records = _steps(jax_model, model, batch, 1)
    _check_records(records)
    assert records[1]['log'][0]['l_g_gan'] > 0


def test_swinir_stochastic_depth_is_seeded_by_the_step():
    """With ``drop_path_rate`` 0.5 two copies of a model take the same
    step alike; another ``manual_seed`` or another iteration draws other
    masks; the generator is dropped after the forward."""
    batch = _swinir_batch(4)
    opt = _opt('SwinIRModel', {**SWINIR, 'drop_path_rate': 0.5})
    model = build_model(opt, device='cpu')
    logs = {}
    for key, seed, step in (('a', 0, 1), ('b', 0, 1), ('seed', 1, 1),
                            ('step', 0, 2)):
        twin = copy.deepcopy(model)
        twin.opt['manual_seed'] = seed
        twin.feed_data(batch)
        twin.optimize_parameters(step)
        logs[key] = twin.get_current_log()['l_pix']
        assert twin.net_g.generator is None
    assert logs['a'] == logs['b']
    assert logs['seed'] != logs['a'] and logs['step'] != logs['a']


@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('reduction', ['mean', 'sum'])
def test_weighted_tv_loss_matches_jax(weighted, reduction):
    rng = np.random.RandomState(5)
    pred = rng.rand(2, 9, 11, 3).astype(np.float32)
    weight = rng.rand(2, 9, 11, 1).astype(np.float32) if weighted else None
    opt = {'type': 'WeightedTVLoss', 'loss_weight': 0.5,
           'reduction': reduction}
    got = build_loss(opt)(torch.from_numpy(pred), None if weight is None
                          else torch.from_numpy(weight))
    want = jax_build_loss(opt)(jnp.asarray(pred), None if weight is None
                               else jnp.asarray(weight))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match='mean | sum'):
        build_loss({**opt, 'reduction': 'none'})
