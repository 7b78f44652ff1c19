"""HiFaceGAN in the port against the JAX package on the CPU, from the same
seeded flax variables (the parameters ``random_params``' N(0, 1/fan_in)
kernels, the affine norms' scales 1 + N(0, 0.1), the spectral-norm
vectors after 20 power iterations from a random start, SPADE's ``batch``
statistics mean N(0, 0.1), variance U[0.5, 1.5]):

* ``SPADE`` with each norm type (``instance``, ``syncbatch``, ``batch``),
  ``SPADEResnetBlock`` with spectral-norm convs in training mode (output,
  ``u`` / ``v``) and plain convs, ``lip2d``, ``SimplifiedLIP`` and the
  ``LIPEncoder``;
* ``HiFaceGAN`` at ``is_train`` False and True (``init_train_phase`` 1:
  two up blocks, ``to_rgbs.1``) and ``SPADEGenerator``, in eval mode (the
  stored vectors) and in training mode (one power iteration, kept);
  ``SRModel.test`` in f32 and under ``val.mixed_precision: bfloat16``;
* ``HiFaceGANDiscriminator``'s stage outputs at both scales;
* ``HiFaceGANModel`` (crop 32, ``num_feat`` 4; D ``num_feat`` 4,
  ``n_layers_d`` 3, hinge ``MultiScaleGANLoss``, ``GANFeatLoss`` 10, L1)
  for two steps against the JAX step: iteration 1 a skipped G turn
  (``net_d_init_iters`` 1), iteration 2 a G turn. Plain SGD, so each
  parameter's change is its gradient times the rate: both nets' updates
  by name, the logged terms, G's ``u`` / ``v`` (moved by its forward on
  both iterations) and D's (moved by D's own step only: the G pass runs D
  in eval mode, on the stored ones, and iterates nothing, which the JAX
  package does and
  :func:`test_generator_pass_uses_stored_discriminator_vectors` pins);
* ``save`` and resume of both nets and both optimizers.

Tolerances, each against the largest entry of the JAX tensor, with what
these inputs measured: outputs and ``u`` / ``v`` 1e-4 (5.2e-6, the LIP
encoder); the updates 3e-3 (7.2e-4, a bias of ``head_0``: G's gradient
reaches it through D and the instance norms of maps down to 1 x 1), or of
1e-3 of the net's largest update where that is larger; the logged terms
rtol 1e-5.
The JAX step compiles once for both iterations (``g_turn`` is traced).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs import hifacegan_arch as jax_arch
from mrefsr_tpu.archs import hifacegan_util as jax_util
from mrefsr_tpu.convert import flax_to_torch as jax_flax_to_torch
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu.parallel import replicate
from mrefsr_tpu_torch.archs import hifacegan_arch, hifacegan_util
from mrefsr_tpu_torch.archs.arch_util import SNConv2d
from mrefsr_tpu_torch.convert import state_dict_from_flax_with_counts
from mrefsr_tpu_torch.models import build_model
from test_torch_video_zoo import close
from torch_video_params import random_params

OUT_TOL, LR, UPDATE_TOL, UPDATE_FLOOR, LOG_RTOL = 1e-4, 1e-2, 3e-3, 1e-3, \
    1e-5
CROP = 32
NET_G = {'type': 'HiFaceGAN', 'num_in_ch': 3, 'num_feat': 4,
         'crop_size': CROP, 'norm_g': 'spectralspadesyncbatch3x3',
         'is_train': True, 'init_train_phase': 3}
NET_D = {'type': 'HiFaceGANDiscriminator', 'num_in_ch': 3, 'num_out_ch': 3,
         'conditional_d': True, 'num_d': 2, 'n_layers_d': 3, 'num_feat': 4,
         'norm_d': 'spectralinstance', 'keep_features': True}


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _power_vectors(kernel, rng, iters=20):
    """A spectral-norm conv's ``u`` / ``v`` after ``iters`` power
    iterations from a normalised N(0, 1) ``u``: near the leading singular
    vectors of the kernel as (O, I * kh * kw), as a trained net holds
    them (random vectors would give sigma any size and sign)."""
    w_mat = np.transpose(kernel, (3, 2, 0, 1)).reshape(kernel.shape[-1], -1)
    u = rng.randn(w_mat.shape[0]).astype(np.float32)
    u /= np.linalg.norm(u)
    for _ in range(iters):
        v = w_mat.T @ u
        v /= np.linalg.norm(v)
        u = w_mat @ v
        u /= np.linalg.norm(u)
    return u.astype(np.float32), v.astype(np.float32)


def _seeded_variables(module, inputs, seed):
    """Seeded flax variables of ``module`` (module docstring)."""
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0),
                                                   *a), *inputs)
    rng = np.random.RandomState(seed + 100)

    def unit_weights(node, key=None):
        if isinstance(node, dict):
            return {k: unit_weights(v, k) for k, v in node.items()}
        if key in ('weight', 'scale'):    # an affine norm's scale
            return (1 + 0.1 * rng.randn(*node.shape)).astype(np.float32)
        return node

    def stats(node, leaf=None):
        if isinstance(node, dict):
            return {k: stats(v, k) for k, v in node.items()}
        if leaf == 'mean':
            return (rng.randn(*node.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, node.shape).astype(np.float32)

    def vectors(node, params):
        if 'u' in node:
            u, v = _power_vectors(params['kernel'], rng)
            return {'u': u, 'v': v}
        return {k: vectors(v, params[k]) for k, v in node.items()}

    params = unit_weights(random_params(module, inputs, seed))
    variables = {'params': params}
    if 'spectral' in shapes:
        variables['spectral'] = vectors(dict(shapes['spectral']), params)
    if 'batch_stats' in shapes:
        variables['batch_stats'] = stats(dict(shapes['batch_stats']))
    return variables


def _port(cls, variables, **kwargs):
    net = cls(**kwargs)
    net.load_state_dict(state_dict_from_flax_with_counts(variables),
                        strict=True)
    return net


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _vectors(net):
    return {k: v.clone() for k, v in net.state_dict().items()
            if k.endswith(('weight_u', 'weight_v'))}


def _jax_vectors(spectral):
    out = {}
    for key, val in jax_flax_to_torch(
            jax.tree_util.tree_map(np.asarray, spectral)).items():
        base, _, leaf = key.rpartition('.')
        out[f'{base}.weight_{leaf}'] = val
    return out


def _close_vectors(got, want, what):
    assert set(got) == set(want), what
    for key, val in want.items():
        close(got[key], val, OUT_TOL, f'{what} {key}')


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize('config', ['spadeinstance3x3', 'spadesyncbatch3x3',
                                    'spadebatch3x3'])
def test_spade_norm_types(config):
    """SPADE with each parameter-free norm; the segmentation map (32 x 32)
    resized to the features' 8 x 8 by nearest."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    seg = rng.rand(2, 32, 32, 3).astype(np.float32)
    module = jax_util.SPADE(config, 8, 3)
    variables = _seeded_variables(module, [x, seg], 1)
    want = jax.jit(module.apply)(variables, x, seg)
    net = _port(hifacegan_util.SPADE, variables, config_text=config,
                norm_nc=8, label_nc=3)
    for mode in (net.eval, net.train):      # the batch norm is frozen
        mode()
        with torch.no_grad():
            close(_nhwc(net(_nchw(x), _nchw(seg))), want, OUT_TOL, config)


@pytest.mark.parametrize('norm_g', ['spectralspadesyncbatch3x3',
                                    'spadeinstance3x3'])
def test_spade_resnet_block(norm_g):
    """A block with a learned shortcut (8 -> 4 channels) in training mode:
    its output and, with spectral norm, its convs' ``u`` / ``v`` after the
    power iteration."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    seg = rng.rand(2, 16, 16, 3).astype(np.float32)
    module = jax_util.SPADEResnetBlock(8, 4, norm_g)
    variables = _seeded_variables(module, [x, seg], 2)
    want, upd = jax.jit(lambda v, a, b: module.apply(
        v, a, b, mutable=['spectral']))(variables, x, seg)
    net = _port(hifacegan_util.SPADEResnetBlock, variables, fin=8, fout=4,
                norm_g=norm_g).train()
    with torch.no_grad():
        close(_nhwc(net(_nchw(x), _nchw(seg))), want, OUT_TOL, norm_g)
    if 'spectral' in norm_g:
        _close_vectors(_vectors(net), _jax_vectors(upd['spectral']), norm_g)
    else:
        assert not any(isinstance(m, SNConv2d) for m in net.modules())


def test_lip2d_simplified_lip_and_encoder():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    logit = rng.randn(2, 16, 16, 4).astype(np.float32)
    close(_nhwc(hifacegan_util.lip2d(_nchw(x), _nchw(logit))),
          jax_util.lip2d(jnp.asarray(x), jnp.asarray(logit)), OUT_TOL,
          'lip2d')
    for module, cls, kwargs in (
            (jax_util.SimplifiedLIP(4), hifacegan_util.SimplifiedLIP,
             {'channels': 4}),
            (jax_util.LIPEncoder(4, 4, 1, 1, 3), hifacegan_util.LIPEncoder,
             {'input_nc': 4, 'ngf': 4, 'sw': 1, 'sh': 1, 'n_2xdown': 3})):
        variables = _seeded_variables(module, [x], 3)
        net = _port(cls, variables, **kwargs)
        with torch.no_grad():
            close(_nhwc(net(_nchw(x))), jax.jit(module.apply)(variables, x),
                  OUT_TOL, cls.__name__)


# -------------------------------------------------------------------- nets
@pytest.mark.parametrize('cls,kwargs,out_side', [
    ('HiFaceGAN', {'is_train': False}, CROP),
    ('HiFaceGAN', {'is_train': True, 'init_train_phase': 1}, CROP // 4),
    ('SPADEGenerator', {'is_train': True}, CROP)])
def test_generators(cls, kwargs, out_side):
    """Eval mode (the stored vectors) and training mode (one iteration,
    kept), outputs and ``u`` / ``v``; ``is_train`` with phase 1 builds two
    up blocks and ``to_rgbs.1``."""
    x = np.random.RandomState(3).rand(2, CROP, CROP, 3).astype(np.float32)
    module = getattr(jax_arch, cls)(num_feat=4, crop_size=CROP, **kwargs)
    variables = _seeded_variables(module, [x], 4)
    net = _port(getattr(hifacegan_arch, cls), variables, num_feat=4,
                crop_size=CROP, **kwargs)
    if kwargs.get('init_train_phase') == 1:
        assert len(net.ups) == 2 and list(net.to_rgbs) == ['1']
    net.eval()
    with torch.no_grad():
        got = _nhwc(net(_nchw(x)))
    assert got.shape == (2, out_side, out_side, 3)
    close(got, jax.jit(module.apply)(variables, x), OUT_TOL, f'{cls} eval')
    want, upd = jax.jit(lambda v, a: module.apply(
        v, a, mutable=['spectral']))(variables, x)
    net.train()
    with torch.no_grad():
        close(_nhwc(net(_nchw(x))), want, OUT_TOL, f'{cls} train')
    _close_vectors(_vectors(net), _jax_vectors(upd['spectral']), cls)


def test_discriminator_features():
    """Every stage's output at both scales, in eval mode and in training
    mode (one iteration, kept)."""
    x = np.random.RandomState(4).rand(4, CROP, CROP, 6).astype(np.float32)
    kwargs = {k: v for k, v in NET_D.items() if k != 'type'}
    module = jax_arch.HiFaceGANDiscriminator(**kwargs)
    variables = _seeded_variables(module, [x], 5)
    net = _port(hifacegan_arch.HiFaceGANDiscriminator, variables, **kwargs)
    for mutable in (False, True):
        if mutable:
            want, upd = jax.jit(lambda v, a: module.apply(
                v, a, mutable=['spectral']))(variables, x)
        else:
            want = jax.jit(module.apply)(variables, x)
        net.train(mutable)
        with torch.no_grad():
            got = net(_nchw(x))
        assert len(got) == 2 and [len(s) for s in got] == [4, 4]
        for i, (scale_got, scale_want) in enumerate(zip(got, want)):
            for j, (g, w) in enumerate(zip(scale_got, scale_want)):
                close(_nhwc(g), w, OUT_TOL, f'D {i} stage {j}')
    _close_vectors(_vectors(net), _jax_vectors(upd['spectral']), 'D')


# ------------------------------------------------------------------- model
def _opt(root='/nonexistent'):
    return {
        'name': 'hifacegan_test', 'model_type': 'HiFaceGANModel',
        'scale': 1, 'num_gpu': 1, 'manual_seed': 0, 'is_train': True,
        'dist': False, 'rank': 0, 'world_size': 1,
        'network_g': dict(NET_G), 'network_d': dict(NET_D),
        'path': {'pretrain_network_g': None, 'pretrain_network_d': None,
                 'strict_load_g': True, 'models': f'{root}/models',
                 'training_states': f'{root}/states'},
        'train': {
            'optim_g': {'type': 'SGD', 'lr': LR},
            'optim_d': {'type': 'SGD', 'lr': LR},
            'scheduler': {'type': 'MultiStepLR', 'milestones': [100],
                          'gamma': 0.5},
            'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0,
                          'reduction': 'mean'},
            'gan_opt': {'type': 'MultiScaleGANLoss', 'gan_type': 'hinge',
                        'loss_weight': 1.0},
            'feature_matching_opt': {'type': 'GANFeatLoss',
                                     'criterion': 'l1', 'loss_weight': 10.0},
            'net_d_iters': 1, 'net_d_init_iters': 1,
            'total_iter': 100, 'warmup_iter': -1},
        'datasets': {}}


def _batch(seed=5):
    rng = np.random.RandomState(seed)
    gt = rng.rand(2, CROP, CROP, 3).astype(np.float32)
    lq = (gt + 0.1 * rng.randn(*gt.shape)).clip(0, 1).astype(np.float32)
    return {'lq': lq, 'gt': gt}


def _pair(opt, batch):
    """The JAX model and the port's from the same seeded variables."""
    jax_model = jax_build_model(copy.deepcopy(opt))
    mesh = jax_model.mesh
    vars_g = _seeded_variables(jax_model.net_g, [batch['lq']], 6)
    cond = np.concatenate([batch['lq'], batch['gt']], -1)
    vars_d = _seeded_variables(jax_model.net_d, [cond], 7)
    jax_model.variables = replicate(vars_g, mesh)
    jax_model.opt_state = replicate(jax_model.tx.init(vars_g['params']),
                                    mesh)
    jax_model.vars_d = replicate(vars_d, mesh)
    jax_model.opt_state_d = replicate(
        jax_model.tx_d.init(vars_d['params']), mesh)
    model = build_model(copy.deepcopy(opt), device='cpu')
    model.load_from_flax(vars_g)
    model.load_net_d_from_flax(vars_d)
    return jax_model, model


def _params(net):
    """The parameters by their flax names' torch form (a spectral-norm
    conv's ``weight_orig`` as ``weight``)."""
    return {k.replace('weight_orig', 'weight'): v.detach().clone().numpy()
            for k, v in net.named_parameters()}


def _jax_params(variables):
    return {k: np.asarray(v) for k, v in jax_flax_to_torch(
        jax.tree_util.tree_map(np.asarray, variables['params'])).items()}


@pytest.fixture(scope='module')
def stepped():
    """Two steps of both models on one batch (iteration 1 skips G's
    turn); each step's logs, parameters and vectors."""
    batch = _batch()
    jax_model, model = _pair(_opt(), batch)
    records = [{'g': (_params(model.net_g), _jax_params(
        jax_model.variables)), 'd': (_params(model.net_d),
                                     _jax_params(jax_model.vars_d))}]
    for step in (1, 2):
        jax_model.feed_data(batch)
        jax_model.optimize_parameters(step)
        model.feed_data(batch)
        model.optimize_parameters(step)
        records.append({
            'log': (model.get_current_log(),
                    {k: float(v) for k, v in
                     jax_model.get_current_log().items()}),
            'g': (_params(model.net_g), _jax_params(jax_model.variables)),
            'd': (_params(model.net_d), _jax_params(jax_model.vars_d)),
            'uv_g': (_vectors(model.net_g),
                     _jax_vectors(jax_model.variables['spectral'])),
            'uv_d': (_vectors(model.net_d),
                     _jax_vectors(jax_model.vars_d['spectral']))})
    return records, model, batch


def test_model_steps_match_jax(stepped):
    """Iteration 1 leaves G as it was (its terms 0) and steps D; iteration
    2 steps both. Logged terms, each parameter's update, both nets' ``u``
    / ``v`` after each step."""
    records, _, _ = stepped
    for step in (1, 2):
        rec, prev = records[step], records[step - 1]
        got, want = rec['log']
        assert sorted(got) == sorted(want) == sorted(
            ['l_g_pix', 'l_g_gan', 'l_g_feat', 'l_d_real', 'l_d_fake'])
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=LOG_RTOL,
                                       atol=1e-9, err_msg=f'{step} {key}')
        for part in ('g', 'd'):
            got, want = rec[part]
            assert set(got) == set(want), part
            updates = {k: (got[k] - prev[part][0][k], v - prev[part][1][k])
                       for k, v in want.items()}
            largest = max(np.abs(w).max() for _, w in updates.values())
            if part == 'g' and step == 1:
                assert largest == 0 and not any(
                    np.any(g) for g, _ in updates.values())
                continue
            for name, (got_u, want_u) in updates.items():
                close(got_u, want_u, UPDATE_TOL, f'{step} {part} {name}',
                      UPDATE_FLOOR * largest)
        for part in ('uv_g', 'uv_d'):
            _close_vectors(*rec[part], f'{step} {part}')
    assert records[1]['log'][0]['l_g_gan'] == 0


def test_generator_pass_uses_stored_discriminator_vectors(stepped):
    """``g_losses`` leaves D's ``u`` / ``v`` as they are, computes the
    losses D in eval mode (sigma from the stored vectors) gives, and hands
    D back in the mode it had, where a training forward would iterate and
    keep it."""
    _, model, batch = stepped
    model.feed_data(batch)
    before = _vectors(model.net_d)
    with torch.no_grad():
        output = model._run(model.net_g, torch.float32, False, model.lq)
        losses = model.g_losses(output)
        after = _vectors(model.net_d)
        assert model.net_d.training
        model.net_d.eval()
        eval_losses = model.g_losses(output)
        assert not model.net_d.training
        model.net_d.train()
    for key in before:
        assert torch.equal(before[key], after[key]), key
    for key, val in eval_losses.items():
        assert torch.equal(losses[key], val), key
    with torch.no_grad():
        model.net_d(torch.cat([model.lq, output], -1).permute(0, 3, 1, 2))
    assert any(not torch.equal(before[k], v)
               for k, v in _vectors(model.net_d).items())


def test_eval_f32_and_bf16():
    """``SRModel.test`` of the port's model (the stored vectors) against
    the JAX net's eval forward (measured 1.2e-6); and under
    ``val.mixed_precision: bfloat16``, from the port's own seeded weights,
    within 8 bf16 eps of the f32 output's largest entry (measured 4.4
    eps)."""
    batch = _batch(8)
    opt = _opt()
    jax_model = jax_build_model(copy.deepcopy(opt))
    vars_g = _seeded_variables(jax_model.net_g, [batch['lq']], 6)
    want = jax.jit(jax_model.net_g.apply)(vars_g, batch['lq'])
    outs = {}
    for mp in (None, 'bfloat16'):
        test_opt = dict(copy.deepcopy(opt), is_train=False,
                        val={'mixed_precision': mp})
        model = build_model(test_opt, device='cpu')
        model.feed_data(batch)
        model.test()
        outs[mp] = model.output.numpy()
        if mp is None:
            model.load_from_flax(vars_g)
            model.test()
            close(model.output.numpy(), want, OUT_TOL, 'f32 test')
    close(outs['bfloat16'], outs[None], 8 * 2.0 ** -7, 'bf16 test')


def test_save_and_resume(stepped, tmp_path):
    """``save`` writes both nets (``u`` / ``v`` included) and both
    optimizers' and schedules' states; a model resumed from them holds the
    same."""
    _, model, _ = stepped
    opt = _opt(str(tmp_path))
    model.opt['path'].update(opt['path'])
    model.save(0, 2)
    resumed_opt = _opt(str(tmp_path))
    resumed_opt['path'].update(
        pretrain_network_g=str(tmp_path / 'models' / 'net_g_2.pth'),
        pretrain_network_d=str(tmp_path / 'models' / 'net_d_2.pth'))
    other = build_model(resumed_opt, device='cpu')
    other.resume_training(other.load_training_state(
        str(tmp_path / 'states' / '2.state')))
    for label in ('net_g', 'net_d'):
        mine = getattr(model, label).state_dict()
        theirs = getattr(other, label).state_dict()
        assert mine.keys() == theirs.keys()
        for key in mine:
            assert torch.equal(mine[key], theirs[key]), (label, key)
    assert [s.state_dict() for s in model.schedulers] == \
        [s.state_dict() for s in other.schedulers]
    assert len(other.optimizers) == 2


def test_ema_is_refused():
    opt = _opt()
    opt['train']['ema_decay'] = 0.999
    with pytest.raises(NotImplementedError, match='EMA'):
        build_model(opt, device='cpu')
