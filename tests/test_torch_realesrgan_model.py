"""Real-ESRGAN's models and discriminator in the port against the JAX
package's on the CPU, from the same flax variables:

* ``UNetDiscriminatorSN`` (num_feat 8): eval and training forwards, the
  power iteration's ``u`` / ``v`` after one and two training forwards, the
  gradients through sigma, ``frozen_stats`` keeping the vectors, and the
  weights from the flax variables and from a reference-layout ``.pth``
  (``weight_orig``, ``weight_u``, ``weight_v``: torch's ``spectral_norm``,
  which the port's conv matches in both modes);
* ``RealESRNetModel`` (RRDBNet num_feat 8, one block, num_grow_ch 4) at f32
  and bf16, and ``RealESRGANModel`` with ``UNetDiscriminatorSN``, a VGG19
  perceptual loss (``conv1_2``, ``conv2_2``), LDL and routed targets
  (``l1_gt_usm`` and ``gan_gt_usm`` true, ``percep_gt_usm`` false): two
  steps each on one batch the port's ``feed_data`` synthesised, given to
  both models; their logged terms, both nets' parameters and the
  discriminator's ``u`` / ``v`` after each step;
* validation, which runs without synthesis, and two iterations of the
  training CLI.

Tolerances, with what these inputs measured: outputs and ``u`` / ``v``
1e-5 of the largest entry (7.2e-7), gradients 1e-5 of each tensor's
largest entry (2.1e-6); the f32 logged terms rtol 1e-5 (2.5e-6); after
each f32 step every parameter within lr of JAX's and 99.9 % of each net's
entries within lr / 10 (Adam's first steps move an entry by about lr
whatever its gradient's size, so a gradient of another sign moves it
apart; measured: all within 1.1e-3 lr). At bf16, where every activation
rounds in other places in the two frameworks and a tiny gradient's sign
with it: the logged loss within 2 bf16 eps (2^-7) relative (0.082 eps),
every parameter within 4 lr (two Adam steps of at most about lr each, of
other signs: 3.9 lr), 95 % of the entries within lr / 10 (98.0 %), and the
median tensor's update within 5 % of JAX's by norm (1.2 %). Each JAX step
compiles once."""
import logging

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mrefsr_tpu.archs.discriminator_arch import \
    UNetDiscriminatorSN as JaxUNetD
from mrefsr_tpu.convert import flax_to_torch as jax_flax_to_torch
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu.parallel import replicate
from mrefsr_tpu_torch.archs import build_network
from mrefsr_tpu_torch.archs.arch_util import SNConv2d
from mrefsr_tpu_torch.convert import (state_dict_from_flax,
                                      state_dict_from_flax_variables)
from mrefsr_tpu_torch.data import build_dataloader, build_dataset
from mrefsr_tpu_torch.models import build_model
from mrefsr_tpu_torch.parallel.batch_norm import frozen_stats
from mrefsr_tpu_torch.train import train_pipeline
from torch_video_params import random_params

GT, B, SCALE, STEPS = 32, 2, 4, 2
LR_NET, LR_GAN = 2e-4, 1e-4
EPS_BF16 = 2.0 ** -7
NET_G = {'type': 'RRDBNet', 'num_in_ch': 3, 'num_out_ch': 3, 'scale': SCALE,
         'num_feat': 8, 'num_block': 1, 'num_grow_ch': 4}
NET_D = {'type': 'UNetDiscriminatorSN', 'num_in_ch': 3, 'num_feat': 8,
         'skip_connection': True}
DEGRADE = {'resize_prob': [0.2, 0.7, 0.1], 'resize_range': [0.15, 1.5],
           'gaussian_noise_prob': 0.5, 'noise_range': [1, 30],
           'poisson_scale_range': [0.05, 3], 'gray_noise_prob': 0.4,
           'jpeg_range': [30, 95], 'second_blur_prob': 0.8,
           'resize_prob2': [0.3, 0.4, 0.3], 'resize_range2': [0.3, 1.2],
           'gaussian_noise_prob2': 0.5, 'noise_range2': [1, 25],
           'poisson_scale_range2': [0.05, 2.5], 'gray_noise_prob2': 0.4,
           'jpeg_range2': [30, 95], 'queue_size': 4, 'gt_size': GT,
           'gt_usm': True}
KERNEL_OPTS = {
    'blur_kernel_size': 21, 'kernel_list': ['iso', 'aniso'],
    'kernel_prob': [0.5, 0.5], 'sinc_prob': 0.1, 'blur_sigma': [0.2, 3],
    'betag_range': [0.5, 4], 'betap_range': [1, 2], 'blur_kernel_size2': 21,
    'kernel_list2': ['iso', 'aniso'], 'kernel_prob2': [0.5, 0.5],
    'sinc_prob2': 0.1, 'blur_sigma2': [0.2, 1.5], 'betag_range2': [0.5, 4],
    'betap_range2': [1, 2], 'final_sinc_prob': 0.8}


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _torch_named(tree):
    return {k: np.asarray(v) for k, v in jax_flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


# ---------------------------------------------------------- discriminator
@pytest.fixture(scope='module')
def unet_d():
    """The JAX net's variables (u / v moved off their start by two
    training forwards), its input, and the port's net from them."""
    x = np.random.RandomState(0).rand(2, 32, 40, 3).astype(np.float32)
    jax_net = JaxUNetD(num_in_ch=3, num_feat=8)
    variables = jax.jit(jax_net.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    train = jax.jit(lambda v, inp: jax_net.apply(v, inp,
                                                 mutable=['spectral']))
    for _ in range(2):
        _, upd = train(variables, jnp.asarray(x))
        variables = dict(variables, **upd)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    net = build_network(NET_D)
    net.load_state_dict(state_dict_from_flax_variables(variables),
                        strict=True)
    return jax_net, train, variables, x, net


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                     1e-12)
    assert err <= tol, err


def test_unet_discriminator_eval_and_training(unet_d):
    """Eval: the stored vectors give sigma. Training: each forward takes a
    power iteration first and keeps it; after one and two forwards every
    conv's ``u`` / ``v`` and the outputs match the JAX net's with a
    mutable ``spectral``; under ``frozen_stats`` the forward is the same
    and the vectors stay."""
    jax_net, train, variables, x, net = unet_d
    net.eval()
    with torch.no_grad():
        _close(net(_nchw(x)).permute(0, 2, 3, 1).numpy(),
               jax.jit(jax_net.apply)(variables, jnp.asarray(x)))
    net.train()
    jax_vars = variables
    for _ in range(2):
        want, upd = train(jax_vars, jnp.asarray(x))
        jax_vars = dict(jax_vars, **upd)
        before = {k: v.clone() for k, v in net.state_dict().items()}
        with torch.no_grad(), frozen_stats(net):
            frozen = net(_nchw(x))
        for k, v in net.state_dict().items():
            assert torch.equal(v, before[k]), k
        with torch.no_grad():
            got = net(_nchw(x))
        assert torch.equal(got, frozen)
        _close(got.permute(0, 2, 3, 1).numpy(), want)
        for i in range(1, 9):
            for leaf, name in (('u', 'weight_u'), ('v', 'weight_v')):
                _close(getattr(net, f'conv{i}').state_dict()[name].numpy(),
                       jax_vars['spectral'][f'conv{i}'][leaf])


def test_unet_discriminator_gradients(unet_d):
    """The training forward's gradients, through sigma, of every
    parameter and the input, against ``jax.grad`` within 1e-5 of each
    tensor's largest entry (measured 2.1e-6)."""
    _, train, variables, x, net = unet_d
    cot = np.random.RandomState(1).randn(2, 32, 40, 1).astype(np.float32)

    def loss(params, inp):
        return jnp.sum(train(dict(variables, params=params), inp)[0] * cot)

    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        variables['params'], jnp.asarray(x))
    net.load_state_dict(state_dict_from_flax_variables(variables))
    net.train().zero_grad()
    inp = _nchw(x).requires_grad_(True)
    (net(inp) * _nchw(cot)).sum().backward()
    _close(inp.grad.permute(0, 2, 3, 1).numpy(), g_x)
    want = _torch_named(g_params)
    for name, param in net.named_parameters():
        key = name.replace('weight_orig', 'weight')
        _close(param.grad.numpy(), want[key])


def test_unet_discriminator_pth_layouts(unet_d):
    """A ``.pth`` the JAX package writes (its ``flax_to_torch`` with the
    ``spectral`` collection: torch's ``spectral_norm`` names) loads
    strictly; and the port's conv equals ``torch.nn.utils.spectral_norm``
    of a plain conv with the same ``weight_orig`` / ``u`` / ``v`` in eval
    mode and after a training forward."""
    variables = unet_d[2]
    state = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             jax_flax_to_torch(variables['params'],
                               spectral=variables['spectral']).items()}
    assert {'conv1.weight_orig', 'conv1.weight_u', 'conv1.weight_v'} \
        <= set(state)
    fresh = build_network(NET_D)
    fresh.load_state_dict(state, strict=True)
    for k, v in state_dict_from_flax_variables(variables).items():
        assert torch.equal(fresh.state_dict()[k], v), k
    conv = SNConv2d(8, 16, 4, 2, 1, bias=False)
    plain = torch.nn.utils.spectral_norm(torch.nn.Conv2d(8, 16, 4, 2, 1,
                                                         bias=False))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        conv.weight_orig.copy_(torch.randn(16, 8, 4, 4, generator=gen))
        conv.reset_vectors_(gen)
        plain.load_state_dict(conv.state_dict(), strict=True)
    inp = torch.randn(2, 8, 12, 12, generator=gen)
    for mode in ('eval', 'train', 'eval'):
        getattr(conv, mode)()
        getattr(plain, mode)()
        with torch.no_grad():
            torch.testing.assert_close(conv(inp), plain(inp), rtol=1e-5,
                                       atol=1e-6)
        torch.testing.assert_close(conv.weight_u, plain.weight_u, rtol=0,
                                   atol=1e-6)


# ------------------------------------------------------------------ models
def _model_opt(model_type, root='/nonexistent', mixed_precision=None):
    opt = {'name': f'test_{model_type}', 'model_type': model_type,
           'scale': SCALE, 'num_gpu': 1, 'manual_seed': 0, 'is_train': True,
           'dist': False, 'rank': 0, 'world_size': 1,
           'high_order_degradation': True, **DEGRADE,
           'network_g': dict(NET_G),
           'path': {'pretrain_network_g': None, 'strict_load_g': True,
                    'models': f'{root}/models',
                    'training_states': f'{root}/states',
                    'visualization': f'{root}/vis'},
           'train': {'ema_decay': 0.999,
                     'optim_g': {'type': 'Adam', 'lr': LR_NET,
                                 'betas': [0.9, 0.99]},
                     'scheduler': {'type': 'MultiStepLR',
                                   'milestones': [100], 'gamma': 0.5},
                     'total_iter': 10, 'warmup_iter': -1,
                     'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0,
                                   'reduction': 'mean'}},
           'val': {'metrics': {'psnr': {'type': 'calculate_psnr',
                                        'crop_border': 4,
                                        'test_y_channel': False}}},
           'datasets': {}}
    if mixed_precision:
        opt['train']['mixed_precision'] = mixed_precision
    if model_type == 'RealESRGANModel':
        opt.update(l1_gt_usm=True, percep_gt_usm=False, gan_gt_usm=True,
                   network_d=dict(NET_D))
        opt['train'].update(
            optim_g={'type': 'Adam', 'lr': LR_GAN, 'betas': [0.9, 0.99]},
            optim_d={'type': 'Adam', 'lr': LR_GAN, 'betas': [0.9, 0.99]},
            perceptual_opt={'type': 'PerceptualLoss',
                            'layer_weights': {'conv1_2': 0.1,
                                              'conv2_2': 0.1},
                            'vgg_type': 'vgg19', 'use_input_norm': True,
                            'perceptual_weight': 1.0, 'style_weight': 0,
                            'range_norm': False, 'criterion': 'l1'},
            gan_opt={'type': 'GANLoss', 'gan_type': 'vanilla',
                     'real_label_val': 1.0, 'fake_label_val': 0.0,
                     'loss_weight': 0.1},
            ldl_opt={'type': 'L1Loss', 'loss_weight': 1.0,
                     'reduction': 'mean'},
            net_d_iters=1, net_d_init_iters=0)
    return opt


def _dataset_batch():
    """A collated batch of ``RealESRGANDataset`` samples' shape: gt 64 x
    64 and 21 x 21 kernels (an isotropic Gaussian, a sinc, a pulse)."""
    from mrefsr_tpu_torch.data.degradations import (bivariate_Gaussian,
                                                    circular_lowpass_kernel)
    rng = np.random.RandomState(4)
    pulse = np.zeros((21, 21), np.float32)
    pulse[10, 10] = 1
    stack = lambda k: np.stack([k.astype(np.float32)] * B)  # noqa: E731
    return {'gt': rng.rand(B, 64, 64, 3).astype(np.float32),
            'kernel1': stack(bivariate_Gaussian(21, 1.5, 1.5, 0)),
            'kernel2': stack(circular_lowpass_kernel(2., 21)),
            'sinc_kernel': stack(pulse)}


def _synthesised(model):
    """One batch through the port's ``feed_data`` (synthesis, crop,
    pool), as numpy."""
    model.feed_data(_dataset_batch())
    assert model.lq.shape == (B, GT // SCALE, GT // SCALE, 3)
    assert model.gt.shape == (B, GT, GT, 3)
    lq = model.lq.numpy()
    assert lq.min() >= 0 and lq.max() <= 1
    assert np.array_equal(np.round(lq * 255), lq * 255)
    out = {'lq': lq, 'gt': model.gt.numpy()}
    if getattr(model, 'gt_usm', None) is not None:
        out['gt_usm'] = model.gt_usm.numpy()
    return out


def _pair(model_type, mixed_precision=None):
    """The JAX and the port model from the same flax variables (seeded
    numpy values in the shapes of the JAX nets' ``init``, normalised
    N(0, 1) ``u`` / ``v``; a flax ``init`` of these nets runs op by op for
    half a minute), the port's VGG from the JAX one's."""
    jax_model = jax_build_model(_model_opt(model_type,
                                           mixed_precision=mixed_precision))
    mesh = jax_model.mesh
    params = random_params(jax_model.net_g, [np.zeros(
        (1, GT // SCALE, GT // SCALE, 3), np.float32)], seed=1)
    jax_model.variables = replicate({'params': params}, mesh)
    jax_model.ema_variables = replicate({'params': params}, mesh)
    jax_model.opt_state = replicate(jax_model.tx.init(params), mesh)
    model = build_model(_model_opt(model_type,
                                   mixed_precision=mixed_precision),
                        device='cpu')
    model.load_from_flax({'params': params})
    if model_type == 'RealESRGANModel':
        gt = np.zeros((1, GT, GT, 3), np.float32)
        params_d = random_params(jax_model.net_d, [gt], seed=2)
        shapes = jax.eval_shape(lambda x: jax_model.net_d.init(
            jax.random.PRNGKey(0), x), gt)['spectral']
        rng = np.random.RandomState(3)
        spectral = {}
        for name, leaves in shapes.items():
            spectral[name] = {}
            for leaf, shape in leaves.items():
                v = rng.randn(*shape.shape).astype(np.float32)
                spectral[name][leaf] = v / np.linalg.norm(v)
        vars_d = {'params': params_d, 'spectral': spectral}
        jax_model.vars_d = replicate(vars_d, mesh)
        jax_model.opt_state_d = replicate(jax_model.tx_d.init(params_d), mesh)
        model.load_net_d_from_flax(vars_d)
        model.cri_perceptual.vgg.load_state_dict(state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray,
                                   jax_model.vgg_variables['params'])),
            strict=True)
    return jax_model, model


def _state(net):
    return {k: v.detach().clone().float().numpy() for k, v in
            net.state_dict().items()}


def _check_params(got, want, lr, worst_lr, share):
    """Every entry within ``worst_lr`` lr, ``share`` of all within lr /
    10."""
    near = count = 0
    for key, val in want.items():
        diff = np.abs(got[key] - val)
        assert diff.max() <= worst_lr * lr, (key, diff.max() / lr)
        near += int((diff <= lr / 10).sum())
        count += diff.size
    assert near / count >= share, near / count


def _jax_d_state(vars_d):
    out = _torch_named(vars_d['params'])
    for name, leaves in vars_d['spectral'].items():
        out[f'{name}.weight_orig'] = out.pop(f'{name}.weight')
        out[f'{name}.weight_u'] = np.asarray(leaves['u'])
        out[f'{name}.weight_v'] = np.asarray(leaves['v'])
    return out


@pytest.mark.parametrize('mixed_precision', [None, 'bfloat16'])
def test_realesrnet_two_steps_match_jax(mixed_precision):
    """``RealESRNetModel`` at f32 and bf16: its ``feed_data`` synthesises
    a batch; both models then take two steps on it (module docstring's
    tolerances)."""
    jax_model, model = _pair('RealESRNetModel', mixed_precision)
    batch = _synthesised(model)
    start = _state(model.net_g)
    for step in range(1, STEPS + 1):
        jax_model.lq, jax_model.gt = batch['lq'], batch['gt']
        jax_model.optimize_parameters(step)
        model.lq, model.gt = (torch.from_numpy(batch[k]) for k in ('lq',
                                                                   'gt'))
        model.optimize_parameters(step)
        got = model.get_current_log()['l_pix']
        want = float(jax_model.get_current_log()['l_pix'])
        want_params = _torch_named(jax_model.variables['params'])
        if mixed_precision:
            assert abs(got - want) <= 2 * EPS_BF16 * abs(want)
            state = _state(model.net_g)
            _check_params(state, want_params, LR_NET, 4, 0.95)
            rel = [np.linalg.norm(state[k] - w) / np.linalg.norm(w - start[k])
                   for k, w in want_params.items()]
            assert np.median(rel) <= 0.05, np.median(rel)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5)
            _check_params(_state(model.net_g), want_params, LR_NET, 1,
                          0.999)


def test_realesrgan_two_steps_match_jax():
    """``RealESRGANModel``: the pixel and GAN terms against ``gt_usm``,
    the perceptual one against ``gt``, LDL against ``gt`` with the EMA's
    output; two steps from one synthesised batch: the logged terms, both
    nets' parameters and every ``u`` / ``v`` (two iterations a step
    kept: the discriminator's real and fake passes; the generator's pass
    iterates and drops its result)."""
    jax_model, model = _pair('RealESRGANModel')
    batch = _synthesised(model)
    assert not np.allclose(batch['gt_usm'], batch['gt'])
    lq, gt_pix, gt_percep, gt_gan, gt_ldl = model._train_step_inputs()
    assert gt_pix is model.gt_usm and gt_gan is model.gt_usm
    assert gt_percep is model.gt and gt_ldl is model.gt
    ldl = []
    for step in range(1, STEPS + 1):
        jax_model.lq, jax_model.gt = batch['lq'], batch['gt']
        jax_model.gt_usm = batch['gt_usm']
        jax_model.optimize_parameters(step)
        model.lq, model.gt, model.gt_usm = (
            torch.from_numpy(batch[k]) for k in ('lq', 'gt', 'gt_usm'))
        model.optimize_parameters(step)
        got = model.get_current_log()
        want = {k: float(v) for k, v in jax_model.get_current_log().items()}
        assert sorted(got) == sorted(want) == sorted(
            ['l_g_pix', 'l_g_ldl', 'l_g_percep', 'l_g_gan', 'l_d_real',
             'l_d_fake', 'out_d_real', 'out_d_fake'])
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-5,
                                       atol=1e-8, err_msg=f'{step} {key}')
        ldl.append(got['l_g_ldl'])
        _check_params(_state(model.net_g),
                      _torch_named(jax_model.variables['params']), LR_GAN,
                      1, 0.999)
        d_state, want_d = _state(model.net_d), _jax_d_state(jax_model.vars_d)
        vectors = [k for k in want_d if k.endswith(('weight_u', 'weight_v'))]
        for key in vectors:
            _close(d_state[key], want_d[key])
        _check_params(d_state, {k: v for k, v in want_d.items()
                                if k not in vectors}, LR_GAN, 1, 0.999)
    assert ldl[0] > 0


def test_validation_runs_without_synthesis(tmp_path):
    """``nondist_validation`` on an lq / gt folder feeds the pairs as
    they are (the synthesizer is not called), restores training mode and
    scores the EMA net's output of each lq."""
    from mrefsr_tpu_torch.metrics import calculate_metric
    from mrefsr_tpu_torch.utils import tensor2img
    rng = np.random.RandomState(5)
    for sub in ('gt', 'lq'):
        (tmp_path / sub).mkdir()
    for name in ('p', 'q'):
        img = (rng.rand(32, 24, 3) * 255).astype(np.uint8)
        cv2.imwrite(str(tmp_path / 'gt' / f'{name}.png'), img)
        cv2.imwrite(str(tmp_path / 'lq' / f'{name}.png'), img[::4, ::4])
    val_opt = {'name': 'val', 'type': 'RealESRGANPairedDataset',
               'phase': 'val', 'scale': SCALE, 'io_backend': {'type': 'disk'},
               'dataroot_gt': str(tmp_path / 'gt'),
               'dataroot_lq': str(tmp_path / 'lq')}
    loader = build_dataloader(build_dataset(val_opt), val_opt)
    for model_type in ('RealESRNetModel', 'RealESRGANModel'):
        model = build_model(_model_opt(model_type, str(tmp_path)),
                            device='cpu')
        model.synth.degrade = None     # a call would raise
        model.nondist_validation(loader, 1, None, False)
        assert model.is_train
        want = []
        for item in loader:
            out = model.eval_forward(torch.from_numpy(item['lq']))
            want.append(calculate_metric(
                {'img': tensor2img(out), 'img2': tensor2img(
                    torch.from_numpy(item['gt']))},
                model.opt['val']['metrics']['psnr']))
        np.testing.assert_allclose(model.metric_results['psnr'],
                                   np.mean(want), rtol=1e-12)


def test_cli_two_iterations(tmp_path):
    """``RealESRGANModel`` through ``train_pipeline`` on the CPU: a
    ``RealESRGANDataset`` PNG folder, two iterations, a checkpoint (the
    discriminator's in torch's ``spectral_norm`` names) and validation on
    a ``RealESRGANPairedDataset`` folder at iteration 2."""
    rng = np.random.RandomState(6)
    for sub in ('hr', 'gt', 'lq'):
        (tmp_path / sub).mkdir()
    for i in range(4):
        cv2.imwrite(str(tmp_path / 'hr' / f'{i}.png'),
                    (rng.rand(72, 70, 3) * 255).astype(np.uint8))
    img = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / 'gt' / 'v.png'), img)
    cv2.imwrite(str(tmp_path / 'lq' / 'v.png'), img[::4, ::4])
    opt = _model_opt('RealESRGANModel')
    opt.pop('path')
    opt.update(name='realesrgan_cli', datasets={
        'train': {'name': 'hr', 'type': 'RealESRGANDataset',
                  'dataroot_gt': str(tmp_path / 'hr'),
                  'io_backend': {'type': 'disk'}, 'use_hflip': True,
                  'use_rot': False, 'crop_pad_size': 64, **KERNEL_OPTS,
                  'batch_size_per_gpu': B, 'num_worker_per_gpu': 2,
                  'dataset_enlarge_ratio': 1},
        'val': {'name': 'pair', 'type': 'RealESRGANPairedDataset',
                'dataroot_gt': str(tmp_path / 'gt'),
                'dataroot_lq': str(tmp_path / 'lq'),
                'io_backend': {'type': 'disk'}}},
        path={'pretrain_network_g': None, 'strict_load_g': True,
              'resume_state': None,
              'experiments_root': str(tmp_path / 'experiments')},
        logger={'print_freq': 1, 'save_checkpoint_freq': 2,
                'use_tb_logger': False},
        dist_params={'backend': 'gloo', 'port': 29500})
    opt['train']['total_iter'] = 2
    opt['val'] = dict(opt['val'], val_freq=2, save_img=False)
    yml = tmp_path / 'realesrgan.yml'
    yml.write_text(yaml.safe_dump(opt))
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logging.getLogger('mrefsr_tpu_torch').addHandler(handler)
    try:
        train_pipeline(str(tmp_path), ['-opt', str(yml), '--device', 'cpu'])
    finally:
        logging.getLogger('mrefsr_tpu_torch').removeHandler(handler)
    text = '\n'.join(records)
    assert 'l_g_ldl' in text and 'l_d_real' in text, text[-2000:]
    assert 'Validation pair' in text, text[-2000:]
    models = tmp_path / 'experiments' / 'realesrgan_cli' / 'models'
    net_d = torch.load(models / 'net_d_2.pth', weights_only=True)['params']
    assert 'conv1.weight_orig' in net_d and 'conv8.weight_v' in net_d
    assert (models / 'net_g_2.pth').is_file()
