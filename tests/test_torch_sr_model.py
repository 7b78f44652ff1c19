"""The port's ``SRModel`` with ``MSRResNet`` (num_feat 8, 2 blocks, x4)
against the JAX package's on the CPU, from the same flax weights: one
backward's gradients by name, a 3-step trajectory with the EMA, the bf16
step's gradients by norm, ``test`` with ``pad_multiple``,
``nondist_validation``'s metrics, loading a checkpoint the JAX model saved,
and save -> ``--auto_resume`` through the training CLI."""
import contextlib
import logging

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mrefsr_tpu.convert import flax_to_torch
from mrefsr_tpu.data import build_dataloader as jax_build_dataloader
from mrefsr_tpu.data import build_dataset as jax_build_dataset
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu_torch.archs import build_network
from mrefsr_tpu_torch.convert import state_dict_from_flax
from mrefsr_tpu_torch.data import build_dataloader, build_dataset
from mrefsr_tpu_torch.models import build_model
from mrefsr_tpu_torch.train import train_pipeline

NET = {'type': 'MSRResNet', 'num_in_ch': 3, 'num_out_ch': 3, 'num_feat': 8,
       'num_block': 2, 'upscale': 4}
LR, DECAY, STEPS, B, GT = 2e-4, 0.9, 3, 2, 32
EPS = 2.0 ** -7


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _opt(root=None, train_mp=None, val=None):
    """BasicSR's ``train_MSRResNet_x4.yml`` train block (L1, Adam 2e-4,
    betas (0.9, 0.99)) at num_feat 8, 2 blocks, with an EMA of decay 0.9
    so that three steps move it."""
    root = root or '/nonexistent'
    opt = {'name': 'sr_test', 'model_type': 'SRModel', 'scale': 4,
           'num_gpu': 1, 'manual_seed': 0, 'is_train': True, 'dist': False,
           'rank': 0, 'world_size': 1, 'network_g': dict(NET),
           'path': {'pretrain_network_g': None, 'strict_load_g': True,
                    'models': f'{root}/models',
                    'training_states': f'{root}/states',
                    'visualization': f'{root}/vis'},
           'train': {'ema_decay': DECAY,
                     'optim_g': {'type': 'Adam', 'lr': LR,
                                 'betas': [0.9, 0.99]},
                     'scheduler': {'type': 'MultiStepLR', 'milestones': [2],
                                   'gamma': 0.5},
                     'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0,
                                   'reduction': 'mean'},
                     'total_iter': 10, 'warmup_iter': -1},
           'val': val or {'metrics': {
               'psnr': {'type': 'calculate_psnr', 'crop_border': 4,
                        'test_y_channel': False},
               'ssim': {'type': 'calculate_ssim_pt', 'crop_border': 4,
                        'test_y_channel': True}}},
           'datasets': {}}
    if train_mp:
        opt['train']['mixed_precision'] = train_mp
    return opt


def _batch(rng, b=B, gt=GT):
    return {'lq': rng.rand(b, gt // 4, gt // 4, 3).astype(np.float32),
            'gt': rng.rand(b, gt, gt, 3).astype(np.float32)}


def _torch_named(tree):
    return {k: np.asarray(v) for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


@contextlib.contextmanager
def _port_log(level=logging.INFO):
    """The lines the port's logger writes meanwhile (it does not
    propagate to the root logger), joined."""
    lines = []
    handler = logging.Handler(level)
    handler.emit = lambda record: lines.append(record.getMessage())
    port = logging.getLogger('mrefsr_tpu_torch')
    before = port.level
    port.addHandler(handler)
    port.setLevel(min(level, before or level))
    try:
        yield lines
    finally:
        port.removeHandler(handler)
        port.setLevel(before)


def _pair(jax_opt, port_opt=None, batch=None):
    """A JAX model initialised on ``batch`` and the port's from its
    variables."""
    jax_model = jax_build_model(jax_opt)
    jax_model.feed_data(batch)
    model = build_model(port_opt or jax_opt, device='cpu')
    model.load_from_flax(jax_model.variables)
    return jax_model, model


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """One backward of each, then STEPS steps of each on one batch; the
    JAX step compiles once."""
    root = tmp_path_factory.mktemp('sr')
    batch = _batch(np.random.RandomState(0))
    jax_model, model = _pair(_opt(root), batch=batch)
    params = jax_model.variables['params']

    def loss_fn(p):
        out = jax_model.net_g.apply({'params': p}, jnp.asarray(batch['lq']))
        return jax_model.cri_pix(out, jnp.asarray(batch['gt']))

    loss_jax, grads_jax = jax.jit(jax.value_and_grad(loss_fn))(params)
    model.feed_data(batch)
    loss = model.cri_pix(model._run(model.net_g, torch.float32, False,
                                    model.lq), model.gt)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.net_g.named_parameters()}
    start = {k: v.clone() for k, v in model.net_g.state_dict().items()}
    losses, losses_jax = [], []
    for step in range(1, STEPS + 1):
        jax_model.feed_data(batch)
        jax_model.optimize_parameters(step)
        losses_jax.append(float(jax_model.get_current_log()['l_pix']))
        model.feed_data(batch)
        model.optimize_parameters(step)
        losses.append(model.get_current_log()['l_pix'])
    return {'root': root, 'batch': batch, 'jax': jax_model, 'model': model,
            'fresh': (float(loss), float(loss_jax), grads,
                      _torch_named(grads_jax)),
            'losses': (losses, losses_jax), 'start': start}


def test_msrresnet_matches_flax():
    """The net alone at x2, x3, x4 (measured: within 2.1e-7 of the
    output's largest entry)."""
    rng = np.random.RandomState(3)
    x = rng.rand(2, 9, 7, 3).astype(np.float32)
    from mrefsr_tpu.archs import build_network as jax_build_network
    for upscale in (2, 3, 4):
        opt = dict(NET, upscale=upscale)
        net = jax_build_network(opt)
        variables = net.init(jax.random.PRNGKey(1), x)
        want = np.asarray(net.apply(variables, x))
        port = build_network(opt)
        port.load_state_dict(state_dict_from_flax(variables['params']),
                             strict=True)
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_gradients_match_jax_by_name(run):
    """Measured: loss within 5.1e-7 relative, every gradient within
    9.9e-7 of its largest entry."""
    loss, loss_jax, got, want = run['fresh']
    assert loss == pytest.approx(loss_jax, rel=1e-5)
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        err = np.abs(got[name].numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), name


def test_trajectory_with_ema_matches_jax(run):
    """The losses within rtol 1e-5, and after three steps every parameter
    and every EMA parameter within lr / 100 of JAX's (measured: 7.5e-9
    each)."""
    got, want = run['losses']
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    jax_model, model = run['jax'], run['model']
    params = _torch_named(jax_model.variables['params'])
    ema = _torch_named(jax_model.ema_variables['params'])
    start = run['start']
    for name, p in model.net_g.named_parameters():
        assert np.abs(p.detach().numpy() - params[name]).max() <= LR / 100
        e = model.net_g_ema.state_dict()[name].numpy()
        assert np.abs(e - ema[name]).max() <= LR / 100, name
        # the EMA lags the net: it moved, by less
        moved = np.abs(e - start[name].numpy()).max()
        assert 0 < moved < np.abs(p.detach().numpy()
                                  - start[name].numpy()).max() + 1e-12
    assert model.get_current_learning_rate() == [LR * 0.5]


def test_bf16_step_gradients_match_jax_by_norm():
    """``train.mixed_precision: bfloat16``: the JAX step's casts (every f32
    parameter and lq to bf16, the output back to f32 before the loss).
    Every activation and cotangent rounds to bf16, in other places in the
    two frameworks: with these inputs JAX's own bf16 gradients are a
    median 10.9 % (by norm) from its f32 ones, and the port's bf16 ones
    5.8 % from JAX's bf16 ones. ||g - g_jax|| / ||g_jax|| per tensor:
    median within 0.1, worst within 0.3 (measured 0.058 and 0.119); the
    loss within 3e-4 relative, as the multi-ref bf16 step's
    (``test_torch_bf16.py``; measured 9.9e-5); master gradients f32."""
    batch = _batch(np.random.RandomState(4))
    jax_model, model = _pair(_opt(train_mp='bfloat16'), batch=batch)
    bf = jnp.bfloat16

    def loss_fn(p):
        p = jax.tree_util.tree_map(lambda v: v.astype(bf), p)
        out = jax_model.net_g.apply({'params': p},
                                    jnp.asarray(batch['lq']).astype(bf))
        return jax_model.cri_pix(out.astype(jnp.float32),
                                 jnp.asarray(batch['gt']))

    loss_jax, grads_jax = jax.jit(jax.value_and_grad(loss_fn))(
        jax_model.variables['params'])
    want = _torch_named(grads_jax)
    model.feed_data(batch)
    loss = model.cri_pix(model._run(model.net_g, torch.bfloat16, False,
                                    model.lq), model.gt)
    loss.backward()
    assert float(loss) == pytest.approx(float(loss_jax), rel=3e-4)
    rel = {}
    for name, p in model.net_g.named_parameters():
        assert p.grad.dtype == torch.float32
        rel[name] = np.linalg.norm(p.grad.numpy() - want[name]) \
            / np.linalg.norm(want[name])
    assert np.median(list(rel.values())) <= 0.1
    assert max(rel.values()) <= 0.3, max(rel, key=rel.get)
    model.net_g.zero_grad(set_to_none=True)
    model.optimize_parameters(1)
    assert all(p.dtype == torch.float32 for p in model.net_g.parameters())


@pytest.mark.parametrize('mp', [None, 'bfloat16'])
def test_test_with_pad_multiple_matches_jax(run, mp):
    """``val.pad_multiple`` 4 on a 10x9 lq: reflect-padded to 12x12, the
    output cropped back to 40x36; through the EMA net, and at
    ``val.mixed_precision: bfloat16`` with the eval net cast once.
    Measured: f32 within 1.3e-7, bf16 within 0.64 EPS of the output's
    largest entry."""
    val = {'pad_multiple': 4}
    if mp:
        val['mixed_precision'] = mp
    lq = np.random.RandomState(5).rand(1, 10, 9, 3).astype(np.float32)
    jax_model, model = run['jax'], run['model']
    jax_model.opt['val'] = model.opt['val'] = val
    jax_model._eval_step = None
    model._cast_cache.clear()
    try:
        jax_model.feed_data({'lq': lq})
        jax_model.test()
        model.feed_data({'lq': lq})
        model.test()
    finally:
        jax_model.opt['val'] = model.opt['val'] = _opt()['val']
        jax_model._eval_step = None
    want = np.asarray(jax_model.output)
    got = model.output.numpy()
    assert got.shape == want.shape == (1, 40, 36, 3)
    tol = EPS if mp else 1e-5
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _paired_folder(root, n=3):
    rng = np.random.RandomState(6)
    for i in range(n):
        gt = (rng.rand(36, 44, 3) * 255).astype(np.uint8)
        lq = cv2.resize(gt, (11, 9), interpolation=cv2.INTER_AREA)
        (root / 'gt').mkdir(parents=True, exist_ok=True)
        (root / 'lq').mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(root / 'gt' / f'{i:03d}.png'), gt)
        cv2.imwrite(str(root / 'lq' / f'{i:03d}.png'), lq)
    return {'name': 'paired_val', 'type': 'PairedImageDataset',
            'phase': 'val', 'scale': 4, 'dataroot_gt': str(root / 'gt'),
            'dataroot_lq': str(root / 'lq'), 'io_backend': {'type': 'disk'}}


def test_nondist_validation_matches_jax(run, tmp_path):
    """PSNR (numpy) and SSIM_Y (batched) averaged over three images, from
    the trained weights (EMA); images saved under the visualization path.
    Measured: PSNR equal, SSIM within 3.1e-7 (the images agree to the
    byte; the SSIMs are float32 sums in two orders)."""
    ds_opt = _paired_folder(tmp_path)
    jax_loader = jax_build_dataloader(jax_build_dataset(ds_opt), ds_opt,
                                      num_gpu=1, dist=False)
    loader = build_dataloader(build_dataset(ds_opt), ds_opt)
    jax_model, model = run['jax'], run['model']
    jax_model.opt['path']['visualization'] = str(tmp_path / 'jax_vis')
    model.opt['path']['visualization'] = str(tmp_path / 'vis')
    jax_model.nondist_validation(jax_loader, 7, None, save_img=False)
    with _port_log() as lines:
        model.nondist_validation(loader, 7, None, save_img=True)
    assert set(model.metric_results) == {'psnr', 'ssim'}
    for key, value in jax_model.metric_results.items():
        assert model.metric_results[key] == pytest.approx(float(value),
                                                          abs=1e-4), key
    assert model.best_metric_results['paired_val']['psnr']['iter'] == 7
    assert len(list((tmp_path / 'vis').rglob('*_7.png'))) == 3
    assert any('Validation paired_val' in line for line in lines)


def test_loads_a_checkpoint_the_jax_model_saved(run, tmp_path):
    """``net_g_<iter>.pth`` from the JAX ``SRModel.save``: ``params`` into
    the net, ``params_ema`` into the EMA, strictly."""
    jax_model = run['jax']
    jax_model.opt['path']['models'] = str(tmp_path / 'models')
    jax_model.opt['path']['training_states'] = str(tmp_path / 'states')
    (tmp_path / 'models').mkdir()
    (tmp_path / 'states').mkdir()
    jax_model.save(0, STEPS)
    opt = _opt(tmp_path)
    opt['path']['pretrain_network_g'] = str(tmp_path / 'models'
                                            / f'net_g_{STEPS}.pth')
    model = build_model(opt, device='cpu')
    params = _torch_named(jax_model.variables['params'])
    ema = _torch_named(jax_model.ema_variables['params'])
    for name, p in model.net_g.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[name])
        np.testing.assert_array_equal(
            model.net_g_ema.state_dict()[name].numpy(), ema[name])


def test_non_strict_load_keeps_seeded_values_and_logs(tmp_path):
    """``strict_load_g: false`` with a file of another net width: every
    tensor of another size keeps its seeded value, with a log line; strict
    raises."""
    other = _opt(tmp_path)
    other['network_g'] = dict(NET, num_block=1)
    small = build_model(other, device='cpu')
    small.opt['path']['models'] = str(tmp_path)
    path = small.save_network(small.net_g, 'net_g', 1)
    opt = _opt(tmp_path)
    opt['path'].update(pretrain_network_g=path, strict_load_g=True)
    with pytest.raises(ValueError, match='missing key'):
        build_model(opt, device='cpu')
    opt['path']['strict_load_g'] = False
    seeded = build_model(_opt(tmp_path), device='cpu').net_g.state_dict()
    with _port_log(logging.WARNING) as lines:
        model = build_model(opt, device='cpu')
    loaded = small.net_g.state_dict()
    for key, value in model.net_g.state_dict().items():
        want = loaded[key] if key in loaded else seeded[key]
        assert torch.equal(value, want), key
    assert 'missing key in checkpoint: body.1.conv1.weight' in lines


def _cli_options(root, ds_opt, iters):
    train_ds = dict(ds_opt, name='paired_train', phase='train', gt_size=16,
                    use_hflip=True, use_rot=True, batch_size_per_gpu=2,
                    num_worker_per_gpu=0, dataset_enlarge_ratio=2)
    opt = _opt()
    opt.update(name='sr_cli', num_gpu=1,
               datasets={'train': train_ds, 'val': ds_opt},
               logger={'print_freq': 2, 'save_checkpoint_freq': 2,
                       'use_tb_logger': False},
               path={'pretrain_network_g': None, 'strict_load_g': True,
                     'resume_state': None},
               dist_params={'backend': 'gloo'})
    opt['train']['total_iter'] = iters
    opt['val'].update(val_freq=2, save_img=False)
    del opt['is_train'], opt['dist'], opt['rank'], opt['world_size']
    path = root / f'sr_{iters}.yml'
    path.write_text(yaml.safe_dump(opt))
    return path


def test_cli_trains_saves_validates_and_auto_resumes(tmp_path):
    """``python -m mrefsr_tpu_torch.train`` on ``SRModel`` and a paired
    folder, in this process: 4 iterations (saves and validates at 2 and
    4), then ``--auto_resume`` with ``total_iter`` 6 goes on from
    ``4.state``: its first step is iteration 5, its optimizer resumed from
    the saved state."""
    ds_opt = _paired_folder(tmp_path / 'data', n=4)
    first = train_pipeline(str(tmp_path), ['-opt', str(_cli_options(
        tmp_path, ds_opt, 4)), '--device', 'cpu'])
    states = tmp_path / 'experiments' / 'sr_cli' / 'training_states'
    assert (states / '4.state').is_file()
    assert set(first.metric_results) == {'psnr', 'ssim'}
    saved = torch.load(states / '4.state', weights_only=True)
    second = train_pipeline(str(tmp_path), ['-opt', str(_cli_options(
        tmp_path, ds_opt, 6)), '--auto_resume', '--device', 'cpu'])
    assert (states / '6.state').is_file()
    step = next(iter(second.optimizer_g.state.values()))['step']
    assert int(step) == 6
    assert saved['iter'] == 4
    assert second.schedulers[0].last_iter == 6
