"""The port's CLIs end to end on the CPU (``--device cpu``), at the dry run's
widths on seeded image folders: ``train_pipeline`` (the decisions its
docstring lists: a process's batch, logging, saving and validating at each
multiple, kernels built before the first collective, preemption and
``--auto_resume``), ``test_pipeline``, two gloo ranks under
``--launcher pytorch``, and the refusal to run on the CPU unasked."""
import copy
import logging
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

import torch_cli_data
from mrefsr_tpu_torch.data import build_dataloader, build_dataset
from mrefsr_tpu_torch.models import build_model
from mrefsr_tpu_torch.ops import _build
from mrefsr_tpu_torch.test import test_pipeline as run_test_pipeline
from mrefsr_tpu_torch.train import train_pipeline
from mrefsr_tpu_torch.utils import options

REPO = Path(__file__).resolve().parents[1]
WAIT_S = 240                       # a CLI subprocess's time limit
ITER_LINE = re.compile(r'iter:\s*([\d,]+), lr')


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tensors here are tiny, and the test workers of one run share
    the host's cores: more threads per process only get in each other's
    way."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _write(path, opt):
    with open(path, 'w') as f:
        yaml.safe_dump(opt, f)
    return str(path)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _logged(run):
    """``run()``'s return and the port logger's messages."""
    lines = _Lines()
    logger = logging.getLogger('mrefsr_tpu_torch')
    logger.addHandler(lines)
    try:
        return run(), lines.messages
    finally:
        logger.removeHandler(lines)


def _iters(text):
    return [int(v.replace(',', '')) for v in ITER_LINE.findall(text)]


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """One in-process run of the tiny YAML: 4 iterations, B 2, logs, saves
    and validates every 2, ``steps_per_dispatch`` 16, ``num_gpu`` 8."""
    root = tmp_path_factory.mktemp('cli')
    opt = torch_cli_data.tiny_options(str(root))
    yml = _write(root / 'tiny.yml', opt)
    model, messages = _logged(lambda: train_pipeline(
        str(root), ['-opt', yml, '--device', 'cpu']))
    return {'root': root, 'opt': opt, 'yml': yml, 'model': model,
            'log': '\n'.join(messages)}


def test_train_cli_fires_at_each_multiple(trained):
    """With ``steps_per_dispatch`` 16 the JAX CLI would log, save and
    validate once, where a wave of 16 crosses 2 (at iteration 4, the
    run's end); the port's loop takes one batch an iteration and fires at
    2 and at 4, then saves the latest and validates once more."""
    log, root = trained['log'], trained['root']
    assert _iters(log) == [2, 4]
    assert log.count('Saving models and training states.') == 2
    assert log.count('# Validation tiny_cufed # PSNR') == 3
    exp = root / 'experiments' / 'tiny'
    assert sorted(os.listdir(exp / 'models')) == [
        'net_g_2.pth', 'net_g_4.pth', 'net_g_latest.pth']
    assert sorted(os.listdir(exp / 'training_states')) == [
        '2.state', '4.state']
    assert (exp / 'tiny.yml').read_text().startswith('# GENERATE TIME')
    assert any(name.startswith('train_tiny_') for name in os.listdir(exp))
    model = trained['model']
    assert model.train_dtype == torch.bfloat16
    assert np.isfinite(model.metric_results['psnr'])
    state = torch.load(exp / 'training_states' / '4.state',
                       weights_only=True)
    assert state['iter'] == 4 and state['epoch'] == 1


def test_train_cli_batch_is_the_process_batch(trained):
    """``batch_size_per_gpu`` is the loader's batch; ``num_gpu`` (8 here)
    multiplies nothing; the global batch is logged."""
    log = trained['log']
    assert 'Batch size per process: 2' in log
    assert 'World size (processes): 1' in log
    assert 'Global batch size: 2' in log
    assert 'Require iter number per epoch: 2' in log


def test_test_cli_equals_the_model_it_loads(trained, tmp_path):
    """``test_pipeline`` with the run's ``net_g_latest.pth``: it writes one
    output an image and its metrics are those of a model loaded from the
    same file and validated on the same loader in this process."""
    opt = torch_cli_data.eval_options(str(tmp_path), trained['opt'])
    latest = trained['root'] / 'experiments/tiny/models/net_g_latest.pth'
    opt['path']['pretrain_network_g'] = str(latest)
    yml = _write(tmp_path / 'test.yml', opt)
    model = run_test_pipeline(str(tmp_path), ['-opt', yml, '--device', 'cpu'])
    saved = tmp_path / 'results' / 'tiny_test' / 'visualization' / 'tiny_cufed'
    assert sorted(os.listdir(saved)) == ['000_multi_tiny_test.png',
                                         '001_multi_tiny_test.png']
    here = build_model(dict(opt, is_train=False, dist=False,
                            path=dict(opt['path'], visualization='')),
                       device='cpu')
    dataset_opt = dict(opt['datasets']['test_1'], phase='test', scale=4)
    here.validation(build_dataloader(build_dataset(dataset_opt),
                                     dataset_opt), 'x', None, save_img=False)
    assert here.metric_results == model.metric_results


def test_cli_without_a_card_raises(monkeypatch, trained):
    """Without ``--device cpu`` and with no card both CLIs raise before
    they make a directory."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for run in (train_pipeline, run_test_pipeline):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            run(str(trained['root'] / 'nowhere'), ['-opt', trained['yml']])
    assert not (trained['root'] / 'nowhere').exists()


def test_kernels_are_built_before_the_first_collective(monkeypatch,
                                                        trained):
    """On a CUDA device ``parse_options`` builds every kernel, then joins
    the process group with the YAML's ``dist_params``."""
    calls = []
    monkeypatch.setattr(options, 'resolve_device',
                        lambda device: torch.device('cuda', 0))
    monkeypatch.setattr(_build, 'build', lambda: calls.append('build'))
    monkeypatch.setattr(options, 'init_dist', lambda launcher, **kw:
                        calls.append(('init_dist', launcher, kw)))
    opt, _ = options.parse_options(str(trained['root']), True, [
        '-opt', trained['yml'], '--launcher', 'pytorch'])
    assert calls == ['build', ('init_dist', 'pytorch',
                               {'backend': 'gloo', 'port': 29739})]
    assert opt['dist'] is True


def _env():
    env = dict(os.environ, OMP_NUM_THREADS='2')
    env.pop('CUDA_VISIBLE_DEVICES', None)
    return env


def _wait(proc, until=None, then=None):
    """``proc``'s exit code and output; ``then()`` once its output first
    matches ``until``."""
    out, t0 = [], time.monotonic()
    try:
        for line in proc.stdout:
            out.append(line)
            if until is not None and until.search(line):
                then()
                until = None
            assert time.monotonic() - t0 < WAIT_S, ''.join(out[-40:])
        return proc.wait(timeout=WAIT_S), ''.join(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _cli(args, env=None):
    return subprocess.Popen(
        [sys.executable, '-m', 'mrefsr_tpu_torch.train', *args],
        cwd=REPO, env=env or _env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def test_sigterm_saves_and_auto_resume_continues(trained, tmp_path):
    """A SIGTERM after iteration 2 ends the iteration, saves its ``.state``
    and ``.pth`` and exits 0; ``--auto_resume`` loads the newest state and
    runs from that iteration to the end."""
    opt = dict(trained['opt'], name='preempt')
    opt['path'] = dict(opt['path'], experiments_root=str(tmp_path))
    opt['logger'] = dict(opt['logger'], print_freq=1,
                         save_checkpoint_freq=1000)
    opt['val'] = dict(opt['val'], val_freq=1000)
    opt['train'] = dict(opt['train'], total_iter=200)
    yml = _write(tmp_path / 'preempt.yml', opt)
    proc = _cli(['-opt', yml, '--device', 'cpu'])
    rc, out = _wait(proc, re.compile(r'iter:\s*2, lr'),
                    lambda: proc.send_signal(signal.SIGTERM))
    assert rc == 0, out[-3000:]
    stopped = int(re.search(r'saving state at iter (\d+)', out).group(1))
    assert 2 <= stopped < 200 and _iters(out)[-1] == stopped
    states = tmp_path / 'preempt' / 'training_states'
    assert os.listdir(states) == [f'{stopped}.state']
    assert (tmp_path / 'preempt' / 'models' /
            f'net_g_{stopped}.pth').is_file()

    rc, out = _wait(_cli(['-opt', yml, '--device', 'cpu', '--auto_resume',
                          '--force_yml', f'train:total_iter={stopped + 2}']))
    assert rc == 0, out[-3000:]
    assert re.search(rf'Resuming training from epoch: \d+, iter: {stopped}\.',
                     out)
    assert _iters(out) == [stopped + 1, stopped + 2]
    assert 'End of training' in out
    assert (tmp_path / 'preempt' / 'models' / 'net_g_latest.pth').is_file()


def test_two_gloo_ranks(trained, tmp_path):
    """``--launcher pytorch`` with two ranks over gloo (a ``file://``
    rendezvous: no port to collide under xdist): DDP training, the global
    batch of 4 logged, validation sharded, rank 0 alone writes."""
    opt = dict(trained['opt'], name='ranks')
    opt['path'] = dict(opt['path'], experiments_root=str(tmp_path))
    opt['datasets'] = dict(opt['datasets'], train=dict(
        opt['datasets']['train'], dataset_enlarge_ratio=2))
    yml = _write(tmp_path / 'ranks.yml', opt)
    procs = []
    for rank in range(2):
        env = dict(_env(), RANK=str(rank), WORLD_SIZE='2',
                   LOCAL_RANK=str(rank))
        procs.append(_cli([
            '-opt', yml, '--device', 'cpu', '--launcher', 'pytorch',
            '--force_yml', 'dist_params:init_method='
            f'file://{tmp_path}/rendezvous'], env))
    results = [_wait(proc) for proc in procs]
    for rc, out in results:
        assert rc == 0, out[-3000:]
    log = results[0][1]
    assert 'World size (processes): 2' in log
    assert 'Global batch size: 4' in log
    assert _iters(log) == [2, 4]
    assert log.count('# Validation tiny_cufed # PSNR') == 3
    assert _iters(results[1][1]) == []          # rank 1 logs errors only
    assert sorted(os.listdir(tmp_path / 'ranks' / 'models')) == [
        'net_g_2.pth', 'net_g_4.pth', 'net_g_latest.pth']


# ----------------------------------------------- the GAN YAML through the CLI
GAN_YML = REPO / 'options' / 'ab' / 'ab_dcn_gan.yml'


def _gan_args(root, data, iters, *extra):
    """``ab_dcn_gan.yml`` as shipped but for tiny widths (ngf 8, 1 block, 2
    deform groups, ndf 4), the tiny folders, B 2 at gt 32, the boundary at
    2, logs every iteration and a checkpoint every 2."""
    md, ann, cufed = data
    return ['-opt', str(GAN_YML), '--device', 'cpu', '--force_yml',
            'network_g:ngf=8', 'network_g:n_blocks=1', 'network_g:groups=2',
            'network_d:ndf=4', f'datasets:train:dataroot_in={md}',
            f'datasets:train:dataroot_ref={md}',
            f'datasets:train:ann_file={ann}', 'datasets:train:gt_size=32',
            'datasets:train:batch_size_per_gpu=2',
            'datasets:train:num_worker_per_gpu=2',
            'datasets:train:decode_cache_size=16',
            'datasets:train:dataset_enlarge_ratio=2',
            f'datasets:val:dataroot_in={cufed}',
            f'datasets:val:dataroot_ref={cufed}', 'datasets:val:pad_to=64',
            'path:pretrain_network_feature_extractor=~',
            f'path:experiments_root={root}', f'train:total_iter={iters}',
            'train:net_g_pretrain_steps=2', 'logger:print_freq=1',
            'logger:save_checkpoint_freq=2', 'val:val_freq=1000', *extra]


def _same_state(a, b):
    if isinstance(a, dict):
        return sorted(a, key=str) == sorted(b, key=str) and all(
            _same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_state, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_gan_yml_trains_across_the_boundary_and_resumes(tmp_path):
    """``ab_dcn_gan.yml`` through ``train_pipeline``: bf16 pixel steps at
    1 and 2, f32 GAN steps from 3 logging the JAX package's keys,
    ``net_d_<iter>.pth`` beside ``net_g``, a ``.state`` of both optimizers
    and schedulers; ``--auto_resume`` from iteration 4 restores ``net_d``
    and both optimizers bit for bit and trains on to 6."""
    from mrefsr_tpu_torch.models.multi_ref_restoration_model import \
        MultiRefRestorationModel as Model
    md, ann = torch_cli_data.write_lmr(str(tmp_path))
    data = (md, ann, torch_cli_data.write_cufed(str(tmp_path)))
    model, messages = _logged(lambda: train_pipeline(
        str(tmp_path), _gan_args(tmp_path, data, 4)))
    log = '\n'.join(messages)
    assert _iters(log) == [1, 2, 3, 4]
    lines = [m for m in messages if ITER_LINE.search(m)]
    assert 'l_pix' in lines[1] and 'l_d_real' not in lines[1]
    for key in ('l_d_real', 'l_d_fake', 'out_d_real', 'out_d_fake',
                'l_grad_penalty', 'l_g_pix', 'l_g_gan'):
        assert key in lines[2] and key in lines[3], key
    assert model.train_dtype == torch.bfloat16
    exp = tmp_path / 'ab_dcn_gan'
    assert sorted(os.listdir(exp / 'models')) == [
        'net_d_2.pth', 'net_d_4.pth', 'net_d_latest.pth', 'net_g_2.pth',
        'net_g_4.pth', 'net_g_latest.pth']
    state = torch.load(exp / 'training_states' / '4.state',
                       weights_only=True)
    assert len(state['optimizers']) == len(state['schedulers']) == 2
    saved_d = torch.load(exp / 'models' / 'net_d_4.pth',
                         weights_only=True)['params']

    resumed = {}
    resume_training = Model.resume_training

    def recorded(self, resume_state):
        resume_training(self, resume_state)
        resumed['optimizers'] = copy.deepcopy(
            [o.state_dict() for o in self.optimizers])
        resumed['net_d'] = {k: v.clone()
                            for k, v in self.net_d.state_dict().items()}

    with mock.patch.object(Model, 'resume_training', recorded):
        model, messages = _logged(lambda: train_pipeline(
            str(tmp_path), _gan_args(tmp_path, data, 6, '--auto_resume')))
    assert _iters('\n'.join(messages)) == [5, 6]
    assert _same_state(resumed['optimizers'], state['optimizers'])
    assert _same_state(resumed['net_d'], saved_d)
    assert 'l_g_gan' in model.get_current_log()


# ----------------------------------------------------- A3: the serving buckets
SERVING_YML = REPO / 'options' / 'test' / 'test_5ref_cufed5_serving.yml'
# (h, w) of the two images: canvases 332x332 and 332x416 under
# pad_to [332, 416, 500]
SERVING_SIZES = ((300, 320), (328, 400))
# The two bf16 evals round every activation to bf16 in other places
# (tests/test_torch_bf16.py: max EPS, mean EPS / 8 of the [0, 1] output).
# On the saved uint8 images, each side rounded to a level: every pixel
# within 255 * EPS + 1 levels and their mean within 255 * EPS / 4 (at
# these 332-px canvases the two evals part by more on average than at
# test_torch_bf16.py's 32 px: measured 0.33 levels, 0.16 EPS, and at most
# 2 levels); the per-image PSNR within 0.05 dB and SSIM within 1e-3
# (measured 1.2e-3 dB and 2.7e-4 on Y).
EPS = 2.0 ** -7
SERVING_MAX_LEVELS, SERVING_MEAN_LEVELS = 255 * EPS + 1, 255 * EPS / 4
SERVING_PSNR_DB, SERVING_SSIM = 0.05, 1e-3


def _seeded_jax_model(opt):
    """The JAX package's model of ``opt``'s nets and seed, initialised as
    its CLI initialises one (the flax init depends on the seed and the
    nets, not on the batch)."""
    from mrefsr_tpu.models import build_model as jax_build_model
    jax_model = jax_build_model(dict(opt, is_train=False, dist=False,
                                     path={}))
    rng = np.random.RandomState(0)
    jax_model.feed_data({
        'img_in': rng.rand(1, 32, 32, 3), 'img_in_up': rng.rand(1, 32, 32, 3),
        'img_in_lq': rng.rand(1, 8, 8, 3),
        'img_ref_list': rng.rand(1, 5, 32, 32, 3)})
    return jax_model


def test_serving_yml_matches_the_jax_test_cli(tmp_path, monkeypatch):
    """``test_5ref_cufed5_serving.yml`` (per-dimension ``pad_to`` buckets,
    bf16) through the port's ``test_pipeline`` and the JAX package's, at
    tiny widths, on two images in two buckets: the port's model takes the
    JAX CLI's seeded weights (``load_from_flax``; the YAML's checkpoints
    are not in the repository); every saved output and its PSNR and SSIM
    (on Y, at the crop border) against the JAX package's."""
    import cv2
    from mrefsr_tpu.test import test_pipeline as jax_test_pipeline
    from mrefsr_tpu_torch import test as port_test
    from mrefsr_tpu_torch.metrics import calculate_psnr, calculate_ssim
    cufed = torch_cli_data.write_cufed(str(tmp_path), SERVING_SIZES)
    with open(SERVING_YML) as f:
        opt = yaml.safe_load(f)
    opt['network_g'].update(ngf=8, n_blocks=1, groups=2)
    jax_model = _seeded_jax_model(opt)
    build = port_test.build_model

    def build_with_jax_weights(opt, device=None):
        model = build(opt, device=device)
        model.load_from_flax(jax_model.vars_extractor, jax_model.vars_map,
                             jax_model.vars_g)
        return model

    monkeypatch.setattr(port_test, 'build_model', build_with_jax_weights)
    args = ['-opt', str(SERVING_YML), '--force_yml',
            f'datasets:test_1:dataroot_in={cufed}',
            f'datasets:test_1:dataroot_ref={cufed}',
            'network_g:ngf=8', 'network_g:n_blocks=1', 'network_g:groups=2',
            'path:pretrain_network_g=~',
            'path:pretrain_network_feature_extractor=~']
    ours = run_test_pipeline(str(tmp_path / 'port'), args + [
        f'path:results_root={tmp_path / "port"}', '--device', 'cpu'])
    theirs = jax_test_pipeline(str(tmp_path / 'jax'), args + [
        f'path:results_root={tmp_path / "jax"}'])
    assert ours.eval_dtype == torch.bfloat16
    dataset = build_dataset(dict(ours.opt['datasets']['test_1']))
    assert sorted({item['img_in_up'].shape[:2] for item in dataset}) == [
        (332, 332), (332, 416)]
    name = ours.opt['name']
    for i, (h, w) in enumerate(SERVING_SIZES):
        gt = cv2.imread(os.path.join(cufed, f'{i:03d}_0.png'))[:h, :w]
        imgs = [cv2.imread(str(tmp_path / side / name / 'visualization'
                               / 'CUFED5' / f'{i:03d}_multi_{name}.png'))
                for side in ('port', 'jax')]
        assert imgs[0].shape == imgs[1].shape == gt.shape
        diff = np.abs(imgs[0].astype(float) - imgs[1])
        assert diff.max() <= SERVING_MAX_LEVELS
        assert diff.mean() <= SERVING_MEAN_LEVELS
        psnr = [calculate_psnr(img, gt, 4, test_y_channel=True)
                for img in imgs]
        ssim = [calculate_ssim(img, gt, 4, test_y_channel=True)
                for img in imgs]
        assert abs(psnr[0] - psnr[1]) <= SERVING_PSNR_DB
        assert abs(ssim[0] - ssim[1]) <= SERVING_SSIM
    for key in ('psnr', 'psnr_y', 'ssim_y'):
        assert ours.metric_results[key] == pytest.approx(
            float(theirs.metric_results[key]),
            abs=SERVING_SSIM if key == 'ssim_y' else SERVING_PSNR_DB)
