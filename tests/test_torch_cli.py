"""The port's CLIs end to end on the CPU (``--device cpu``), at the dry run's
widths on seeded image folders: ``train_pipeline`` (the decisions its
docstring lists: a process's batch, logging, saving and validating at each
multiple, kernels built before the first collective, preemption and
``--auto_resume``), ``test_pipeline``, two gloo ranks under
``--launcher pytorch``, and the refusal to run on the CPU unasked."""
import logging
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

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
