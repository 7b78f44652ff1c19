"""The port's launchers (``mrefsr_tpu_torch/scripts/dist_train.sh`` and
``dist_test.sh``) against the JAX package's (``scripts/dist_*.sh``), with
stub ``python`` and ``torchrun`` programs first on ``PATH`` that record
their arguments: with one GPU both run the CLI in one process on the same
options and extra arguments (the JAX one ``train.py`` / ``test.py``, the
port ``-m mrefsr_tpu_torch.train`` / ``.test``); with more the port runs
``torchrun`` with a process a GPU and ``--launcher pytorch``, where the
JAX one runs one process a host with ``--launcher jax``."""
import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = '#!/bin/sh\necho "$(basename "$0") $*" >> "$STUB_LOG"\n'


@pytest.fixture
def stubs(tmp_path):
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    for name in ('python', 'torchrun'):
        path = bin_dir / name
        path.write_text(STUB)
        path.chmod(0o755)
    log = tmp_path / 'calls.log'
    env = dict(os.environ, STUB_LOG=str(log),
               PATH=f'{bin_dir}{os.pathsep}{os.environ["PATH"]}')

    def run(script, *args):
        if log.exists():
            log.unlink()
        subprocess.run(['bash', script, *args], cwd=REPO, env=env,
                       check=True, timeout=60)
        return log.read_text().splitlines()

    return run


@pytest.mark.parametrize('cli', ['train', 'test'])
def test_one_gpu_runs_one_process(stubs, cli):
    extra = ('opts/x.yml', '--auto_resume', '--force_yml', 'a=b c')
    (jax_call,) = stubs(os.path.join('scripts', f'dist_{cli}.sh'), '1',
                        *extra)
    (port_call,) = stubs(os.path.join('mrefsr_tpu_torch', 'scripts',
                                      f'dist_{cli}.sh'), '1', *extra)
    tail = '-opt opts/x.yml --auto_resume --force_yml a=b c'
    assert jax_call == f'python {cli}.py {tail}'
    assert port_call == f'python -m mrefsr_tpu_torch.{cli} {tail}'


@pytest.mark.parametrize('cli', ['train', 'test'])
def test_several_gpus_run_torchrun(stubs, cli):
    (port_call,) = stubs(os.path.join('mrefsr_tpu_torch', 'scripts',
                                      f'dist_{cli}.sh'), '4', 'opts/x.yml',
                         '--debug')
    assert port_call == (f'torchrun --nproc_per_node 4 -m '
                         f'mrefsr_tpu_torch.{cli} -opt opts/x.yml '
                         f'--launcher pytorch --debug')
    (jax_call,) = stubs(os.path.join('scripts', f'dist_{cli}.sh'), '4',
                        'opts/x.yml', '--debug')
    assert jax_call == (f'python {cli}.py -opt opts/x.yml --launcher jax '
                        f'--debug')
