"""Arch registry: every ``*_arch.py`` module of this package registers its
nets; :func:`build_network` looks up the options' ``type:`` string."""
import importlib
from copy import deepcopy
from pathlib import Path

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

__all__ = ['build_network']

for _path in sorted(Path(__file__).parent.glob('*_arch.py')):
    importlib.import_module(f'{__name__}.{_path.stem}')


def build_network(opt):
    """Instantiate a registered arch from its options dict (``type`` plus
    the constructor's keyword arguments)."""
    opt = deepcopy(opt)
    return ARCH_REGISTRY.get(opt.pop('type'))(**opt)
