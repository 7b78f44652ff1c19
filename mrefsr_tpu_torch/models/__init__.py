"""Model registry: every ``*_model.py`` module of this package registers
its models; :func:`build_model` looks up ``opt['model_type']``."""
import importlib
from copy import deepcopy
from pathlib import Path

from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY

__all__ = ['build_model']

for _path in sorted(Path(__file__).parent.glob('*_model.py')):
    importlib.import_module(f'{__name__}.{_path.stem}')


def build_model(opt, device=None):
    """Instantiate the registered model for ``opt['model_type']`` on
    ``device`` (``cuda`` unless the caller names another)."""
    return MODEL_REGISTRY.get(opt['model_type'])(deepcopy(opt),
                                                 device=device)
