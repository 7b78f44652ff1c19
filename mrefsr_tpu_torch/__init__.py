"""mrefsr_tpu_torch — the PyTorch/CUDA port of mrefsr_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same structure (``ops/``,
``archs/``, ``models/``, ``utils/``, ``convert.py``) and the reference's
torch parameter names, so one ``.pth`` loads into both. Plain tensor code
is PyTorch; the custom ops the JAX package built by hand for the TPU
(``mrefsr_tpu/ops``) are CUDA kernels written for ``sm_90a`` under
``ops/csrc``, built with ``nvcc`` at first use.

This package imports neither jax nor ``mrefsr_tpu``. Its entry points run
on ``cuda`` unless the caller passes ``device='cpu'``; on the CPU every
kernel wrapper takes its plain PyTorch version.

A run is driven from a YAML and a folder of images, as the JAX package's:
``python -m mrefsr_tpu_torch.train -opt <yml>`` and
``python -m mrefsr_tpu_torch.test -opt <yml>`` (``--device cpu`` for the
CPU, ``torchrun ... --launcher pytorch`` for several cards), through
``utils/options.py``, ``utils/logger.py``, the datasets and loaders of
``data/`` and the models of ``models/``.
"""
from .version import __version__  # noqa: F401
