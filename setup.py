"""Install mrefsr_tpu as a package (the reference ships a setup.py for
basicsr; this framework has no compiled torch extensions to build — the
native packio library builds with `make -C native`)."""
from setuptools import find_packages, setup


def get_version():
    scope = {}
    with open('mrefsr_tpu/version.py') as f:
        exec(f.read(), scope)  # noqa: S102 - own version file
    return scope.get('__version__', '0.0.0')


setup(
    name='mrefsr_tpu',
    version=get_version(),
    description='TPU-native multi-reference super-resolution framework '
                '(JAX/XLA rebuild of the MRefSR/BasicSR toolbox)',
    packages=find_packages(exclude=('tests', 'options', 'scripts',
                                    'inference', 'native')),
    package_data={'mrefsr_tpu.metrics': ['niqe_pris_params.npz'],
                  # CUDA sources of the PyTorch port, built by nvcc at
                  # first use (mrefsr_tpu_torch/ops/_build.py)
                  'mrefsr_tpu_torch.ops': ['csrc/*.cu', 'csrc/*.cuh'],
                  # NIQE's pristine parameters, the host library's source
                  'mrefsr_tpu_torch.metrics': ['niqe_pris_params.npz'],
                  'mrefsr_tpu_torch.data': ['csrc/*.cpp'],
                  # the port's launchers (one GPU, or torchrun)
                  'mrefsr_tpu_torch.scripts': ['*.sh']},
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'numpy', 'opencv-python', 'Pillow',
        'pandas', 'scipy', 'pyyaml',
    ],
    extras_require={
        'torch_io': ['torch'],        # .pth checkpoint import/export
        'lmdb': ['lmdb'],
        'tb': ['tensorboard'],
    },
)
