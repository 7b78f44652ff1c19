"""Process groups over ``torch.distributed`` (port of
``mrefsr_tpu/utils/dist_util.py``, and of the reference's
``basicsr/utils/dist_util.py``).

A run of several processes starts one per rank under the launch contract
of ``torch.distributed.launch`` / ``torchrun``: each process finds
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in its environment and calls ``init_dist('pytorch')``.
By hand, for two ranks on one host::

    MASTER_ADDR=localhost MASTER_PORT=29500 WORLD_SIZE=2 RANK=0 \\
        LOCAL_RANK=0 python my_script.py &
    MASTER_ADDR=localhost MASTER_PORT=29500 WORLD_SIZE=2 RANK=1 \\
        LOCAL_RANK=1 python my_script.py

Rank ``r`` computes on ``cuda:<LOCAL_RANK % device_count>``.
"""
import datetime
import functools
import os

import torch
import torch.distributed as dist

# a lost rank makes the others fail after this long, never hang
DEFAULT_TIMEOUT = datetime.timedelta(seconds=60)


def init_dist(launcher, backend=None, timeout=DEFAULT_TIMEOUT, port=None,
              init_method='env://'):
    """Join the process group of this run; idempotent.

    ``launcher`` ``none`` or None runs one process and does nothing here;
    ``pytorch`` reads the env contract above. ``backend`` is ``nccl`` by
    default where CUDA is available and ``gloo`` otherwise. NCCL takes one
    rank per device; gloo also reduces CUDA tensors (through the host), so
    several ranks may share one device with it. ``port`` (the YAML's
    ``dist_params.port``) becomes ``MASTER_PORT`` where the environment
    does not set it. ``init_method`` replaces the env rendezvous
    (``'file:///...'``, for example). Any other keyword is a ``TypeError``:
    nothing unknown reaches ``init_process_group``."""
    if launcher in (None, 'none') or dist.is_initialized():
        return
    if launcher != 'pytorch':
        raise ValueError(f'launcher {launcher!r} is not supported: the port '
                         'runs "pytorch" (torchrun\'s env contract) or none')
    if port is not None:
        os.environ.setdefault('MASTER_PORT', str(port))
    rank = int(os.environ['RANK'])
    world_size = int(os.environ['WORLD_SIZE'])
    local_rank = int(os.environ.get('LOCAL_RANK', rank))
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)


def get_dist_info():
    """``(rank, world_size)`` of the default group; ``(0, 1)`` outside
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def get_rank():
    return get_dist_info()[0]


def get_world_size():
    return get_dist_info()[1]


def master_only(func):
    """Run ``func`` on rank 0 only; the other ranks get None."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if get_dist_info()[0] == 0:
            return func(*args, **kwargs)
        return None

    return wrapper
