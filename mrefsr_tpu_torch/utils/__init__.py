"""Small shared helpers of the port."""
import sys
import time

import torch

from .img_util import (crop_border, imfrombytes, img2tensor, imwrite,
                       read_img_seq, tensor2img, tensor2img_fast)

__all__ = ['ProgressBar', 'crop_border', 'imfrombytes', 'img2tensor',
           'imwrite', 'read_img_seq', 'resolve_device', 'tensor2img',
           'tensor2img_fast']


def resolve_device(device=None):
    """The device an entry point runs on: the current CUDA device (the
    rank's, under ``init_dist``) unless the caller names another. With no
    CUDA device and no explicit choice this raises: the port never carries
    on on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run '
                'the plain PyTorch path on the CPU')
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


class ProgressBar:
    """A console progress bar: ``pbar = ProgressBar(total)``, then
    ``pbar.update(msg)`` a task (reference misc.py:146-202; the JAX
    package's utils/__init__.py:24)."""

    def __init__(self, task_num=0, bar_width=50, start=True):
        self.task_num = task_num
        self.bar_width = bar_width
        self.completed = 0
        if start:
            self.start()

    def start(self):
        if self.task_num > 0:
            sys.stdout.write(f'[{" " * self.bar_width}] 0/{self.task_num}, '
                             'elapsed: 0s, ETA:\nStart...\n')
        else:
            sys.stdout.write('completed: 0, elapsed: 0s')
        sys.stdout.flush()
        self.start_time = time.time()

    def update(self, msg='In progress...'):
        self.completed += 1
        elapsed = time.time() - self.start_time + 1e-8
        fps = self.completed / elapsed
        if self.task_num > 0:
            percentage = self.completed / float(self.task_num)
            eta = int(elapsed * (1 - percentage) / percentage + 0.5)
            mark_width = int(self.bar_width * percentage)
            bar_chars = '>' * mark_width + '-' * (self.bar_width - mark_width)
            sys.stdout.write(
                f'\033[J[{bar_chars}] {self.completed}/{self.task_num}, '
                f'{fps:.1f} task/s, elapsed: {int(elapsed + 0.5)}s, '
                f'ETA: {eta:5}s\n{msg}\n')
        else:
            sys.stdout.write(
                f'completed: {self.completed}, elapsed: {int(elapsed + 0.5)}s,'
                f' {fps:.1f} tasks/s')
        sys.stdout.flush()
