"""A profiled window of training steps (port of
``mrefsr_tpu/utils/profiler.py``): ``torch.profiler`` over the host and,
where there is one, the CUDA device, set by three keys of the options'
``logger``::

    logger:
      profile_start_iter: 100   # first profiled iteration
      profile_num_steps: 5      # how many iterations (default 5)
      profile_dir: ~            # default <experiments_root>/tb_logger

The window is written as a Chrome trace,
``<profile_dir>/trace_iter<first>-<last>.json`` (``chrome://tracing`` or
Perfetto read it).
"""
import os
import os.path as osp

import torch

from .logger import get_root_logger


class StepProfiler:
    """One ``torch.profiler`` window in the training loop: call
    :meth:`maybe_start` before an iteration's step and :meth:`maybe_stop`
    after it (both do nothing outside the window), and :meth:`close` when
    the loop ends, which writes a window still open."""

    def __init__(self, opt):
        logger_opt = opt.get('logger') or {}
        self.start_iter = logger_opt.get('profile_start_iter')
        self.num_steps = logger_opt.get('profile_num_steps', 5)
        root = (opt.get('path') or {}).get('experiments_root', '.')
        self.trace_dir = logger_opt.get('profile_dir') or osp.join(
            root, 'tb_logger')
        self.trace_path = None
        self._prof = None
        self._first = None
        self._done = False

    @property
    def enabled(self):
        return self.start_iter is not None

    def maybe_start(self, current_iter):
        if not self.enabled or self._prof is not None or self._done:
            return
        # >=, as the JAX CLI's: a run resumed past start_iter profiles its
        # first iterations
        if current_iter >= self.start_iter:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            get_root_logger().info(
                f'Starting torch.profiler trace at iter {current_iter} '
                f'({self.num_steps} steps) -> {self.trace_dir}')
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self._first = current_iter

    def maybe_stop(self, current_iter):
        if self._prof is not None and \
                current_iter >= self.start_iter + self.num_steps - 1:
            self._finish(current_iter)

    def close(self, current_iter=None):
        """Write the window if it is still open (it ends at
        ``current_iter``, or where it started if that is not given)."""
        if self._prof is not None:
            self._finish(self._first if current_iter is None
                         else current_iter)

    def _finish(self, last_iter):
        prof, self._prof = self._prof, None
        prof.stop()
        self._done = True
        os.makedirs(self.trace_dir, exist_ok=True)
        self.trace_path = osp.join(
            self.trace_dir, f'trace_iter{self._first}-{last_iter}.json')
        prof.export_chrome_trace(self.trace_path)
        get_root_logger().info(
            f'Saved torch.profiler trace to {self.trace_path}')


def trace_annotation(name):
    """A context manager naming a host region in the trace."""
    return torch.profiler.record_function(name)
