"""Batches from the host loader to the model's device (port of
``mrefsr_tpu/data/prefetch_dataloader.py``, the reference's
``basicsr/data/prefetch_dataloader.py:63-125``).

* :class:`CPUPrefetcher` (``prefetch_mode: cpu`` or unset) hands the host
  batches over as they are; ``feed_data`` copies them.
* :class:`CUDAPrefetcher` (``prefetch_mode: cuda``; the JAX package's
  ``DevicePrefetcher``) copies the next batch on a side stream of the
  training thread while the current one trains.
* :class:`BackgroundDevicePrefetcher` (``prefetch_mode: device``, the
  shipped YAMLs') does the copies on a thread of its own, so that they
  overlap the step however long the host takes to issue them.

Both device prefetchers copy the arrays of ``device_keys`` (the model's
``device_input_keys``; by default every float array and every uint8 array
of 3 dimensions or more) from pinned memory and turn uint8 into float32 in
[0, 1] on the device, where a dataset ships uint8 (``output_dtype:
uint8``: a quarter of the bytes). That conversion is a lookup into the
256 values of the host formula ``np.arange(256).astype(float32) / 255``:
bit for bit the host's ``astype(float32) / 255``, where ``x.float() /
255`` on a CUDA tensor is not, since PyTorch's CUDA division by a scalar
multiplies by its reciprocal (126 of the 256 values differ by an ulp). On
the CPU (``--device cpu``) they do the same without streams or pinning.
"""
import queue
import threading

import numpy as np
import torch

# the host formula's value of each uint8
U8_TO_F32 = np.arange(256, dtype=np.uint8).astype(np.float32) / 255.


def uint8_to_float32(x, lut=None):
    """uint8 ``x`` (a numpy array or a tensor on any device) as float32 in
    [0, 1], bit for bit ``x.astype(float32) / 255``; ``lut`` is
    :data:`U8_TO_F32` on ``x``'s device, made here where not given."""
    if isinstance(x, np.ndarray):
        return x.astype(np.float32) / 255.
    if lut is None:
        lut = torch.from_numpy(U8_TO_F32).to(x.device)
    return lut[x.long()]


def _moves(key, value, device_keys):
    """Whether the prefetchers put ``value`` (of ``key``) on the device."""
    if not isinstance(value, np.ndarray):
        return False
    if device_keys is not None:
        return key in device_keys
    return value.dtype.kind == 'f' or (value.dtype == np.uint8
                                       and value.ndim >= 3)


class _Transfer:
    """Host batches onto ``device``: on a CUDA device through pinned memory
    and a side stream (made on the calling thread, which must have
    ``device`` current), each batch closed by an event the consumer waits
    for."""

    def __init__(self, device, device_keys):
        self.device = device
        self.device_keys = device_keys
        self.cuda = device.type == 'cuda'
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.lut = None

    def __call__(self, batch):
        """``(batch with its arrays moved, ready event or None)``."""
        out = dict(batch)
        if not self.cuda:
            for k, v in batch.items():
                if _moves(k, v, self.device_keys):
                    out[k] = uint8_to_float32(torch.from_numpy(v)) \
                        if v.dtype == np.uint8 else torch.from_numpy(v)
            return out, None
        with torch.cuda.stream(self.stream):
            if self.lut is None:
                self.lut = torch.from_numpy(U8_TO_F32).to(self.device)
            for k, v in batch.items():
                if not _moves(k, v, self.device_keys):
                    continue
                t = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                t = t.to(self.device, non_blocking=True)
                out[k] = uint8_to_float32(t, self.lut) \
                    if t.dtype == torch.uint8 else t
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event


def _hand_over(batch, event, device):
    """The consumer's side of a transfer: its stream waits for ``event``,
    and each device tensor is marked as used on that stream, so that the
    caching allocator does not hand its memory to the side stream again
    before the step has read it."""
    if event is None:
        return batch
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    for v in batch.values():
        if isinstance(v, torch.Tensor) and v.device.type == 'cuda':
            v.record_stream(stream)
    return batch


class CPUPrefetcher:
    """The loader's batches as they are (reference :63-81)."""

    def __init__(self, loader):
        self.ori_loader = loader
        self.loader = iter(loader)

    def next(self):
        try:
            return next(self.loader)
        except StopIteration:
            return None

    def reset(self):
        self.loader = iter(self.ori_loader)

    def close(self):
        self.loader = iter(())


class CUDAPrefetcher:
    """Double buffering on the training thread (reference :84-125): while a
    batch trains, the next is copied on a side stream of ``device``.
    ``device_keys`` as the module docstring says."""

    def __init__(self, loader, device, device_keys=None):
        self.ori_loader = loader
        self.device = torch.device(device)
        self._transfer = _Transfer(self.device, device_keys)
        self.loader = iter(loader)
        self.batch = None
        self.preload()

    def preload(self):
        try:
            self.batch = self._transfer(next(self.loader))
        except StopIteration:
            self.batch = None

    def next(self):
        if self.batch is None:
            return None
        batch = _hand_over(*self.batch, self.device)
        self.preload()
        return batch

    def reset(self):
        self.loader = iter(self.ori_loader)
        self.preload()

    def close(self):
        self.loader = iter(())
        self.batch = None


class BackgroundDevicePrefetcher:
    """The copies on a daemon thread of their own: it drains the loader,
    moves each batch's ``device_keys`` arrays to ``device`` (module
    docstring) and queues the batch with its ready event; :meth:`next`
    makes the current stream wait for that event. The thread makes
    ``device`` its current CUDA device (the current device is per thread:
    without it a rank's copies would go to ``cuda:0``).

    ``depth`` batches wait at most in the queue: ``prefetch_depth``, else
    twice ``train.steps_per_dispatch`` (at least 2), as in the JAX package.
    The thread starts at the first :meth:`next` or :meth:`reset`; a reset
    (each epoch, after the sampler's ``set_epoch``) stops the old thread
    first. An exception on the thread is raised by :meth:`next`.
    """

    def __init__(self, loader, device, opt=None, device_keys=None,
                 depth=None):
        self.ori_loader = loader
        self.device = torch.device(device)
        self.device_keys = device_keys
        if depth is None:
            train_opt = (opt or {}).get('train') or {}
            depth = 2 * int(train_opt.get('steps_per_dispatch') or 1)
        self.depth = max(int(depth), 2)
        self._queue = None
        self._thread = None
        self._stop = None
        self._done = False

    @staticmethod
    def _put_until_stop(q, stop, item):
        """Put ``item`` unless ``stop`` is set first; True if it was put."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self, q, stop):
        batches = iter(self.ori_loader)
        try:
            if self.device.type == 'cuda':
                torch.cuda.set_device(self.device)
            transfer = _Transfer(self.device, self.device_keys)
            for batch in batches:
                if not self._put_until_stop(q, stop, transfer(batch)):
                    return
        except BaseException as e:  # noqa: B036
            # raised on the consumer's side: a producer that died without
            # a word would leave training waiting for ever
            self._put_until_stop(q, stop, e)
            return
        finally:
            close = getattr(batches, 'close', None)
            if close is not None:
                close()
        self._put_until_stop(q, stop, None)

    def next(self):
        if self._thread is None:
            self.reset()
        if self._done:
            return None
        item = self._queue.get()
        if isinstance(item, BaseException):
            raise item
        if item is None:
            self._done = True
            return None
        return _hand_over(*item, self.device)

    def close(self):
        """Stop the thread, emptying the queue so that it can end."""
        if self._stop is None:
            return
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                self._thread.join(timeout=0.1)
        self._stop = self._thread = self._queue = None

    def reset(self):
        self.close()
        self._done = False
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self.depth)
        self._thread = threading.Thread(target=self._producer,
                                        args=(self._queue, self._stop),
                                        daemon=True)
        self._thread.start()
