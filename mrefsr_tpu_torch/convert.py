"""Carry weights into the port's modules.

Two sources, both in the reference's torch key layout, which the port's
modules keep (so ``load_state_dict(strict=True)`` takes them unchanged):

* a reference-format ``.pth`` (:func:`load_torch_state_dict`);
* the flax parameter tree of the JAX package (:func:`state_dict_from_flax`,
  numpy in, torch state dict out): a kernel ``(kh, kw, I, O)`` becomes the
  weight ``(O, I, kh, kw)``, a dense kernel ``(I, O)`` becomes ``(O, I)``,
  a norm scale becomes ``weight``, anything else keeps its leaf name.

A copy of the numpy-only half of ``mrefsr_tpu/convert.py``, so the port
imports nothing of the JAX package.
"""
import numpy as np
import torch


def load_torch_state_dict(path, param_key='params'):
    """Load a reference-format ``.pth``: ``{param_key: state_dict}`` or a
    bare state dict, with ``module.`` prefixes stripped. Asking for
    ``params_ema`` from a file that holds only ``params`` takes ``params``
    (reference base_model.py:294-297); ``param_key=None`` takes the file
    as a bare state dict. Returns ``{key: tensor}`` on the CPU."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    if param_key is not None and isinstance(ckpt, dict):
        if param_key not in ckpt and param_key == 'params_ema' \
                and isinstance(ckpt.get('params'), dict):
            param_key = 'params'
        if isinstance(ckpt.get(param_key), dict):
            ckpt = ckpt[param_key]
    out = {}
    for k, v in ckpt.items():
        if isinstance(v, dict):
            raise ValueError(
                f'{path} is a wrapped checkpoint (keys {list(ckpt)}); '
                f'pass param_key to select one (got {param_key!r})')
        out[k[7:] if k.startswith('module.') else k] = torch.as_tensor(v)
    return out


def drop_buffer_keys(key):
    """Rename hook for extractor checkpoints: drop the reference's ImageNet
    mean/std buffers (contras_extractor_arch.py:31-38), which are
    constants here."""
    if key.endswith('.mean') or key.endswith('.std') or key in ('mean',
                                                                'std'):
        return None
    return key


def rename_keys(state_dict, rename):
    """Apply ``rename(key) -> key or None`` (None drops the entry)."""
    out = {}
    for key, val in state_dict.items():
        key = rename(key)
        if key is not None:
            out[key] = val
    return out


def _flatten(tree):
    """Nested dict -> ``{dotted_key: np.ndarray}``."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            p = f'{prefix}.{k}' if prefix else k
            if isinstance(v, dict):
                walk(v, p)
            else:
                flat[p] = np.asarray(v)

    walk(tree, '')
    return flat


def flax_to_torch(params):
    """Flax parameter tree -> ``{torch_key: np.ndarray}``."""
    out = {}
    for key, val in _flatten(params).items():
        base, dot, leaf = key.rpartition('.')
        if leaf == 'kernel':
            if val.ndim == 4:  # conv HWIO -> OIHW
                val = val.transpose(3, 2, 0, 1)
            elif val.ndim == 2:  # dense (I, O) -> (O, I)
                val = val.transpose(1, 0)
            else:
                raise ValueError(f'{key}: no torch layout for a '
                                 f'{val.ndim}-D kernel')
            out[f'{base}{dot}weight'] = val
        elif leaf == 'scale':
            out[f'{base}{dot}weight'] = val
        else:
            out[key] = val
    return out


def state_dict_from_flax(params):
    """Flax parameter tree (e.g. ``variables['params']``) -> a torch state
    dict of contiguous float tensors, ready for
    ``load_state_dict(strict=True)``."""
    return {k: torch.tensor(v) for k, v in flax_to_torch(params).items()}
