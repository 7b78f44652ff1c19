"""Batch collation (copy of ``mrefsr_tpu/data/loader.py:17-33``)."""
import numpy as np


def default_collate(samples):
    """Stack a list of ``{key: array | scalar | str}`` dicts into batched
    numpy arrays; scalars and tuples of ints become arrays, anything else
    a list."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            out[key] = np.stack(vals, axis=0)
        elif isinstance(first, (int, float, bool, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        elif isinstance(first, tuple) and all(
                isinstance(x, (int, np.integer)) for x in first):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out
