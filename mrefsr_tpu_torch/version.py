"""The port's version (copy of ``mrefsr_tpu/version.py``)."""
__version__ = '0.1.0'
__gitsha__ = 'unknown'
version_info = (0, 1, 0)
