"""String-keyed registries mapping names to classes/functions.

Same semantics as ``mrefsr_tpu/utils/registry.py`` (itself a rebuild of
the reference's basicsr/utils/registry.py:4-88): objects are looked up by
the ``type:`` strings of experiment options, with a package-suffix
fallback and the reference's ``_basicsr`` suffix fallback. A name the JAX
package registers and the port does not yet (:data:`PENDING`) raises
``NotImplementedError`` naming its ROADMAP item.
"""

# the JAX package's names the port has still to port, by registry, with
# their ROADMAP items
PENDING = {
    'model': {'HiFaceGANModel': 'A11'},
    'arch': {'DFDNet': 'A11', 'HiFaceGAN': 'A11', 'SPADEGenerator': 'A11',
             'HiFaceGANDiscriminator': 'A11'},
    'dataset': {'FFHQDataset': 'A11'},
}

class Registry:
    """Name -> object mapping supporting decorator-based registration.

    Usage::

        ARCH_REGISTRY = Registry('arch')

        @ARCH_REGISTRY.register()
        class MyArch: ...

        # or
        ARCH_REGISTRY.register(MyArch)
    """

    def __init__(self, name):
        self._name = name
        self._obj_map = {}

    def _do_register(self, name, obj, suffix=None):
        if isinstance(suffix, str):
            name = name + '_' + suffix
        if name in self._obj_map:
            raise KeyError(
                f"An object named '{name}' was already registered in "
                f"'{self._name}' registry!")
        self._obj_map[name] = obj

    def register(self, obj=None, suffix=None):
        if obj is None:
            # used as a decorator
            def deco(func_or_class):
                self._do_register(func_or_class.__name__, func_or_class,
                                  suffix)
                return func_or_class

            return deco
        self._do_register(obj.__name__, obj, suffix)
        return obj

    def get(self, name, suffix='mrefsr_tpu_torch'):
        ret = self._obj_map.get(name)
        if ret is None:
            ret = self._obj_map.get(name + '_' + suffix)
        if ret is None:
            # reference-compat: classes the reference registered with its
            # '_basicsr' suffix keep resolving (registry.py:65-72)
            ret = self._obj_map.get(name + '_basicsr')
        if ret is None and name in PENDING.get(self._name, {}):
            raise NotImplementedError(
                f"{self._name} '{name}' is not ported yet (ROADMAP "
                f'{PENDING[self._name][name]})')
        if ret is None:
            raise KeyError(
                f"No object named '{name}' found in '{self._name}' registry! "
                f'Available: {sorted(self._obj_map)}')
        return ret

    def __contains__(self, name):
        return name in self._obj_map

    def __iter__(self):
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()

    def __len__(self):
        return len(self._obj_map)


ARCH_REGISTRY = Registry('arch')
DATASET_REGISTRY = Registry('dataset')
MODEL_REGISTRY = Registry('model')
METRIC_REGISTRY = Registry('metric')
