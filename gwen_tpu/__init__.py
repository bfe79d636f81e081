"""Deprecated import name of :mod:`gwen`, kept so existing scripts run.

``import gwen_tpu.x.y`` gives the module object ``gwen.x.y`` itself (one
copy of each module, so classes, registries and jit caches are shared) and
warns once with a :class:`DeprecationWarning`; ``python -m gwen_tpu`` runs
the ``gwen`` CLI. Import ``gwen`` instead: this alias will be removed.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import gwen

_NEW = "gwen"

warnings.warn(f"{__name__} is deprecated: import {_NEW} instead",
              DeprecationWarning, stacklevel=2)


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<alias>.x.y`` to the already-importable ``gwen.x.y``."""

    def find_spec(self, fullname, path=None, target=None):
        if (fullname.startswith(__name__ + ".")
                and not fullname.endswith(".__main__")):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_NEW + spec.name[len(__name__):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # The import system stamped the alias's spec on the real module;
        # give it back its own.
        module.__spec__ = module.__spec__.loader_state


sys.meta_path.insert(0, _Alias())


def __getattr__(name):
    return getattr(gwen, name)
