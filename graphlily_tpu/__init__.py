"""The package's former name, kept so that existing imports keep working.

Importing it, or any of its submodules, gives the `graphlily_jax` module
itself; new code imports `graphlily_jax`.
"""
import importlib
import pkgutil
import sys
import warnings

import graphlily_jax

warnings.warn(f"{__name__} is an alias of graphlily_jax; import graphlily_jax",
              DeprecationWarning, stacklevel=2)
for _info in pkgutil.walk_packages(graphlily_jax.__path__, "graphlily_jax."):
    importlib.import_module(_info.name)
for _name, _module in list(sys.modules.items()):
    if _name.split(".")[0] == "graphlily_jax":
        sys.modules[__name__ + _name[len("graphlily_jax"):]] = _module
