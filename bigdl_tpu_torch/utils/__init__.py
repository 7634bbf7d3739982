"""Host-side utilities of the port (counterpart of ``bigdl_tpu/utils``),
with the JAX package's exported names where the port has them.

Importing this package imports no torch: ``utils.kineto`` and
``utils.table`` (which the fleet router reaches through ``obs``) import
none, and the names below load on first use. Only ``utils.summary``,
which imports no torch either, loads with the package, so that
``utils.summary`` is the function, as in the JAX package. The JAX
package's ``save_pytree``/``load_pytree`` have no counterpart here: the
port's blobs are written by ``interop.checkpoint.save_model``/
``load_model``."""

import importlib

from bigdl_tpu_torch.utils.summary import param_bytes, param_count, summary

_EXPORTS = {
    "gradcheck": ("check_gradients", "numerical_grad"),
    "table": ("Table", "T"),
    "classifier": ("Classifier",),
    "file": ("latest_checkpoint", "save_module", "load_module"),
    "profiling": ("time_modules", "trace", "format_times"),
}
_OWNER = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(set(_OWNER) | {"param_bytes", "param_count", "summary"})


def __getattr__(name):
    mod = _OWNER.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
