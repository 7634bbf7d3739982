"""The serving fleet (counterpart of ``bigdl_tpu/serving/fleet``): a
router process in front of K engine worker processes.

``control`` is the message schema and transport (stdlib only, safe in
the router). ``router`` spawns and monitors the workers and proxies
traffic by SLO-burn-weighted queue depth. ``worker`` is the engine
process: the ``serve`` stack plus its control surface. ``swap`` is the
rolling weight reload.

Importing this package loads none of the submodules, and the router
process imports no torch: the K workers own the card.
"""

from __future__ import annotations

__all__ = ["control", "router", "swap", "worker"]


def __getattr__(name):
    if name in __all__:
        import importlib
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
