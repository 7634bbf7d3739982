"""Persistent autotune cache: one JSON file per device kind (counterpart
of ``bigdl_tpu/tuning/cache.py``, the same file format).

Decisions persist in ``~/.cache/bigdl_tpu/autotune/<device-kind>.json``
(``BIGDL_TPU_AUTOTUNE_CACHE`` names another directory), versioned by
:data:`CACHE_VERSION` so a format change never reads old decisions as
current ones. The device kind is ``torch.cuda.get_device_name()``, or
``"cpu"`` where there is no card: an H100 SXM's file is
``nvidia-h100-80gb-hbm3.json``.

The serialized bytes are a pure function of the entries: keys sorted, no
timestamps, no environment fingerprints. Two dry ``measure`` runs over
the same keys write the same bytes, and a file written by this package
reads the same way in the JAX package and back. A corrupt or
version-mismatched file loads as empty, so the tuner falls back to its
defaults instead of failing the run.

Namespaces in one file (the key's leading ``op`` token): ``flash``,
``bn_stats``, ``bn_fba``, ``conv_layouts``, ``conv_geom``, ``grad_comm``,
``kv_pages`` and ``quant``. Entry sources: ``measured``, ``dry`` and
``probe``.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

__all__ = ["AutotuneCache", "CACHE_VERSION", "cache_dir", "cache_path",
           "device_kind", "device_slug"]

CACHE_VERSION = 1


def cache_dir() -> str:
    """The cache directory: ``BIGDL_TPU_AUTOTUNE_CACHE`` wins, else a
    per-user path."""
    explicit = os.environ.get("BIGDL_TPU_AUTOTUNE_CACHE")
    if explicit:
        return explicit
    return os.path.join(os.path.expanduser("~"), ".cache", "bigdl_tpu",
                        "autotune")


def device_kind() -> str:
    """The card's name (``torch.cuda.get_device_name()``), or "cpu" where
    torch sees no card."""
    try:
        import torch
        if torch.cuda.is_available():
            return torch.cuda.get_device_name() or "cpu"
    except Exception:
        pass
    return "cpu"


def device_slug(kind: str) -> str:
    """Filesystem-safe spelling of a device kind ("NVIDIA H100 80GB HBM3"
    -> "nvidia-h100-80gb-hbm3")."""
    slug = "".join(c if c.isalnum() else "-" for c in kind.lower())
    while "--" in slug:
        slug = slug.replace("--", "-")
    return slug.strip("-") or "unknown"


def cache_path(kind: Optional[str] = None) -> str:
    return os.path.join(cache_dir(),
                        device_slug(kind or device_kind()) + ".json")


class AutotuneCache:
    """In-memory view of one device kind's JSON decision file.

    ``get``/``put`` work on the in-memory store; ``save()`` writes the
    whole store atomically (a temporary file, then a rename), so a reader
    never sees a torn file. Every corruption loads as an empty store."""

    def __init__(self, kind: Optional[str] = None,
                 path: Optional[str] = None):
        self.kind = kind or device_kind()
        self.path = path or cache_path(self.kind)
        self.entries: Dict[str, dict] = {}
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            return  # missing or corrupt: start empty
        if not isinstance(blob, dict) or blob.get("version") != CACHE_VERSION:
            return  # another format's decisions are not decisions
        entries = blob.get("entries")
        if isinstance(entries, dict):
            self.entries = {str(k): dict(v) for k, v in entries.items()
                            if isinstance(v, dict) and "config" in v}

    def get(self, key: str) -> Optional[dict]:
        ent = self.entries.get(key)
        return dict(ent) if ent is not None else None

    def put(self, key: str, entry: dict) -> None:
        self.entries[key] = dict(entry)

    def save(self) -> None:
        """Atomic, deterministic write: sorted keys, fixed separators, no
        wall clock anywhere in the payload."""
        blob = {"version": CACHE_VERSION, "device_kind": self.kind,
                "entries": dict(sorted(self.entries.items()))}
        payload = json.dumps(blob, sort_keys=True, indent=1) + "\n"
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".autotune_")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
