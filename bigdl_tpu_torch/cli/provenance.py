"""The shared program-configuration provenance (counterpart of
``bigdl_tpu/cli/provenance.py``).

Every surface that says which program produced a number assembles the
same core here: the ``cli.perf`` JSON line, the ``/metrics`` ``_info``
gauge (``serving.engine.InferenceEngine.provenance``), and the
``batch-predict`` report.

* :func:`provenance_dict` builds the core (BN fusion mode, autotune
  decisions, conv layout policy, per-geometry conv decisions) in the two
  shapes the callers use: ``flat=False`` keeps structured values and
  leaves defaults out (the perf line: an absent key is the default),
  ``flat=True`` renders scalars and always emits every key (the scrape's
  stable label set).
* :data:`PROVENANCE_COMPANION_KEYS` lists the provenance columns a record
  assembly copies from a result dict.

Every field is read from the live process state at call time.
"""

from __future__ import annotations

__all__ = ["provenance_dict", "PROVENANCE_COMPANION_KEYS"]

# provenance columns a record assembly copies verbatim from a result
# dict: the config core plus the feed-attribution columns
PROVENANCE_COMPANION_KEYS = ("conv_layouts", "conv_geom", "autotune",
                             "bn_fused", "pipeline", "stall_frac",
                             "data_wait_s")


def provenance_dict(model=None, flat: bool = False) -> dict:
    """The shared provenance core, assembled from live process state.

    ``model`` (a ``torch.nn.Module``) supplies the BN-fusion verdict
    (``bn_fused`` is left out when None and ``flat=False``, and reported
    as ``"none"`` when None and ``flat=True``).

    ``flat=False`` (the perf line's shape), defaults left out:
    ``conv_layouts`` (the non-default triple), ``conv_geom`` (the
    installed per-geometry decisions), ``autotune`` (the tuner's
    annotation, absent under ``off``), ``bn_fused``
    (``off``/``stats``/``apply``).

    ``flat=True`` (the ``_info`` gauge's shape), every key present:
    ``conv_layouts`` (``"k=v/..."`` or ``"default"``),
    ``conv_geom_decisions`` (a count), ``autotune`` (the mode),
    ``bn_fused``."""
    from bigdl_tpu_torch import tuning
    from bigdl_tpu_torch.nn.norm import bn_fused_mode
    from bigdl_tpu_torch.ops.conv2d import (conv_layouts_if_nondefault,
                                            geom_policy_if_any)

    out: dict = {}
    cl = conv_layouts_if_nondefault()
    gp = geom_policy_if_any()
    if flat:
        out["bn_fused"] = (bn_fused_mode(model) if model is not None
                           else "none")
        out["autotune"] = tuning.get_mode()
        out["conv_layouts"] = ("/".join(f"{k}={v}" for k, v in
                                        sorted(cl.items()))
                               if cl else "default")
        out["conv_geom_decisions"] = len(gp) if gp else 0
        return out
    if model is not None:
        out["bn_fused"] = bn_fused_mode(model)
    ann = tuning.annotation()
    if ann is not None:
        out["autotune"] = ann
    if cl:
        out["conv_layouts"] = cl
    if gp:
        out["conv_geom"] = gp
    return out
