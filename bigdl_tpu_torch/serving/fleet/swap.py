"""Zero-downtime weight swap (counterpart of
``bigdl_tpu/serving/fleet/swap.py``): drain, then copy the new weights
into the served tensors.

The worker half (:func:`swap_app_weights`) reads the checkpoint first,
against the served model's layout, so a checkpoint of another shape or
dtype is refused (:class:`WeightSwapError`) before anything is touched.
Then it takes the batcher's execution lock, the decoder's lock and the
serving graphs' lock, and copies only once nothing is in flight under
them: every request already admitted finished on the old weights, and
every later one runs wholly on the new. The router half
(:func:`rolling_reload`) walks the fleet one worker at a time: out of
rotation, wait for its queues to empty, ``POST /admin/reload``, wait for
a ``ready`` heartbeat at the new version, back into rotation; K-1
workers serve throughout.

Stated differences from the JAX package, whose swap rebinds the engines'
parameter trees:

* The weights are copied in place (``copy_`` under ``no_grad``; a
  ``QuantizedWeight`` gets the new weight's 8-bit values and scales in
  its existing buffers). The serving CUDA graphs were captured against
  these tensors' storage, so a rebound tensor would leave them reading
  the old weights. A self-draft shares the target's tensors; a distinct
  draft keeps its own, as in the JAX package.
* The prefix cache is cleared under the decoder's lock. The JAX swap
  keeps it, so a prompt that hits a prefix cached under the old weights
  reuses their K/V after a reload.
* A worker rejoins rotation with the ``ready`` heartbeat the rolling
  reload just read. The JAX reload clears ``draining`` while the router's
  table may still hold the ``reloading`` state of its last poll, so the
  next worker's drain can leave no worker routable (a 503) for up to a
  heartbeat.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import time

from bigdl_tpu_torch.serving.fleet import control

logger = logging.getLogger(__name__)

__all__ = ["WeightSwapError", "rolling_reload", "swap_app_weights"]


class WeightSwapError(RuntimeError):
    """A reload that could not complete safely (drain timeout, a
    checkpoint that cannot be read or does not fit the served model). The
    worker keeps serving the old weights, all of them."""


def _in_flight(app) -> int:
    """Rows queued or being computed for /predict, plus the decoder's
    active slots and waiting requests."""
    n = 0
    if app.batcher is not None:
        n += app.batcher.in_flight()
    if app.decoder is not None:
        n += app.decoder.queue_load()
    return n


def _served_modules(app) -> list:
    """The distinct modules whose tensors the served graphs read (the
    /predict engine's and the decoder's are usually one; a self-draft is
    the decoder's own)."""
    mods = []
    for m in (getattr(app.engine, "module", None),
              getattr(app.decoder, "model", None)):
        if m is not None and all(m is not x for x in mods):
            mods.append(m)
    return mods


def _layout_like(module):
    """A meta-device copy of ``module`` in the checkpoint's layout: each
    tensor a meta tensor of its shape and dtype, each ``QuantizedWeight``
    a parameter of its logical shape in its scales' dtype (f32)."""
    import torch

    from bigdl_tpu_torch.serving.quant import QuantizedWeight

    memo = {}
    for t in list(module.parameters()) + list(module.buffers()):
        meta = torch.empty(t.shape, dtype=t.dtype, device="meta")
        memo[id(t)] = (torch.nn.Parameter(meta, requires_grad=False)
                       if isinstance(t, torch.nn.Parameter) else meta)
    like = copy.deepcopy(module, memo)
    for owner in list(like.modules()):
        for name, child in list(owner.named_children()):
            if isinstance(child, QuantizedWeight):
                delattr(owner, name)
                setattr(owner, name, torch.nn.Parameter(
                    torch.empty(child.shape, dtype=child.scale.dtype,
                                device="meta"), requires_grad=False))
    return like


def _restore(checkpoint: str, module) -> dict:
    """{name: CPU tensor} of ``checkpoint`` (a directory's newest
    ``model.<n>``, one blob file or one DCP snapshot directory, local or
    fsspec, of the port or the JAX package), held against ``module``'s
    layout (``utils.orbax_ckpt.restore_for_inference``)."""
    from bigdl_tpu_torch.utils.orbax_ckpt import restore_for_inference

    try:
        params, state = restore_for_inference(checkpoint,
                                              _layout_like(module))
    except SystemExit as e:
        # restore_for_inference exits clean on a missing or corrupt
        # checkpoint at start-up; mid-serve that is a refusable error
        raise WeightSwapError(f"restore failed for {checkpoint!r}: {e} — "
                              f"weights NOT swapped") from None
    return {**params, **state}


def _copy_into(module, tensors: dict) -> None:
    """Copy each checkpoint tensor into ``module``'s own (quantizing
    into a ``QuantizedWeight``'s buffers)."""
    import torch

    from bigdl_tpu_torch.serving.quant import QuantizedWeight, quantize_weight

    with torch.no_grad():
        for name, value in tensors.items():
            owner, _, attr = name.rpartition(".")
            target = getattr(module.get_submodule(owner), attr)
            if isinstance(target, QuantizedWeight):
                q = quantize_weight(value.to(target.device), target.fmt)
                target.q.copy_(q.q)
                target.scale.copy_(q.scale)
            else:
                target.copy_(value)


@contextlib.contextmanager
def _quiesced(app):
    """Hold every lock the serving path computes under: the batcher's
    execution lock, the decoder's lock, the serving graphs' lock (in the
    order the serving threads take them)."""
    with contextlib.ExitStack() as stack:
        if app.batcher is not None:
            stack.enter_context(app.batcher.exec_lock)
        if app.decoder is not None:
            stack.enter_context(app.decoder._lock)
        pool = (app.decoder._pool if app.decoder is not None
                else getattr(getattr(app.engine, "graphs", None), "pool",
                             None))
        if pool is not None:
            stack.enter_context(pool.work())
        yield


def swap_app_weights(app, checkpoint: str, version: str, *,
                     drain_timeout_s: float = 60.0,
                     poll_s: float = 0.02,
                     clock=time.monotonic) -> None:
    """Drain-then-copy on one worker: read ``checkpoint`` against the
    served layout, wait until nothing is in flight with every serving
    lock held, copy the weights in place, clear the prefix cache and set
    ``app.model_version``. Raises :class:`WeightSwapError` without
    touching the served weights when the checkpoint does not fit or the
    drain times out."""
    mods = _served_modules(app)
    new = [_restore(checkpoint, m) for m in mods]
    deadline = clock() + float(drain_timeout_s)
    while True:
        with _quiesced(app):
            if _in_flight(app) == 0:
                for m, tensors in zip(mods, new):
                    _copy_into(m, tensors)
                pfx = getattr(app.decoder, "_pfx", None)
                if pfx is not None:
                    pfx.clear()  # its K/V were computed by the old weights
                app.model_version = str(version)
                break
        if clock() > deadline:
            raise WeightSwapError(
                f"drain timeout after {drain_timeout_s}s with "
                f"{_in_flight(app)} request(s) still in flight — "
                f"weights NOT swapped")
        time.sleep(poll_s)
    logger.info("weight swap complete: %s -> version %s", checkpoint,
                version)


def rolling_reload(router, checkpoint: str, version: str, *,
                   drain_timeout_s: float = 60.0,
                   reload_timeout_s: float = 600.0,
                   rejoin_timeout_s: float = 60.0,
                   poll_s: float = 0.05) -> list:
    """Walk the fleet one worker at a time: drain (out of rotation; the
    worker finishes in-flight work on the old weights), reload, wait for
    a ``ready`` heartbeat at the new version, rejoin. Aborts on the
    first failure: the workers already swapped keep the new version, the
    others the old, and the result rows say which is which."""
    results = []
    host = router.host
    for h in router.worker_handles():
        row = {"worker": h.index, "port": h.port}
        if not h.process_alive():
            row.update(status="skipped", reason="process not running")
            results.append(row)
            continue
        router.set_draining(h, True)
        try:
            t_end = time.monotonic() + drain_timeout_s
            while True:
                st = control.fetch_status(host, h.port, timeout=2.0)
                if (st is not None and st.queue_depth == 0
                        and st.decode_active == 0):
                    break
                if time.monotonic() > t_end:
                    row.update(status="error",
                               error=f"drain timeout after "
                                     f"{drain_timeout_s}s")
                    results.append(row)
                    return results
                time.sleep(poll_s)
            try:
                code, body = control.request_json(
                    "POST", host, h.port, control.RELOAD_PATH,
                    {"checkpoint": checkpoint, "version": version,
                     "drain_timeout_s": drain_timeout_s},
                    timeout=reload_timeout_s)
            except OSError as e:
                row.update(status="error", error=f"reload transport: {e}")
                results.append(row)
                return results
            if code != 200:
                row.update(status="error",
                           error=str(body.get("error", f"HTTP {code}")))
                results.append(row)
                return results
            t_end = time.monotonic() + rejoin_timeout_s
            while True:
                t_req = time.monotonic()
                st = control.fetch_status(host, h.port, timeout=2.0)
                if (st is not None and st.state == "ready"
                        and st.model_version == str(version)):
                    break
                if time.monotonic() > t_end:
                    row.update(status="error",
                               error="worker never reported ready at "
                                     f"version {version}")
                    results.append(row)
                    return results
                time.sleep(poll_s)
            # back in rotation as the heartbeat just read says, not as
            # the monitor last saw it ("reloading"): else the next
            # worker's drain could leave no routable worker for up to a
            # heartbeat
            router.note_status(h, st, t_req)
            row.update(status="reloaded", version=str(version))
            results.append(row)
        finally:
            router.set_draining(h, False)
    router.note_reloaded(checkpoint, str(version))
    return results
