"""Zero-downtime weight swap (counterpart of
``bigdl_tpu/serving/fleet/swap.py``): drain, then copy the new weights
into the served tensors.

The worker half (:func:`swap_app_weights`) reads the checkpoint first,
against the served model's layout, so a checkpoint of another shape or
dtype is refused (:class:`WeightSwapError`) before anything is touched.
Then it takes, replica by replica in index order, the batcher's
execution lock, the decoder's lock and the serving graphs' lock, and
copies only once nothing is in flight under them: every request already
admitted finished on the old weights, and every later one runs wholly on
the new. Every replica of a ``dp:N`` worker (``app.replicas``) is
swapped, or none. The router half (:func:`rolling_reload`) walks the
fleet one worker at a time: out of rotation, wait for its queues to
empty, ``POST /admin/reload``, wait for a ``ready`` heartbeat at the new
version, back into rotation; K-1 workers serve throughout.

Under ``tp:K`` (and ``dp:N+tp:K``) the worker is K processes, and the
swap reaches every rank through each replica's ``TPLink``
(:func:`install_tp_swap` registers the handlers on every rank): each
rank reads the whole checkpoint and keeps its own slice of each split
leaf (the placement's ``_tp_split``, ``ServingSharding.place_params``),
the ranks agree, and only when every rank of every replica read it
cleanly does rank 0 drain and have each rank copy under its own serving
locks; ``model_version`` moves after the last rank copied. A checkpoint
any rank refuses leaves every rank on the old weights.

Stated differences from the JAX package, whose swap rebinds the engines'
parameter trees:

* The weights are copied in place (``copy_`` under ``no_grad``; a
  ``QuantizedWeight`` gets the new weight's 8-bit values and scales in
  its existing buffers). The serving CUDA graphs were captured against
  these tensors' storage, so a rebound tensor would leave them reading
  the old weights. A self-draft shares the target's tensors; a distinct
  draft keeps its own, as in the JAX package. A tensor that several
  served modules share is copied once.
* The prefix cache of every replica is cleared under its decoder's lock.
  The JAX swap keeps it, so a prompt that hits a prefix cached under the
  old weights reuses their K/V after a reload.
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

__all__ = ["WeightSwapError", "install_tp_swap", "rolling_reload",
           "swap_app_weights"]


class WeightSwapError(RuntimeError):
    """A reload that could not complete safely (drain timeout, a
    checkpoint that cannot be read or does not fit the served model). The
    worker keeps serving the old weights, all of them."""


def _stacks(app) -> list:
    """(engine, batcher, decoder) of each replica, in index order: a
    ``dp:N`` app's replicas, a tp follower's engines (no batcher), or the
    single-stack app as a fleet of one."""
    if getattr(app, "replicas", None) is not None:
        return [(r.engine, r.batcher, r.decoder)
                for r in app.replicas.replicas]
    engines = getattr(app, "engines", None)
    if engines is not None:  # cli.serve.TPFollower
        decoders = list(app.decoders) or [None] * len(engines)
        return [(e, None, d) for e, d in zip(engines, decoders)]
    return [(app.engine, app.batcher, app.decoder)]


def _links(app) -> list:
    """Each replica's ``TPLink`` (rank 0's or a follower's), or []."""
    links = getattr(app, "links", None)
    if links is None:
        links = getattr(app, "tp_link", None)
    if links is None:
        return []
    return [link for link in (links if isinstance(links, (list, tuple))
                              else [links]) if link.size > 1]


def _in_flight(app) -> int:
    """Rows queued or being computed for /predict, plus the decoders'
    active slots and waiting requests, over every replica."""
    n = 0
    for _, batcher, decoder in _stacks(app):
        if batcher is not None:
            n += batcher.in_flight()
        if decoder is not None:
            n += decoder.queue_load()
    return n


def _served_modules(engine, decoder) -> list:
    """The distinct modules whose tensors one replica's programs read
    (the /predict engine's and the decoder's are usually one; a
    self-draft is the decoder's own)."""
    mods = []
    for m in (getattr(engine, "module", None),
              getattr(decoder, "model", None)):
        if m is not None and all(m is not x for x in mods):
            mods.append(m)
    return mods


def _layout_like(module):
    """A meta-device copy of ``module`` in the checkpoint's layout: each
    tensor a meta tensor of its shape and dtype, each ``QuantizedWeight``
    a parameter of its logical shape in its scales' dtype (f32), each leaf
    a tp placement split (``module._tp_split``) at its whole size, and no
    tp state (whose process groups do not copy)."""
    import torch

    from bigdl_tpu_torch.serving.quant import QuantizedWeight

    memo = {}
    for t in list(module.parameters()) + list(module.buffers()):
        meta = torch.empty(t.shape, dtype=t.dtype, device="meta")
        memo[id(t)] = (torch.nn.Parameter(meta, requires_grad=False)
                       if isinstance(t, torch.nn.Parameter) else meta)
    for m in module.modules():
        tp = m.__dict__.get("_tp")
        if tp is not None:
            memo[id(tp)] = None
    like = copy.deepcopy(module, memo)
    split = getattr(module, "_tp_split", None) or {}
    for owner in list(like.modules()):
        for name, child in list(owner.named_children()):
            if isinstance(child, QuantizedWeight):
                delattr(owner, name)
                setattr(owner, name, torch.nn.Parameter(
                    torch.empty(child.shape, dtype=child.scale.dtype,
                                device="meta"), requires_grad=False))
    for name, (dim, whole) in split.items():
        owner, _, leaf = name.rpartition(".")
        mod = like.get_submodule(owner) if owner else like
        t = getattr(mod, leaf)
        shape = list(t.shape)
        shape[dim] = int(whole)
        setattr(mod, leaf, torch.nn.Parameter(
            torch.empty(shape, dtype=t.dtype, device="meta"),
            requires_grad=False))
    return like


def _restore(checkpoint: str, module) -> dict:
    """{name: CPU tensor} of ``checkpoint`` (a directory's newest
    ``model.<n>``, one blob file or one DCP snapshot directory, local or
    fsspec, of the port or the JAX package), held against ``module``'s
    whole layout (``utils.orbax_ckpt.restore_for_inference``)."""
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


def _copy_into(module, tensors: dict, done: set, rank: int = 0,
               size: int = 1) -> None:
    """Copy each checkpoint tensor into ``module``'s own (quantizing
    into a ``QuantizedWeight``'s buffers), a tp split leaf taking rank
    ``rank``'s slice of ``size`` by the placement's own rule
    (``parallel.tensor_parallel.rank_slice``).
    ``done`` holds the ids of targets already written (skipped)."""
    import torch

    from bigdl_tpu_torch.parallel.tensor_parallel import rank_slice
    from bigdl_tpu_torch.serving.quant import QuantizedWeight, quantize_weight

    split = getattr(module, "_tp_split", None) or {}
    with torch.no_grad():
        for name, value in tensors.items():
            owner, _, attr = name.rpartition(".")
            target = getattr(module.get_submodule(owner), attr)
            key = id(target.q if isinstance(target, QuantizedWeight)
                     else target)
            if key in done:
                continue
            done.add(key)
            if isinstance(target, QuantizedWeight):
                value = quantize_weight(value.to(target.device), target.fmt)
            if name in split:
                value = rank_slice(value, split[name][0], rank, size)
            if isinstance(target, QuantizedWeight):
                target.q.copy_(value.q)
                target.scale.copy_(value.scale)
            else:
                target.copy_(value)


@contextlib.contextmanager
def _quiesced(app):
    """Hold every lock the serving path computes under, replica by
    replica in index order (one fixed order, so two swaps cannot
    deadlock): the batcher's execution lock, the decoder's lock, the
    serving graphs' lock (in the order the serving threads take them)."""
    with contextlib.ExitStack() as stack:
        for engine, batcher, decoder in _stacks(app):
            _enter_stack(stack, engine, batcher, decoder)
        yield


def _pool(engine, decoder):
    """The ``GraphPool`` one replica's programs (and its tp link's calls)
    run under, or None."""
    if decoder is not None:
        return decoder._pool
    return getattr(getattr(engine, "graphs", None), "pool", None)


def _enter_stack(stack, engine, batcher, decoder) -> None:
    if batcher is not None:
        stack.enter_context(batcher.exec_lock)
    if decoder is not None:
        stack.enter_context(decoder._lock)
    pool = _pool(engine, decoder)
    if pool is not None:
        stack.enter_context(pool.work())


def _clear_prefix(decoder) -> None:
    pfx = getattr(decoder, "_pfx", None)
    if pfx is not None:
        pfx.clear()  # its K/V were computed by the old weights


class _ReplicaSwap:
    """One replica's read-then-copy on one rank, the same steps whether
    they run in the worker's one process or on every rank of a tp group
    through the replica's ``TPLink``: :meth:`read` reads the checkpoint
    against this rank's layout and returns every rank's error (None where
    it read cleanly), :meth:`copy` copies what was read (a follower under
    its own serving locks; rank 0 holds its own already) and clears the
    prefix cache, :meth:`drop` forgets it. ``done`` is shared by the
    rank's replicas: the ids of the tensors written in this swap, so that
    a tensor several replicas share is copied once."""

    def __init__(self, engine, decoder, link, done: set):
        self.engine, self.decoder, self.link = engine, decoder, link
        self.done = done
        self.pending: list = []

    def read(self, checkpoint):
        self.pending = []
        self.done.clear()
        err = None
        try:
            self.pending = [(m, _restore(checkpoint, m)) for m in
                            _served_modules(self.engine, self.decoder)]
        except WeightSwapError as e:
            err = str(e)
        except Exception as e:  # reported by every rank's verdict
            err = f"{type(e).__name__}: {e}"
        if err is not None:
            self.pending = []
        return self.link.agree(err) if self.link else [err]

    def copy(self):
        link = self.link
        with contextlib.ExitStack() as stack:
            if link is not None and not link.leader:
                _enter_stack(stack, self.engine, None, self.decoder)
            for m, tensors in self.pending:
                _copy_into(m, tensors, self.done,
                           link.rank if link else 0, link.size if link else 1)
            _clear_prefix(self.decoder)
        self.pending = []
        if link is not None:
            link.agree(True)  # every rank has copied

    def drop(self):
        self.pending = []


def _replica_swaps(app, links) -> list:
    done: set = set()
    stacks = _stacks(app)
    return [_ReplicaSwap(engine, decoder, link, done) for link, (
        engine, _, decoder) in zip(links or [None] * len(stacks), stacks)]


def install_tp_swap(app) -> None:
    """Register the swap's steps (``swap.read``, ``swap.copy``,
    ``swap.drop``: :class:`_ReplicaSwap`) on each replica's ``TPLink`` of
    a tp:K app, on every rank (rank 0's app and a follower's
    ``TPFollower`` alike), before rank 0 serves."""
    for sw in _replica_swaps(app, _links(app)):
        for step in ("read", "copy", "drop"):
            sw.link.register(f"swap.{step}", getattr(sw, step))


def _drain(app, drain_timeout_s, poll_s, clock, copy_fn, drop_fn) -> None:
    """Wait, re-taking every serving lock, until nothing is in flight,
    then run ``copy_fn`` under the locks; past ``drain_timeout_s`` run
    ``drop_fn`` and raise."""
    deadline = clock() + float(drain_timeout_s)
    while True:
        with _quiesced(app):
            if _in_flight(app) == 0:
                copy_fn()
                return
        if clock() > deadline:
            drop_fn()
            raise WeightSwapError(
                f"drain timeout after {drain_timeout_s}s with "
                f"{_in_flight(app)} request(s) still in flight — "
                f"weights NOT swapped")
        time.sleep(poll_s)


def swap_app_weights(app, checkpoint: str, version: str, *,
                     drain_timeout_s: float = 60.0,
                     poll_s: float = 0.02,
                     clock=time.monotonic) -> None:
    """Drain-then-copy on one worker: read ``checkpoint`` against the
    served layout (on every rank under tp), wait until nothing is in
    flight with every serving lock of every replica held, copy the
    weights in place (every rank, every replica), clear the prefix
    caches and set ``app.model_version``. Raises
    :class:`WeightSwapError` without touching the served weights when the
    checkpoint does not fit (on any rank) or the drain times out."""
    stacks = _stacks(app)
    links = _links(app)
    if links:
        def call(step, *args):
            # a replica's link calls are serialised by its pool's lock
            out = []
            for link, (engine, _, decoder) in zip(links, stacks):
                with _pool(engine, decoder).work():
                    out.append(link.call(f"swap.{step}", *args))
            return out
    else:
        swaps = _replica_swaps(app, None)

        def call(step, *args):
            return [getattr(sw, step)(*args) for sw in swaps]

    errors = [e for verdicts in call("read", str(checkpoint))
              for e in verdicts if e is not None]
    if errors:
        call("drop")
        raise WeightSwapError(errors[0])

    def copy_fn():
        call("copy")
        app.model_version = str(version)

    _drain(app, drain_timeout_s, poll_s, clock, copy_fn,
           lambda: call("drop"))
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
