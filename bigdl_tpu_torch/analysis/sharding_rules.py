"""shardlint: sharding- and collective-aware rules over a rank's traced
step (counterpart of ``bigdl_tpu/analysis/sharding_rules.py``).

The JAX rules read the SPMD plan's annotations: ``NamedSharding``s and
``sharding_constraint``s, with no collective equations (the partitioner
inserts those after tracing). The port's plan is explicit, so these
rules read it directly: the ``c10d`` collectives rank 0's traced step
issues, each named by the mesh axes of its process group
(``fx_walk.collect_collectives``), and the spec trees the strategies
place by (``parallel.tensor_parallel.megatron_specs``). The trace runs
over a fake process group of the declared size (``fx_walk.fake_world``):
nothing allocated, nothing sent, no card. The five failure classes are
the JAX package's:

1. **strategy/collective consistency**: a collective over a group that
   is no line of the declared mesh, or a spec naming an undeclared axis
   (``shard-collective-axis``); a declared axis nothing reduces or splits
   over, a ``--gradCompress`` run with no 16-bit gradient reduction, a tp
   layout that splits no weight (``shard-collective-missing``); a
   collective over an axis the strategy never plans
   (``shard-collective-extra``).
2. **replicated-large-operand**: a >= 1 MiB leaf left whole under a
   model-ish axis (``shard-replicated-operand``; the serving spelling
   ``serving-unsharded-matmul`` stays as an alias).
3. **wire dtype**: a >= 1 MiB gradient reduction over the data axis in
   f32 while ``--gradCompress`` is active; an 8-bit tensor dequantized
   dense right before a collective.
4. **reshard churn**: a value gathered whole by a collective and cut
   back into a slice (all-gather then re-partition), with the wasted
   bytes.
5. **KV-pool misfit**: a KV layout whose ``kv_heads`` the tp degree
   cannot split.

Stated differences: the serving context allows collectives over the
``model`` axis (the port's tp engine writes Megatron's all-reduces out,
where a jitted JAX decode step carries none); a KV leaf is checked for
divisibility only (the port's caches are per-rank tensors, with no
committed sharding to read).
"""

from __future__ import annotations

import operator
from typing import Dict, List, Optional, Tuple

import torch

from bigdl_tpu_torch.analysis.fx_walk import (aval_bytes, call_nodes,
                                              flatten_tree, node_val,
                                              observed_mesh_axes,
                                              sharded_levels, spec_axes)
from bigdl_tpu_torch.analysis.report import Finding, Report

__all__ = ["SHARD_CATALOG", "SHARD_MIN_BYTES", "expected_collective_axes",
           "run_sharding_rules", "run_replicated_operand_rules",
           "run_kv_sharding_rules", "flatten_specs"]

# operands below this are latency-bound anyway (the serving tp rule's and
# the comm f32 rule's bar)
SHARD_MIN_BYTES = 1 * 2 ** 20

# mesh axes that replicate params by design (dp batch axes): the
# replicated-operand rule only fires for the model-ish axes
_DATA_AXES = ("data", "batch")

# the collective signature each strategy plans
_EXPECTED_AXES = {
    "dp": ("data",),
    "tp": ("data", "model"),
    "sp": ("data", "seq"),
    "pp": ("data", "pipe"),
    "ep": ("data", "expert"),
}

SHARD_CATALOG = {
    "shard-collective-axis": (
        "sharding", "error",
        "a collective or a spec references a mesh axis the declared "
        "--strategy mesh does not define — its group is no line of the "
        "mesh"),
    "shard-collective-missing": (
        "sharding", "error",
        "the declared strategy implies a collective signature the traced "
        "step does not carry (a mesh axis nothing reduces or splits over, "
        "a gradCompress run with no 16-bit gradient reduction, a tp layout "
        "with no split weight) — the strategy is a silent no-op"),
    "shard-collective-extra": (
        "sharding", "error",
        "a collective over an axis the declared strategy never asked "
        "for — an unplanned reduction in the hot path"),
    "shard-replicated-operand": (
        "sharding", "error",
        "a >=1 MiB operand fully replicated under a model-ish mesh axis "
        "(mesh-aware generalization of serving-unsharded-matmul): every "
        "shard computes/stores it whole"),
    "shard-wire-dtype": (
        "sharding", "error",
        "a >=1 MiB gradient reduction crossing the wire in f32 while "
        "--gradCompress is active — the compressed path did not engage "
        "for this value"),
    "shard-quant-remat-wire": (
        "sharding", "warning",
        "an 8-bit tensor dequantized dense immediately before a "
        "collective — the wire carries the dense value, forfeiting the "
        "quantization win"),
    "shard-reshard-churn": (
        "sharding", "warning",
        "a value gathered whole by a collective and cut back into a "
        "slice: all-gather then re-partition ping-pong, with estimated "
        "wasted wire bytes"),
    "kv-shard-misfit": (
        "sharding", "error",
        "KV pool/cache layout whose kv_heads dim the tp degree cannot "
        "split — pages replicate on every rank, breaking the head split "
        "the engines place"),
}


def _shard_finding(rule: str, message: str, where: str = "",
                   hint: str = "", detail: Optional[dict] = None,
                   severity: Optional[str] = None) -> Finding:
    fam, sev, _ = SHARD_CATALOG[rule]
    return Finding(rule=rule, family=fam, severity=severity or sev,
                   message=message, where=where, hint=hint,
                   detail=detail or {})


def expected_collective_axes(strategy: Optional[str]) -> Tuple[str, ...]:
    """Mesh axes the declared strategy may legitimately reduce over
    (``None``/unknown strategy allows any declared axis)."""
    if not strategy:
        return ()
    return _EXPECTED_AXES.get(str(strategy), ())


def _spec_is_replicated(spec) -> bool:
    return not any(a is not None for a in tuple(spec or ()))


def flatten_specs(tree, prefix: str = "") -> List[Tuple[str, tuple]]:
    """(path, spec) of a spec tree (dicts of specs, a spec a tuple over a
    leaf's dims), paths spelled as :func:`fx_walk.flatten_tree` spells
    them."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += flatten_specs(v, f"{prefix}[{k!r}]")
        return out
    return [(prefix, tuple(tree or ()))]


def _fmt_mesh(declared: Dict[str, int]) -> str:
    return "{" + ", ".join(f"{k}:{v}" for k, v in declared.items()) + "}"


# ================================================ group 1: consistency
def _rule_axis_membership(collectives, declared, param_specs, report):
    for c in collectives:
        if c.group_size > 1 and not c.axes:
            report.add(_shard_finding(
                "shard-collective-axis",
                f"{c.op} over a group of {c.group_size} ranks that is no "
                f"line of the declared mesh {_fmt_mesh(declared)}",
                where=c.where(),
                hint="a collective's group must be a mesh axis's "
                     "(parallel.mesh.make_mesh builds them)",
                detail={"group_size": c.group_size, "mesh": dict(declared)}))
        bad = [a for a in c.axes if a not in declared]
        if bad:
            report.add(_shard_finding(
                "shard-collective-axis",
                f"{c.op} over undeclared mesh axis(es) {bad} — declared "
                f"mesh is {_fmt_mesh(declared)}",
                where=c.where(),
                hint="align the strategy's mesh with the --strategy "
                     "declaration (cli.common.strategy_mesh_axes)",
                detail={"axes": bad, "mesh": dict(declared)}))
    for path, spec in flatten_specs(param_specs or {}):
        bad = [a for a in spec_axes(spec) if a not in declared]
        if bad:
            report.add(_shard_finding(
                "shard-collective-axis",
                f"spec {spec} of {path} splits over undeclared mesh "
                f"axis(es) {bad} — declared mesh is {_fmt_mesh(declared)}",
                where=path,
                hint="build the specs over the declared mesh's axes",
                detail={"axes": bad, "mesh": dict(declared)}))


def _rule_extra_collectives(collectives, declared, strategy, context,
                            report):
    allowed = set(expected_collective_axes(strategy)) or set(declared)
    if context == "serving":
        # the tp engine's Megatron reduces, and nothing else
        allowed = {"model"}
    for c in collectives:
        extra = [a for a in c.axes if a in declared and a not in allowed]
        if extra:
            report.add(_shard_finding(
                "shard-collective-extra",
                f"{c.op} over axis(es) {extra} — the declared strategy "
                f"({strategy or context}) plans no collective there",
                where=c.where(),
                hint="drop the collective or declare the strategy that "
                     "owns it",
                detail={"axes": extra, "strategy": strategy,
                        "context": context}))


def _rule_signature(collectives, declared, strategy, grad_comm,
                    param_specs, report):
    # (a) every declared >1 axis must carry some collective or split
    referenced = set()
    for c in collectives:
        referenced.update(c.axes)
    for _, spec in flatten_specs(param_specs or {}):
        referenced.update(spec_axes(spec))
    for axis, size in declared.items():
        if size > 1 and axis not in referenced:
            report.add(_shard_finding(
                "shard-collective-missing",
                f"mesh axis {axis!r}:{size} is declared but nothing in the "
                "traced step reduces or splits over it — the strategy is a "
                "silent no-op on that axis",
                where="mesh",
                hint="check the strategy's spec builder (megatron_specs "
                     "divisibility, batch sharding) against the model "
                     "geometry",
                detail={"axis": axis, "size": int(size),
                        "referenced": sorted(referenced)}))

    # (b) gradCompress declared ⇒ >= 1 16-bit gradient reduction
    if grad_comm is not None and getattr(grad_comm, "active", False) \
            and any(s > 1 for s in declared.values()):
        wire16 = sum(1 for c in collectives
                     if c.reduces and "data" in c.axes
                     and c.dtype is not None and c.dtype.itemsize == 2)
        if wire16 == 0:
            report.add(_shard_finding(
                "shard-collective-missing",
                f"--gradCompress {grad_comm.compress} is active but the "
                "traced step carries no 16-bit gradient reduction over the "
                "data axis — the grad all-reduce would ride f32",
                where="grad_comm",
                hint="route reduce_grads through parallel.grad_comm "
                     "(the DataParallel path does)",
                detail={"compress": grad_comm.compress}))

    # (c) tp ⇒ the layout must actually split weights
    if strategy == "tp" and param_specs is not None \
            and int(declared.get("model", 1)) > 1:
        specs = [s for _, s in flatten_specs(param_specs)]
        n_split = sum(1 for s in specs if not _spec_is_replicated(s))
        if specs and n_split == 0:
            report.add(_shard_finding(
                "shard-collective-missing",
                f"tp mesh (model:{declared['model']}) declared but the "
                "Megatron layout split zero parameter leaves — no "
                "row-split reduce exists; every rank runs the full model",
                where="megatron_specs",
                hint="pick a tp degree that divides d_model/heads, or "
                     "drop --strategy tp for this model",
                detail={"tp": int(declared["model"]),
                        "param_leaves": len(specs)}))


# ===================================== group 3: wire dtype / quant remat
def _rule_wire_dtype(collectives, grad_comm, report):
    if grad_comm is None or not getattr(grad_comm, "active", False):
        return
    for c in collectives:
        if not c.reduces or "data" not in c.axes \
                or c.nbytes < SHARD_MIN_BYTES:
            continue
        if c.dtype == torch.float32:
            report.add(_shard_finding(
                "shard-wire-dtype",
                f"{c.nbytes / 2**20:.1f} MiB {c.op} over the data axis "
                f"crosses the wire in f32 while --gradCompress "
                f"{grad_comm.compress} is active — this value bypassed "
                "the compressed bucket path",
                where=c.where(),
                hint="compress before the reduction "
                     "(grad_comm.compress_bucket) or exclude the value "
                     "deliberately",
                detail={"bytes": c.nbytes,
                        "compress": grad_comm.compress}))


_8BIT = (torch.int8, torch.uint8, torch.float8_e4m3fn, torch.float8_e5m2)
_aten = torch.ops.aten
_TRANSPARENT = (_aten._to_copy.default, _aten.view.default,
                _aten._unsafe_view.default, _aten.t.default,
                _aten.transpose.int, _aten.permute.default,
                _aten.clone.default, _aten.mul.Tensor, _aten.add.Tensor,
                _aten.expand.default, _aten.unsqueeze.default)


def _users(node, hops: int = 4):
    """Nodes reached from ``node`` through the tuple reads of an op's
    results and up to ``hops`` value-preserving ops (views, copies,
    converts, the scale of a dequant)."""
    out, frontier = [], [(node, 0)]
    seen = set()
    while frontier:
        n, d = frontier.pop()
        for u in n.users:
            if u in seen:
                continue
            seen.add(u)
            out.append(u)
            if u.target is operator.getitem:
                frontier.append((u, d))
            elif d < hops and u.target in _TRANSPARENT:
                frontier.append((u, d + 1))
    return out


def _rule_quant_remat(gm, collectives, report):
    """An 8-bit → wide convert whose >= 1 MiB result reaches a collective
    within a few value-preserving hops: the dense copy crosses the wire,
    not the 8-bit value."""
    coll_nodes = {c.node: c for c in collectives}
    for i, n in call_nodes(gm):
        if n.target is not _aten._to_copy.default \
                or n.kwargs.get("dtype") is None:
            continue
        src = node_val(n.args[0])
        if not isinstance(src, torch.Tensor) or src.dtype not in _8BIT:
            continue
        if aval_bytes(n) < SHARD_MIN_BYTES:
            continue
        for u in _users(n):
            c = coll_nodes.get(u)
            if c is None:
                continue
            report.add(_shard_finding(
                "shard-quant-remat-wire",
                f"{str(src.dtype).replace('torch.', '')} tensor "
                f"rematerialized dense ({aval_bytes(n) / 2**20:.1f} MiB) "
                f"before {c.op} — the wire carries the dense value",
                where=c.where(),
                hint="keep the 8-bit value across the collective and "
                     "dequantize per shard (QuantizedWeight keeps the "
                     "scale alongside)",
                detail={"bytes": aval_bytes(n),
                        "src_dtype": str(src.dtype).replace("torch.", "")}))
            break


# ============================================== group 4: reshard churn
_SLICES = (_aten.slice.Tensor, _aten.narrow.default, _aten.split.Tensor,
           _aten.split_with_sizes.default, _aten.chunk.default,
           _aten.select.int)


_ZEROS = (_aten.zeros.default, _aten.new_zeros.default,
          _aten.zeros_like.default)


def _gathers(c) -> bool:
    """A collective that assembles a whole value from the ranks' parts:
    an all-gather, or an all-reduce of a zero-padded slice (the
    Megatron gather of ``parallel.tensor_parallel``)."""
    if "gather" in c.op:
        return True
    if not c.reduces:
        return False
    arg = c.node.args[0]
    src = arg[0] if isinstance(arg, (list, tuple)) and arg else arg
    return isinstance(src, torch.fx.Node) and src.target in _ZEROS


def _rule_reshard_churn(collectives, declared, report):
    for c in collectives:
        if not c.axes or not _gathers(c):
            continue
        n = 1
        for a in c.axes:
            n *= int(declared.get(a, 1))
        if n <= 1:
            continue
        cut = [u for u in _users(c.node) if u.target in _SLICES]
        if not cut:
            continue
        whole = aval_bytes(cut[0].args[0])
        if whole < SHARD_MIN_BYTES:
            continue
        wasted = int(2 * whole * (n - 1) / n)
        report.add(_shard_finding(
            "shard-reshard-churn",
            f"{c.op} over {list(c.axes)} gathers a {whole / 2**20:.1f} MiB "
            f"value whole and {str(cut[0].target).split('.')[1]} cuts it "
            f"back into a slice (~{wasted / 2**20:.1f} MiB wasted wire)",
            where=c.where(),
            hint="keep the value split for its lifetime, or gather it "
                 "once where it is needed whole",
            detail={"bytes": whole, "axes": list(c.axes),
                    "wasted_bytes": wasted}))


# ======================================= group 2: replicated operands
def _abstract(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return t.is_meta or isinstance(t, FakeTensor)


def _leaf_layout(leaf, spec):
    """(shape, nbytes, replicated) of one param leaf: from its spec when
    the layout is given; a placed leaf (a real tensor) with no spec is
    whole on this rank; an abstract leaf with no spec is unknown (None
    never fires the rule)."""
    shape = tuple(getattr(leaf, "shape", ()))
    dtype = getattr(leaf, "dtype", None)
    if not shape or not isinstance(dtype, torch.dtype):
        return shape, 0, None
    n = 1
    for d in shape:
        n *= int(d)
    nbytes = n * dtype.itemsize
    if spec is not None:
        return shape, nbytes, _spec_is_replicated(spec)
    if isinstance(leaf, torch.Tensor) and not _abstract(leaf):
        return shape, nbytes, True
    return shape, nbytes, None


def run_replicated_operand_rules(params, mesh_axes: Dict[str, int], *,
                                 specs=None, split_axes=None,
                                 rule_id: str = "shard-replicated-operand",
                                 report: Optional[Report] = None) -> Report:
    """Mesh-aware replicated-large-operand rule over training and serving
    param trees (the JAX param paths, ``parallel.tensor_parallel.
    param_tree``): a >= 1 MiB, >= 2-D leaf fully replicated while a
    model-ish mesh axis is declared means every shard computes and stores
    it whole. Reads the ``specs`` tree (``megatron_specs``'s) where given;
    ``rule_id`` keeps the ``serving-unsharded-matmul`` spelling as an
    alias, which reads placed (real-tensor) trees only."""
    report = report if report is not None else Report()
    declared = {str(k): int(v) for k, v in (mesh_axes or {}).items()}
    if split_axes is None:
        split_axes = tuple(a for a in declared
                           if a not in _DATA_AXES and declared[a] > 1)
    sizes = [declared[a] for a in split_axes if declared.get(a, 1) > 1]
    if not sizes:
        return report
    spec_of = dict(flatten_specs(specs)) if specs is not None else {}
    legacy = rule_id == "serving-unsharded-matmul"
    for where_s, leaf in flatten_tree(params):
        leaf = getattr(leaf, "q", leaf)  # a quantized weight's int8 plane
        if legacy and (not isinstance(leaf, torch.Tensor)
                       or _abstract(leaf)):
            continue  # placed trees only
        spec = spec_of.get(where_s) if specs is not None else None
        shape, nbytes, replicated = _leaf_layout(leaf, spec)
        if len(shape) < 2 or nbytes < SHARD_MIN_BYTES \
                or replicated is not True:
            continue
        splittable = sorted({a for a in split_axes
                             for d in shape if d % declared[a] == 0})
        if legacy:
            tp = max(sizes)
            report.add(Finding(
                rule=rule_id, family="serving", severity="error",
                message=f"{where_s}: {nbytes / 2**20:.1f} MiB weight "
                        f"{shape} is fully replicated under tp={tp} — "
                        "each chip runs this matmul whole",
                where=where_s,
                hint="shard dims the Megatron pairing can split "
                     "(d_model / heads divisible by K), or drop "
                     "--strategy tp for this model",
                detail={"bytes": nbytes, "shape": list(shape),
                        "tp": int(tp)}))
            continue
        mesh_str = ", ".join(f"{a}:{declared[a]}" for a in split_axes)
        if splittable:
            msg = (f"{where_s}: {nbytes / 2**20:.1f} MiB operand {shape} "
                   f"fully replicated though mesh axis(es) "
                   f"{splittable} could split a dim — every shard "
                   "computes it whole")
            hint = ("shard it over the model axis (megatron_specs "
                    "pairing / with_sharding_constraint), or shrink "
                    "the mesh")
        else:
            msg = (f"{where_s}: {nbytes / 2**20:.1f} MiB operand {shape} "
                   f"fully replicated and NO dim divides the declared "
                   f"axis(es) {{{mesh_str}}} — this degree does not "
                   "fit the model geometry")
            hint = ("pick a degree that divides d_model/heads, or "
                    "accept replication explicitly with --strategy dp")
        report.add(_shard_finding(
            rule_id, msg, where=where_s, hint=hint,
            detail={"bytes": nbytes, "shape": list(shape),
                    "mesh": {a: declared[a] for a in split_axes},
                    "splittable_axes": splittable}))
    return report


# ============================================ group 5: KV pool misfit
def run_kv_sharding_rules(kv_tree, tp_k: int, *, axis: str = "model",
                          page_tokens: Optional[int] = None,
                          report: Optional[Report] = None) -> Report:
    """KV-pool/cache sharding misfit under tp: ``kv_tree`` is the whole
    model's page pools (an 8-bit pool's q and s planes) or dense cache,
    abstract or real. Fires when a >= 1 MiB 4-D leaf's kv_heads dim (axis
    1 of ``(slots|pages, kv_heads, tokens, head_dim)``) is not divisible by
    ``tp_k``: the head split the engines place falls back to the whole
    cache on every rank."""
    report = report if report is not None else Report()
    k = int(tp_k)
    if k <= 1:
        return report
    for where_s, leaf in flatten_tree(kv_tree):
        shape = tuple(getattr(leaf, "shape", ()))
        dtype = getattr(leaf, "dtype", None)
        if len(shape) != 4 or not isinstance(dtype, torch.dtype):
            continue
        nbytes = shape[0] * shape[1] * shape[2] * shape[3] * dtype.itemsize
        if nbytes < SHARD_MIN_BYTES:
            continue
        kv_heads = int(shape[1])
        if kv_heads % k:
            report.add(_shard_finding(
                "kv-shard-misfit",
                f"{where_s}: KV leaf {shape} has kv_heads={kv_heads} not "
                f"divisible by tp={k} — the P(None,{axis!r},None,None) "
                f"head split falls back to replicating "
                f"{nbytes / 2**20:.1f} MiB of pages on every chip",
                where=where_s,
                hint="pick tp dividing kv_heads (GQA: raise kv_heads "
                     "or lower K), or serve this model dp-only",
                detail={"bytes": nbytes, "shape": list(shape),
                        "kv_heads": kv_heads, "tp": k,
                        "page_tokens": page_tokens}))
    return report


# ================================================= composed entry point
def run_sharding_rules(graph, *, mesh_axes: Optional[Dict[str, int]] = None,
                       strategy: Optional[str] = None, grad_comm=None,
                       param_specs=None, params=None,
                       context: str = "train", groups=None,
                       report: Optional[Report] = None) -> Report:
    """All shardlint rules over one rank's traced step (groups 1, 3, 4,
    plus group 2 when ``params``/``param_specs`` are given).
    ``mesh_axes`` is the declared mesh (axis -> size; default every axis
    a collective was seen over), ``strategy`` the declared ``--strategy``
    name, ``grad_comm`` the ``GradCommConfig`` in effect, ``context``
    ``"train"`` or ``"serving"``, ``groups`` the process-group -> axes map
    of the traced mesh (default the one the trace left on the graph)."""
    report = report if report is not None else Report()
    groups = groups if groups is not None else graph.meta.get(
        "mesh_groups", {})
    levels = sharded_levels(graph, groups)
    declared = ({str(k): int(v) for k, v in mesh_axes.items()}
                if mesh_axes else observed_mesh_axes(levels))
    collectives = levels[0].collectives

    _rule_axis_membership(collectives, declared, param_specs, report)
    _rule_extra_collectives(collectives, declared, strategy, context,
                            report)
    _rule_signature(collectives, declared, strategy, grad_comm,
                    param_specs, report)
    _rule_wire_dtype(collectives, grad_comm, report)
    _rule_quant_remat(graph, collectives, report)
    _rule_reshard_churn(collectives, declared, report)
    if params is not None and declared:
        run_replicated_operand_rules(params, declared, specs=param_specs,
                                     report=report)
    return report
