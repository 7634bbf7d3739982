"""The lint's rule registry (counterpart of ``bigdl_tpu/analysis/rules.py``):
performance and correctness anti-patterns of the H100 path caught by a
trace on the CPU, before a card is touched.

Two kinds of rules share one catalog, with the JAX package's ids,
families and severities:

* **graph rules** (:func:`run_jaxpr_rules`, named as the JAX function is
  so a reader finds it) walk the FX graph of a traced step
  (``fx_walk.trace_graph``) and the kernel sites it recorded: bf16→f32
  upcasts re-reading large activations, an upcast promoted by a
  one-element f32 tensor, train-state buffers updated out of place,
  kernel launches no compiled kernel takes or whose tiles pad the
  sequence or whose plan crowds the SM's shared memory, host syncs in the
  step, per-leaf collectives, an f32 dequant chain into a product.
* **module rules** (:func:`run_module_rules`) walk the model tree: BN
  sites running outside the fused block, GEMM-eligible 1x1 convs
  resolving to a spatial layout (``ops/conv2d.resolve_site_layouts``),
  feature dims and head dims off the tensor cores' grid, attention on
  the dense path.

Severity policy as in the JAX package: **error** = the measured-regression
configurations and launch hazards (unfused BN, a launch no kernel takes,
padded tiles, host sync in the step) that ``--lint=strict`` refuses to
launch on; **warning** = costs worth a look; **info** = grid-fit notes.

Stated differences from the JAX rules (each id stays in the catalog):

* ``dtype-weak-scalar``: torch does not promote a tensor on a 0-d f32
  tensor (it is weak, as a python scalar is); the rule fires on an
  upcast bf16 operand whose partner is a one-element f32 tensor of one
  dim or more, which does promote.
* ``donate-missing``/``donate-ok``: there is no ``jit`` boundary; the
  train-state inputs of a traced step (``state_argnums``) that ≥ 1 MiB
  round-trip to an output of their shape and dtype without being updated
  in place keep two copies, against state updated in place (the port's
  optimizers, ``foreach`` or per-leaf ``_`` ops).
* ``tile-min``, ``tile-pad``, ``vmem-budget``: the port has no Pallas
  blocks (so no ``check_block_tiling``/``min_sublane``); one
  :func:`check_launch_plan` over a recorded kernel site takes their place:
  a shape no compiled kernel takes (it would fail to launch), a sequence
  that is not a multiple of the variant's tiles (128-row units and
  128-key tiles for the wgmma kernels, 64 for ``mma.sync`` and FMA), and
  a plan over 0.8 of the 227 KB of shared memory a CTA may have, or a
  cooperative BN plan whose CTAs cannot all be resident.
* ``tile-ragged-attn``: a causal LM at a ragged length stays on the
  kernels (they mask a ragged edge); the rule fires where the port does
  leave them, a key-padding mask whose length none of 512/256/128
  divides (the dense path of ``blockwise_attention``). ``tile-seq-clamp``
  reads that path's clamped key block.
* ``tile-bn-ineligible``: every BN shape takes the port's kernels, so it
  never fires.
* ``layout-c128``, ``layout-headdim``: the card's grid: ``wgmma`` takes
  widths that are multiples of 8, and a bf16 head dim other than 64 or
  128 leaves the wgmma kernels.
* ``kv-page-misfit``: pages against the prefill kernel's key tile; the
  Mosaic 8-sublane part has no counterpart.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from bigdl_tpu_torch.analysis.fx_walk import (aval_bytes, call_nodes,
                                              collect_collectives,
                                              flatten_tree, kernel_sites,
                                              node_val, where)
from bigdl_tpu_torch.analysis.report import Finding, Report
from bigdl_tpu_torch.ops.lint_sites import SMEM_PER_BLOCK

__all__ = ["CATALOG", "run_jaxpr_rules", "run_module_rules",
           "run_comm_rules", "run_memory_rules", "run_decode_rules",
           "run_serving_tp_rules", "check_launch_plan",
           "UPCAST_MIN_BYTES", "DONATE_MIN_BYTES", "SMEM_BUDGET_BYTES",
           "COMM_F32_MIN_BYTES", "COMM_MAX_COLLECTIVES",
           "HBM_WARN_FRAC", "SERVING_TP_MIN_BYTES", "MMA_WIDTH"]

# rule id -> (family, severity, one-line catalog description)
CATALOG: Dict[str, Tuple[str, str, str]] = {
    "dtype-upcast": (
        "dtype", "warning",
        "large bf16→f32 copy feeding a reduction that leaves the last dim "
        "or a matmul/conv — the activation crosses HBM again at 2x width "
        "(the plain-BN stats pattern)"),
    "dtype-weak-scalar": (
        "dtype", "warning",
        "a one-element f32 tensor promotes a large bf16 tensor to f32 — "
        "use a python scalar or cast the constant to bf16"),
    "donate-missing": (
        "donation", "warning",
        "the step returns fresh copies of >=1 MiB train-state inputs "
        "(params/opt-state round-trip) instead of updating them in place "
        "— ~2x HBM for the train state"),
    "donate-ok": (
        "donation", "info",
        "the step updates its round-tripping train state in place (the "
        "optim/method.py update contract)"),
    "tile-min": (
        "tiling", "error",
        "a kernel launch at a shape no compiled kernel takes (head dim or "
        "dtype outside flash_fwd_sm90/mma.sync/FMA's set) — it fails on "
        "the card"),
    "tile-pad": (
        "tiling", "error",
        "the sequence is not a multiple of the kernel variant's tiles — "
        "the last tile of every (batch, head) runs padded"),
    "tile-ragged-attn": (
        "tiling", "error",
        "key-padding attention at a length none of 512/256/128 divides — "
        "it leaves the kernels for the dense path"),
    "tile-bn-ineligible": (
        "tiling", "info",
        "BN site the kernel cannot take (never fires in the port: the "
        "CUDA kernels take every rows >= 1 and C >= 1)"),
    "vmem-budget": (
        "tiling", "warning",
        "a launch plan over 0.8 of the 227 KB of shared memory a CTA may "
        "have, or a cooperative BN plan whose CTAs cannot all be resident "
        "— no room to deepen the pipeline, or a looping grid"),
    "tile-seq-clamp": (
        "tiling", "info",
        "the key-padding path's key block clamps below the 512 default "
        "(fine, but a 512-divisible length keeps the default tiling)"),
    "fusion-bn-unfused": (
        "fusion", "error",
        "BatchNormalization site eligible for the fused apply block "
        "(fused='apply') is running unfused/stats — the "
        "measured-regression config"),
    "tile-bn-fallback": (
        "tiling", "warning",
        "fused BN requested but fewer BN kernel sites traced than fused "
        "modules — the fusion silently isn't happening"),
    "fusion-conv-gemm": (
        "fusion", "warning",
        "GEMM-eligible 1x1/s1 conv resolves to a spatial layout — the "
        "matmul spelling is available (ops/conv2d.py GEMM)"),
    "fusion-attn-dense": (
        "fusion", "info",
        "attention runs the dense PyTorch path; the flash kernels are "
        "available (attn_impl='flash')"),
    "layout-c128": (
        "layout", "info",
        "feature dims off the tensor cores' 8-wide grid — wgmma tiles are "
        "padded, waste estimated via utils/flops.conv_unit_flops"),
    "layout-headdim": (
        "layout", "info",
        "attention head_dim is not 64 or 128 — bf16 attention leaves the "
        "wgmma kernels for mma.sync"),
    "host-sync": (
        "host-sync", "error",
        "host sync inside the step (.item(), .tolist(), .cpu(), a "
        "data-dependent op) — every step waits for the card to drain"),
    "comm-f32-allreduce": (
        "comm", "warning",
        "multi-device strategy reduces >=1 MiB gradient buckets in f32 "
        "with compression off — twice the wire bytes the 16-bit codec "
        "path (--gradCompress bf16) would move"),
    "comm-unbucketed": (
        "comm", "warning",
        "gradient reduction is per-leaf (>16 collectives in one step "
        "graph / unbucketed grad tree) — per-collective launch latency "
        "is paid per parameter instead of per dense bucket"),
    "hbm-oversubscribed": (
        "memory", "error",
        "the step's working set (obs/memory.build_plan) exceeds the "
        "device HBM — the run fails with an OOM on its first step; "
        "caught on the CPU"),
    "hbm-tight": (
        "memory", "warning",
        "the step's working set is within 15% of the device HBM — "
        "fragmentation or a live-buffer spike will tip it over "
        "(obs/memory forecasts the max batch that still fits)"),
    "lint-trace-error": (
        "meta", "info",
        "the step could not be traced; only module-level rules ran"),
    "decode-sampling-sort": (
        "decode", "warning",
        "full-vocab sort inside the per-token decode step — top-k/top-p "
        "warping pays O(V log V) per slot per token; at large vocab the "
        "sampler dominates the step (serve only the sort-free program "
        "to greedy/temperature traffic, or filter on a partial "
        "threshold)"),
    "kv-page-misfit": (
        "decode", "warning",
        "KV page token size misfits the layout: when neither the prefill "
        "kernel's key tile nor the page divides the other, key tiles "
        "straddle page boundaries in the gathered view"),
    "quant-dequant-upcast": (
        "dtype", "error",
        "a dequantized int8/fp8 weight is re-materialized as f32 "
        "feeding a matmul whose other operand was upcast from bf16 — "
        "the dequant epilogue defeats the 8-bit storage AND drags the "
        "activation to f32; dequantize into the activation dtype "
        "instead (serving/quant.py does)"),
    "serving-unsharded-matmul": (
        "serving", "error",
        "tp-strategy serving graph carries a >=1 MiB matmul weight with "
        "fully-replicated placement — every rank runs the full matmul "
        "and tp buys nothing for it (a megatron_specs divisibility gate "
        "fell back to replication); alias of the mesh-aware "
        "shard-replicated-operand rule, kept for stable serve --lint "
        "output"),
}

UPCAST_MIN_BYTES = 2 * 1024 * 1024    # ignore small/scalar copies
DONATE_MIN_BYTES = 1 * 1024 * 1024    # per-buffer floor for the HBM rule
SMEM_BUDGET_BYTES = SMEM_PER_BLOCK     # shared memory a CTA may have
SMEM_WARN_FRAC = 0.8
COMM_F32_MIN_BYTES = 1 * 1024 * 1024  # grad wire worth compressing
COMM_MAX_COLLECTIVES = 16             # per-leaf-reduce smell threshold
HBM_WARN_FRAC = 0.85                  # plan/HBM ratio that earns hbm-tight
DECODE_SORT_MIN_LANES = 16384         # vocab size where the warp sort bites
SERVING_TP_MIN_BYTES = 1 * 1024 * 1024  # matmul weight worth sharding
MMA_WIDTH = 8                         # wgmma's width grid (multiples of 8)

_aten = torch.ops.aten


def _finding(rule: str, message: str, where: str = "", hint: str = "",
             detail: Optional[dict] = None,
             severity: Optional[str] = None) -> Finding:
    family, default_sev, _ = CATALOG[rule]
    return Finding(rule=rule, family=family,
                   severity=severity or default_sev, message=message,
                   where=where, hint=hint, detail=detail or {})


def _sites_of(hits) -> str:
    return "; ".join(hits[:4]) + ("…" if len(hits) > 4 else "")


# ========================================================= kernel sites
def check_launch_plan(site) -> List[Tuple[str, str]]:
    """Problems (empty = fine) of one recorded kernel site, as (rule id,
    text): ``tile-min`` where no compiled kernel takes the launch,
    ``tile-pad`` where a flash sequence is not a multiple of its
    variant's tiles, ``vmem-budget`` where the plan's shared memory passes
    0.8 x 227 KB or a cooperative BN grid cannot be resident at once.
    The port's single source of truth for the three tile rules."""
    plan = site.plan
    probs: List[Tuple[str, str]] = []
    if site.kernel.startswith("flash_"):
        if plan.get("variant") is None:
            probs.append(("tile-min", plan.get("problem",
                                               "no compiled kernel")))
            return probs
        waste = padded_fraction(plan)
        if waste > 0.0:
            probs.append(("tile-pad",
                          f"{plan['variant']} tiles ({plan['tile_q']}, "
                          f"{plan['tile_k']}) pad s_q {plan['s_q']} / s_k "
                          f"{plan['s_k']} ({waste * 100:.0f}% wasted)"))
    smem = int(plan.get("smem_bytes") or 0)
    if smem > SMEM_WARN_FRAC * SMEM_BUDGET_BYTES:
        probs.append(("vmem-budget",
                      f"{plan.get('variant') or plan.get('kernel')}: "
                      f"{smem / 1024:.1f} KB of shared memory a CTA (budget "
                      f"{SMEM_BUDGET_BYTES / 1024:.0f} KB)"))
    if "blocks" in plan and plan["blocks"] * plan["slabs"] > plan["ctas"]:
        probs.append(("vmem-budget",
                      f"bn_coop_kernel {plan['mode']}: {plan['blocks']} "
                      f"channel blocks x {plan['slabs']} slabs > "
                      f"{plan['ctas']} resident CTAs (the grid loops)"))
    return probs


def padded_fraction(plan: dict) -> float:
    """Share of a flash launch's tile work that is padding."""
    real = padded = 1.0
    for s, t in ((plan["s_q"], plan["tile_q"]), (plan["s_k"], plan["tile_k"])):
        real *= s
        padded *= -(-s // t) * t
    return 0.0 if padded <= real else 1.0 - real / padded


def _rule_kernel_sites(gm, report: Report) -> None:
    """The tile rules over the kernel sites the trace recorded (the JAX
    ``_rule_pallas`` over ``pallas_call`` equations), one finding per
    rule and kernel, and the key-padding path's fallbacks."""
    by: Dict[tuple, list] = {}
    ragged, clamped = [], []
    for i, site in enumerate(kernel_sites(gm)):
        if site.kernel == "blockwise_attention":
            bk, s_k = site.plan["block_k"], site.shapes[1][-2]
            if site.plan["dense"]:
                ragged.append(site)
            elif bk < 512 and bk < s_k:
                clamped.append(site)
            continue
        for rule, text in check_launch_plan(site):
            by.setdefault((rule, site.kernel), []).append(
                (f"{site.kernel}#{i}", text, site))
    hints = {
        "tile-min": "serve/train at a head dim the kernels take "
                    "(16/32/64/128) in float32 or bfloat16",
        "tile-pad": "pick a sequence length the variant's tiles divide "
                    "(a multiple of 128), or pack sequences to one",
        "vmem-budget": "a smaller head dim or tile keeps room for a "
                       "deeper pipeline; a BN grid that loops re-reads "
                       "its operands",
    }
    for (rule, kernel), hits in by.items():
        text = hits[0][1]
        report.add(_finding(
            rule, f"kernel {kernel}: {len(hits)} launch(es): {text}",
            where=_sites_of([h[0] for h in hits]), hint=hints[rule],
            detail={"count": len(hits), "plan": dict(hits[0][2].plan)}))
    if ragged:
        s = ragged[0]
        report.add(_finding(
            "tile-ragged-attn",
            f"{len(ragged)} key-padding attention site(s): s_k "
            f"{s.shapes[1][-2]} does not tile (block_k="
            f"{s.plan['block_k']}) — the call takes the dense path",
            where=f"blockwise_attention {s.shapes[0]}",
            hint="pad/pack sequences to a multiple of 128 "
                 "(dataset.text.pack_sequences) or accept the fallback",
            detail={"seq": s.shapes[1][-2], "count": len(ragged),
                    "block_k": s.plan["block_k"]}))
    if clamped:
        s = clamped[0]
        report.add(_finding(
            "tile-seq-clamp",
            f"{len(clamped)} key-padding attention site(s): s_k "
            f"{s.shapes[1][-2]} clamps the key block to "
            f"{s.plan['block_k']} — fine, but a 512-divisible length keeps "
            "the default tiling",
            where=f"blockwise_attention {s.shapes[0]}",
            detail={"count": len(clamped), "block_k": s.plan["block_k"]}))


# =========================================================== graph rules
_REDUCE_OPS = (_aten.sum.dim_IntList, _aten.mean.dim, _aten.amax.default,
               _aten.amin.default, _aten.var.correction,
               _aten.var_mean.correction, _aten.prod.dim_int)
_MATMUL_OPS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
               _aten.baddbmm.default, _aten.convolution.default)
_BINARY_OPS = (_aten.add.Tensor, _aten.sub.Tensor, _aten.mul.Tensor,
               _aten.div.Tensor, _aten.maximum.default,
               _aten.minimum.default, _aten.pow.Tensor_Tensor)
_CONVERT_OPS = (_aten._to_copy.default, torch.ops.prims.convert_element_type
                .default)
_SYNC_OPS = (_aten._local_scalar_dense.default, _aten.nonzero.default,
             _aten.masked_select.default, _aten.item.default)
_SORT_OPS = (_aten.sort.default, _aten.sort.stable, _aten.topk.default)


def _val_dtype(x):
    v = node_val(x)
    return v.dtype if isinstance(v, torch.Tensor) else None


def _convert_to(node) -> Optional[torch.dtype]:
    """The dtype a convert node casts to, or None if it is no convert."""
    if node.target not in _CONVERT_OPS:
        return None
    if node.target is _aten._to_copy.default:
        return node.kwargs.get("dtype")
    return node.args[1] if len(node.args) > 1 else None


def _upcasts(gm, min_bytes: int):
    """(position, node) of every bf16→f32 convert of >= ``min_bytes``."""
    for i, n in call_nodes(gm):
        if _convert_to(n) is not torch.float32:
            continue
        if _val_dtype(n.args[0]) is not torch.bfloat16:
            continue
        if aval_bytes(n) >= min_bytes:
            yield i, n


def _rule_dtype_upcast(gm, report: Report) -> None:
    hits, total = [], 0
    for i, n in _upcasts(gm, UPCAST_MIN_BYTES):
        nd = node_val(n).dim()
        interesting = False
        for c in n.users:
            if c.target in _MATMUL_OPS:
                interesting = True
            elif c.target in _REDUCE_OPS:
                dims = c.args[1] if len(c.args) > 1 else None
                dims = [d % nd for d in (dims if isinstance(
                    dims, (list, tuple)) else [dims])] if dims is not None \
                    else list(range(nd))
                # reductions that leave the last dim are the BN-stats
                # pattern; a last-dim reduce is the (expected) f32 softmax
                if nd and (nd - 1) not in dims:
                    interesting = True
        if interesting:
            hits.append(where(i, n))
            total += aval_bytes(n)
    if hits:
        report.add(_finding(
            "dtype-upcast",
            f"{len(hits)} bf16→f32 upcast(s) totalling "
            f"{total / 2**20:.0f} MiB feed reductions over the leading "
            "dims or matmuls — the activation crosses HBM again at 2x "
            "width",
            where=_sites_of(hits),
            hint="fuse the consumer (e.g. --fusedBN apply keeps the "
                 "upcast inside one kernel) or keep the chain in bf16",
            detail={"count": len(hits), "bytes": total,
                    "sites": hits[:16]}))


def _rule_weak_scalar(gm, report: Report) -> None:
    """torch promotes a bf16 tensor to f32 inside a binary op whose other
    operand is an f32 tensor of one element and at least one dim (a 0-d
    tensor or a python scalar does not): an op of two such inputs with a
    large f32 output, or an explicit bf16→f32 copy feeding one."""
    hits = []

    def one_f32(v):
        v = node_val(v)
        return (isinstance(v, torch.Tensor) and v.dtype == torch.float32
                and v.dim() >= 1 and v.numel() == 1)

    for i, n in call_nodes(gm):
        if n.target not in _BINARY_OPS or len(n.args) < 2:
            continue
        a, b = n.args[0], n.args[1]
        for big, small in ((a, b), (b, a)):
            src = big
            if isinstance(big, torch.fx.Node) and \
                    _convert_to(big) is torch.float32:
                src = big.args[0]
            if (_val_dtype(src) is torch.bfloat16 and one_f32(small)
                    and _val_dtype(n) is torch.float32
                    and aval_bytes(n) >= UPCAST_MIN_BYTES):
                hits.append(where(i, n))
                break
    if hits:
        report.add(_finding(
            "dtype-weak-scalar",
            f"{len(hits)} op(s) promote a large bf16 tensor to f32 via "
            "a one-element f32 tensor",
            where=_sites_of(hits),
            hint="use a plain python scalar (it stays bf16) or cast the "
                 "constant to the tensor dtype",
            detail={"count": len(hits), "sites": hits[:16]}))


_VIEW_OPS = (_aten.view.default, _aten._unsafe_view.default,
             _aten.t.default, _aten.transpose.int, _aten.permute.default,
             _aten.slice.Tensor, _aten.select.int, _aten.expand.default,
             _aten.unsqueeze.default, _aten.squeeze.dim, _aten.alias.default,
             _aten.as_strided.default, _aten.detach.default,
             _aten.narrow.default)


def _mutates_first(node) -> bool:
    schema = getattr(node.target, "_schema", None)
    if schema is None or not schema.arguments:
        return False
    info = schema.arguments[0].alias_info
    return bool(info is not None and info.is_write)


def _rule_donation(gm, report: Report) -> None:
    """The train-state placeholders (``graph.meta["state_inputs"]``) that
    the step updates in place against those it returns fresh copies
    of."""
    state = gm.meta.get("state_inputs")
    if not state:
        return
    holders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    state = [holders[k] for k in state if k < len(holders)]
    base = {n: n for n in holders}
    mutated = set()
    for n in gm.graph.nodes:
        if n.op != "call_function" or not n.args:
            continue
        src = n.args[0] if isinstance(n.args[0], torch.fx.Node) else None
        if src is None or src not in base:
            continue
        if n.target in _VIEW_OPS:
            base[n] = base[src]
        elif _mutates_first(n):
            mutated.add(base[src])
    outs = []
    for o in gm.graph.nodes:
        if o.op == "output":
            outs = [x for x in flatten_tree(o.args)
                    if isinstance(x[1], torch.fx.Node)]
    out_counts: Dict[tuple, int] = {}
    for _, node in outs:
        v = node_val(node)
        if node in state or not isinstance(v, torch.Tensor):
            continue
        key = (tuple(v.shape), v.dtype)
        out_counts[key] = out_counts.get(key, 0) + 1
    missing = n_missing = in_place = 0
    for p in state:
        b = aval_bytes(p)
        if p in mutated:
            in_place += b
            continue
        v = node_val(p)
        key = (tuple(v.shape), v.dtype)
        if b >= DONATE_MIN_BYTES and out_counts.get(key, 0) > 0:
            out_counts[key] -= 1
            missing += b
            n_missing += 1
    if missing:
        report.add(_finding(
            "donate-missing",
            f"step keeps {n_missing} train-state buffer(s) "
            f"({missing / 2**20:.0f} MiB) whose shape/dtype round-trip to "
            "fresh outputs — params/opt-state live twice in HBM",
            where="step",
            hint="update the state in place (the optimizers' "
                 "torch._foreach_*_/w.sub_ contract, optim/method.py)",
            detail={"bytes": missing, "buffers": n_missing}))
    elif in_place:
        report.add(_finding(
            "donate-ok",
            f"step updates {in_place / 2**20:.0f} MiB of round-tripping "
            "train state in place",
            where="step", detail={"bytes": in_place}))


def _rule_host_sync(gm, report: Report) -> None:
    for i, n in call_nodes(gm):
        sync = n.target in _SYNC_OPS
        if (not sync and n.target is _aten._to_copy.default
                and str(n.kwargs.get("device", "")) == "cpu"):
            src = node_val(n.args[0])
            sync = isinstance(src, torch.Tensor) and src.device.type != "cpu"
        if sync:
            report.add(_finding(
                "host-sync",
                f"{where(i, n).rsplit('#', 1)[0]} inside the step — the "
                "host waits for the card every iteration",
                where=where(i, n),
                hint="keep values on the card (log from returned tensors "
                     "after the step; debug reads only under a flag)"))


def _rule_collectives(gm, report: Report) -> None:
    """More than COMM_MAX_COLLECTIVES collectives in one step graph means
    the reduction is per leaf; the dense buckets of
    ``parallel/grad_comm`` amortize that launch latency away."""
    hits = [c.where() for c in collect_collectives(gm)]
    if len(hits) > COMM_MAX_COLLECTIVES:
        report.add(_finding(
            "comm-unbucketed",
            f"{len(hits)} collective op(s) in one step graph (threshold "
            f"{COMM_MAX_COLLECTIVES}) — per-leaf reduction pays launch "
            "latency per parameter",
            where=_sites_of(hits),
            hint="bucket the grads into dense size-bounded buffers "
                 "(parallel/grad_comm; --gradCompress enables it)",
            detail={"count": len(hits), "sites": hits[:16]}))


# ops a dequant chain routes through between the convert and the matmul:
# the scale multiply/add, layout moves, and the converts themselves
_DEQUANT_PASSTHRU = _CONVERT_OPS + (
    _aten.mul.Tensor, _aten.add.Tensor, _aten.t.default,
    _aten.transpose.int, _aten.permute.default, _aten.view.default,
    _aten._unsafe_view.default, _aten.expand.default,
    _aten.unsqueeze.default, _aten.clone.default)
_QUANT_SRC_DTYPES = (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2)


def _convert_sources(node, max_depth: int = 8) -> set:
    """Source dtypes of every convert on ``node``'s producer chain,
    walking back through the passthrough ops only."""
    out: set = set()
    stack, seen = [(node, 0)], set()
    while stack:
        v, d = stack.pop()
        if d > max_depth or v in seen or not isinstance(v, torch.fx.Node):
            continue
        seen.add(v)
        if v.op != "call_function" or v.target not in _DEQUANT_PASSTHRU:
            continue
        if _convert_to(v) is not None:
            out.add(_val_dtype(v.args[0]))
        for a in v.args:
            if isinstance(a, torch.fx.Node):
                stack.append((a, d + 1))
    return out


def _rule_quant_dequant_upcast(gm, report: Report) -> None:
    hits = []
    for i, n in call_nodes(gm):
        if n.target not in (_aten.mm.default, _aten.addmm.default,
                            _aten.bmm.default):
            continue
        ops = list(n.args[-2:])
        srcs = [_convert_sources(v) for v in ops]
        for a, b in ((0, 1), (1, 0)):
            if (any(s in _QUANT_SRC_DTYPES for s in srcs[a])
                    and torch.bfloat16 in srcs[b]
                    and _val_dtype(ops[b]) is torch.float32):
                hits.append(where(i, n))
                break
    if hits:
        report.add(_finding(
            "quant-dequant-upcast",
            f"{len(hits)} matmul(s) pair a f32-rematerialized "
            "dequantized weight with a bf16-upcast activation — the "
            "contraction runs at f32 width, defeating both the 8-bit "
            "storage and the bf16 compute dtype",
            where=_sites_of(hits),
            hint="dequantize into the activation dtype (the "
                 "serving/quant.py epilogue) or take the native int8 "
                 "product (torch._int_mm)",
            detail={"count": len(hits), "sites": hits[:16]}))


def _rule_decode_sort(gm, report: Report) -> None:
    for i, n in call_nodes(gm):
        if n.target not in _SORT_OPS:
            continue
        v = node_val(n.args[0])
        lanes = int(v.shape[-1]) if isinstance(v, torch.Tensor) and \
            v.dim() else 0
        if lanes >= DECODE_SORT_MIN_LANES:
            report.add(_finding(
                "decode-sampling-sort",
                f"sort over {lanes} lanes in the decode step "
                "(top-k/top-p warp) — O(V log V) per slot per token",
                where=where(i, n),
                hint="route greedy/temperature-only traffic through the "
                     "sort-free step program (the engine picks per "
                     "round); consider a threshold-filter sampler at "
                     "this vocab",
                detail={"lanes": lanes}))


def run_decode_rules(graph=None, *, page_tokens: Optional[int] = None,
                     max_len: Optional[int] = None,
                     head_dim: Optional[int] = None, dtype=None,
                     report: Optional[Report] = None) -> Report:
    """Decode-hot-path rules, run by the serve pre-flight before the
    first request: host syncs and full-vocab sampling sorts in the traced
    decode step (``DecodeEngine.trace_step_graph()``), plus the page
    layout's fit against the prefill kernel's key tile when paging is
    on."""
    from bigdl_tpu_torch.ops.attention_kernel import launch_plan

    report = report if report is not None else Report()
    if graph is not None:
        _rule_host_sync(graph, report)
        _rule_decode_sort(graph, report)
    if page_tokens and max_len and head_dim:
        dt = dtype if dtype is not None else torch.float32
        tk = launch_plan("flash_fwd", dt, int(head_dim), int(max_len),
                         int(max_len))["tile_k"]
        pt = int(page_tokens)
        plan = {"page_tokens": pt, "block_k": tk,
                "divides_max_len": max_len % pt == 0,
                "block_aligned": pt % tk == 0 or tk % pt == 0}
        problems = []
        if not plan["divides_max_len"]:
            problems.append(f"page_tokens {pt} does not divide max_len "
                            f"{max_len}")
        if not plan["block_aligned"]:
            problems.append(
                f"page_tokens {pt} vs the prefill kernel's key tile {tk}: "
                "neither divides the other — key tiles straddle page "
                "boundaries")
        if problems:
            report.add(_finding(
                "kv-page-misfit", "; ".join(problems),
                where=f"kv_pages(page_tokens={pt}, max_len={max_len})",
                hint="pick --kvPageTokens from the tuned ladder "
                     "(tuning.kv_page_tokens: 32/64/128/256) or 'auto'",
                detail=plan))
    return report


def run_serving_tp_rules(params, n_shard: int, *, specs=None,
                         report: Optional[Report] = None) -> Report:
    """Tensor-parallel serving placement rule, run by the serve pre-flight
    under ``--strategy tp:K`` (K > 1) over the param tree the engine
    placed (its whole tensors, with ``specs`` the layout it was placed
    under): a >=1 MiB weight left fully replicated means every rank runs
    that matmul whole. An alias of the mesh-aware
    :func:`bigdl_tpu_torch.analysis.sharding_rules.run_replicated_operand_rules`,
    kept so the serve pre-flight's output stays stable."""
    from bigdl_tpu_torch.analysis.sharding_rules import \
        run_replicated_operand_rules

    report = report if report is not None else Report()
    if n_shard <= 1:
        return report
    return run_replicated_operand_rules(
        params, {"model": int(n_shard)}, specs=specs, split_axes=("model",),
        rule_id="serving-unsharded-matmul", report=report)


def run_jaxpr_rules(graph, report: Optional[Report] = None) -> Report:
    """All graph-level rules over one traced step (an FX graph from
    ``fx_walk.trace_graph``, or any fn traced by
    :func:`bigdl_tpu_torch.analysis.lint_fn`)."""
    report = report if report is not None else Report()
    _rule_donation(graph, report)
    _rule_dtype_upcast(graph, report)
    _rule_weak_scalar(graph, report)
    _rule_kernel_sites(graph, report)
    _rule_host_sync(graph, report)
    _rule_collectives(graph, report)
    _rule_quant_dequant_upcast(graph, report)
    return report


# ============================================================ comm rules
def run_comm_rules(params, strategy: Optional[str],
                   grad_compress: Optional[str] = None,
                   report: Optional[Report] = None) -> Report:
    """Gradient-communication rules over one run configuration: the f32
    bytes the gradient all-reduce would move, from the param tree (real,
    meta or fake leaves), the strategy and ``--gradCompress``."""
    report = report if report is not None else Report()
    if strategy not in ("dp", "tp", "sp"):
        return report  # pp/ep own their comm structure; one device has
        # no grad wire
    compress = grad_compress or "off"
    from bigdl_tpu_torch.parallel.grad_comm import (DEFAULT_BUCKET_BYTES,
                                                    build_bucket_plan)
    plan = build_bucket_plan(params, DEFAULT_BUCKET_BYTES)
    if compress == "off":
        big = [b for b in plan.buckets if b.nbytes >= COMM_F32_MIN_BYTES]
        if big:
            total = sum(b.nbytes for b in plan.buckets)
            report.add(_finding(
                "comm-f32-allreduce",
                f"--strategy {strategy} all-reduces "
                f"{total / 2**20:.1f} MiB of gradient in f32 "
                f"({len(big)} bucket(s) >= "
                f"{COMM_F32_MIN_BYTES / 2**20:.0f} MiB) with "
                "compression off",
                where=f"grad tree: {plan.n_leaves} leaves, "
                      f"{len(plan.buckets)} bucket(s)",
                hint="--gradCompress bf16 halves the wire bytes "
                     "(bf16+ec keeps optimizer math exactly f32)",
                detail={"bytes_f32": total,
                        "big_buckets": len(big),
                        "n_leaves": plan.n_leaves}))
        n_inexact = plan.n_leaves - len(plan.passthrough)
        if n_inexact > COMM_MAX_COLLECTIVES:
            report.add(_finding(
                "comm-unbucketed",
                f"{n_inexact} gradient leaves reduce without bucketing "
                f"(threshold {COMM_MAX_COLLECTIVES}) — per-leaf "
                "collectives pay launch latency per parameter",
                where=f"grad tree: {plan.n_leaves} leaves",
                hint="--gradCompress bf16 packs them into "
                     f"{len(plan.buckets)} dense bucket(s)",
                detail={"n_leaves": n_inexact,
                        "n_buckets": len(plan.buckets)}))
    return report


# ========================================================= memory rules
def run_memory_rules(plan: Optional[dict],
                     report: Optional[Report] = None) -> Report:
    """HBM working-set rules over one memory plan (an
    :func:`bigdl_tpu_torch.obs.memory.build_plan` dict, built from the
    step's abstract trees): **error** when the plan's total exceeds the
    device's memory (the card's ``total_memory``; off the card the CPU
    nominal), **warning** above ``HBM_WARN_FRAC`` of it. ``plan=None``
    adds nothing."""
    report = report if report is not None else Report()
    if not plan:
        return report
    total = int(plan.get("total_bytes") or 0)
    hbm = int(plan.get("hbm_bytes") or 0)
    if not total or not hbm:
        return report
    frac = total / hbm
    cats = plan.get("categories") or {}
    top = sorted(cats.items(), key=lambda kv: -kv[1])[:3]
    top_s = ", ".join(f"{k} {v / 2**20:.0f} MiB" for k, v in top)
    where_s = (f"{plan.get('model') or 'step'} b={plan.get('batch')} on "
               f"{plan.get('device') or 'device'}")
    if frac > 1.0:
        report.add(_finding(
            "hbm-oversubscribed",
            f"step working set {total / 2**30:.2f} GiB exceeds device "
            f"HBM {hbm / 2**30:.1f} GiB ({frac * 100:.0f}%) — top: "
            f"{top_s}",
            where=where_s,
            hint="shrink the batch (python -m bigdl_tpu_torch.cli.main "
                 "explain --mem predicts the max that fits), drop "
                 "momentum state, or shard the model (--strategy tp)",
            detail={"total_bytes": total, "hbm_bytes": hbm,
                    "frac": round(frac, 4),
                    "categories": dict(cats)}))
    elif frac > HBM_WARN_FRAC:
        report.add(_finding(
            "hbm-tight",
            f"step working set {total / 2**30:.2f} GiB is "
            f"{frac * 100:.0f}% of device HBM {hbm / 2**30:.1f} GiB "
            f"(threshold {HBM_WARN_FRAC * 100:.0f}%) — top: {top_s}",
            where=where_s,
            hint="headroom this thin fails on fragmentation; explain "
                 "--mem forecasts the fit per batch",
            detail={"total_bytes": total, "hbm_bytes": hbm,
                    "frac": round(frac, 4)}))
    return report


# ========================================================== module rules
def _mod_label(m) -> str:
    n = getattr(m, "name", None)
    cls = type(m).__name__
    return f"{cls}({n})" if isinstance(n, str) and n and n != cls else cls


def _ceil_grid(n: int) -> int:
    return -(-int(n) // MMA_WIDTH) * MMA_WIDTH


def _bn_kernel_ok(m) -> bool:
    """A BN site the port's kernels take: every shape does; the
    configuration must be the kernels' (affine, no axis, all rows)."""
    return bool(m.affine and m.axis_name is None and not m.stat_sample)


def _rule_bn(model, report: Report) -> None:
    from bigdl_tpu_torch.nn.norm import BatchNormalization

    unfused = []
    for m in model.modules():
        if not isinstance(m, BatchNormalization) or not _bn_kernel_ok(m):
            continue
        c = int(m.n_output)
        if m.fused != "apply":
            mode = m.fused or "off"
            unfused.append((f"{_mod_label(m)} C={c} fused={mode}", c))
    if unfused:
        report.add(_finding(
            "fusion-bn-unfused",
            f"{len(unfused)} BatchNormalization site(s) eligible for "
            "the fused apply block are running "
            f"{'/'.join(sorted({s.rsplit('=', 1)[-1] for s, _ in unfused}))}"
            " — the measured-regression config",
            where=_sites_of([s for s, _ in unfused]),
            hint="--fusedBN apply (CLI) / set_bn_fused(model, 'apply')",
            detail={"count": len(unfused),
                    "channels": sorted({c for _, c in unfused})}))


def _conv_geom_args(m) -> tuple:
    """(kh, kw, stride, padding, dilation, groups, cin, cout) of one
    SpatialConvolution-family module."""
    dil = (int(getattr(m, "dilation_h", 1)), int(getattr(m, "dilation_w", 1)))
    return (int(m.kernel_h), int(m.kernel_w),
            (int(m.stride_h), int(m.stride_w)),
            ((int(m.pad_h), int(m.pad_h)), (int(m.pad_w), int(m.pad_w))),
            dil, int(m.n_group),
            int(m.n_input_plane), int(m.n_output_plane))


def _rule_conv_gemm(model, report: Report, dtype="bfloat16") -> None:
    from bigdl_tpu_torch.nn.conv import SpatialConvolution
    from bigdl_tpu_torch.ops.conv2d import gemm_eligible, resolve_site_layouts

    hits = []
    for m in model.modules():
        if not isinstance(m, SpatialConvolution):
            continue
        kh, kw, stride, pad, dil, groups, cin, cout = _conv_geom_args(m)
        if not gemm_eligible(kh, kw, stride, pad, dil, groups):
            continue
        lays = resolve_site_layouts(kh, kw, stride, pad, dil, groups,
                                    cin, cout, dtype)
        spatial = [p for p, l in lays.items() if l != "GEMM"]
        if spatial:
            hits.append(f"{_mod_label(m)} {cin}->{cout} "
                        f"passes={','.join(spatial)}")
    if hits:
        report.add(_finding(
            "fusion-conv-gemm",
            f"{len(hits)} GEMM-eligible 1x1/s1 conv site(s) resolve to "
            "a spatial layout — the matmul spelling (~half of "
            "ResNet-50's FLOPs live in these sites) is not engaged",
            where=_sites_of(hits),
            hint="--convLayout with GEMM per pass, a --convGeom decision "
                 "file, or --autotune measure on the card",
            detail={"count": len(hits)}))


def _rule_channels(model, report: Report) -> None:
    from bigdl_tpu_torch.nn.conv import SpatialConvolution
    from bigdl_tpu_torch.nn.linear import Linear
    from bigdl_tpu_torch.utils.flops import conv_unit_flops

    hits = []
    for m in model.modules():
        if isinstance(m, SpatialConvolution):
            kh, kw, _, _, _, groups, cin, cout = _conv_geom_args(m)
        elif isinstance(m, Linear):
            kh = kw = groups = 1
            cin, cout = int(m.in_features), int(m.out_features)
        else:
            continue
        if cin % MMA_WIDTH == 0 and cout % MMA_WIDTH == 0:
            continue
        real = conv_unit_flops(1, 1, 1, cin, cout, kh, kw, groups)
        padded = conv_unit_flops(1, 1, 1, _ceil_grid(cin), _ceil_grid(cout),
                                 kh, kw, groups)
        waste = 1.0 - real / padded
        hits.append((waste, f"{_mod_label(m)} {cin}->{cout} "
                            f"(~{waste * 100:.0f}% padded wgmma tiles)"))
    if hits:
        hits.sort(key=lambda h: -h[0])
        report.add(_finding(
            "layout-c128",
            f"{len(hits)} layer(s) with feature dims off the tensor "
            f"cores' {MMA_WIDTH}-wide grid; worst: {hits[0][1]}",
            where=_sites_of([s for _, s in hits]),
            hint="edge layers (stems, heads) are usually unavoidable; "
                 f"interior widths should stay on multiples of "
                 f"{MMA_WIDTH}",
            detail={"count": len(hits),
                    "worst_waste": round(hits[0][0], 3)}))


def _rule_attention(model, report: Report, seq: Optional[int],
                    dtype="bfloat16") -> None:
    from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                              dot_product_attention)

    dense, headdims = [], {}
    for m in model.modules():
        if not isinstance(m, MultiHeadAttention):
            continue
        hd = int(m.head_dim)
        if str(dtype).replace("torch.", "") == "bfloat16" \
                and hd not in (64, 128):
            headdims[hd] = headdims.get(hd, 0) + 1
        if m.attn_fn is dot_product_attention:
            dense.append(_mod_label(m))
    if dense:
        report.add(_finding(
            "fusion-attn-dense",
            f"{len(dense)} attention site(s) on the dense PyTorch path",
            where=_sites_of(dense),
            hint="attn_impl='flash' (the perf zoo's LM rows use it)",
            detail={"count": len(dense)}))
    if headdims:
        report.add(_finding(
            "layout-headdim",
            "attention head_dim in "
            f"{sorted(headdims)} leaves the wgmma flash kernels "
            "(flash_fwd_sm90) for mma.sync",
            where=f"{sum(headdims.values())} attention site(s)",
            hint="same d_model with 64- or 128-wide heads "
                 "(e.g. transformer_lm_1k_hd128)",
            detail={"head_dims": sorted(headdims)}))


def run_module_rules(model, report: Optional[Report] = None, *,
                     seq: Optional[int] = None,
                     dtype="bfloat16") -> Report:
    """All configuration-level rules over one model tree. ``seq`` is the
    traced sequence length when known (the port's attention tile checks
    read traced kernel sites instead); ``dtype`` keys the conv-geometry
    resolution and the head-dim rule."""
    report = report if report is not None else Report()
    _rule_bn(model, report)
    _rule_conv_gemm(model, report, dtype=dtype)
    _rule_channels(model, report)
    _rule_attention(model, report, seq, dtype=dtype)
    return report


# shardlint shares this catalog: merge its rule family in so the CLI's
# rule listing and report grouping see one registry
from bigdl_tpu_torch.analysis.sharding_rules import \
    SHARD_CATALOG as _SHARD_CATALOG  # noqa: E402

CATALOG.update(_SHARD_CATALOG)
