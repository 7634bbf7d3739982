"""Per-shape autotuner (counterpart of ``bigdl_tpu/tuning/autotune.py``).

A measured, cached decision per (op, shape, dtype, device kind) over the
degrees of freedom the port leaves open: the key block
``flash_attention`` hands ``blockwise_attention``, the slab height of the
BN kernels' launch plan, the conv passes' layouts, the KV page size, the
gradient bucket bound and the quantized product's kind.

Three modes, process-global as in the JAX package:

* ``off`` (default): every surface returns the caller's untuned choice.
* ``cached``: read-only; a persisted decision where there is one, the
  default otherwise. Never measures, never writes.
* ``measure``: on a miss (or a ``dry`` entry, once a card is present)
  time the candidates on the card and persist the winner.

Dry mode: where torch sees no card (:func:`dry_run`), ``measure``
records the defaults without timing, so the CPU pipeline round-trips and
its files are byte-identical to the JAX package's for the namespaces
whose candidate rules agree (``grad_comm``, ``kv_pages``, ``quant``,
``conv_geom``, ``conv_layouts``).

Every consulted key is recorded, and :func:`annotation` gives the perf
JSON line the decisions it ran under. Keys, entry schema and the
resolution ladder are the JAX package's. Where the port's knobs differ:

* ``flash``: the CUDA kernels have one compiled tiling, so a decision's
  ``block_q`` is recorded (the default's) and not used; its ``block_k``
  is the key block of the key-padding path (``ops.attention_kernel.
  flash_block_k``). Candidates vary ``block_k`` only.
* ``bn_stats``/``bn_fba``: ``row_block`` is the slab height of
  ``ops.bn_kernel._plan`` (the rows a CTA covers). Candidates are the
  heights at which every CTA of the cooperative launch stays resident,
  ``blocks * slabs <= ctas``, for each kernel that shares the key; the
  default is the untuned plan, which a miss under ``cached`` keeps.
* ``quant``: ``native-int8`` is a candidate only at shapes
  ``torch._int_mm`` takes on the card (more than 16 rows; rows, k and n
  multiples of 8); elsewhere, and for a cached kind that cannot run
  there, the product is ``dequant``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from bigdl_tpu_torch.tuning.cache import AutotuneCache

__all__ = ["MODES", "set_mode", "get_mode", "dry_run", "make_key",
           "flash_blocks", "bn_row_block", "fba_row_block",
           "grad_bucket_bytes", "kv_page_tokens", "quant_matmul_kind",
           "install_conv_layouts", "conv_geom_layout", "conv_geom_key",
           "peek_geom_layout", "put_geom_decisions",
           "annotation", "reset", "reset_decisions", "get_cache",
           "int_mm_ok"]

MODES = ("off", "cached", "measure")

_MODE = "off"
# consulted keys for the result line's provenance: key -> {"source", ...}
_DECISIONS: Dict[str, dict] = {}
_CACHE: Optional[AutotuneCache] = None

# the JAX package's flash tilings; the port sweeps them as block_k
FLASH_TILINGS = (128, 256, 512, 1024)

# dense-bucket byte bounds around the 4 MiB default
GRAD_BUCKET_BYTES = tuple(m * 2 ** 20 for m in (1, 2, 4, 8, 16))

# the quantized product's spellings: dequant-fused (default) or an int8
# x int8 product with int32 accumulation and per-row activation scales
QUANT_MATMUL_KINDS = ("dequant", "native-int8")

# KV page sizes swept for the paged decode cache; 128 is the default
# where it divides max_len
KV_PAGE_TOKENS = (32, 64, 128, 256)

CONV_VARIANTS = ("plain", "inner", "s2d")

# per-geometry conv layout candidates: both activation layouts, and GEMM
# where the site is exactly a product (1x1, stride 1, unpadded, ungrouped)
CONV_GEOM_LAYOUTS = ("NHWC", "NCHW", "GEMM")


def set_mode(mode: str) -> str:
    """Install the process-global autotune mode (CLI ``--autotune``)."""
    global _MODE
    if mode not in MODES:
        raise ValueError(f"autotune mode must be one of {MODES}, "
                         f"got {mode!r}")
    _MODE = mode
    return _MODE


def get_mode() -> str:
    return _MODE


def dry_run() -> bool:
    """True where torch sees no card: a CPU timing says nothing about the
    card, so ``measure`` records the defaults instead."""
    try:
        import torch
        return not torch.cuda.is_available()
    except Exception:
        return True


def reset() -> None:
    """Back to a pristine state (tests): mode off, ledger and in-memory
    cache dropped (the file on disk is untouched)."""
    global _MODE, _CACHE
    _MODE = "off"
    _DECISIONS.clear()
    _CACHE = None


def reset_decisions() -> None:
    """Clear the consulted-key ledger only: each perf run annotates the
    decisions it consulted, not the process's history."""
    _DECISIONS.clear()


def get_cache() -> AutotuneCache:
    global _CACHE
    if _CACHE is None:
        _CACHE = AutotuneCache()
    return _CACHE


def make_key(op: str, **facets) -> str:
    """Canonical cache key: op name + sorted facet pairs."""
    return "|".join([op] + [f"{k}={facets[k]}" for k in sorted(facets)])


def _dtype_name(dtype) -> str:
    """The JAX package's dtype spelling ("float32", "bfloat16") for a
    torch dtype, a numpy dtype or a string."""
    s = str(dtype)
    if s.startswith("torch."):
        return s[len("torch."):]
    import numpy as np
    try:
        return np.dtype(dtype).name
    except TypeError:
        return s


def _record(key: str, config: Optional[dict], source: str) -> None:
    ent = {"source": source}
    if config:
        ent["config"] = dict(config)
    _DECISIONS[key] = ent


def annotation() -> Optional[dict]:
    """The run's tuning provenance for perf JSON lines: None under
    ``off``; otherwise the mode and, per consulted key, the decision's
    config (with its source) or the string "default"."""
    if _MODE == "off":
        return None
    decisions = {}
    for k, v in sorted(_DECISIONS.items()):
        if v.get("config"):
            decisions[k] = dict(v["config"], source=v["source"])
        else:
            decisions[k] = "default"
    return {"mode": _MODE, "decisions": decisions}


def _stale(ent: dict) -> bool:
    """A dry placeholder that ``measure`` re-measures once a card is
    present."""
    return (_MODE == "measure" and ent.get("source") == "dry"
            and not dry_run())


def _measure_entry(measure_fn) -> dict:
    import torch
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("autotune measure: a decision was first asked "
                           "for inside a CUDA graph capture; run the "
                           "program once eagerly before capturing it")
    config, best_ms = measure_fn()
    return {"config": dict(config), "source": "measured",
            "best_ms": round(best_ms, 4)}


def _resolve(key: str, default_config: dict, measure_fn) -> Tuple[dict, str]:
    """The resolution ladder: cache hit -> cached decision; cached-mode
    miss -> default; measure-mode miss (or a dry placeholder once a card
    is present) -> measure and persist. Returns (config, source)."""
    if _MODE == "off":
        return dict(default_config), "off"
    cache = get_cache()
    ent = cache.get(key)
    if ent is not None and not _stale(ent):
        _record(key, ent.get("config"), "cached")
        return dict(ent["config"]), "cached"
    if _MODE == "cached":
        _record(key, None, "default")
        return dict(default_config), "default"
    if dry_run():
        ent = {"config": dict(default_config), "source": "dry"}
    else:
        ent = _measure_entry(measure_fn)
    cache.put(key, ent)
    cache.save()
    _record(key, ent["config"], ent["source"])
    return dict(ent["config"]), ent["source"]


# --------------------------------------------------------------- surfaces
def flash_blocks(s_q: int, s_k: int, d: int, causal: bool,
                 dtype) -> Optional[Tuple[int, int]]:
    """Tuned (block_q, block_k) for one attention shape, or None when the
    mode is off or the shape admits no standard tiling (the caller keeps
    its untuned rule). Only ``block_k`` is swept and used."""
    if _MODE == "off":
        return None
    from bigdl_tpu_torch.utils.flops import DEFAULT_BLOCK, clamp_block

    cand_q = [b for b in FLASH_TILINGS if b <= s_q and s_q % b == 0]
    cand_k = [b for b in FLASH_TILINGS if b <= s_k and s_k % b == 0]
    if not cand_q or not cand_k:
        return None
    key = make_key("flash", seq_q=s_q, seq_k=s_k, head_dim=d,
                   causal=int(bool(causal)), dtype=_dtype_name(dtype))
    default = {"block_q": clamp_block(DEFAULT_BLOCK, s_q),
               "block_k": clamp_block(DEFAULT_BLOCK, s_k)}
    pairs = [(default["block_q"], bk) for bk in cand_k]

    def _measure():
        from bigdl_tpu_torch.tuning.measure import measure_flash_blocks
        return measure_flash_blocks(s_q, s_k, d, causal, dtype, pairs)

    config, _ = _resolve(key, default, _measure)
    return int(config["block_q"]), int(config["block_k"])


def _slab(key: str, heights: Sequence[int], measure_fn) -> Optional[int]:
    """The BN surfaces' ladder over slab heights (``heights[0]`` the
    untuned plan's): None (the untuned plan) when off, on a cached-mode
    miss or for a cached height that is not a candidate here."""
    if _MODE == "off" or not heights:
        return None
    config, source = _resolve(key, {"row_block": int(heights[0])},
                              measure_fn)
    h = config.get("row_block")
    if source == "default" or h not in heights:
        return None
    return int(h)


def bn_row_block(rows: int, c: int, dtype,
                 heights: Sequence[int] = ()) -> Optional[int]:
    """Tuned slab height of the stats kernels (``bn_stats`` and
    ``bn_bwd_stats``, which share the key) at (rows, C), or None for
    the untuned plan. ``heights``: the legal heights, the untuned first
    (``ops.bn_kernel.slab_heights``)."""
    key = make_key("bn_stats", rows=rows, channels=c,
                   dtype=_dtype_name(dtype))

    def _measure():
        from bigdl_tpu_torch.tuning.measure import measure_bn_row_block
        return measure_bn_row_block(rows, c, dtype, heights)

    return _slab(key, heights, _measure)


def fba_row_block(rows: int, c: int, dtype, relu: bool = False,
                  heights: Sequence[int] = ()) -> Optional[int]:
    """Tuned slab height of the fused block (``bn_fwd_apply`` and
    ``bn_bwd_fused``), keyed apart from the stats pair and by ``relu``;
    None for the untuned plan."""
    key = make_key("bn_fba", rows=rows, channels=c,
                   dtype=_dtype_name(dtype), relu=int(bool(relu)))

    def _measure():
        from bigdl_tpu_torch.tuning.measure import measure_fba_row_block
        return measure_fba_row_block(rows, c, dtype, relu, heights)

    return _slab(key, heights, _measure)


def grad_bucket_bytes(param_bytes: int, n_devices: int,
                      dtype) -> Optional[int]:
    """Tuned dense-bucket byte bound of the gradient all-reduce, or None
    when the mode is off (the caller keeps the 4 MiB default). Keyed per
    (param MiB rounded up, device count, wire dtype)."""
    if _MODE == "off":
        return None
    param_mib = max(1, -(-int(param_bytes) // 2 ** 20))
    key = make_key("grad_comm", param_mib=param_mib, n_devices=n_devices,
                   dtype=_dtype_name(dtype))
    cands = [b for b in GRAD_BUCKET_BYTES if b <= param_bytes] or \
        [GRAD_BUCKET_BYTES[0]]
    from bigdl_tpu_torch.parallel.grad_comm import DEFAULT_BUCKET_BYTES
    default_b = DEFAULT_BUCKET_BYTES
    if default_b not in cands:  # small trees: the largest candidate
        default_b = cands[-1]
    default = {"bucket_bytes": default_b}

    def _measure():
        from bigdl_tpu_torch.tuning.measure import measure_grad_buckets
        return measure_grad_buckets(param_bytes, n_devices, dtype, cands)

    config, _ = _resolve(key, default, _measure)
    return int(config["bucket_bytes"])


def kv_page_tokens(max_len: int, kv_heads: int, head_dim: int,
                   dtype) -> Optional[int]:
    """Tuned KV page size in tokens, or None when the mode is off (the
    caller keeps its ladder) or no candidate divides ``max_len``."""
    if _MODE == "off":
        return None
    cands = [c for c in KV_PAGE_TOKENS
             if c <= max_len and max_len % c == 0]
    if not cands:
        return None
    key = make_key("kv_pages", max_len=max_len, kv_heads=kv_heads,
                   head_dim=head_dim, dtype=_dtype_name(dtype))
    default = {"page_tokens": 128 if 128 in cands else cands[-1]}

    def _measure():
        from bigdl_tpu_torch.tuning.measure import measure_kv_page_tokens
        return measure_kv_page_tokens(max_len, kv_heads, head_dim, dtype,
                                      cands)

    config, _ = _resolve(key, default, _measure)
    return int(config["page_tokens"])


def int_mm_ok(rows: int, k: int, n: int) -> bool:
    """Whether ``torch._int_mm`` takes a (rows, k) x (k, n) product on the
    card: more than 16 rows (torch's check), and rows, k and n multiples
    of 8 (cuBLASLt refused 17 rows of a 64 x 40 product on an H100 with
    CUBLAS_STATUS_NOT_SUPPORTED)."""
    return (rows > 16 and rows % 8 == 0 and k > 0 and k % 8 == 0
            and n > 0 and n % 8 == 0)


def quant_matmul_kind(m: int, k: int, n: int, dtype,
                      rows: Optional[int] = None) -> str:
    """Tuned quantized-product kind for one (m, k, n, dtype) shape:
    ``"dequant"`` or ``"native-int8"``. ``m`` is the key's (the
    activation's second-to-last axis, as the JAX package keys it);
    ``rows`` the product's flattened row count (default ``m``), which
    decides whether ``native-int8`` can run. Off mode keeps dequant."""
    if _MODE == "off":
        return "dequant"
    rows = int(m) if rows is None else int(rows)
    native_ok = int_mm_ok(rows, int(k), int(n))
    key = make_key("quant", m=int(m), k=int(k), n=int(n),
                   dtype=_dtype_name(dtype))
    default = {"kind": "dequant"}

    def _measure():
        from bigdl_tpu_torch.tuning.measure import measure_quant_matmul
        return measure_quant_matmul(rows, int(k), int(n), dtype, native_ok)

    config, _ = _resolve(key, default, _measure)
    kind = str(config.get("kind", "dequant"))
    if kind == "native-int8" and not native_ok:
        return "dequant"
    return kind if kind in QUANT_MATMUL_KINDS else "dequant"


def conv_geom_key(pass_name: str, geom: tuple) -> str:
    """The ``conv_geom`` key of one (geometry, pass): geom is
    ``ops.conv2d``'s 10-tuple (kh, kw, sh, sw, cin, cout, groups, dh, dw,
    dtype)."""
    kh, kw, sh, sw, cin, cout, groups, dh, dw, dtype = geom
    return make_key("conv_geom", kh=kh, kw=kw, stride=f"{sh}x{sw}",
                    cin=cin, cout=cout, groups=groups, dil=f"{dh}x{dw}",
                    dtype=dtype, **{"pass": pass_name})


def _usable_layout(ent, gemm_ok: bool) -> Optional[str]:
    lay = ((ent.get("config") or {}).get("layout")
           if isinstance(ent, dict) else None)
    if lay in CONV_GEOM_LAYOUTS and (lay != "GEMM" or gemm_ok):
        return lay
    return None


def conv_geom_layout(pass_name: str, geom: tuple, x_shape: tuple,
                     gemm_ok: bool) -> Optional[str]:
    """Tuned layout of one conv geometry and pass, or None: the caller
    then takes the global triple (a cached-mode miss means "the global
    policy", not NHWC). ``measure`` times the pass at the activation
    shape ``x_shape`` (not in the key: the first shape of a geometry
    decides); dry runs record NHWC."""
    if _MODE == "off":
        return None
    key = conv_geom_key(pass_name, geom)
    cache = get_cache()
    ent = cache.get(key)
    if ent is not None and not _stale(ent):
        lay = _usable_layout(ent, gemm_ok)
        if lay is not None:
            _record(key, ent.get("config"), "cached")
            return lay
        # an entry this site cannot use (a GEMM decision at an ineligible
        # site, a hand edit): a miss
    if _MODE == "cached":
        _record(key, None, "default")
        return None
    if dry_run():
        ent = {"config": {"layout": "NHWC"}, "source": "dry"}
    else:
        cands = [lay for lay in CONV_GEOM_LAYOUTS
                 if lay != "GEMM" or gemm_ok]

        def _measure():
            from bigdl_tpu_torch.tuning.measure import measure_conv_geom
            return measure_conv_geom(pass_name, geom, x_shape, cands)

        ent = _measure_entry(_measure)
    cache.put(key, ent)
    cache.save()
    _record(key, ent["config"], ent["source"])
    return ent["config"]["layout"]


def peek_geom_layout(pass_name: str, geom: tuple,
                     gemm_ok: bool) -> Optional[str]:
    """Read-only ``conv_geom`` lookup: the cached, usable decision or
    None. Never measures, writes or records."""
    if _MODE == "off":
        return None
    return _usable_layout(get_cache().get(conv_geom_key(pass_name, geom)),
                          gemm_ok)


def put_geom_decisions(decisions, cache=None) -> int:
    """Write per-geometry decisions (``tools/conv_probe.py --geom`` JSON)
    into the cache under ``conv_geom`` keys with source "probe", so
    ``--autotune cached`` replays them. Returns the (geometry, pass)
    entries written."""
    from bigdl_tpu_torch.ops.conv2d import geom_from_json
    cache = cache or get_cache()
    n = 0
    for d in decisions:
        geom = geom_from_json(d.get("geom", {}))
        for p, lay in sorted((d.get("layouts") or {}).items()):
            if lay not in CONV_GEOM_LAYOUTS:
                raise ValueError(f"bad layout {lay!r} in decision {d!r}")
            cache.put(conv_geom_key(p, geom),
                      {"config": {"layout": lay}, "source": "probe"})
            n += 1
    cache.save()
    return n


def install_conv_layouts(variant: str = "plain", device=None
                         ) -> Dict[str, str]:
    """Resolve and install the global per-pass conv layout triple for one
    run configuration (``variant``: plain, inner or s2d, each its own
    key). Off mode keeps the untuned ladder (``ops.conv2d.
    maybe_install_auto``); an explicit ``--convLayout`` wins in every
    mode."""
    if variant not in CONV_VARIANTS:
        raise ValueError(f"conv variant must be one of {CONV_VARIANTS}, "
                         f"got {variant!r}")
    from bigdl_tpu_torch.ops import conv2d

    guarded = variant != "plain"
    if _MODE == "off":
        return conv2d.maybe_install_auto(device, guarded=guarded)
    default = (dict(conv2d._DEFAULT) if guarded
               else conv2d.resolve_layout_spec("auto", device))
    key = make_key("conv_layouts", variant=variant)

    def _measure():
        import torch

        from bigdl_tpu_torch.tuning.measure import measure_conv_layouts
        return measure_conv_layouts(torch.bfloat16)

    config, _ = _resolve(key, default, _measure)
    config = {p: config.get(p, "NHWC") for p in ("fwd", "dgrad", "wgrad")}
    return conv2d.maybe_install_auto(device, policy=config)
