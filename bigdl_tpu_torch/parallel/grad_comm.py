"""Bucketed, optionally 16-bit gradient all-reduce (counterpart of
``bigdl_tpu/parallel/grad_comm.py``; reference
parameters/FP16CompressedTensor.scala and AllReduceParameter.scala).

* **Buckets.** The gradients flatten into size-bounded dense 1-D buckets
  whose layout is a pure function of the leaf order, shapes and the byte
  bound (:func:`build_bucket_plan`): the JAX package's rules over the JAX
  flatten order of the parameter names (each dict's keys sorted as
  strings at every level, the order the port's checkpoints use), so both
  packages put the same leaves in the same buckets. A conv weight has a
  torch layout here and an HWIO one in JAX: its element count is the
  same, its shape is not, so plans agree by membership, counts and bytes,
  not by ``signature``.
* **The reduce.** Each bucket is one ``dist.all_reduce`` over the data
  axis's group, all issued before any is waited on; the f32 sum is
  divided by the world size (the mean of the ranks' gradients, each the
  mean over its part of the batch).
* **Wire compression** (``--gradCompress``). A rank divides its bucket
  by the world size, casts it to bf16 (or clamps it to ±65504 and casts
  to fp16: a rank's share can then not overflow the half sum), and the
  all-reduce sums the 16-bit values: half the bytes on the wire. Stated
  difference: the JAX compression is an annotation on an already global
  gradient, so its ``bf16`` rounds the global sum once and its ``+ec``
  gives the exact f32 step. Here each rank's share is rounded before the
  sum, and ``+ec`` is error feedback: the rounding residual a rank left
  out of this step's wire is added to its next step's bucket, so nothing
  is lost over steps, but a step's gradient is not the f32 one.

``--gradBuckets auto`` asks the tuner's ``grad_comm`` namespace first
(``--autotune cached|measure``; ``bucket_source`` "autotune", the JAX
package's word), else takes :data:`DEFAULT_BUCKET_BYTES` (``bucket_source``
"default").
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["COMPRESS_MODES", "DEFAULT_BUCKET_BYTES", "GradCommConfig",
           "parse_compress_spec", "make_config", "BucketPlan",
           "build_bucket_plan", "plan_wire_bytes", "apply_grad_comm",
           "compress_bucket", "decompress_bucket", "compressed_psum",
           "jax_order"]

COMPRESS_MODES = ("off", "bf16", "fp16", "bf16+ec", "fp16+ec")

# the default dense-bucket byte bound (the JAX package's, before its
# autotuner decides)
DEFAULT_BUCKET_BYTES = 4 * 2 ** 20

_F16_MAX = 65504.0  # largest finite float16


@dataclass(frozen=True)
class GradCommConfig:
    """One run's gradient-communication configuration (the parsed
    ``--gradCompress``/``--gradBuckets`` pair). ``bucket_bytes`` None
    means "auto": :data:`DEFAULT_BUCKET_BYTES`."""

    compress: str = "off"
    bucket_bytes: Optional[int] = None

    @property
    def active(self) -> bool:
        return self.compress != "off"

    @property
    def wire_dtype(self) -> Optional[str]:
        if not self.active:
            return None
        return "bfloat16" if self.compress.startswith("bf16") else "float16"

    @property
    def error_comp(self) -> bool:
        return self.compress.endswith("+ec")


def parse_compress_spec(spec: Optional[str]) -> str:
    """Validate one ``--gradCompress`` spelling -> canonical mode string
    (ValueError on junk; the CLI wraps it in SystemExit)."""
    mode = (spec or "off").strip().lower()
    if mode not in COMPRESS_MODES:
        raise ValueError(
            f"gradCompress must be one of {list(COMPRESS_MODES)}, "
            f"got {spec!r}")
    return mode


def make_config(compress: Optional[str] = None,
                buckets=None) -> Optional[GradCommConfig]:
    """``(--gradCompress, --gradBuckets)`` -> config (None when the whole
    surface is off). ``buckets`` is 'auto'/None or an integer MiB bound
    (ValueError on junk)."""
    mode = parse_compress_spec(compress)
    bucket_bytes = None
    if buckets is not None and str(buckets).strip().lower() != "auto":
        try:
            mib = int(str(buckets).strip())
        except ValueError:
            raise ValueError(
                f"gradBuckets must be 'auto' or an integer MiB bound, "
                f"got {buckets!r}")
        if mib < 1:
            raise ValueError(f"gradBuckets must be >= 1 MiB, got {mib}")
        bucket_bytes = mib * 2 ** 20
    if mode == "off" and bucket_bytes is None:
        return None
    return GradCommConfig(compress=mode, bucket_bytes=bucket_bytes)


# ------------------------------------------------------------ bucket plan
def _flatten(tree, prefix=()) -> List[Tuple[tuple, str, object]]:
    """[(JAX key path, dotted name, leaf)] of a dict tree, a dotted key
    opening into its parts, in the JAX flatten order."""
    out = []
    for k, v in tree.items():
        path = prefix + tuple(str(k).split("."))
        if isinstance(v, dict):
            out += _flatten(v, path)
        else:
            out.append((path, ".".join(path), v))
    return sorted(out, key=lambda e: e[0])


def jax_order(names) -> List[str]:
    """Parameter names in the JAX flatten order of their trees."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


@dataclass(frozen=True)
class _BucketSpec:
    """One dense bucket: which flat-tree leaves it packs, in order."""
    leaf_ids: Tuple[int, ...]
    shapes: Tuple[tuple, ...]
    sizes: Tuple[int, ...]       # element counts, leaf order
    nbytes: int                  # f32 bytes of the packed bucket


@dataclass(frozen=True)
class BucketPlan:
    """Deterministic bucket layout for one gradient tree; ``names`` are
    the leaves' dotted names in flatten order (``leaf_ids`` index them).
    ``signature`` hashes (leaf order, shapes, dtypes, byte bound): two
    plans of the port agree iff their signatures agree."""
    buckets: Tuple[_BucketSpec, ...]
    passthrough: Tuple[int, ...]  # non-float leaves, left untouched
    n_leaves: int
    bucket_bytes: int
    total_bytes: int              # f32 bytes across all bucketed leaves
    signature: str
    names: Tuple[str, ...] = ()


_PLAN_CACHE: Dict[tuple, BucketPlan] = {}


def build_bucket_plan(tree, bucket_bytes: int) -> BucketPlan:
    """Flatten ``tree`` ({name: tensor}, nested or dotted) into
    size-bounded dense buckets, by the JAX rules: leaves pack in flatten
    order; a bucket closes when the next leaf would push it past
    ``bucket_bytes``, and once it reaches the bound; a leaf over the bound
    gets a bucket of its own, never split; non-float leaves bypass
    bucketing. Cached per (names, shapes, dtypes, bound)."""
    flat = _flatten(tree)
    names = tuple(n for _, n, _ in flat)
    shapes = tuple(tuple(getattr(l, "shape", ())) for _, _, l in flat)
    dtypes = tuple(str(getattr(l, "dtype", torch.float32)).replace(
        "torch.", "") for _, _, l in flat)
    key = (names, shapes, dtypes, int(bucket_bytes))
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        return cached

    buckets: List[_BucketSpec] = []
    passthrough: List[int] = []
    cur: List[int] = []
    cur_bytes = 0

    def close():
        nonlocal cur, cur_bytes
        if cur:
            buckets.append(_BucketSpec(
                tuple(cur), tuple(shapes[i] for i in cur),
                tuple(_numel(shapes[i]) for i in cur), cur_bytes))
        cur, cur_bytes = [], 0

    total = 0
    for i, dt in enumerate(dtypes):
        if not dt.startswith(("float", "bfloat", "complex")):
            passthrough.append(i)
            continue
        nbytes = _numel(shapes[i]) * 4  # buckets pack in f32
        total += nbytes
        if cur_bytes and cur_bytes + nbytes > bucket_bytes:
            close()
        cur.append(i)
        cur_bytes += nbytes
        if cur_bytes >= bucket_bytes:
            close()
    close()

    sig = hashlib.sha256(repr(
        (shapes, dtypes, int(bucket_bytes))).encode()).hexdigest()[:16]
    plan = BucketPlan(buckets=tuple(buckets), passthrough=tuple(passthrough),
                      n_leaves=len(flat), bucket_bytes=int(bucket_bytes),
                      total_bytes=total, signature=sig, names=names)
    _PLAN_CACHE[key] = plan
    return plan


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def plan_wire_bytes(plan: BucketPlan, config: Optional[GradCommConfig]
                    ) -> int:
    """Per-step, per-direction bytes the plan's buckets put on the wire:
    the f32 bytes, or half of them for a 16-bit wire dtype."""
    if config is None or not config.active:
        return plan.total_bytes
    return plan.total_bytes // 2


# ------------------------------------------------------- compress / wire
def compress_bucket(buf, mode: str):
    """f32 bucket -> wire dtype: bf16 is a cast; fp16 clamps to the finite
    half range first (one Inf would poison the whole sum)."""
    if mode.startswith("fp16"):
        return torch.clamp(buf, -_F16_MAX, _F16_MAX).to(torch.float16)
    return buf.to(torch.bfloat16)


def decompress_bucket(cbuf):
    return cbuf.to(torch.float32)


def _group_world(mesh):
    import torch.distributed as dist
    group = getattr(mesh, "group", None)
    if not dist.is_initialized():
        return group, 1
    return group, dist.get_world_size(group)


def compressed_psum(bucket, mesh, axis: str = "data", mode: str = "bf16"):
    """The f32 sum over the ``axis`` of ``mesh`` of this rank's f32
    ``bucket``, reduced on the wire in the 16-bit dtype of ``mode``."""
    if axis not in getattr(mesh, "axis_names", (axis,)):
        raise ValueError(f"mesh has no axis {axis!r}")
    import torch.distributed as dist
    c = compress_bucket(bucket, mode)
    if dist.is_initialized():
        dist.all_reduce(c, group=getattr(mesh, "group", None))
    return decompress_bucket(c)


# ------------------------------------------------------------ the reduce
def _resolve_bucket_bytes(config: Optional[GradCommConfig],
                          param_bytes: int, n_devices: int
                          ) -> Tuple[int, str]:
    """The bucket byte bound and its provenance: an explicit
    ``--gradBuckets N`` wins, else the tuner's ``grad_comm`` decision
    when it is on, else the shipped default."""
    if config is not None and config.bucket_bytes is not None:
        return int(config.bucket_bytes), "explicit"
    from bigdl_tpu_torch.tuning import autotune as _at
    wire = (config.wire_dtype if config is not None else None) or "bfloat16"
    tuned = _at.grad_bucket_bytes(param_bytes, n_devices, wire)
    if tuned is not None:
        return int(tuned), "autotune"
    return DEFAULT_BUCKET_BYTES, "default"


def apply_grad_comm(grads: dict, config: Optional[GradCommConfig], mesh,
                    residuals: Optional[dict] = None):
    """The mean over the ranks of ``mesh`` of ``grads`` ({name: tensor}),
    bucketed per :func:`build_bucket_plan` and compressed per ``config``;
    returns ``(grads, info)`` with new tensors. ``info`` is None unless
    compression is active, else the JAX package's accounting dict
    (``compress``, ``n_buckets``, ``bucket_bytes``, ``bucket_source``,
    ``wire_bytes``, ``wire_bytes_f32``, ``plan_signature``, ``n_devices``).
    ``residuals`` ({bucket index: f32 tensor}) holds this rank's ``+ec``
    rounding residuals between calls. Without a process group (one
    process) the gradients come back as they are."""
    import torch.distributed as dist

    group, world = _group_world(mesh)
    if not dist.is_initialized():
        return dict(grads), None
    param_bytes = sum(t.numel() * 4 for t in grads.values())
    bucket_bytes, source = _resolve_bucket_bytes(config, param_bytes, world)
    plan = build_bucket_plan(grads, bucket_bytes)
    active = config is not None and config.active
    leaves = [grads[n] for n in plan.names]
    out = dict(grads)
    pending = []
    for b, spec in enumerate(plan.buckets):
        buf = torch.cat([leaves[i].reshape(-1).float()
                         for i in spec.leaf_ids])
        if active:
            buf = buf / world
            if config.error_comp and residuals is not None:
                if b in residuals:
                    buf = buf + residuals[b]
            wire = compress_bucket(buf, config.compress)
            if config.error_comp and residuals is not None:
                residuals[b] = buf - decompress_bucket(wire)
        else:
            wire = buf
        pending.append((spec, wire, dist.all_reduce(wire, group=group,
                                                    async_op=True)))
    for spec, wire, work in pending:
        work.wait()
        flat = decompress_bucket(wire) if active else wire / world
        for i, piece in zip(spec.leaf_ids, torch.split(flat,
                                                       list(spec.sizes))):
            out[plan.names[i]] = piece.view(leaves[i].shape).to(
                leaves[i].dtype)
    if not active:
        return out, None
    info = {
        "compress": config.compress,
        "n_buckets": len(plan.buckets),
        "bucket_bytes": plan.bucket_bytes,
        "bucket_source": source,
        "wire_bytes": plan_wire_bytes(plan, config),
        "wire_bytes_f32": plan.total_bytes,
        "plan_signature": plan.signature,
        "n_devices": world,
    }
    return out, info
