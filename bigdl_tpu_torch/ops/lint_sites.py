"""Kernel sites of a lint trace (``bigdl_tpu_torch.analysis``).

The lint traces a step on fake tensors (``FakeTensorMode``: shapes,
dtypes and devices, no data). Handed a fake tensor that is not on the
CPU, a kernel wrapper launches nothing and bumps no count in
``ops.kernel_launches()``: it records a :class:`KernelSite` (the kernel,
its operands' shapes and dtype, the launch plan the card would take)
into the recorder that :func:`recording` opens, and returns empty outputs
of the kernel's shapes, so the trace goes on. On the real path the
wrappers pay one type check a call for this.

The plans use an H100 SXM5's numbers (:data:`SMS` and the shared memory
below), so the lint reads the same on a machine without a card; the CTAs
an SM holds come from shared memory and threads (registers are known only
to the compiled kernel).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

__all__ = ["KernelSite", "recording", "active", "traced", "record",
           "resident_ctas", "SMS", "SMEM_PER_SM", "SMEM_PER_BLOCK"]

SMS = 132                      # SMs of an H100 SXM5
SMEM_PER_SM = 228 * 1024       # shared memory of an SM
SMEM_PER_BLOCK = 227 * 1024    # the most one CTA may have
THREADS_PER_SM = 2048
RESERVED_SMEM = 1024           # what the runtime keeps of each CTA's share

_OPEN: list = []  # the recorders of the traces in progress, innermost last


@dataclass
class KernelSite:
    """One launch a traced step would make: ``kernel`` (the wrapper's
    name, as ``ops.kernel_launches()`` keys it), its operands' ``shapes``
    and ``dtype``, and the launch ``plan``."""
    kernel: str
    shapes: tuple
    dtype: str
    plan: dict = field(default_factory=dict)


@contextlib.contextmanager
def recording():
    """Within this context every kernel site a wrapper meets is appended
    to the yielded list."""
    sites: list = []
    _OPEN.append(sites)
    try:
        yield sites
    finally:
        _OPEN.pop()


def active() -> bool:
    return bool(_OPEN)


def traced(t) -> bool:
    """True for a tensor of a lint trace (a fake tensor): it holds no data
    a kernel could read."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def record(site: KernelSite) -> None:
    if _OPEN:
        _OPEN[-1].append(site)


def resident_ctas(smem_bytes: int, threads: int) -> int:
    """CTAs of ``threads`` threads and ``smem_bytes`` of shared memory
    (dynamic and static) that the card holds at once."""
    per_sm = min(THREADS_PER_SM // threads,
                 SMEM_PER_SM // (smem_bytes + RESERVED_SMEM))
    return max(per_sm, 0) * SMS
