"""Hand-written CUDA kernels of the port, with their plain versions.

``kernel_launches()`` reads, and ``reset_kernel_launches()`` zeroes, the
launch count of every kernel wrapper: the proof that a run went through
the kernels. A wrapper counts the launches it makes; a CUDA graph's
replay launches what its capture recorded, and the code that replays it
credits those with ``add_kernel_launches`` (the capture itself launched
nothing, and takes its counts back the same way)."""

from bigdl_tpu_torch.ops.attention_kernel import (flash_attention,
                                                   flash_attention_reference,
                                                   flash_bwd,
                                                   flash_bwd_reference,
                                                   flash_dkv, flash_dq,
                                                   flash_fwd,
                                                   serving_prefill_buckets)
from bigdl_tpu_torch.ops.bn_kernel import (bn_bwd_fused, bn_bwd_stats,
                                           bn_fwd_apply, bn_stats,
                                           fused_bn_apply_train,
                                           fused_bn_train)

__all__ = ["flash_attention", "flash_attention_reference", "flash_fwd",
           "flash_bwd", "flash_bwd_reference", "flash_dq", "flash_dkv",
           "serving_prefill_buckets", "bn_stats", "bn_bwd_stats",
           "bn_fwd_apply", "bn_bwd_fused", "fused_bn_train",
           "fused_bn_apply_train", "kernel_launches",
           "reset_kernel_launches", "add_kernel_launches"]

_WRAPPERS = {"flash_fwd": flash_fwd, "flash_dq": flash_dq,
             "flash_dkv": flash_dkv, "bn_stats": bn_stats,
             "bn_bwd_stats": bn_bwd_stats, "bn_fwd_apply": bn_fwd_apply,
             "bn_bwd_fused": bn_bwd_fused}


def kernel_launches() -> dict:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_kernel_launches() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def add_kernel_launches(counts: dict, times: int = 1) -> None:
    """Add ``counts[name] * times`` to each wrapper's count."""
    for name, n in counts.items():
        _WRAPPERS[name].launches += n * times
