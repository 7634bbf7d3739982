"""Hand-written CUDA kernels of the port, with their plain versions.

``kernel_launches()`` reads, and ``reset_kernel_launches()`` zeroes, the
launch count of every kernel wrapper: the proof that a run went through
the kernels."""

from bigdl_tpu_torch.ops.attention_kernel import (flash_attention,
                                                   flash_attention_reference,
                                                   flash_bwd,
                                                   flash_bwd_reference,
                                                   flash_dkv, flash_dq,
                                                   flash_fwd,
                                                   serving_prefill_buckets)

__all__ = ["flash_attention", "flash_attention_reference", "flash_fwd",
           "flash_bwd", "flash_bwd_reference", "flash_dq", "flash_dkv",
           "serving_prefill_buckets", "kernel_launches",
           "reset_kernel_launches"]

_WRAPPERS = {"flash_fwd": flash_fwd, "flash_dq": flash_dq,
             "flash_dkv": flash_dkv}


def kernel_launches() -> dict:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_kernel_launches() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
