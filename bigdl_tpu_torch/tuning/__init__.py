"""The autotuner: measured, cached per-shape decisions (counterpart of
``bigdl_tpu.tuning``, with its names, keys and file format).

See :mod:`bigdl_tpu_torch.tuning.autotune` for the design. The CLI flag is
``--autotune {off,cached,measure}`` (``cli/common.py``); the consumers are
``ops/conv2d.py`` (per-pass and per-geometry layouts),
``ops/attention_kernel.py`` (the key block of the key-padding path),
``ops/bn_kernel.py`` (the launch plan's slab height),
``parallel/grad_comm.py`` (the bucket bound), ``cli/serve.py`` (the KV
page size) and ``serving/quant.py`` (the int8 product's kind).
"""

from bigdl_tpu_torch.tuning.autotune import (MODES, QUANT_MATMUL_KINDS,
                                             annotation, bn_row_block,
                                             conv_geom_key, conv_geom_layout,
                                             dry_run, fba_row_block,
                                             flash_blocks, get_cache,
                                             get_mode, grad_bucket_bytes,
                                             install_conv_layouts,
                                             kv_page_tokens, make_key,
                                             put_geom_decisions,
                                             quant_matmul_kind, reset,
                                             reset_decisions, set_mode)
from bigdl_tpu_torch.tuning.cache import (CACHE_VERSION, AutotuneCache,
                                          cache_dir, cache_path, device_kind,
                                          device_slug)

__all__ = ["MODES", "QUANT_MATMUL_KINDS",
           "set_mode", "get_mode", "dry_run", "make_key",
           "flash_blocks", "bn_row_block", "fba_row_block",
           "grad_bucket_bytes", "kv_page_tokens", "quant_matmul_kind",
           "install_conv_layouts", "conv_geom_key", "conv_geom_layout",
           "put_geom_decisions",
           "annotation", "reset", "reset_decisions", "get_cache",
           "AutotuneCache", "CACHE_VERSION", "cache_dir", "cache_path",
           "device_kind", "device_slug"]
