"""Where a training step's time goes on the card.

    python -m bigdl_tpu_torch.tools.profile_train [-b 8] [--remat full]

Builds ``transformer_lm_1k_hd128`` at full width on CUDA (random weights,
seed 0, bf16 activations) with the training step of ``cli.perf``, then:

* times 5 steps on the host clock after 3 warm-up steps, ended by
  ``torch.cuda.synchronize()``;
* traces 3 steps with ``torch.profiler`` and prints the device busy time
  (sum of kernel times) over the traced wall time, the kernel count per
  step, the flash kernels' share of the device time, and the top
  operators by device time and by host time.

Prints the card's name and power limit first; needs a card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

MODEL, WARMUP, STEPS, TRACED = "transformer_lm_1k_hd128", 3, 5, 3


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--batchSize", type=int, default=8)
    p.add_argument("--remat", nargs="?", const="full", default=False,
                   choices=["full", "dots"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from bigdl_tpu_torch.cli.perf import train_step

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    step, tokens, _ = train_step(MODEL, args.batchSize, torch.bfloat16,
                                 "cuda", args.remat)
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    print(f"{MODEL} bf16 batch {args.batchSize} remat={args.remat}: step "
          f"{step_ms:.2f} ms (host clock, synchronized), "
          f"{tokens / step_ms * 1e3:.1f} tokens/s", flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED):
            step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev)
    flash_us = sum(e.self_device_time_total for e in dev if "flash_" in e.key)
    n_kernels = sum(e.count for e in dev)
    print(f"traced {TRACED} steps: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{dev_us / 1e3:.2f} ms ({100 * dev_us / wall_us:.1f}%), "
          f"{n_kernels / TRACED:.0f} kernels per step; flash kernels "
          f"{flash_us / 1e3 / TRACED:.2f} ms per step "
          f"({100 * flash_us / max(dev_us, 1e-9):.1f}% of device time)",
          flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=20))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
