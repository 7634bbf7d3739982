"""Where a training step's time goes on the card.

    python -m bigdl_tpu_torch.tools.profile_train [-m MODEL] [-b BATCH]
        [--fusedBN off|stats|apply] [--remat full] [--innerSteps K]

Builds a model of ``cli.perf``'s zoo at full width on CUDA (random weights,
seed 0, bf16 activations; default ``transformer_lm_1k_hd128`` at batch 8,
``resnet50`` rows at batch 128 on random images) with the training step
of ``cli.perf``, then:

* times 5 dispatches on the host clock after 3 warm-up ones, ended by
  ``torch.cuda.synchronize()``;
* traces 3 dispatches with ``torch.profiler`` and prints the device busy time
  (sum of kernel times) over the traced wall time, the kernel count per
  step, the port's kernels' share of the device time (flash for an LM,
  BN for a ResNet), the convolutions' (``aten::convolution`` and its
  backward, with the kernels under them) and the copies' and casts'
  (``aten::copy_``), and the top operators by device time and by host
  time.

A dispatch is one eager step, or with ``--innerSteps K`` one replay of a
CUDA graph of K steps (``cli.perf.train_step``'s ``graph_steps``; K = 1
is a one-step graph replayed each step). Every per-step figure is over
dispatches x K steps, so an eager and a graphed row compare directly:
their kernels a step are equal, beside the few device events a replay
adds outside the graph (the copy of its loss among them). Operator rows
(convolutions, copies) are empty for a graphed row: a replay runs no
operator.

Prints the card's name and power limit first; needs a card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

WARMUP, STEPS, TRACED = 3, 5, 3


def main(argv=None) -> int:
    from bigdl_tpu_torch.cli.common import add_fused_bn_arg
    from bigdl_tpu_torch.cli.perf import IMAGE_CONFIGS, LM_CONFIGS

    p = argparse.ArgumentParser()
    p.add_argument("-m", "--model", default="transformer_lm_1k_hd128",
                   choices=sorted(IMAGE_CONFIGS) + sorted(LM_CONFIGS))
    p.add_argument("-b", "--batchSize", type=int, default=None,
                   help="default 8 for an LM, 128 for an image model")
    p.add_argument("--remat", nargs="?", const="full", default=False,
                   choices=["full", "dots"])
    p.add_argument("--innerSteps", type=int, default=0, metavar="K",
                   help="replay a CUDA graph of K steps per dispatch "
                        "(default: eager steps)")
    add_fused_bn_arg(p)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from bigdl_tpu_torch.cli.perf import train_step
    from bigdl_tpu_torch.nn import bn_fused_mode

    is_lm = args.model in LM_CONFIGS
    batch = args.batchSize or (8 if is_lm else 128)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    k = max(1, args.innerSteps)
    step, model, tokens, _ = train_step(
        args.model, batch, torch.bfloat16, "cuda", args.remat,
        fused_bn=args.fusedBN, data_type="random",
        graph_steps=args.innerSteps)
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / (STEPS * k)
    rate = (f"{tokens / step_ms * 1e3:.1f} tokens/s" if is_lm else
            f"{batch / step_ms * 1e3:.1f} images/s")
    mode = (f"graph of {args.innerSteps} step(s)" if args.innerSteps
            else "eager")
    print(f"{args.model} bf16 batch {batch} remat={args.remat} fused_bn="
          f"{bn_fused_mode(model)} {mode}: step {step_ms:.2f} ms (host "
          f"clock, synchronized), {rate}", flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED):
            step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    steps = TRACED * k
    events = prof.key_averages()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev)
    n_kernels = sum(e.count for e in dev)
    marks = ("flash_",) if is_lm else ("bn_coop_kernel",)
    port = [e for e in dev if any(m in e.key for m in marks)]
    port_ms = sum(e.self_device_time_total for e in port) / 1e3 / steps
    port_n = sum(e.count for e in port)

    def ops_ms(*names):
        """Device ms a step under these operators (their kernels)."""
        return sum(e.device_time_total for e in events
                   if e.key in names) / 1e3 / steps

    def pct(ms):
        return 100 * ms * 1e3 * steps / max(dev_us, 1e-9)

    conv_ms = ops_ms("aten::convolution", "aten::convolution_backward")
    copy_ms = ops_ms("aten::copy_")
    print(f"traced {steps} steps: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{dev_us / 1e3:.2f} ms ({100 * dev_us / wall_us:.1f}%, "
          f"{dev_us / 1e3 / steps:.2f} ms a step), "
          f"{n_kernels / steps:.2f} kernels per step ({n_kernels} device "
          f"events); the port's "
          f"{'/'.join(marks)} kernels {port_ms:.2f} ms per step "
          f"({pct(port_ms):.1f}% of device time, {port_n / steps:.0f} "
          f"kernels); convolutions "
          f"{conv_ms:.2f} ms ({pct(conv_ms):.1f}%); copies and casts "
          f"{copy_ms:.2f} ms ({pct(copy_ms):.1f}%)", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=20))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
