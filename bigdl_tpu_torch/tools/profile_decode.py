"""Where a served decode step's time goes on the card, eager against
CUDA-graphed and dense against paged KV.

    python -m bigdl_tpu_torch.tools.profile_decode [--bf16] [--slots 4]

Builds ``transformer_lm_1k_hd128`` at full width on CUDA (random weights,
seed 0) and, for each row (dense eager, dense graphed, paged eager, paged
graphed; paged with 128-token pages), a ``DecodeEngine`` whose slots are
filled with 64-token greedy prompts, then:

* times the batched decode step on the host clock: 20 steps after 3
  warm-up ones, ended by ``torch.cuda.synchronize()``; generated tokens/s
  is slots / step time;
* traces 8 steps with ``torch.profiler``: device time a step (the sum of
  the kernels' times), the device busy share (that sum over the traced
  wall time) and kernels a step (graph replays' kernels included).

Prints the card's name and power limit first, then one line a row and,
for the last row, the top operators by device time; needs a card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

PROMPT, WARM, STEPS, TRACED = 64, 3, 20, 8
ROWS = (("dense", "eager", None, False), ("dense", "graphed", None, True),
        ("paged", "eager", 128, False), ("paged", "graphed", 128, True))


def _trace(eng, steps: int):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    cuda = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in cuda)
    return events, dev_us, wall_us, sum(e.count for e in cuda)


def profile_row(model, slots: int, page_tokens, graphs: bool) -> dict:
    """One row's numbers (host-clock ms a step, tokens/s, device ms a
    step, busy share, kernels a step) on a fresh engine."""
    from bigdl_tpu_torch.serving import DecodeEngine

    eng = DecodeEngine(model, slots=slots, device="cuda",
                       kv_page_tokens=page_tokens, graphs=graphs)
    rs = torch.Generator().manual_seed(0)
    budget = WARM + STEPS + TRACED + 1
    for _ in range(slots):
        eng.submit(torch.randint(0, model.vocab, (PROMPT,),
                                 generator=rs).tolist(), budget)
    for _ in range(WARM):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        eng.step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    events, dev_us, wall_us, n_kernels = _trace(eng, TRACED)
    eng.close()
    return {"step_ms": step_ms, "tokens_per_s": 1e3 * slots / step_ms,
            "device_ms": dev_us / 1e3 / TRACED,
            "busy": dev_us / wall_us, "kernels": n_kernels / TRACED,
            "events": events}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--slots", type=int, default=4)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from bigdl_tpu_torch.cli.perf import build_model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    model, _ = build_model("transformer_lm_1k_hd128")
    model.compute_dtype = torch.bfloat16 if args.bf16 else None
    tag = f"{'bf16' if args.bf16 else 'f32'} slots={args.slots}"
    row = None
    for kv, mode, pt, graphs in ROWS:
        row = profile_row(model.cuda(), args.slots, pt, graphs)
        print(f"{tag} {kv} {mode}: decode step {row['step_ms']:.3f} ms "
              f"(host clock), {row['tokens_per_s']:.1f} generated "
              f"tokens/s, device {row['device_ms']:.3f} ms a step, busy "
              f"{100 * row['busy']:.1f}%, {row['kernels']:.0f} kernels a "
              f"step ({card})", flush=True)
    print(row["events"].table(sort_by="self_device_time_total",
                              row_limit=15))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
