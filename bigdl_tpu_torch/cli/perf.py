"""Training throughput of the LM rows of the perf model zoo (counterpart
of the LM branch of ``bigdl_tpu/cli/perf.py``)::

    python -m bigdl_tpu_torch.cli.perf -m transformer_lm_1k_hd128 -b 8

builds the model with random weights from a seed (the flash kernels for
attention), takes SGD(0.01, momentum 0.9) steps over one resident batch
of random tokens from ``np.random.RandomState(0)``, and prints one JSON
line: model, batch, iterations, seconds, records_per_second,
tokens_per_second, dtype. Warm-up steps run before the timed ones; the
clock stops after the last step's loss reaches the host. bf16 activations
unless ``--f32``. MFU and the analytic FLOP count come with the perf
harness (ROADMAP.md queue 1 item 7); the 16k/32k rows wait for remat
at those lengths to be measured.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch import models

__all__ = ["LM_VOCAB", "LM_CONFIGS", "build_model", "train_step", "run",
           "main"]

LM_VOCAB = 32000

LM_CONFIGS = {
    "transformer_lm": dict(d_model=512, num_layers=8, num_heads=8,
                           max_len=512, pos_encoding="sinusoidal",
                           num_kv_heads=None),
    "transformer_lm_rope": dict(d_model=512, num_layers=8, num_heads=8,
                                max_len=512, pos_encoding="rope",
                                num_kv_heads=2),
    "transformer_lm_1k": dict(d_model=1024, num_layers=12, num_heads=16,
                              max_len=1024, pos_encoding="rope",
                              num_kv_heads=4),
    "transformer_lm_1k_hd128": dict(d_model=1024, num_layers=12,
                                    num_heads=8, max_len=1024,
                                    pos_encoding="rope", num_kv_heads=2),
}


def build_model(name: str, seq_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None, **kw):
    """(model, input shape) for an LM of the zoo, on the CPU; weights are
    random from ``generator`` (default seeded 0). ``kw`` (e.g. ``remat``,
    ``num_layers``) overrides the row's config."""
    if name not in LM_CONFIGS:
        raise SystemExit(f"model {name} is not in the PyTorch port yet; "
                         f"choose from {list(LM_CONFIGS)}")
    cfg = dict(LM_CONFIGS[name], **kw)
    if seq_len is not None:
        cfg["max_len"] = int(seq_len)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = models.transformer_lm(LM_VOCAB, attn_impl="flash",
                                  generator=generator, **cfg)
    return model, (cfg["max_len"],)


def train_step(model_name: str, batch: int, dtype=torch.bfloat16,
               device=None, remat=False, seq_len: Optional[int] = None):
    """(step, tokens per step, device): ``step()`` takes one SGD(0.01, momentum
    0.9) step of the zoo LM on a resident batch of random tokens from
    ``np.random.RandomState(0)`` and returns the loss (not synced)."""
    from bigdl_tpu_torch.core.module import resolve_device
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import SGD

    device = resolve_device(device)
    model, in_shape = build_model(model_name, seq_len=seq_len, remat=remat)
    if dtype == torch.bfloat16:
        model.compute_dtype = dtype  # the cast lives after the embedding
    model = model.to(device).train()
    crit = TimeDistributedCriterion(ClassNLLCriterion())
    opt = SGD(learning_rate=0.01, momentum=0.9)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, LM_VOCAB, (batch, *in_shape))
                         .astype(np.int32)).to(device)
    y = torch.from_numpy(rng.randint(0, LM_VOCAB, (batch, *in_shape))
                         .astype(np.int32)).to(device)
    params = dict(model.named_parameters())
    state = opt.init(params)

    def step():
        nonlocal state
        loss = crit(model(x).float(), y)
        loss.backward()
        state = opt.update({k: p.grad for k, p in params.items()}, state,
                           params)
        for p in params.values():
            p.grad = None
        return loss.detach()

    return step, batch * in_shape[0], device


def run(model_name: str, batch: int = 32, iterations: int = 10,
        dtype=torch.bfloat16, warmup: int = 2, device=None, remat=False,
        seq_len: Optional[int] = None) -> dict:
    """Time ``iterations`` training steps after ``warmup`` ones; returns
    the JSON line's fields plus ``losses`` (every step's, warm-up first)."""
    step, tokens, device = train_step(model_name, batch, dtype, device,
                                      remat, seq_len)
    losses = [float(step()) for _ in range(warmup)]  # each one synced
    t0 = time.perf_counter()
    timed = [step() for _ in range(iterations)]
    losses += [float(v) for v in timed]  # the first read waits for the last
    dt = time.perf_counter() - t0
    rps = batch * iterations / dt
    return {"model": model_name, "batch": batch, "iterations": iterations,
            "seconds": round(dt, 4), "records_per_second": round(rps, 2),
            "tokens_per_second": round(rps * tokens / batch, 1),
            "dtype": str(dtype).replace("torch.", ""),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "remat": remat or None, "warmup": warmup,
            "first_loss": losses[0], "final_loss": losses[-1],
            "losses": losses}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.perf")
    p.add_argument("-m", "--model", default="transformer_lm_1k_hd128",
                   choices=sorted(LM_CONFIGS))
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("-i", "--iteration", type=int, default=10)
    p.add_argument("--f32", action="store_true",
                   help="f32 activations (default bf16 after the embedding)")
    p.add_argument("--remat", nargs="?", const="full", default=False,
                   choices=["full", "dots"])
    p.add_argument("--seq", type=int, default=None,
                   help="override the context length (small CPU runs)")
    p.add_argument("--platform", choices=("cuda", "cpu"), default=None,
                   help="default cuda; cpu runs the kernels' plain versions")
    args = p.parse_args(argv)
    out = run(args.model, batch=args.batchSize, iterations=args.iteration,
              dtype=torch.float32 if args.f32 else torch.bfloat16,
              device=args.platform, remat=args.remat,
              seq_len=args.seq)
    line = {k: v for k, v in out.items() if k != "losses"}
    print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()
