"""Training throughput of the perf model zoo's ResNet and LM rows
(counterpart of ``bigdl_tpu/cli/perf.py``)::

    python -m bigdl_tpu_torch.cli.perf -m resnet50_fba -b 128 --dataType random
    python -m bigdl_tpu_torch.cli.perf -m transformer_lm_1k_hd128 -b 8

builds the model with random weights from a seed (the BN kernels for the
``_fbn``/``_fba`` rows or ``--fusedBN``, the flash kernels for attention),
takes SGD(0.01, momentum 0.9) steps over one resident batch from
``np.random.RandomState(0)`` (images of ones or N(0, 1) per
``--dataType``, random labels; random tokens for an LM), and prints one
JSON line: model, batch, iterations, seconds, records_per_second (images
or sequences a second), tokens_per_second (LM rows), dtype, fused_bn,
inner_steps. Warm-up steps run before the timed ones; the clock stops
after the last step's loss reaches the host. ``--innerSteps K`` (K > 1)
makes each iteration K steps replayed as one CUDA graph, the counterpart
of the JAX harness's K-step ``fori_loop`` on the resident batch; the
rates are over iterations x K steps. bf16 activations unless ``--f32``
(images are cast to bf16, the parameters stay f32); the loss is taken on
the f32 output. MFU and the analytic FLOP count come with the rest of
the perf harness (ROADMAP.md queue 1 item 7); the 16k/32k LM rows wait
for remat at those lengths to be measured.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch import models
from bigdl_tpu_torch.cli.common import add_fused_bn_arg

__all__ = ["LM_VOCAB", "LM_CONFIGS", "IMAGE_CONFIGS", "build_model",
           "train_step", "run", "main"]

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

# name -> (builder kwargs, input (H, W, C), classes). _fbn: the stats
# kernels; _fba: the fused BN block with the conv->BN->ReLU ReLUs absorbed
IMAGE_CONFIGS = {
    "resnet50": (dict(depth=50), (224, 224, 3), 1000),
    "resnet50_fbn": (dict(depth=50, fused_bn="stats"), (224, 224, 3), 1000),
    "resnet50_fba": (dict(depth=50, fused_bn="apply"), (224, 224, 3), 1000),
    "resnet20_cifar": (dict(depth=20, cifar=True), (32, 32, 3), 10),
}


def build_model(name: str, seq_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None, **kw):
    """(model, input shape) for a model of the zoo, on the CPU; weights
    are random from ``generator`` (default seeded 0). For an LM, ``kw``
    (e.g. ``remat``, ``num_layers``) overrides the row's config."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if name in IMAGE_CONFIGS:
        cfg, in_shape, classes = IMAGE_CONFIGS[name]
        cfg = dict(cfg)
        if cfg.pop("cifar", False):
            model = models.resnet_cifar(cfg.pop("depth"), classes,
                                        generator=generator, **cfg)
        else:
            model = models.resnet(cfg.pop("depth"), classes,
                                  generator=generator, **cfg)
        return model, in_shape
    if name not in LM_CONFIGS:
        raise SystemExit(f"model {name} is not in the PyTorch port yet; "
                         f"choose from {sorted(IMAGE_CONFIGS)} or "
                         f"{sorted(LM_CONFIGS)}")
    cfg = dict(LM_CONFIGS[name], **kw)
    if seq_len is not None:
        cfg["max_len"] = int(seq_len)
    model = models.transformer_lm(LM_VOCAB, attn_impl="flash",
                                  generator=generator, **cfg)
    return model, (cfg["max_len"],)


def train_step(model_name: str, batch: int, dtype=torch.bfloat16,
               device=None, remat=False, seq_len: Optional[int] = None,
               fused_bn: Optional[str] = None, data_type: str = "constant",
               graph_steps: int = 0):
    """(step, model, tokens per step or None, device): ``step()`` takes
    SGD(0.01, momentum 0.9) steps of the zoo model on one resident batch
    from ``np.random.RandomState(0)`` and returns the last loss (not
    synced). ``fused_bn`` (--fusedBN) is installed on top of the row's
    own BN mode. With ``graph_steps`` = 0 a call is one eager step; with
    K >= 1 a call is K steps, on CUDA one replay of a CUDA graph of the K
    steps (the first call runs them eagerly on the capture stream, then
    captures; :class:`~bigdl_tpu_torch.optim.step_graph.StepGraph`), on
    the CPU K eager steps."""
    from bigdl_tpu_torch.cli.common import apply_fused_bn
    from bigdl_tpu_torch.core.module import resolve_device
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.step_graph import StepGraph

    device = resolve_device(device)
    is_lm = model_name in LM_CONFIGS
    model, in_shape = build_model(model_name, seq_len=seq_len,
                                  **({"remat": remat} if is_lm else {}))
    apply_fused_bn(model, fused_bn)
    rng = np.random.RandomState(0)
    if is_lm:
        if dtype == torch.bfloat16:
            model.compute_dtype = dtype  # the cast lives after the embedding
        crit = TimeDistributedCriterion(ClassNLLCriterion())
        x = torch.from_numpy(rng.randint(0, LM_VOCAB, (batch, *in_shape))
                             .astype(np.int32))
        y = torch.from_numpy(rng.randint(0, LM_VOCAB, (batch, *in_shape))
                             .astype(np.int32))
        tokens = batch * in_shape[0]
    else:
        crit = ClassNLLCriterion()
        x = (np.ones((batch, *in_shape), np.float32) if data_type ==
             "constant" else rng.randn(batch, *in_shape).astype(np.float32))
        x = torch.from_numpy(x).to(dtype)
        y = torch.from_numpy(rng.randint(0, IMAGE_CONFIGS[model_name][2],
                                         batch).astype(np.int32))
        tokens = None
    model = model.to(device).train()
    opt = SGD(learning_rate=0.01, momentum=0.9)
    params = dict(model.named_parameters())
    names, plist = list(params), list(params.values())
    state = opt.init(params)

    def one_step(xd, yd, seed=None):
        loss = crit(model(xd).float(), yd)
        grads = torch.autograd.grad(loss, plist)
        opt.update(dict(zip(names, grads)), state, params)
        return loss.detach()

    xd, yd = x.to(device), y.to(device)
    if graph_steps == 0:
        return (lambda: one_step(xd, yd)), model, tokens, device
    if device.type == "cpu":
        def steps():
            for _ in range(graph_steps):
                loss = one_step(xd, yd)
            return loss
        return steps, model, tokens, device

    graph = None

    def replay():
        nonlocal graph
        if graph is not None:
            return graph.replay()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(graph_steps):
                loss = one_step(xd, yd)
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = StepGraph(one_step, (x, y), graph_steps, device, stream)
        graph.put([(x, y)] * graph_steps, [0] * graph_steps)
        graph.capture()
        return loss

    return replay, model, tokens, device


def run(model_name: str, batch: int = 32, iterations: int = 10,
        dtype=torch.bfloat16, warmup: int = 2, device=None, remat=False,
        seq_len: Optional[int] = None, fused_bn: Optional[str] = None,
        data_type: str = "constant", inner_steps: int = 1) -> dict:
    """Time ``iterations`` dispatches of ``inner_steps`` training steps
    each after ``warmup`` ones (with ``inner_steps`` > 1 a dispatch is a
    CUDA graph of the steps; the first warm-up dispatch runs them eagerly
    and captures the graph); returns the JSON line's fields plus
    ``losses`` (each dispatch's last step's, warm-up first). The rates are
    over ``iterations * inner_steps`` steps."""
    from bigdl_tpu_torch.nn import bn_fused_mode

    if inner_steps > 1 and warmup < 1:
        raise ValueError("inner_steps > 1 needs a warm-up dispatch (it "
                         "captures the graph)")
    step, model, tokens, device = train_step(
        model_name, batch, dtype, device, remat, seq_len, fused_bn,
        data_type, graph_steps=inner_steps if inner_steps > 1 else 0)
    losses = [float(step()) for _ in range(warmup)]  # each one synced
    t0 = time.perf_counter()
    timed = [step() for _ in range(iterations)]
    losses += [float(v) for v in timed]  # the first read waits for the last
    dt = time.perf_counter() - t0
    rps = batch * iterations * inner_steps / dt
    return {"model": model_name, "batch": batch, "iterations": iterations,
            "inner_steps": inner_steps,
            "seconds": round(dt, 4), "records_per_second": round(rps, 2),
            "tokens_per_second": (None if tokens is None else
                                  round(rps * tokens / batch, 1)),
            "dtype": str(dtype).replace("torch.", ""),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "remat": remat or None, "fused_bn": bn_fused_mode(model),
            "data_type": None if tokens is not None else data_type,
            "warmup": warmup, "first_loss": losses[0],
            "final_loss": losses[-1], "losses": losses}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.perf")
    p.add_argument("-m", "--model", default="transformer_lm_1k_hd128",
                   choices=sorted(IMAGE_CONFIGS) + sorted(LM_CONFIGS))
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("-i", "--iteration", type=int, default=10)
    p.add_argument("--innerSteps", type=int, default=1, metavar="K",
                   help="K SGD steps per iteration on the resident batch, "
                        "as one CUDA graph replayed each iteration (K > 1); "
                        "the rate is over iterations x K steps")
    p.add_argument("--dataType", choices=["constant", "random"],
                   default="constant",
                   help="image rows: images of ones or N(0, 1) draws")
    p.add_argument("--f32", action="store_true",
                   help="f32 activations (default bf16: the input images, "
                        "or the LM's activations after the embedding)")
    p.add_argument("--remat", nargs="?", const="full", default=False,
                   choices=["full", "dots"])
    p.add_argument("--seq", type=int, default=None,
                   help="override the LM context length (small CPU runs)")
    p.add_argument("--platform", choices=("cuda", "cpu"), default=None,
                   help="default cuda; cpu runs the kernels' plain versions")
    add_fused_bn_arg(p)
    args = p.parse_args(argv)
    out = run(args.model, batch=args.batchSize, iterations=args.iteration,
              dtype=torch.float32 if args.f32 else torch.bfloat16,
              device=args.platform, remat=args.remat, seq_len=args.seq,
              fused_bn=args.fusedBN, data_type=args.dataType,
              inner_steps=args.innerSteps)
    line = {k: v for k, v in out.items() if k != "losses"}
    print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()
