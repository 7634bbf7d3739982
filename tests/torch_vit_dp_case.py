"""The rank side of tests/test_torch_vit.py's data-parallel case: a
``cli.perf`` ViT row, cut to a CPU width, stepped with ``--strategy dp``
over the gloo ranks ``parallel.launch.spawn`` starts. Imports no jax."""

import torch

from bigdl_tpu_torch.cli import perf

# the row at a CPU width: 32 x 32 images, 16 patches of 8, one layer of
# 384 (vit_s16's width, 3 heads of 128)
TINY = (dict(arch="vit", attn_impl="flash", d_model=384, image_size=32,
             patch_size=8, num_layers=1), (32, 32, 3), 10)


def run_row(args: dict) -> dict:
    """Rank target and single-process reference: ``iterations`` SGD steps
    of the tiny row at global ``batch``; the losses."""
    torch.set_num_threads(1)
    perf.IMAGE_CONFIGS["vit_s16"] = TINY
    out = perf.run("vit_s16", batch=args["batch"],
                   iterations=args["iterations"], warmup=1,
                   dtype=torch.float32, device="cpu", data_type="random",
                   strategy=args.get("strategy"))
    return {"losses": out["losses"], "n_devices": out["n_devices"]}
