"""Where the native feed's time goes on this host::

    python -m bigdl_tpu_torch.tools.profile_feed [--images 1024]
        [--side 256] [--crop 224] [-b 128] [--threads 1,2,4,8]

prints the host's copy rate for one batch of float32 images (one thread,
and PyTorch's copy with its intra-op threads), then the images/s of
``NativePrefetchDataSet`` alone (seeded uint8 images, random crop, flip,
ImageNet mean and std) at each worker-thread count, over 4 epochs after
a warm-up one. A rate that stops growing with threads while the cores are
not all busy points at host memory. The first line names the machine:
the card and its power limit where there is one (``nvidia-smi``), else
"no card"; every number is the host's."""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

from bigdl_tpu_torch.dataset import (IMAGENET_MEAN, IMAGENET_STD,
                                     NativePrefetchDataSet)

__all__ = ["main"]


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "no card"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "no card"


def copy_rates(shape, reps: int = 5) -> dict:
    """GB/s of copying one float32 batch into memory already mapped: one
    thread (numpy) and PyTorch's intra-op threads."""
    src = np.ones(shape, np.float32)
    dst = np.empty_like(src)
    np.copyto(dst, src)
    t0 = time.perf_counter()
    for _ in range(reps):
        np.copyto(dst, src)
    one = src.nbytes * reps / (time.perf_counter() - t0) / 1e9
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    t0 = time.perf_counter()
    for _ in range(reps):
        td.copy_(ts)
    many = src.nbytes * reps / (time.perf_counter() - t0) / 1e9
    return {"one_thread_gb_s": one, "torch_gb_s": many,
            "torch_threads": torch.get_num_threads()}


def feed_rate(images, labels, batch, crop, threads, epochs=4) -> float:
    ds = NativePrefetchDataSet(images, labels, batch, crop=(crop, crop),
                               train=True, mean=IMAGENET_MEAN,
                               std=IMAGENET_STD, n_threads=threads)
    for _ in ds:  # warm-up epoch: threads, pinned blocks, page mappings
        pass
    ds.shuffle()
    n, t0 = 0, time.perf_counter()
    for _ in range(epochs):
        for b in ds:
            n += len(b.input)
        ds.shuffle()
    rate = n / (time.perf_counter() - t0)
    ds.close()
    return rate


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.tools.profile_feed")
    p.add_argument("--images", type=int, default=1024)
    p.add_argument("--side", type=int, default=256)
    p.add_argument("--crop", type=int, default=224)
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("--threads", default="1,2,4,8")
    args = p.parse_args(argv)
    print(f"{_card()}; {os.cpu_count()} cores on the host", flush=True)
    shape = (args.batchSize, args.crop, args.crop, 3)
    rates = copy_rates(shape)
    mb = np.prod(shape) * 4 / 1e6
    print(f"copy of one {mb:.1f} MB float32 batch: "
          f"{rates['one_thread_gb_s']:.2f} GB/s on one thread, "
          f"{rates['torch_gb_s']:.2f} GB/s with torch's "
          f"{rates['torch_threads']} threads", flush=True)
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (args.images, args.side, args.side, 3),
                        dtype=np.uint8)
    labels = rs.randint(0, 1000, args.images).astype(np.int32)
    feed = {}
    for t in (int(v) for v in args.threads.split(",")):
        feed[t] = feed_rate(images, labels, args.batchSize, args.crop, t)
        print(f"NativePrefetchDataSet, {t} threads: {feed[t]:.1f} images/s "
              f"({feed[t] * mb / args.batchSize / 1e3:.2f} GB/s of float32 "
              f"batches out)", flush=True)
    return {"copy": rates, "feed": feed}


if __name__ == "__main__":
    main()
