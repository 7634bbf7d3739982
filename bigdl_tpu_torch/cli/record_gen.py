"""Record-shard generator (counterpart of ``bigdl_tpu/cli/record_gen.py``;
reference models/utils/ImageNetSeqFileGenerator.scala)::

    python -m bigdl_tpu_torch.cli.record_gen -f /data/imagenet \\
        -o /data/records -b 512 -p 8 [--limit N]

packs the label-by-folder trees ``<folder>/train`` and ``<folder>/val``
(or ``<folder>`` itself as one split) into ``.btr`` record shards of
``-b`` images each, written by ``-p`` threads
(``dataset.recordfile.write_image_shards``): the JAX tool's records, in
the JAX tool's order. ``RecordImageDataSet(<output>/train, ...)`` reads
them back. A host-only tool: it runs on no device, so it takes no
``--platform``.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.record_gen")
    p.add_argument("-f", "--folder", required=True,
                   help="imagenet-style root (train/ and val/ subfolders)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-b", "--blockSize", type=int, default=512,
                   help="images per shard (reference default 512)")
    p.add_argument("-p", "--parallel", type=int, default=8)
    p.add_argument("--limit", type=int, default=None,
                   help="at most this many images per split")
    args = p.parse_args(argv)

    from bigdl_tpu_torch.dataset.recordfile import write_image_shards

    splits = [s for s in ("train", "val")
              if os.path.isdir(os.path.join(args.folder, s))] or [""]
    written = {}
    for s in splits:
        src = os.path.join(args.folder, s) if s else args.folder
        dst = os.path.join(args.output, s) if s else args.output
        written[s] = write_image_shards(
            src, dst, prefix=s or "data", images_per_shard=args.blockSize,
            workers=args.parallel, limit=args.limit)
        print(f"{src}: wrote {len(written[s])} shards to {dst}")
    return written


if __name__ == "__main__":
    main()
