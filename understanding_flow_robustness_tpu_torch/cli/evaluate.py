"""Standalone evaluation CLI (counterpart of
``understanding_flow_robustness_tpu/cli/evaluate.py``; reference:
training/evaluate.py:395-427).

Runs ``validate_{chairs,sintel,kitti}`` picked by ``--dataset`` on any
ported registry architecture (``--arch``, RAFT by default, like the
reference), or with ``--submission`` writes the Sintel or KITTI benchmark
submission.  RAFT runs 24 iterations (32 on Sintel) in f32 unless
``--mixed_precision``.  ``--model`` is a reference ``.pth``/``.pth.tar``
checkpoint, a weights file of the port's trainer (``save_weights``) or a
flax ``.msgpack`` of the JAX package (``ufr-convert``'s full variables or
its trainer's params-only export; ``cli.convert`` writes one), loaded
strictly; ``--small`` builds small RAFT for it.  ``--device`` is the card
unless asked for ``cpu`` (no fallback).  ``--n_devices N`` shards KITTI
validation over N ranks, one process per device (``parallel.launch``:
N cards, or N CPU ranks with ``--device cpu``; more CUDA ranks than cards
raise).

Example:
  python -m understanding_flow_robustness_tpu_torch.cli.evaluate \\
      --model raft-kitti.pth --dataset kitti \\
      --data_roots '{"kitti": "datasets/KITTI/2015"}'
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ..models import device_arg, fetch_model
from ..parallel.mesh import current_mesh, launch, make_mesh
from ..training import evaluate as ev


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", required=True,
                   help="checkpoint: a reference .pth/.pth.tar, a "
                        "weights file of the port's trainer, or a flax "
                        ".msgpack (full variables or params only)")
    p.add_argument("--dataset", required=True,
                   choices=["chairs", "sintel", "kitti"],
                   help="dataset for evaluation")
    p.add_argument("--arch", default="RAFT",
                   help="registry architecture ID (RAFT, as the reference)")
    p.add_argument("--small", action="store_true", help="small RAFT")
    p.add_argument("--mixed_precision", action="store_true",
                   help="RAFT in mixed precision (bf16 compute); f32 "
                        "unless set, as in the reference")
    p.add_argument("--alternate_corr", action="store_true",
                   help="RAFT's on-demand correlation lookup (the default "
                        "'auto' already takes it)")
    p.add_argument("--iters", type=int, default=None,
                   help="RAFT refinement iterations (reference defaults: "
                        "24 chairs/kitti, 32 sintel)")
    p.add_argument("--submission", choices=["sintel", "kitti"], default=None,
                   help="write a benchmark submission instead of "
                        "validating (evaluate.py:200-267)")
    p.add_argument("--output_path", default=None,
                   help="submission output dir")
    p.add_argument("--warm_start", action="store_true",
                   help="Sintel submission warm-start flow propagation")
    p.add_argument("--n_devices", type=int, default=None,
                   help="shard KITTI validation over N ranks, one process "
                        "per device")
    p.add_argument("--data_roots", type=str, default=None,
                   help="JSON dict of dataset roots, e.g. "
                        '\'{"kitti": "/data/KITTI"}\'')
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: the card unless asked for 'cpu' "
                        "(no fallback); 'gpu' means 'cuda'")
    return p


def _main_rank(mesh, argv):
    return main(argv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    device = device_arg(args.device)
    mesh = None
    if args.n_devices:
        if args.dataset != "kitti" or args.submission:
            raise ValueError("--n_devices shards KITTI validation only "
                             "(--dataset kitti, no --submission)")
        if args.n_devices > 1 and current_mesh() is None:
            return launch(_main_rank, args.n_devices, argv,
                          device=torch.device(device).type)
        mesh = make_mesh(args.n_devices, device=device)
        device = mesh.device
    if not os.path.isfile(args.model):
        # the JAX CLI's torch.load of the file raises the same
        raise FileNotFoundError(f"--model {args.model!r}: no such file")

    kwargs = {}
    if args.arch.startswith("RAFT"):
        if args.small:
            kwargs["small"] = True
        kwargs["mixed_precision"] = args.mixed_precision
        if args.alternate_corr:
            kwargs["corr_impl"] = "alt"
        # reference iters: 24 for chairs/kitti, 32 for sintel
        # (evaluate.py:273,301,349)
        kwargs["iters"] = args.iters if args.iters is not None else (
            32 if args.dataset == "sintel" else 24)
    model = fetch_model(args.arch, pretrained_path=args.model,
                        device=device, **kwargs)

    roots = json.loads(args.data_roots) if args.data_roots else {}

    def root(key):
        return {"root": roots[key]} if key in roots else {}

    from ..data.datasets import KITTI, FlyingChairs, MpiSintel

    if args.submission == "sintel":
        return ev.create_sintel_submission(
            model, lambda d: MpiSintel(split="test", dstype=d,
                                       **root("sintel")),
            output_path=args.output_path or "sintel_submission",
            warm_start=args.warm_start)
    if args.submission == "kitti":
        return ev.create_kitti_submission(
            model, KITTI(split="testing", **root("kitti")),
            output_path=args.output_path or "kitti_submission")
    if args.dataset == "chairs":
        return ev.validate_chairs(
            model, FlyingChairs(split="validation", **root("chairs")))
    if args.dataset == "sintel":
        return ev.validate_sintel(
            model, lambda d: MpiSintel(dstype=d, **root("sintel")))
    return ev.validate_kitti(model, KITTI(split="training", **root("kitti")),
                             mesh=mesh)


if __name__ == "__main__":
    main()
