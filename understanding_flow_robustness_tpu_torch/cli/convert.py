"""Checkpoint converter CLI (counterpart of the JAX package's
``ufr-convert``, ``understanding_flow_robustness_tpu/cli/convert.py``):
a reference torch checkpoint to a flax ``.msgpack``.

Builds ``--flownet`` on the CPU (the conversion needs no card), loads
``--src`` strictly through the port's loader (a ``.pth``/``.pth.tar``, or
SpyNet's directory of per-level weight files), converts the weights with
the JAX package's rules (``models.convert.flax_variables``) and writes the
FULL variables dict (params and any batch-norm statistics) with the port's
msgpack codec: the file ``ufr-convert`` writes for the same weights, which
both packages' ``fetch_model(name, pretrained_path="model.msgpack")``,
``cli.evaluate --model`` and ``cli.infer --pretrained`` restore.

    python -m understanding_flow_robustness_tpu_torch.cli.convert \\
        --flownet RAFT --src raft-things.pth --dst raft-things.msgpack
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Convert a reference torch checkpoint to flax msgpack")
    p.add_argument("--flownet", required=True,
                   help="model ID (models.fetch_model)")
    p.add_argument("--src", required=True,
                   help="torch checkpoint file (.pth/.pth.tar) or the "
                        "SpyNet per-level weight directory")
    p.add_argument("--dst", required=True, help="output .msgpack path")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.src):
        raise SystemExit(f"checkpoint not found: {args.src}")
    if not args.dst.endswith(".msgpack"):
        raise SystemExit("--dst must end in .msgpack")

    from ..models import fetch_model
    from ..models.convert import flax_variables
    from ..models.registry import _resolve_checkpoint
    from ..utils import msgpack

    if _resolve_checkpoint(args.flownet, args.src) is None:
        raise SystemExit(f"{args.src} holds no checkpoint of {args.flownet}")
    model = fetch_model(args.flownet, pretrained_path=args.src, device="cpu")
    data = msgpack.packb(flax_variables(model.module))
    os.makedirs(os.path.dirname(os.path.abspath(args.dst)), exist_ok=True)
    with open(args.dst, "wb") as f:
        f.write(data)
    size = os.path.getsize(args.dst)
    print(f"{args.flownet}: {args.src} -> {args.dst} ({size / 1e6:.1f} MB)")
    return args.dst


if __name__ == "__main__":
    main()
