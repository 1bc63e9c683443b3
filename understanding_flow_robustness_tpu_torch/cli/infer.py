"""Batch inference over frame pairs on disk (counterpart of
``understanding_flow_robustness_tpu/cli/infer.py``, ``ufr-infer``): the
system's serving path for files.

* Frames are decoded ahead, in order, by a thread pool over the port's
  readers (``zlib`` and the host library's PNG unfilter release the GIL),
  padded on the host by RAFT's InputPadder rule to the model's size
  multiple, predicted in batches of ``--batch_size`` and unpadded.  A
  ragged last batch runs as it is, not repeated to full size.
* Outputs per pair, written by the same pool: ``.flo`` (Middlebury),
  ``_flow.png`` (KITTI 16-bit, all valid) and / or ``_viz.png`` (the
  Middlebury colour wheel).
* ``--device`` is the card unless asked for ``cpu`` (no fallback).
* ``--devices N`` (dividing ``--batch_size``) runs N ranks, one process
  per device (``parallel.launch``: N cards, or N CPU ranks with ``--device
  cpu``; more CUDA ranks than cards raise).  Each batch is split as the
  JAX CLI shards it, a ragged last batch repeated to full size first; each
  rank decodes, predicts and writes the pairs of its slice.

Input selection (one of):
  --pairs LIST.txt     two image paths per line (whitespace-separated)
  --dir DIR            KITTI-style directory: every ``*_10.png`` pairs
                       with its ``*_11.png`` sibling
  --img1 A --img2 B    a single pair

All frames in a run share one resolution.

Example:
  python -m understanding_flow_robustness_tpu_torch.cli.infer --flownet RAFT \\
      --dir datasets/KITTI/2015/testing/image_2 --batch_size 8 \\
      --save flo,png,viz --output_dir flow_out
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import glob
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--flownet", default="RAFT",
                   help="model ID (models.fetch_model)")
    p.add_argument("--pretrained", default=None,
                   help="checkpoint file (.pth/.pth.tar or a flax "
                        ".msgpack); seeded random "
                        "weights when omitted")
    p.add_argument("--pairs", default=None,
                   help="text file: two image paths per line")
    p.add_argument("--dir", dest="pair_dir", default=None,
                   help="directory of KITTI-style *_10.png / *_11.png pairs")
    p.add_argument("--img1", default=None)
    p.add_argument("--img2", default=None)
    p.add_argument("--output_dir", default="flow_out")
    p.add_argument("--save", default="flo",
                   help="comma list of output formats: flo, png (KITTI "
                        "16-bit), viz (color wheel)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--devices", type=int, default=1,
                   help="data-parallel ranks, one process per device (must "
                        "divide batch_size)")
    p.add_argument("--pad_mode", default="kitti", choices=["kitti", "sintel"],
                   help="InputPadder rule: kitti pads H at the bottom, "
                        "sintel pads both axes symmetrically")
    p.add_argument("--prefetch_threads", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: the card unless asked for 'cpu' "
                        "(no fallback); 'gpu' means 'cuda'")
    return p


def collect_pairs(args) -> list:
    """[(img1_path, img2_path, output_stem), ...] from the CLI selection."""
    if args.pairs:
        out = []
        with open(args.pairs) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    stem = os.path.splitext(os.path.basename(parts[0]))[0]
                    out.append((parts[0], parts[1], stem))
        return out
    if args.pair_dir:
        out = []
        for p1 in sorted(glob.glob(os.path.join(args.pair_dir, "*_10.png"))):
            p2 = p1[: -len("_10.png")] + "_11.png"
            if os.path.exists(p2):
                stem = os.path.splitext(os.path.basename(p1))[0][:-3]
                out.append((p1, p2, stem))
        return out
    if args.img1 and args.img2:
        stem = os.path.splitext(os.path.basename(args.img1))[0]
        return [(args.img1, args.img2, stem)]
    raise SystemExit("need --pairs, --dir, or --img1/--img2")


def _dedup_stems(pairs: list) -> list:
    """Disambiguate duplicate output stems (same basename, different dirs)
    by appending the pair index -- otherwise later pairs silently overwrite
    earlier outputs."""
    seen: dict = {}
    for _, _, stem in pairs:
        seen[stem] = seen.get(stem, 0) + 1
    if all(v == 1 for v in seen.values()):
        return pairs
    dupes = {s for s, v in seen.items() if v > 1}
    return [
        (p1, p2, f"{stem}_{i:06d}" if stem in dupes else stem)
        for i, (p1, p2, stem) in enumerate(pairs)
    ]


def _writers(formats):
    from ..flowviz import flowlib, io as fio

    def write(stem_path, flow):
        if "flo" in formats:
            fio.write_flo(stem_path + ".flo", flow)
        if "png" in formats:
            fio.write_flow_png(stem_path + "_flow.png", flow,
                               np.ones(flow.shape[:2], np.float32))
        if "viz" in formats:
            fio.write_image(stem_path + "_viz.png",
                            flowlib.flow_to_image(flow))

    return write


def _read_pair(pair):
    """Both frames of a pair as (H, W, 3) samples (grey tiled, alpha
    dropped), uint8 or uint16 as the file stores them."""
    from ..flowviz.io import read_samples

    out = []
    for path in pair[:2]:
        im = read_samples(path)
        if im.ndim == 2:
            im = np.stack([im] * 3, -1)
        out.append(im[..., :3])
    return out


def _rank_pairs(n_pairs: int, bs: int, world: int, rank: int) -> list:
    """This rank's (pair index, written) list: batch after batch of ``bs``,
    the last repeated to full size with its last pair (the JAX CLI's static
    batch), each split into ``world`` contiguous slices.  One rank alone
    runs a ragged last batch as it is."""
    if world == 1:
        return [(i, True) for i in range(n_pairs)]
    k = bs // world
    out = []
    for s0 in range(0, n_pairs, bs):
        for j in range(s0 + rank * k, s0 + (rank + 1) * k):
            out.append((min(j, n_pairs - 1), j < n_pairs))
    return out


def _main_rank(mesh, argv):
    return main(argv)


def main(argv=None) -> dict:
    """Returns {"pairs": done, "seconds": wall time with decode and
    writing, "model_seconds": time in the model's forward and the copy of
    its flow to the host}; with ``--devices N``, the pairs of all ranks
    and the slowest rank's times."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    pairs = _dedup_stems(collect_pairs(args))
    if not pairs:
        raise SystemExit("no input pairs found")
    if args.batch_size % args.devices:
        raise SystemExit("--devices must divide --batch_size")
    formats = {f.strip() for f in args.save.split(",") if f.strip()}
    unknown = formats - {"flo", "png", "viz"}
    if unknown:
        raise SystemExit(f"unknown --save formats: {sorted(unknown)}")
    os.makedirs(args.output_dir, exist_ok=True)

    import torch

    from ..models import device_arg, fetch_model, predict_flow
    from ..native import batch_u8_to_float01_pad
    from ..ops.interp import compute_pad, remove_pad
    from ..parallel.mesh import (
        current_mesh,
        gather_objects,
        launch,
        make_mesh,
    )

    device = device_arg(args.device)
    mesh = None
    if args.devices > 1:
        if current_mesh() is None:
            return launch(_main_rank, args.devices, argv,
                          device=torch.device(device).type)
        mesh = make_mesh(args.devices)
        device = mesh.device
    world, rank = (mesh.world, mesh.rank) if mesh else (1, 0)
    mine = _rank_pairs(len(pairs), args.batch_size, world, rank)
    model = fetch_model(args.flownet, pretrained_path=args.pretrained,
                        device=device)
    write = _writers(formats)
    bs = args.batch_size // world
    t0 = time.perf_counter()
    model_s = 0.0
    done = 0
    shape = None
    with concurrent.futures.ThreadPoolExecutor(args.prefetch_threads) as pool:
        # decode ahead in order, at most two batches beyond the current one
        ahead = collections.deque()
        todo = iter(mine)
        writes = []

        def run(batch):
            nonlocal done, model_s
            h0, w0 = batch[0][0].shape[:2]
            t, b, l, r = compute_pad(h0, w0, mode=args.pad_mode,
                                     multiple=model.size_multiple)
            imgs = []
            for k in range(2):
                x = np.stack([p[k] for p in batch])
                if x.dtype == np.uint8:  # one pass: u8 -> [0, 1], pad
                    x = batch_u8_to_float01_pad(x, h0 + t + b, w0 + l + r,
                                                t, l)
                else:  # 16-bit frames scale by their own maximum
                    x = np.pad(x.astype(np.float32) / np.iinfo(x.dtype).max,
                               ((0, 0), (t, b), (l, r), (0, 0)), mode="edge")
                imgs.append(torch.from_numpy(x).to(model.device))
            tm = time.perf_counter()
            flow = predict_flow(model, *imgs).float().cpu().numpy()
            model_s += time.perf_counter() - tm
            flow = remove_pad(flow, (t, b, l, r))
            for i, (idx, written) in enumerate(mine[done:done + len(batch)]):
                if written:
                    stem = os.path.join(args.output_dir, pairs[idx][2])
                    writes.append(pool.submit(write, stem, flow[i]))
            done += len(batch)

        batch = []
        while True:
            while len(ahead) < 2 * bs:
                item = next(todo, None)
                if item is None:
                    break
                ahead.append(pool.submit(_read_pair, pairs[item[0]]))
            if not ahead:
                break
            im1, im2 = ahead.popleft().result()
            shape = shape or im1.shape
            if im1.shape != shape or im2.shape != shape:
                raise SystemExit(
                    f"all frames must share one resolution: got {im1.shape} "
                    f"after {shape}")
            batch.append((im1, im2))
            if len(batch) == bs:
                run(batch)
                batch = []
        if batch:
            run(batch)
        for f in writes:
            f.result()
    dt = time.perf_counter() - t0
    ranks = gather_objects(mesh, (sum(w for _, w in mine), dt, model_s))
    done = sum(r[0] for r in ranks)
    dt, model_s = max(r[1] for r in ranks), max(r[2] for r in ranks)
    if rank == 0:
        print(f"{done} pairs -> {args.output_dir} "
              f"[{','.join(sorted(formats))}] in {dt:.2f}s "
              f"({done / dt:.2f} pairs/s with decode and writing; the model "
              f"{100 * model_s / dt:.1f} % of it"
              + (f"; {world} ranks" if world > 1 else "") + ")")
    return {"pairs": done, "seconds": dt, "model_seconds": model_s}


if __name__ == "__main__":
    main()
