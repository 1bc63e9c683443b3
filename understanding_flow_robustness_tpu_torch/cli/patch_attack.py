"""Universal adversarial patch training CLI (counterpart of
``understanding_flow_robustness_tpu/cli/patch_attack.py``; reference:
patch_attacks/main.py:35-343).

Optimizes a circular/square patch against a flow net over 3-frame
sequences; per epoch the patch is saved under
``<output>/<name>/patches/epoch_N.npy`` and validated (clean vs
adversarial EPE/cossim).  The same flags as the JAX CLI, plus ``--device``:
the card unless asked for ``cpu`` (no fallback; ``gpu`` means ``cuda``).
Trains on ``SequenceFolder(--data)`` (prepared KITTI raw, JPEG frames) and
validates on ``--valset`` under ``--kitti-data`` at 384x1280, or on
``--synthetic N`` random frames; ``--patch-path``/``--mask-path`` start from
image files.

Example:
  python -m understanding_flow_robustness_tpu_torch.cli.patch_attack \\
      --flownet FlowNetC --patch-size 0.1 --epochs 2 --synthetic 4
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..attacks.patch import (
    init_patch_circle,
    init_patch_from_image,
    init_patch_square,
)
from ..attacks.patch_attack import (
    PatchAttackConfig,
    make_patch_attack_step,
    train_patch_epoch,
    validate_patch,
)
from ..flowviz.io import write_image
from ..utils.meters import AverageMeter, make_summary_writer


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", type=str, default="datasets/KITTI/2012_prepared",
                   help="prepared KITTI raw root (SequenceFolder)")
    p.add_argument("--kitti-data", type=str, default="datasets/KITTI/scene_flow",
                   help="KITTI scene-flow root for validation")
    p.add_argument("--valset", type=str, default="kitti2015",
                   choices=["kitti2012", "kitti2015"])
    p.add_argument("--flownet", type=str, default="FlowNetC")
    p.add_argument("--pretrained_path", type=str, default="pretrained_models",
                   help="a checkpoint file; absent means seeded random "
                        "weights")
    p.add_argument("--patch-type", type=str, default="circle",
                   choices=["circle", "square"])
    p.add_argument("--patch-size", type=float, default=0.01,
                   help="patch fraction of image size (main.py --patch-size)")
    p.add_argument("--image-size", type=int, default=384)
    p.add_argument("--lr", type=float, default=1e2)
    p.add_argument("--alpha", type=float, default=0.0)
    p.add_argument("--max-count", type=int, default=2)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--epoch-size", type=int, default=100)
    p.add_argument("--l2", action="store_true", help="L2 loss (else cossim)")
    p.add_argument("--norotate", action="store_true")
    p.add_argument("--patch-path", type=str, default="",
                   help="initialize patch from this image (main.py:48)")
    p.add_argument("--mask-path", type=str, default="",
                   help="initialize mask from this image (main.py:51)")
    p.add_argument("--DEBUG", action="store_true",
                   help="truncate the train set to 8 samples (main.py:238)")
    p.add_argument("-j", "--workers", type=int, default=4,
                   help="reference DataLoader workers; accepted for parity")
    p.add_argument("--log-terminal", action="store_true",
                   help="multi-bar terminal UI (logger.py TermLogger)")
    p.add_argument("--log-output", action="store_true",
                   help="save each epoch's patch as a PNG")
    p.add_argument("--log-summary", default="progress_log_summary.csv",
                   help="accepted for reference parity; the reference "
                        "parses but never writes it (main.py:136-141)")
    p.add_argument("--log-full", default="progress_log_full.csv",
                   help="accepted for reference parity; unused upstream "
                        "too (main.py:142-147)")
    p.add_argument("-b", "--batch-size", type=int, default=4,
                   help="accepted for parity; the reference's loaders "
                        "hardcode batch_size=1 (main.py:240-262) and so "
                        "does this CLI")
    p.add_argument("-e", "--evaluate", action="store_true",
                   help="accepted for parity; args.evaluate is declared "
                        "but never read upstream (main.py:103-109)")
    p.add_argument("-f", "--training-output-freq", type=int, default=100,
                   help="TensorBoard train-image frequency "
                        "(main.py:463-519); 0 disables")
    p.add_argument("--print-freq", type=int, default=10,
                   help="accepted for reference parity; unused upstream")
    p.add_argument("--momentum", type=float, default=0.9,
                   help="accepted for reference parity; the attack update "
                        "is hand-coded, the flag is dead upstream "
                        "(main.py:88-92)")
    p.add_argument("--beta", type=float, default=0.999,
                   help="accepted for reference parity; dead upstream")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="accepted for reference parity; dead upstream")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--name", type=str, default="patch_run")
    p.add_argument("--output", type=str, default="output/patch_attacks")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--synthetic-size", type=int, nargs=2, default=(128, 192))
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: the card unless asked for 'cpu' "
                        "(no fallback); 'gpu' means 'cuda'")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)

    from ..models import (
        checkpoint_arg,
        device_arg,
        fetch_model,
        predict_flow,
        predict_flow_differentiable,
    )

    device = device_arg(args.device)

    model = fetch_model(
        args.flownet,
        pretrained_path=checkpoint_arg(args.pretrained_path, args.flownet),
        device=device)

    def predict(a, b):
        return predict_flow(model, a, b)

    out_dir = os.path.join(args.output, args.name)
    os.makedirs(os.path.join(out_dir, "patches"), exist_ok=True)
    with open(os.path.join(out_dir, "args.json"), "w") as f:
        json.dump(vars(args), f, indent=2)
    writer = make_summary_writer(os.path.join(out_dir, "tb"))

    if args.patch_type == "circle":
        patch, mask, patch_shape = init_patch_circle(
            args.image_size, args.patch_size
        )
    else:
        patch, patch_shape = init_patch_square(args.image_size, args.patch_size)
        mask = np.ones(patch_shape, np.float32)
    if args.patch_path:
        # resume/warm-start from an image pair (main.py:287-291)
        patch, mask, patch_shape = init_patch_from_image(
            args.patch_path, args.mask_path, args.image_size,
            args.patch_size,
        )
    patch_init = patch.copy()

    cfg = PatchAttackConfig(
        lr=args.lr, alpha=args.alpha, max_count=args.max_count, l2=args.l2
    )
    attack_step = make_patch_attack_step(
        lambda a, b: predict_flow_differentiable(model, a, b), cfg)

    def train_batches():
        if args.synthetic:
            rng = np.random.RandomState(args.seed)
            h, w = args.synthetic_size
            n = min(args.synthetic, 8) if args.DEBUG else args.synthetic
            for _ in range(n):
                yield (rng.rand(1, h, w, 3).astype(np.float32),
                       rng.rand(1, h, w, 3).astype(np.float32))
            return
        from ..data import (
            Compose,
            RandomHorizontalFlip,
            RandomScaleCrop,
            SequenceFolder,
            ToFloat01,
        )

        ds = SequenceFolder(args.data, seed=args.seed, train=True,
                            sequence_length=3)
        # the JAX package's SequenceFolder re-seeds the global np.random,
        # which its scale-crop and this CLI's patch placement share
        np.random.seed(args.seed)
        # the reference's train crop is SQUARE and keyed on the patch
        # size, not --image-size: 384x384 iff int(patch_size*384) == 153,
        # else 256x256 (patch_attacks/main.py:203-206)
        side = 384 if int(args.patch_size * 384) == 153 else 256
        ds.transform = Compose([
            RandomHorizontalFlip(ds.rng),
            RandomScaleCrop(side, side, np.random),
            ToFloat01(),
        ])
        n = min(len(ds), 8) if args.DEBUG else len(ds)  # main.py:238-241
        for i in range(n):
            tgt, refs, _ = ds[i]
            yield tgt[None], refs[1][None]

    def val_samples():
        if args.synthetic:
            rng = np.random.RandomState(args.seed + 1)
            h, w = args.synthetic_size
            for _ in range(max(args.synthetic // 2, 1)):
                tgt = rng.rand(1, h, w, 3).astype(np.float32)
                fut = rng.rand(1, h, w, 3).astype(np.float32)
                gt = np.zeros((1, h, w, 3), np.float32)
                gt[..., 2] = 1
                yield tgt, tgt, fut, gt
            return
        from argparse import Namespace

        from ..data import get_evaluation_set

        ds = get_evaluation_set(args.valset, Namespace(
            img_height=384, img_width=1280, kitti_dir=args.kitti_data,
        ))
        for i in range(len(ds)):
            past, tgt, fut, gt_flow, _, _, _ = ds[i]
            yield past[None], tgt[None], fut[None], gt_flow[None]

    term = None
    if args.log_terminal:
        from ..utils.meters import TermLogger

        term = TermLogger(n_epochs=args.epochs, train_size=args.epoch_size,
                          valid_size=0, attack_size=args.max_count)

    errors = AverageMeter(i=4)
    for epoch in range(args.epochs):
        if term is not None:
            term.epoch_bar.update(epoch)

        def on_batch(i, tgt, adv_tgt, patch_canvas, loss):
            # TB train images every training_output_freq iters
            # (main.py:463-519)
            if (args.training_output_freq <= 0 or writer is None
                    or i % args.training_output_freq):
                return
            step = epoch * (args.epoch_size or 1) + i
            writer.add_scalar("train/attack_loss", loss, step)
            writer.add_image("train tgt image",
                             tgt[0].transpose(2, 0, 1), step)
            writer.add_image("train adv tgt image",
                             np.clip(adv_tgt[0], 0, 1).transpose(2, 0, 1),
                             step)

        patch, mask, patch_init, patch_shape = train_patch_epoch(
            attack_step, predict, patch, mask, patch_init, patch_shape,
            train_batches(), patch_type=args.patch_type,
            norotate=args.norotate, epoch_size=args.epoch_size,
            on_batch=on_batch, device=device,
        )
        metrics = validate_patch(
            predict, patch, mask, patch_shape, val_samples(),
            patch_type=args.patch_type, norotate=args.norotate, device=device,
        )
        errors.update([metrics["epe"], metrics["adv_epe"],
                       metrics["cos_sim"], metrics["adv_cos_sim"]])
        np.save(os.path.join(out_dir, "patches", f"epoch_{epoch}.npy"), patch)
        if args.log_output:
            # qualitative dump of the current patch (main.py:699 logs viz
            # images to TensorBoard; the patch is saved as a PNG)
            write_image(os.path.join(out_dir, "patches", f"epoch_{epoch}.png"),
                        (np.clip(patch[0], 0, 1) * 255).astype(np.uint8))
        if writer is not None:
            for k, v in metrics.items():
                writer.add_scalar(f"val/{k}", v, epoch)
        print(f"epoch {epoch}: epe {metrics['epe']:.3f} "
              f"adv_epe {metrics['adv_epe']:.3f} "
              f"cossim {metrics['cos_sim']:.3f} "
              f"adv_cossim {metrics['adv_cos_sim']:.3f}")
    if errors.count:
        avg = errors.avg
        print(f"avg over {args.epochs} epochs: epe {avg[0]:.3f} "
              f"adv_epe {avg[1]:.3f} cossim {avg[2]:.3f} "
              f"adv_cossim {avg[3]:.3f}")
    if writer is not None:
        writer.close()
    return patch, mask


if __name__ == "__main__":
    main()
