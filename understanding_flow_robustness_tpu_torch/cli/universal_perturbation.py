"""Universal perturbation training CLI (counterpart of
``understanding_flow_robustness_tpu/cli/universal_perturbation.py``;
reference: global_attacks/universal_perturbation.py:31-158 argparse,
:161-353 run()).

Trains a single shared two-frame perturbation with n-step I-FGSM descent
toward the negated clean flow; per-epoch snapshots under
``<output>/.../perturbations/epoch_N.npy``, which ``run_perturb_model
--universal_evaluation`` reads.  The output-path taxonomy matches run()
(:196-208):
``output_path/kitti2015/<flownet>/universal/<mode>/<method>_<loss>/<norm>/
<lr>_<nstep>_<seed>[_addG]`` — the "kitti2015" segment is hardcoded
upstream regardless of --valset, reproduced as-is.  ``--device`` is the
card unless asked for ``cpu`` (no fallback; ``gpu`` means ``cuda``).  Runs
on ``--synthetic N`` batches, each epoch ending in the JAX CLI's data-free
report; the dataset branches (``SequenceFolder``, the per-epoch valset
sweep) raise naming ROADMAP A11 until the loaders are ported.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np
import torch

from ..attacks.losses import compute_epe
from ..attacks.universal import (
    UniversalConfig,
    make_universal_attack_step,
    train_universal_perturbation,
)
from ..utils import TermLogger, make_summary_writer, on_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", default="datasets/KITTI/2012_prepared",
                   help="prepared-KITTI SequenceFolder root "
                        "(universal_perturbation.py:240-247 hardcodes "
                        "datasets/KITTI/2012_prepared)")
    p.add_argument("--valset", default="kitti2015",
                   choices=["kitti2015", "kitti2012"])
    p.add_argument("--kitti_dir", default="datasets/KITTI/scene_flow")
    p.add_argument("--flownet", default="FlowNetC")
    p.add_argument("--pretrained_path", default="pretrained_models")
    p.add_argument("--perturb_method", default="ifgsm",
                   help="ifgsm | ifgm, optionally with the reference's "
                        "'di2' prefix (stripped like run() :226-227)")
    p.add_argument("--perturb_mode", default="both",
                   choices=["both", "left", "right"])
    p.add_argument("--output_norm", type=float, default=0.02)
    p.add_argument("--n_step", type=int, default=10)
    p.add_argument("--learning_rate", type=float, default=2e-3)
    p.add_argument("--momentum", type=float, default=0.47,
                   help="accepted for parity; the universal attack only "
                        "implements ifgsm/ifgm upstream "
                        "(universal_perturbation.py:475-489)")
    p.add_argument("--probability_diverse_input", type=float, default=0.0,
                   help="accepted for parity; unused by the universal "
                        "attack loop upstream")
    p.add_argument("--flow_loss", default="cossim",
                   choices=["cossim", "l2", "l1", "corr"])
    p.add_argument("--add_gaussian", action="store_true")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--epoch_size", type=int, default=100,
                   help="0 = full dataset per epoch (run() :288-289)")
    p.add_argument("--batch_size", type=int, default=4,
                   help="accepted for parity; the reference's loader "
                        "hardcodes batch_size=1 (run() :270-276) and so "
                        "does this CLI")
    p.add_argument("-j", "--workers", type=int, default=4,
                   help="accepted for parity; decode is synchronous here")
    p.add_argument("--n_height", type=int, default=256)
    p.add_argument("--n_width", type=int, default=640)
    p.add_argument("--image-size", type=int, nargs=2, default=None,
                   help="legacy alias for --n_height/--n_width")
    p.add_argument("--output_path", "--output", dest="output_path",
                   default="output/universal")
    p.add_argument("--log-output", type=bool, default=True,
                   help="flow/adv-flow viz images at the valset sweep "
                        "(universal_perturbation.py:569-620); accepted for "
                        "parity, the sweep is ROADMAP A11")
    p.add_argument("--log_terminal", action="store_true")
    p.add_argument("--training-output-freq", type=int, default=50,
                   help="TensorBoard train-image frequency; 0 disables "
                        "(universal_perturbation.py:399-442)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: the card unless asked for 'cpu' "
                        "(no fallback); 'gpu' means 'cuda'")
    p.add_argument("--DEBUG", action="store_true",
                   help="route under <output>/DEBUG + truncate the train "
                        "set to 8 samples (run() :180-181,263-266)")
    # the reference raises NotImplementedError for --disparity
    # (universal_perturbation.py:292)
    p.add_argument("--disparity", action="store_true")
    p.add_argument("--disparity_method", type=str, default="psmnet")
    p.add_argument("--disparity_model_restore_path", type=str, default="")
    p.add_argument("--seed", type=int, default=-1,
                   help="<= 0 draws a random unused seed like run() "
                        ":184-186")
    p.add_argument("--synthetic", type=int, default=0)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.disparity:
        raise NotImplementedError(
            "disparity is unimplemented in the reference too "
            "(universal_perturbation.py:292)")
    if args.flow_loss == "corr":
        raise NotImplementedError(
            "flow_loss='corr' is accepted but unimplemented upstream "
            "(perturb_model.py:129-142)")
    if not args.synthetic:
        raise NotImplementedError(
            "the KITTI loaders (SequenceFolder, the evaluation sets) are not "
            "ported yet (ROADMAP A11); use --synthetic N")
    if args.image_size is not None:  # legacy alias
        args.n_height, args.n_width = args.image_size
    if args.seed <= 0:
        args.seed = int(np.random.randint(0, int(1e4)))
    np.random.seed(args.seed)

    # 'di2' prefix strips to the base method (run() :226-227); the diverse
    # transform itself is not applied by the universal attack upstream
    if "di2" in args.perturb_method:
        args.perturb_method = args.perturb_method[3:]

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

    def predict_eval(a, b):
        return predict_flow(model, a, b)

    def predict(a, b):
        return predict_flow_differentiable(model, a, b)

    cfg = UniversalConfig(
        perturb_method=args.perturb_method, perturb_mode=args.perturb_mode,
        output_norm=args.output_norm, n_step=args.n_step,
        learning_rate=args.learning_rate, flow_loss=args.flow_loss,
        add_gaussian=args.add_gaussian,
    )
    attack_step = make_universal_attack_step(predict, cfg)

    h, w = args.n_height, args.n_width
    # output taxonomy, universal_perturbation.py:196-208
    folder_name = f"{args.learning_rate}_{args.n_step}_{args.seed}"
    if args.add_gaussian:
        folder_name += "_addG"
    out_dir = os.path.join(
        args.output_path, *( ["DEBUG"] if args.DEBUG else [] ),
        "kitti2015", args.flownet, "universal", args.perturb_mode,
        f"{args.perturb_method}_{args.flow_loss}", str(args.output_norm),
        folder_name,
    )
    print(f"Save everything to {out_dir}")
    os.makedirs(out_dir, exist_ok=True)
    # fresh perturbations dir like run() :215-220
    shutil.rmtree(os.path.join(out_dir, "perturbations"), ignore_errors=True)
    with open(os.path.join(out_dir, "args.json"), "w") as f:
        json.dump(vars(args), f, indent=2)
    train_writer = make_summary_writer(os.path.join(out_dir, "train"))

    def batches():
        rng = np.random.RandomState(args.seed)
        n = 8 if args.DEBUG else args.synthetic
        for _ in range(n):
            yield (rng.rand(1, h, w, 3).astype(np.float32),
                   rng.rand(1, h, w, 3).astype(np.float32))

    logger = None
    if args.log_terminal:
        logger = TermLogger(n_epochs=args.epochs,
                            train_size=args.epoch_size or 0,
                            valid_size=0, attack_size=args.n_step)

    def on_epoch_end(epoch, n0, n1):
        # the JAX CLI's data-free report when no valset is found: EPE
        # degradation vs the clean prediction on one train-style batch
        # (the valset sweep, universal_perturbation.py:533-620, is A11)
        tgt, fut = (on_device(x, device) for x in next(iter(batches())))
        clean = predict_eval(tgt, fut)
        gt = torch.cat([clean, torch.ones_like(clean[..., :1])], -1)
        adv = predict_eval(torch.clamp(tgt + on_device(n0, device), 0, 1),
                          torch.clamp(fut + on_device(n1, device), 0, 1))
        print(f"epoch {epoch}: |noise|_max {np.abs(n0).max():.4f}  "
              f"adv-EPE vs clean flow {float(compute_epe(gt, adv)):.3f}")

    n_train_iter = [0]

    def on_train_batch(tgt, fut, n0, n1):
        # TB train images every training_output_freq iters
        # (universal_perturbation.py:399-442)
        i = n_train_iter[0]
        n_train_iter[0] += 1
        if (args.training_output_freq <= 0 or train_writer is None
                or i % args.training_output_freq):
            return
        train_writer.add_image("train tgt image",
                               tgt[0].cpu().numpy().transpose(2, 0, 1), i)
        for name, n in (("universal perturbation 0", n0),
                        ("universal perturbation 1", n1)):
            x = n[0].cpu().numpy()
            lo, hi = x.min(), x.max()
            train_writer.add_image(
                name, ((x - lo) / (hi - lo + 1e-12)).transpose(2, 0, 1), i)

    n0, n1 = train_universal_perturbation(
        predict_eval, attack_step, batches, (1, h, w, 3), cfg,
        epochs=args.epochs, epoch_size=args.epoch_size, save_dir=out_dir,
        rng=np.random.RandomState(args.seed), on_epoch_end=on_epoch_end,
        on_batch_end=on_train_batch, logger=logger, device=device,
    )
    if train_writer is not None:
        train_writer.close()
    print(f"saved perturbations under {out_dir}/perturbations")
    return n0, n1


if __name__ == "__main__":
    main()
