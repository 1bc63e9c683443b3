"""Training CLI for RAFT (counterpart of the JAX package's ``ufr-train``,
``understanding_flow_robustness_tpu/cli/train.py``; reference:
training/train.py:355-636).

Takes the flags the RAFT path reads, adversarial training's among them
(``--adversarial``: each batch attacked in eval mode and trained on
together with its adversarial pair, 3 updates a batch; ``--arbitrary_gt``:
the attack targets a random sample's ground truth).  ``--synthetic N``
trains on N random batches made with numpy from ``--seed``, as the JAX CLI
does; the dataset stages (the KITTI pairs of adversarial training among
them), the other model families and multi-device training raise with the
ROADMAP item that ports them.

    python -m understanding_flow_robustness_tpu_torch.cli.train --model RAFT \\
        --stage chairs --num_steps 100 --batch_size 4 \\
        --image_size 288 960 --mixed_precision --synthetic 8
    python -m understanding_flow_robustness_tpu_torch.cli.train --model RAFT \\
        --adversarial --batch_size 1 --synthetic 4 --num_steps 3
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..attacks.global_attacks import PerturbConfig
from ..models import FLOWNET_IDS, NOT_PORTED, fetch_model
from ..training import TrainConfig, train
from ..training.checkpoint import load_weights

# model IDs the port cannot train yet, by the ROADMAP item that ports them:
# the unbuilt ones, and the FlowNet family with FlowNet2, SpyNet, PWC-Net
# and RAFT's FlowNetC-encoder variant, which serve but do not train
_NOT_TRAINED = {**NOT_PORTED, **dict.fromkeys(FLOWNET_IDS, "A7"),
                "FlowNet2": "A7", "SpyNet": "A9", "PWCNet": "A9",
                "PWCNet_adv_ifgsm_l2_002": "A9",
                "RAFT_FlowNetCEncoder_WoContext": "A10"}
# flags of the JAX CLI that belong to paths not ported yet
_OTHER_FAMILIES = {
    "flowNetC": "A7", "pwc": "A9", "small": "A10", "validation": "A11",
    "n_devices": "A13",
}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--name", default="flow", help="experiment name")
    p.add_argument("--model", default="RAFT", help="ported RAFT model ID")
    p.add_argument("--stage", default="chairs",
                   choices=["chairs", "things", "sintel", "kitti",
                            "kitti2015", "kitti2012"],
                   help="training stage; batch norm is frozen for every "
                        "stage but chairs (train.py:130-137)")
    p.add_argument("--restore_ckpt", default=None,
                   help="weights-only .pth to start from")
    # the reference's defaults (training/train.py:370-373)
    p.add_argument("--lr", type=float, default=0.000125)
    p.add_argument("--num_steps", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--image_size", type=int, nargs=2, default=[256, 640])
    p.add_argument("--wdecay", type=float, default=1e-4)
    p.add_argument("--epsilon", type=float, default=1e-8)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=0.8)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--val_freq", type=int, default=None,
                   help="checkpoint every this many batches; 1000 with "
                        "--adversarial, else 5000 (train.py:143-148)")
    p.add_argument("--checkpoint_dir", "--ckpt_dir", dest="checkpoint_dir",
                   default="checkpoints")
    p.add_argument("--mixed_precision", action="store_true",
                   help="bf16 autocast (the registry's RAFT has it already)")
    p.add_argument("--add_noise", action="store_true",
                   help="per-batch gaussian image noise, stdv ~ U(0, 5) on "
                        "the 0-255 scale (train.py:162-169)")
    p.add_argument("--no_excluding", action="store_true",
                   help="accepted for parity; a dead no-op upstream too")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on; the card unless asked "
                        "for 'cpu' (no fallback)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N random batches (no dataset)")
    # adversarial training (train.py:171-225) and its attack's flags, with
    # the JAX CLI's defaults (cli/train.py:86-101)
    p.add_argument("--adversarial", "--adv_train", dest="adversarial",
                   action="store_true")
    p.add_argument("--adv_method", "--perturb_method", dest="adv_method",
                   default="ifgsm")
    p.add_argument("--perturb_mode", default="both",
                   choices=["both", "left", "right"])
    p.add_argument("--adv_norm", "--output_norm", dest="adv_norm",
                   type=float, default=0.02)
    p.add_argument("--adv_loss", "--flow_loss", dest="adv_loss",
                   default="l2")
    p.add_argument("--perturb_n_step", type=int, default=40)
    p.add_argument("--perturb_learning_rate", type=float, default=2e-3)
    p.add_argument("--perturb_momentum", type=float, default=0.47)
    p.add_argument("--probability_diverse_input", type=float, default=0.0)
    p.add_argument("--arbitrary_gt", action="store_true",
                   help="targeted adversarial training toward a random "
                        "sample's ground truth (train.py:151,188-199)")
    for flag in ("--flowNetC", "--pwc", "--small"):
        p.add_argument(flag, action="store_true",
                       help="not ported yet; raises")
    p.add_argument("--validation", nargs="+", default=None,
                   help="not ported yet; raises")
    p.add_argument("--n_devices", "--gpus", dest="n_devices", type=int,
                   default=None, help="not ported yet; raises")
    return p


def _synthetic_batches(n: int, batch_size: int, h: int, w: int, seed: int):
    """The JAX CLI's --synthetic batches (cli/train.py:361-380)."""
    def batches():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            yield {
                "image1": rng.rand(batch_size, h, w, 3).astype(np.float32),
                "image2": rng.rand(batch_size, h, w, 3).astype(np.float32),
                "flow": rng.randn(batch_size, h, w, 2).astype(np.float32),
                "valid": np.ones((batch_size, h, w), np.float32),
            }
    return batches


def main(argv=None) -> dict:
    """Run the CLI; returns {"total_steps": batches taken, "history":
    metrics of each batch of this run}."""
    args = build_parser().parse_args(argv)
    other = [f for f, item in _OTHER_FAMILIES.items() if getattr(args, f)]
    if other:
        raise NotImplementedError(
            f"--{other[0]} is not ported yet (ROADMAP "
            f"{_OTHER_FAMILIES[other[0]]})")
    if args.model in _NOT_TRAINED:
        raise NotImplementedError(
            f"training --model {args.model} is not ported yet (ROADMAP "
            f"{_NOT_TRAINED[args.model]})")
    if not args.synthetic:
        what = ("--adversarial's KITTI pairs (training/utils.py:245-289)"
                if args.adversarial else f"--stage {args.stage}")
        raise NotImplementedError(
            f"{what} needs its dataset loaders (ROADMAP A11); use "
            "--synthetic N")
    if args.val_freq is None:  # train.py:143-148
        args.val_freq = 1000 if args.adversarial else 5000

    kwargs = {"iters": args.iters}
    if args.mixed_precision:
        kwargs["mixed_precision"] = True
    model = fetch_model(args.model, device=args.device, seed=args.seed,
                        **kwargs)
    n_params = sum(p.numel() for p in model.module.parameters())
    print(f"Parameter Count: {n_params}")  # training/train.py:102
    if args.restore_ckpt:
        load_weights(args.restore_ckpt, model.module)

    cfg = TrainConfig(
        name=args.name, stage=args.stage,
        image_size=tuple(args.image_size), batch_size=args.batch_size,
        lr=args.lr, wdecay=args.wdecay, epsilon=args.epsilon, clip=args.clip,
        gamma=args.gamma, num_steps=args.num_steps, val_freq=args.val_freq,
        checkpoint_dir=os.path.join(args.checkpoint_dir, args.name),
        freeze_bn=args.stage != "chairs",  # train.py:130-137, RAFT
        adversarial=args.adversarial,
        adv_config=PerturbConfig(
            perturb_method=args.adv_method, flow_loss=args.adv_loss,
            output_norm=args.adv_norm, perturb_mode=args.perturb_mode,
            n_step=args.perturb_n_step,
            learning_rate=args.perturb_learning_rate,
            momentum=args.perturb_momentum,
            probability_diverse_input=args.probability_diverse_input,
            targeted=args.arbitrary_gt),  # train.py:183
        seed=args.seed, add_noise=args.add_noise,
        arbitrary_gt=args.arbitrary_gt, not_excluding=args.no_excluding)
    h, w = args.image_size
    history = []

    def sample_gt_fn(rng):
        # --arbitrary_gt's random target in synthetic mode (cli/train.py:
        # 377-381 of the JAX package)
        flow = rng.randn(args.batch_size, h, w, 2).astype(np.float32)
        return flow, np.ones((args.batch_size, h, w), np.float32)

    def logger(step, metrics):
        history.append(metrics)
        if step % 100 == 0 or step < 10:
            print(f"step {step}: " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()), flush=True)

    steps = train(cfg, model,
                  _synthetic_batches(args.synthetic, args.batch_size, h, w,
                                     args.seed),
                  logger=logger, sample_gt_fn=sample_gt_fn)
    print(f"training done at step {steps}")
    return {"total_steps": steps, "history": history}


if __name__ == "__main__":
    main()
