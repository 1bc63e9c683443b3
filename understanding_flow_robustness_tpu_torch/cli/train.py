"""Training CLI (counterpart of the JAX package's ``ufr-train``,
``understanding_flow_robustness_tpu/cli/train.py``; reference:
training/train.py:355-636).

Trains RAFT, the FlowNet family, FlowNet2, SpyNet and PWC-Net: ``--model``
takes a registry ID, or the reference's architecture flags pick one
(``--flowNetC`` with ``--larger_field`` / ``--flexible_larger_field``,
``--kernel_size``, ``--numReps``, ``--dilation``, ``--div_flow``;
``--pwc``).  The other families train on their per-level flows with the
loss's FlowNetC (and PWC) branch, ``--multiscaleEPE`` for the multiscale
EPE, ``--flownetc_weighing`` for FlowNetC's scale weights; batch norm is
frozen after the chairs stage for RAFT only.  Adversarial training
(``--adversarial``: each batch attacked in eval mode and trained on
together with its adversarial pair, 3 updates a batch; ``--arbitrary_gt``:
the attack targets a random sample's ground truth) runs on every family.  ``--synthetic N``
trains on N random batches made with numpy from ``--seed``, as the JAX CLI
does; without it the stage's dataset is read from disk: ``--stage
chairs|things|sintel|kitti`` through ``data.fetch_dataset`` (``--data_roots``
JSON, ``--trans_rot``, ``--online_subset``) and ``--stage
kitti2015|kitti2012`` (adversarial training's KITTI pairs) from
``--data_list_dir``'s path lists, batches from the threaded
``data.DataLoader``.  ``--validation kitti|sintel|chairs`` runs at every
``--val_freq`` on the default dataset roots, skipped when they are absent.
RAFT trains in every configuration of the JAX CLI: ``--small``, ``--fnorm``,
``--cnorm``, ``--corr_levels``, ``--corr_radius`` (1..7 on the card),
``--no_separate_context``, ``--flowNetCEnc``, ``--compute_spatial``,
``--alternate_corr`` (the on-demand lookup, ``corr_impl="alt"``),
``--model_kwargs`` (a JSON dict of module keyword arguments) and ``--DEBUG``
(3 iterations, no checkpoints), and RAFT_FlowNetCEncoder_WoContext by its
ID.  The flags the reference parses but never builds raise, as in the JAX
CLI.  ``--restore_ckpt`` starts from a weights-only ``.pth`` or a flax
``.msgpack`` (the JAX trainer's params-only export, or ``ufr-convert``'s
full variables).  ``--n_devices N`` (``--gpus``) trains in N ranks, one
process per device (``parallel.launch``, each rank running this CLI on the
same arguments): N cards, or N CPU ranks with ``--device cpu``; more CUDA
ranks than cards raise.  Without it the CLI takes the largest divisor of
``--batch_size`` up to the card count, as the JAX CLI does (1 on the CPU).

    python -m understanding_flow_robustness_tpu_torch.cli.train --model RAFT \\
        --stage kitti --num_steps 100 --batch_size 4 \\
        --image_size 288 960 --mixed_precision \\
        --data_roots '{"kitti": "datasets/KITTI/2015"}'
    python -m understanding_flow_robustness_tpu_torch.cli.train --model RAFT \\
        --adversarial --stage kitti2015 --batch_size 1 --num_steps 3
    python -m understanding_flow_robustness_tpu_torch.cli.train --flowNetC \\
        --flexible_larger_field --kernel_size 3 --numReps 3 --synthetic 4
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..attacks.global_attacks import PerturbConfig
from ..models import device_arg, fetch_model
from ..parallel.mesh import current_mesh, is_rank0, launch
from ..training import TrainConfig, train
from ..training.checkpoint import load_variables, load_weights
from ..training.trainer import n_devices_for

# flags the reference parses but whose model construction is commented out
# (training/train.py:66-84), never read, or crashes upstream
# (--update_no_motion_downsampling, models/raft/update.py:110-119): the
# JAX CLI accepts them and raises when one is set (cli/train.py:161-192)
_DEAD_FLAGS = ("--flowNetCFlexible", "--larger_field2", "--relu_wo_out",
               "--net_relu", "--no_residuals", "--no_sep_gru", "--iterative",
               "--single", "--pinard", "--predict_bias", "--raft_leaky_relu",
               "--raft_no_out_conv", "--corr_conv", "--first_conv_5",
               "--relu", "--update_no_motion_downsampling",
               "--flowNetC_separateContext", "--flowNetC_raftEncoder")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--name", default="flow", help="experiment name")
    p.add_argument("--model", default="RAFT",
                   help="registry ID; the architecture flags below take "
                        "precedence")
    p.add_argument("--stage", default="chairs",
                   choices=["chairs", "things", "sintel", "kitti",
                            "kitti2015", "kitti2012"],
                   help="training stage; RAFT's batch norm is frozen for "
                        "every stage but chairs (train.py:130-137)")
    p.add_argument("--restore_ckpt", default=None,
                   help="weights to start from: a weights-only .pth, or a "
                        "flax .msgpack (params only, the JAX trainer's "
                        "export, or full variables)")
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
                        "--adversarial, 100 with --finetune, else 5000 "
                        "(train.py:143-148)")
    p.add_argument("--checkpoint_dir", "--ckpt_dir", dest="checkpoint_dir",
                   default="checkpoints")
    p.add_argument("--mixed_precision", action="store_true",
                   help="bf16 autocast (the registry's RAFT and PWC-Net "
                        "have it already; the FlowNet family, FlowNet2 and "
                        "SpyNet take none and raise)")
    p.add_argument("--multiscaleEPE", action="store_true",
                   help="the multiscale EPE loss instead of the default "
                        "sequence loss (train.py:245-264)")
    p.add_argument("--flownetc_weighing", action="store_true",
                   help="FlowNetC's per-scale loss weights (train.py:448, "
                        "utils.py:119)")
    p.add_argument("--finetune", action="store_true",
                   help="finetune mode: val_freq 100 (train.py:145-148)")
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
    # the reference's get_model() architecture flags (train.py:55-92)
    p.add_argument("--flowNetC", action="store_true",
                   help="train a FlowNetC-family model (train.py:489)")
    p.add_argument("--flexible_larger_field", action="store_true",
                   help="FlowNetC_flexible_larger_field (train.py:503)")
    p.add_argument("--larger_field", action="store_true",
                   help="FlowNetC_larger_field (train.py:497)")
    p.add_argument("--kernel_size", type=int, default=5,
                   help="flexible FlowNetC kernel size (train.py:508)")
    p.add_argument("--numReps", type=int, default=0,
                   help="flexible FlowNetC conv repetitions (train.py:511)")
    p.add_argument("--dilation", type=int, default=1,
                   help="flexible FlowNetC dilation (train.py:528)")
    p.add_argument("--div_flow", type=float, default=1,
                   help="flow scaling of the FlowNetC variants "
                        "(train.py:446)")
    p.add_argument("--pwc", action="store_true",
                   help="train PWC-Net (train.py:531)")
    p.add_argument("--pwcflex", action="store_true",
                   help="PWCNetFlex (train.py:89): missing from the "
                        "reference itself; raises")
    p.add_argument("--pwc_correlations", nargs="+", default=None,
                   help="PWCNetFlex's per-level correlation switches "
                        "(train.py:534; only meaningful with --pwcflex)")
    # RAFT's architecture flags (train.py:395-436; cli/train.py:135-150)
    p.add_argument("--small", "--raft_small", dest="small",
                   action="store_true", help="small RAFT (train.py:424)")
    p.add_argument("--fnorm", default="instance",
                   choices=["none", "batch", "group", "instance"],
                   help="RAFT feature-encoder norm (train.py:401)")
    p.add_argument("--cnorm", default="batch",
                   choices=["none", "batch", "group", "instance"],
                   help="RAFT context-encoder norm (train.py:407)")
    p.add_argument("--no_separate_context", action="store_true",
                   help="RAFT's conv_redir context variant")
    p.add_argument("--flowNetCEnc", action="store_true",
                   help="RAFT's FlowNetC encoder variant")
    p.add_argument("--compute_spatial", action="store_true",
                   help="RAFT's spatial-correlation mode")
    p.add_argument("--corr_levels", type=int, default=4)
    p.add_argument("--corr_radius", type=int, default=4)
    p.add_argument("--alternate_corr", action="store_true",
                   help="RAFT's on-demand correlation (train.py:436): the "
                        "alt lookup (corr_impl='alt'), the default already; "
                        "this forces it")
    p.add_argument("--model_kwargs", default=None,
                   help="JSON dict of extra module keyword arguments")
    p.add_argument("--DEBUG", action="store_true",
                   help="iters=3, no checkpoint writes "
                        "(train.py:140-141,235,286-289)")
    for flag in _DEAD_FLAGS:
        p.add_argument(flag, action="store_true",
                       dest=f"dead_{flag.lstrip('-')}",
                       help="dead in the reference (train.py:66-84); raises")
    p.add_argument("--raft_kernel_size", type=int, default=3,
                   help="dead in the reference; raises if != 3")
    p.add_argument("--flowNetC_corrDepth", type=int, default=None,
                   help="dead in the reference; raises if set")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="encoder dropout (train.py:398; the reference's "
                        "default 0); > 0 raises")
    p.add_argument("--validation", nargs="+", default=None,
                   choices=["chairs", "sintel", "kitti"],
                   help="validation sets run at every val_freq "
                        "(train.py:302-313); skipped when absent")
    p.add_argument("--data_list_dir",
                   default="datasets/KITTI/global_attacks/training",
                   help="path-list dir for the kitti2015/kitti2012 pair "
                        "stages (setup_dataset_kitti.py output)")
    p.add_argument("--data_roots", default=None,
                   help="JSON dict of dataset roots (chairs, things, "
                        "sintel, kitti)")
    p.add_argument("--trans_rot", action="store_true",
                   help="translation/rotation augmentation "
                        "(augmentor.py:88-165)")
    p.add_argument("--online_subset", type=int, nargs="+", default=None,
                   help="train on a fixed subset of dataset indices "
                        "(training/utils.py:275-283)")
    p.add_argument("--n_devices", "--gpus", dest="n_devices", type=int,
                   default=None,
                   help="data-parallel ranks, one process per device (the "
                        "reference's DataParallel GPUs); default: the "
                        "largest divisor of --batch_size up to the card "
                        "count")
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


class _PairView:
    """(img0, img1, gt_small, gt_full) of ``KittiPairDataset`` -> the
    loader's 4-tuple with the small GT as the training target
    (kitti_datasets.py:112-118 finetune return; the full-res GT only feeds
    the reference's epe_attacked metric)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        img0, img1, gt_small, _ = self.ds[i]
        # DataLoader._collate divides images by 255
        return (img0 * 255.0, img1 * 255.0, gt_small[..., :2],
                gt_small[..., 2])


def _dataset(args):
    """The stage's training dataset (cli/train.py:383-436 of the JAX
    package)."""
    from ..data import Subset, fetch_dataset
    from ..data.validation import KittiPairDataset

    if args.stage in ("kitti2015", "kitti2012"):
        # the reference's adversarial-training data path
        # (training/utils.py:245-289): Scale'd KITTI pairs, batch 1
        if args.adversarial and args.batch_size != 1:
            raise ValueError("--adversarial on KITTI pairs takes "
                             "--batch_size 1 (training/utils.py:249)")
        dataset = _PairView(KittiPairDataset.from_lists(
            args.data_list_dir,
            year="2015" if args.stage == "kitti2015" else "2012",
            split="train", n_height=args.image_size[0],
            n_width=args.image_size[1]))
    else:
        if args.adversarial:
            raise SystemExit(
                "--adversarial needs --stage kitti2015 or kitti2012 (the "
                "reference's adv_train branch, training/utils.py:245-272, "
                "raises NotImplementedError for other stages)")
        roots = json.loads(args.data_roots) if args.data_roots else None
        dataset = fetch_dataset(args.stage, tuple(args.image_size),
                                trans_rot=args.trans_rot, roots=roots)
    if args.online_subset is not None:
        # train on a fixed index subset (training/utils.py:275-276)
        dataset = Subset(dataset, list(args.online_subset))
    return dataset


def _validate_fn(model, valsets):
    """``--validation``'s sets at every val_freq checkpoint, on the default
    dataset roots (cli/train.py:444-470 of the JAX package), with the
    module in eval mode; a set that is not on disk is skipped."""
    from ..data.datasets import KITTI, FlyingChairs, MpiSintel
    from ..training import evaluate as ev

    def validate(module, step):
        training = module.training
        module.eval()
        try:
            for valset in valsets:
                try:
                    if valset == "kitti":
                        res = ev.validate_kitti(model, KITTI(split="training"))
                    elif valset == "sintel":
                        res = ev.validate_sintel(
                            model, lambda d: MpiSintel(dstype=d))
                    else:
                        res = ev.validate_chairs(
                            model, FlyingChairs(split="validation"))
                    print(f"step {step} [{valset}]: " + " ".join(
                        f"{k}={v:.3f}" for k, v in res.items()))
                except (FileNotFoundError, OSError) as e:
                    print(f"step {step} [{valset}]: skipped ({e})")
        finally:
            module.train(training)
    return validate


def _model_kwargs(args) -> dict:
    """The reference's get_model() dispatch (train.py:55-92; the JAX CLI's
    cli/train.py:231-252): the architecture flags set ``args.model``; the
    module's keyword arguments."""
    kwargs = {}
    if args.flowNetC:
        if args.flexible_larger_field:
            args.model = "FlowNetCFlexLarger_k3_reps3"
            kwargs.update(kernel_size=args.kernel_size,
                          number_of_reps=args.numReps,
                          dilation=args.dilation, div_flow=args.div_flow)
        elif args.larger_field:
            args.model = "FlowNetC_larger_field"
            kwargs.update(div_flow=args.div_flow)
        else:
            args.model = "FlowNetC"
            if args.div_flow != 1:
                kwargs.update(div_flow=args.div_flow)
    elif args.pwcflex:
        raise NotImplementedError(
            "PWCNetFlex does not exist in the reference repo either "
            "(models/PWCNetFlex.py is missing; its import at "
            "models/__init__.py:8 makes the reference's --pwcflex branch "
            "unrunnable) -- use --pwc")
    elif args.pwc:
        args.model = "PWCNet"
    if args.model.startswith("RAFT"):
        kwargs["iters"] = 3 if args.DEBUG else args.iters  # train.py:235
        for flag, key, default in (
                ("small", "small", False), ("fnorm", "fnorm", "instance"),
                ("cnorm", "cnorm", "batch"),
                ("no_separate_context", "no_separate_context", False),
                ("flowNetCEnc", "flownetc_encoder", False),
                ("compute_spatial", "compute_spatial", False),
                ("corr_levels", "corr_levels", 4),
                ("corr_radius", "corr_radius", 4)):
            if getattr(args, flag) != default:
                kwargs[key] = getattr(args, flag)
        if args.alternate_corr:
            kwargs["corr_impl"] = "alt"
    if args.mixed_precision:
        kwargs["mixed_precision"] = True
    if args.model_kwargs:
        kwargs.update(json.loads(args.model_kwargs))
    return kwargs


def _refuse_dead_flags(args) -> None:
    """The JAX CLI's refusals (cli/train.py:205-230): --dropout > 0, and
    the flags that are dead in the reference itself."""
    if args.dropout > 0:
        raise NotImplementedError(
            "--dropout > 0 is not supported (the reference default is 0; "
            "no released checkpoint trains with it)")
    dead = [k for k, v in vars(args).items() if k.startswith("dead_") and v]
    if args.raft_kernel_size != 3:
        dead.append("raft_kernel_size")
    if args.flowNetC_corrDepth is not None:
        dead.append("flowNetC_corrDepth")
    if dead:
        raise NotImplementedError(
            f"{sorted(dead)}: dead in the reference itself -- the model "
            "construction for these flags is commented out "
            "(training/train.py:66-84), the modules never read them, or "
            "the live read crashes upstream "
            "(--update_no_motion_downsampling, models/raft/update.py:"
            "110-119 channel mismatch)")


def _main_rank(mesh, argv):
    return main(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns {"total_steps": batches taken, "history":
    metrics of each batch of this run} (rank 0's, with ``--n_devices``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    _refuse_dead_flags(args)
    device = torch.device(device_arg(args.device))
    n_devices = n_devices_for(TrainConfig(batch_size=args.batch_size,
                                          n_devices=args.n_devices), device)
    mesh = current_mesh()
    if n_devices > 1 and mesh is None:
        return launch(_main_rank, n_devices, argv, device=device.type)
    if mesh is not None:
        device = mesh.device
    kwargs = _model_kwargs(args)
    if args.val_freq is None:  # train.py:143-148
        args.val_freq = (1000 if args.adversarial
                         else 100 if args.finetune else 5000)

    model = fetch_model(args.model, device=device, seed=args.seed,
                        **kwargs)
    n_params = sum(p.numel() for p in model.module.parameters())
    if is_rank0(mesh):
        print(f"Parameter Count: {n_params}")  # training/train.py:102
    if args.restore_ckpt and args.restore_ckpt.endswith(".msgpack"):
        load_variables(args.restore_ckpt, model.module)  # train.py:297-302
    elif args.restore_ckpt:
        load_weights(args.restore_ckpt, model.module)

    cfg = TrainConfig(
        name=args.name, stage=args.stage,
        image_size=tuple(args.image_size), batch_size=args.batch_size,
        lr=args.lr, wdecay=args.wdecay, epsilon=args.epsilon, clip=args.clip,
        gamma=args.gamma, num_steps=args.num_steps, val_freq=args.val_freq,
        checkpoint_dir=os.path.join(args.checkpoint_dir, args.name),
        # train.py:245-264: the sequence loss by default for every model
        # (its flownetc / pwc branches take the per-level flows)
        loss_type="multiscale" if args.multiscaleEPE else "sequence",
        flownetc=not model.is_raft, pwc="PWC" in args.model,
        flownetc_weighing=args.flownetc_weighing,
        # train.py:130-137: frozen after chairs, for RAFT-style models only
        freeze_bn=args.stage != "chairs" and model.is_raft,
        adversarial=args.adversarial,
        adv_config=PerturbConfig(
            perturb_method=args.adv_method, flow_loss=args.adv_loss,
            output_norm=args.adv_norm, perturb_mode=args.perturb_mode,
            n_step=args.perturb_n_step,
            learning_rate=args.perturb_learning_rate,
            momentum=args.perturb_momentum,
            probability_diverse_input=args.probability_diverse_input,
            targeted=args.arbitrary_gt),  # train.py:183
        n_devices=n_devices, seed=args.seed, add_noise=args.add_noise,
        arbitrary_gt=args.arbitrary_gt, not_excluding=args.no_excluding,
        save_checkpoints=not args.DEBUG)
    h, w = args.image_size
    history = []

    if args.synthetic:
        batches = _synthetic_batches(args.synthetic, args.batch_size, h, w,
                                     args.seed)

        def sample_gt_fn(rng):
            # --arbitrary_gt's random target in synthetic mode (cli/train.py:
            # 377-381 of the JAX package)
            flow = rng.randn(args.batch_size, h, w, 2).astype(np.float32)
            return flow, np.ones((args.batch_size, h, w), np.float32)
    else:
        from ..data import DataLoader

        dataset = _dataset(args)
        # one loader for the whole run: its shuffle advances across epochs
        loader = DataLoader(dataset, batch_size=args.batch_size,
                            num_workers=4, seed=args.seed)
        if len(loader) == 0:  # the trainer would wait for a batch forever
            raise ValueError(f"--stage {args.stage}: {len(dataset)} samples "
                             f"hold no batch of {args.batch_size}")

        def batches():
            yield from loader

        def sample_gt_fn(rng):
            # a random training sample's GT (train.py:188-199)
            _, _, flow, valid = dataset[rng.randint(len(dataset))][:4]
            return np.asarray(flow)[None], np.asarray(valid)[None]

    def logger(step, metrics):
        history.append(metrics)
        if step % 100 == 0 or step < 10:
            print(f"step {step}: " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()), flush=True)

    validate_fn = (_validate_fn(model, args.validation) if args.validation
                   else None)
    steps = train(cfg, model, batches, validate_fn=validate_fn,
                  logger=logger, sample_gt_fn=sample_gt_fn)
    if is_rank0(mesh):
        print(f"training done at step {steps}")
    return {"total_steps": steps, "history": history}


if __name__ == "__main__":
    main()
