"""Global-attack CLI (counterpart of
``understanding_flow_robustness_tpu/cli/run_perturb_model.py``; reference:
global_attacks/run_perturb_model.py:26-281).

The same flags, defaults and output-path taxonomy
(``output_path[/DEBUG]/dataset/flownet[/targeted][/universal]/mode/...``,
perturb_main.py:77-119).  The reference's three branches run:
universal-perturbation evaluation, the white-box and noise attacks, and
the image corruptions, swept over severities 1-5 into
``.../mode/<corruption>/<severity>/`` (run_perturb_model.py:246-281), on
the KITTI pairs listed under ``--data_list_dir`` or on ``--synthetic N``
random pairs.  ``--disparity`` raises (unimplemented upstream too).
``--device`` defaults to ``cuda``, with no fallback; ``--device cpu`` runs
on the CPU.  ``--flownet`` takes every registry ID, FlowNetC by default.
The corruptions run on the host, all 19 with neither cv2 nor PIL.

Example:
  python -m understanding_flow_robustness_tpu_torch.cli.run_perturb_model \\
      --flownet RAFT --perturb_method ifgsm --flow_loss l2 \\
      --output_norm 0.02 --synthetic 4
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..attacks.global_attacks import (
    LEARNING_RATE,
    MOMENTUM,
    N_STEP,
    OUTPUT_NORM,
    PERTURB_METHOD,
    PerturbConfig,
)
from ..attacks.perturb_runner import (
    CORRUPTIONS,
    WHITEBOX_METHODS,
    RunConfig,
    build_arbitrary_gt,
    run,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", type=str, default="kitti2015",
                   choices=["kitti2012", "kitti2015"])
    p.add_argument("--data_list_dir", type=str,
                   default="datasets/KITTI/global_attacks/training")
    p.add_argument("--n_height", type=int, default=256)
    p.add_argument("--n_width", type=int, default=640)
    p.add_argument("--perturb_method", type=str, default=PERTURB_METHOD,
                   choices=list(WHITEBOX_METHODS) + list(CORRUPTIONS))
    # "same" is accepted and then raises in the attack's mode mask, as in
    # the JAX package and the reference
    p.add_argument("--perturb_mode", type=str, default="both",
                   choices=["both", "left", "right", "same"])
    # untyped, as upstream: a float eps for the attacks, an int severity
    # for the corruptions
    p.add_argument("--output_norm", default=OUTPUT_NORM)
    p.add_argument("--n_step", type=int, default=N_STEP)
    p.add_argument("--learning_rate", type=float, default=LEARNING_RATE)
    p.add_argument("--momentum", type=float, default=MOMENTUM)
    p.add_argument("--probability_diverse_input", type=float, default=0.0,
                   help="per-step probability of random resize-pad input "
                        "diversification (perturb_model.py:759-821)")
    p.add_argument("--flownet", type=str, default="FlowNetC")
    p.add_argument("--pretrained_path", type=str, default="pretrained_models",
                   help="a checkpoint file (or SpyNet's weight directory); "
                        "absent means seeded random weights")
    # "corr" is accepted for CLI parity but unimplemented in the reference
    # too: its compute_flow_loss has no corr branch (perturb_model.py:129-142)
    p.add_argument("--flow_loss", type=str, default="l2",
                   choices=["cossim", "l2", "l1", "corr"])
    p.add_argument("--targeted", action="store_true")
    p.add_argument("--homogeneous", action="store_true",
                   help="second frame := first frame, zeroed full-res GT "
                        "(perturb_main.py:477-481)")
    p.add_argument("--show_evolve", action="store_true",
                   help="write perturbation-evolution GIFs under "
                        "<output>/evolve (perturb_model.py:604-614)")
    p.add_argument("--arbitrary_gt_index", type=str, default=None,
                   help="dataset index digit, 'fun', or 'uniform_N'")
    p.add_argument("--arbitrary_noise_index", type=int, default=None,
                   help="attack sample N once, re-apply its noise to every "
                        "sample (perturb_main.py:385-448)")
    p.add_argument("--universal_evaluation", action="store_true")
    p.add_argument("--perturbations_file", type=str, default=None,
                   help="explicit universal-perturbation file; default is "
                        "<output>/<folder_name>/perturbations/"
                        "epoch_<epoch_number> like perturb_main.py:458-464")
    p.add_argument("--folder_name", type=str, default="",
                   help="training-run folder under the universal taxonomy "
                        "(run_perturb_model.py:153-156)")
    p.add_argument("--epoch_number", type=int, default=-1,
                   help="universal-perturbation epoch snapshot to evaluate")
    p.add_argument("--uniform_noise", action="store_true",
                   help="universal evaluation with a uniform-noise baseline "
                        "pair (perturb_main.py:451-457)")
    p.add_argument("--disparity", action="store_true",
                   help="unimplemented upstream (stereo model commented "
                        "out, perturb_main.py:195-200); raises")
    p.add_argument("--disparity_method", type=str, default="psmnet")
    p.add_argument("--disparity_model_restore_path", type=str, default="")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: the card unless asked for 'cpu' "
                        "(no fallback); 'gpu' means 'cuda'")
    p.add_argument("--DEBUG", action="store_true",
                   help="route outputs under <output>/DEBUG "
                        "(perturb_main.py:77-78)")
    p.add_argument("--output_path", type=str, default="output/global_attacks")
    p.add_argument("--write_out", action="store_true")
    p.add_argument("--write_out_npy", action="store_true")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic frame pairs instead of a dataset")
    return p


def _samples(args):
    """--synthetic N: the JAX CLI's numpy pairs (same RandomState draws)
    with an all-zero, all-valid GT.  Otherwise the KITTI pairs of
    ``--data_list_dir``'s path lists (``KittiPairDataset.from_lists``):
    the frames resized to n_height x n_width, the GT downscaled
    sparse-aware beside the full-resolution GT."""
    if args.synthetic:
        rng = np.random.RandomState(0)
        for _ in range(args.synthetic):
            img0 = rng.rand(1, args.n_height, args.n_width, 3).astype(
                np.float32)
            img1 = rng.rand(1, args.n_height, args.n_width, 3).astype(
                np.float32)
            gt = np.zeros((1, args.n_height, args.n_width, 3), np.float32)
            gt[..., 2] = 1
            yield img0, img1, gt, gt
        return
    from ..data import KittiPairDataset

    year = "2015" if args.dataset == "kitti2015" else "2012"
    ds = KittiPairDataset.from_lists(
        args.data_list_dir, year=year, split="train",
        n_height=args.n_height, n_width=args.n_width)
    for i in range(len(ds)):
        img0, img1, gt_small, gt_full = ds[i]
        yield img0[None], img1[None], gt_small[None], gt_full[None]


def _output_path(args) -> str:
    """The reference's exact output taxonomy (perturb_main.py:77-119)."""
    parts = [args.output_path]
    if args.DEBUG:
        parts.append("DEBUG")
    parts += [args.dataset, args.flownet]
    if args.targeted:
        parts.append("targeted")
    if args.universal_evaluation:
        parts.append("universal")
    parts.append(args.perturb_mode)
    method = args.perturb_method
    if method in CORRUPTIONS:
        if args.homogeneous:
            parts.append("homogeneous")
        parts += [method]  # severity appended by the sweep caller
    else:
        if args.homogeneous:
            parts.append("homogeneous")
        if args.arbitrary_gt_index is not None:
            parts += ["arbitraryGT", str(args.arbitrary_gt_index)]
        if args.arbitrary_noise_index is not None:
            parts += ["arbitraryNoise", str(args.arbitrary_noise_index)]
        parts += [f"{method}_{args.flow_loss}", str(args.output_norm)]
    if args.universal_evaluation:
        parts.append("uniform" if args.uniform_noise else args.folder_name)
    return os.path.join(*[str(x) for x in parts if str(x)])


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    args.perturb_method = args.perturb_method.lower()
    args.perturb_mode = args.perturb_mode.lower()

    if args.disparity:
        raise NotImplementedError(
            "disparity estimation is unimplemented in the reference too "
            "(perturb_main.py:195-200 leaves stereo_model = None)")
    if args.flow_loss == "corr":
        raise NotImplementedError(
            "flow_loss='corr' is accepted but unimplemented upstream "
            "(perturb_model.py:129-142 has no corr branch)")
    from ..models import (
        checkpoint_arg,
        device_arg,
        fetch_model,
        predict_flow_differentiable,
    )

    device = device_arg(args.device)

    model = fetch_model(args.flownet,
                        pretrained_path=checkpoint_arg(args.pretrained_path,
                                                       args.flownet),
                        device=device, seed=max(args.seed, 0))

    def predict(a, b):
        return predict_flow_differentiable(model, a, b)

    base_out = _output_path(args)

    def make_cfg(method, norm, out_path):
        return RunConfig(
            flownet=args.flownet,
            perturb=PerturbConfig(
                perturb_method=method,
                perturb_mode=args.perturb_mode,
                output_norm=float(norm),
                n_step=args.n_step,
                learning_rate=args.learning_rate,
                momentum=args.momentum,
                targeted=args.targeted or args.arbitrary_gt_index is not None,
                flow_loss=args.flow_loss,
                probability_diverse_input=args.probability_diverse_input,
            ),
            n_height=args.n_height,
            n_width=args.n_width,
            output_path=out_path,
            seed=max(args.seed, 0),
            write_out_frequency=10 if args.write_out else 0,
            save_npy=args.write_out_npy,
            homogeneous=args.homogeneous,
            show_evolve_path=(
                os.path.join(out_path, "evolve") if args.show_evolve else None
            ),
            device=device,
        )

    arbitrary_gt = None
    if args.arbitrary_gt_index is not None:
        helper = next(_samples(args))[2][0]
        if args.arbitrary_gt_index.isdigit():
            idx = int(args.arbitrary_gt_index)
            for i, s in enumerate(_samples(args)):
                if i == idx:
                    arbitrary_gt = s[2][0]
                    break
        else:
            arbitrary_gt = build_arbitrary_gt(args.arbitrary_gt_index, helper)

    if args.universal_evaluation:
        cfg = make_cfg(args.perturb_method, args.output_norm, base_out)
        if args.uniform_noise:
            cfg.uniform_noise = True
        else:
            path = args.perturbations_file or os.path.join(
                base_out, "perturbations", f"epoch_{args.epoch_number}")
            # the trainer saves .npy snapshots; the reference's torch.save
            # path has no suffix -- accept either
            if not os.path.isfile(path) and os.path.isfile(path + ".npy"):
                path += ".npy"
            cfg.universal_perturbation_path = path
        res = run(predict, _samples(args), cfg)
        print(f"universal eval: epe {res['flow_epe_origin'][0]:.3f} -> "
              f"{res['flow_epe'][0]:.3f}; results under {cfg.output_path}")
        return res

    if args.perturb_method in CORRUPTIONS:
        # the severity sweep 1-5 (run_perturb_model.py:246-281); returns
        # the last severity's metrics, as the other branches return theirs
        for severity in range(1, 6):
            cfg = make_cfg(args.perturb_method, severity,
                           os.path.join(base_out, str(severity)))
            cfg.arbitrary_gt = arbitrary_gt
            res = run(predict, _samples(args), cfg)
            print(f"severity {severity}: epe "
                  f"{res['flow_epe_origin'][0]:.3f} -> "
                  f"{res['flow_epe'][0]:.3f}")
        return res

    cfg = make_cfg(args.perturb_method, args.output_norm, base_out)
    cfg.arbitrary_gt = arbitrary_gt
    if args.arbitrary_noise_index is not None:
        # attack sample N once; its noise is re-applied to every sample
        # (perturb_main.py:385-448)
        import torch

        from ..attacks.global_attacks import make_attack

        sample = None
        for i, s in enumerate(_samples(args)):
            if i == args.arbitrary_noise_index:
                sample = s
                break
        if sample is None:
            raise IndexError(
                f"arbitrary_noise_index {args.arbitrary_noise_index} "
                "out of range")
        img0, img1, gt_small, _ = (torch.as_tensor(x, device=device)
                                   for x in sample)
        gen = torch.Generator(device=device).manual_seed(max(args.seed, 0))
        n0, n1, _, _ = make_attack(predict, cfg.perturb)(img0, img1, gt_small,
                                                         gen)
        cfg.arbitrary_noise = np.stack([n0[0].cpu().numpy(),
                                        n1[0].cpu().numpy()])
    res = run(predict, _samples(args), cfg)
    print(f"epe {res['flow_epe_origin'][0]:.3f} -> "
          f"{res['flow_epe'][0]:.3f}; results under {cfg.output_path}")
    return res


if __name__ == "__main__":
    main()
