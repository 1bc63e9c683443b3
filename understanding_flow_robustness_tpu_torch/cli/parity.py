"""One-command parity harness (counterpart of the JAX package's
``understanding_flow_robustness_tpu/cli/parity.py``; BASELINE.md's accuracy
bars).

Given the reference zoo (``setup/download_weights.sh``) and dataset roots,
writes the full table in one run: per-model clean EPE on KITTI 2012/2015
(the "EPE within 1%" bar), the I-FGSM adversarial EPE and, where a trained
patch is supplied, the patch attack's EPE (the reference's two headline
attack families, patch_attacks/main.py and global_attacks/perturb_main.py).
``--zoo`` is a directory with the reference's per-model file names
(``models.registry``'s ``ModelSpec.checkpoint``); a model whose file is
missing runs on seeded random weights, with a warning.  ``--synthetic N``
runs on N numpy frame pairs instead of the datasets.  ``--device`` is the
card unless asked for ``cpu`` (no fallback).

    python -m understanding_flow_robustness_tpu_torch.cli.parity \\
        --zoo pretrained_models --kitti_dir datasets/KITTI/scene_flow \\
        --expected reference_numbers.json --out parity

``--expected`` is a JSON of reference numbers to diff against, e.g.
``{"RAFT": {"kitti2015": {"epe": 1.50, "ifgsm_epe": 12.3}}}``: a clean-EPE
delta beyond ``--epe_tol`` (the 1 % bar) or an adversarial one beyond
``--adv_tol`` makes the run exit 2.  The table goes to
``<out>/parity_table.md`` and ``<out>/parity.json``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

# registry IDs evaluated by default: the full zoo, flagship first
DEFAULT_MODELS = [
    "RAFT",
    "FlowNetC",
    "FlowNetS",
    "FlowNet2",
    "SpyNet",
    "PWCNet",
    "FlowNetCFlexLarger_k3_reps3",
    "FlowNetCFlexLarger_k5_reps0",
    "RAFT_FlowNetCEncoder_WoContext",
    "FlowNetCFlexLarger_k3_reps3_adv_ifgsm_l2_002",
    "PWCNet_adv_ifgsm_l2_002",
    "RAFT_adv_kitti2012_ifgsm_l2_002",
]


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--zoo", default="pretrained_models",
                   help="zoo directory (setup/download_weights.sh); a "
                        "missing file means random weights, with a warning")
    p.add_argument("--models", default=None,
                   help="comma-separated registry IDs (default: the zoo)")
    p.add_argument("--valsets", default="kitti2015,kitti2012",
                   help="comma-separated eval sets")
    p.add_argument("--kitti_dir", default="datasets/KITTI/scene_flow",
                   help="KITTI 2015 scene_flow root")
    p.add_argument("--kitti2012_dir", default="datasets/KITTI/stereo_flow",
                   help="KITTI 2012 stereo_flow root")
    p.add_argument("--sintel_dir", default="datasets/Sintel")
    p.add_argument("--img_height", type=int, default=256)
    p.add_argument("--img_width", type=int, default=832)
    p.add_argument("--attack_norm", type=float, default=0.02,
                   help="I-FGSM L-inf budget (the paper's headline 0.02)")
    p.add_argument("--attack_steps", type=int, default=20)
    p.add_argument("--patch_tmpl", default=None,
                   help="per-model trained-patch path template, e.g. "
                        "'patches/{model}.npy': the patch-attack columns "
                        "(cli.test_patch's fixed-location evaluation)")
    p.add_argument("--expected", default=None,
                   help="JSON file of reference numbers to diff against")
    p.add_argument("--epe_tol", type=float, default=0.01,
                   help="relative clean-EPE tolerance (BASELINE: 1%%)")
    p.add_argument("--adv_tol", type=float, default=0.05,
                   help="relative adversarial-EPE tolerance")
    p.add_argument("--synthetic", type=int, default=0,
                   help="N synthetic frame pairs instead of the datasets")
    p.add_argument("--out", default="output/parity",
                   help="output dir: parity_table.md and parity.json")
    p.add_argument("--device", default="cuda",
                   help="torch device: the card unless asked for 'cpu' "
                        "(no fallback); 'gpu' means 'cuda'")
    return p


def _samples(args, valset):
    """(img0, img1, gt_small, gt_full) NHWC numpy with the batch dimension:
    the JAX CLI's synthetic pairs, or KITTI's *_10/_11 pairs with their
    flow_occ GT through ``KittiPairDataset`` (the attack CLI's samples)."""
    if args.synthetic:
        rng = np.random.RandomState(0)
        for _ in range(args.synthetic):
            a = rng.rand(1, args.img_height, args.img_width, 3)
            b = rng.rand(1, args.img_height, args.img_width, 3)
            gt = np.zeros((1, args.img_height, args.img_width, 3),
                          np.float32)
            gt[..., 2] = 1
            yield a.astype(np.float32), b.astype(np.float32), gt, gt
        return
    from glob import glob

    from ..data.validation import KittiPairDataset

    if valset == "kitti2015":
        base, img_dir = os.path.join(args.kitti_dir, "training"), "image_2"
    elif valset == "kitti2012":
        base = os.path.join(args.kitti2012_dir, "training")
        img_dir = "colored_0"
    else:
        raise SystemExit(f"the parity harness takes the KITTI valsets, got "
                         f"{valset} (cli.evaluate gives Sintel's EPE)")
    flows = sorted(glob(os.path.join(base, "flow_occ", "*_10.png")))
    if not flows:
        raise SystemExit(f"no GT flow files under {base}/flow_occ: check "
                         "--kitti_dir/--kitti2012_dir, or use --synthetic")
    img0 = [os.path.join(base, img_dir, os.path.basename(f)) for f in flows]
    img1 = [p[:-6] + "11.png" for p in img0]
    ds = KittiPairDataset(img0, img1, flows, args.img_height, args.img_width)
    for i in range(len(ds)):
        a, b, gt_small, gt_full = ds[i]
        yield a[None], b[None], gt_small[None], gt_full[None]


def _eval_model(args, model_id, valset, out_dir):
    """{'epe', 'ifgsm_epe', 'ifgsm_cossim'; 'patch_epe', 'patch_adv_epe',
    'patch_cossim' with a patch}."""
    from ..attacks.global_attacks import PerturbConfig
    from ..attacks.perturb_runner import RunConfig, run
    from ..models import device_arg, fetch_model, predict_flow_differentiable

    device = device_arg(args.device)
    zoo = args.zoo if os.path.isdir(args.zoo) else None
    if zoo is None:
        print(f"WARNING: zoo dir '{args.zoo}' not found: {model_id} runs "
              "with RANDOM weights (smoke mode only; its EPE says nothing "
              "about parity)")
    model = fetch_model(model_id, pretrained_path=zoo, device=device)

    def predict(a, b):
        return predict_flow_differentiable(model, a, b)

    cfg = RunConfig(
        flownet=model_id,
        perturb=PerturbConfig(
            perturb_method="ifgsm", flow_loss="l2",
            output_norm=args.attack_norm, n_step=args.attack_steps),
        n_height=args.img_height, n_width=args.img_width,
        output_path=os.path.join(out_dir, model_id, valset), device=device)
    res = run(predict, _samples(args, valset), cfg)
    row = {
        "epe": float(res["flow_epe_origin"][0]),
        "ifgsm_epe": float(res["flow_epe"][0]),
        "ifgsm_cossim": float(res["flow_cossim_attacked"][0]),
    }

    if args.patch_tmpl:
        patch_path = args.patch_tmpl.format(model=model_id, valset=valset)
        if os.path.isfile(patch_path):
            from . import test_patch as tp

            argv = [
                "--flownet", model_id,
                "--pretrained_path", args.zoo,
                "--valset", valset if not args.synthetic else "kitti2015",
                "--kitti-dir", args.kitti_dir,
                "--sintel-dir", args.sintel_dir,
                "--patch_path", patch_path,
                "--output", os.path.join(out_dir, model_id,
                                         f"{valset}_patch"),
                "--device", args.device,
            ]
            if args.synthetic:
                argv += ["--synthetic", str(args.synthetic)]
            epe, adv_epe, _, adv_cos = tp.main(argv)
            row.update(patch_epe=float(epe), patch_adv_epe=float(adv_epe),
                       patch_cossim=float(adv_cos))
        else:
            print(f"note: no trained patch at {patch_path}; patch columns "
                  f"skipped for {model_id}/{valset}")
    return row


def _diff(table, expected, epe_tol, adv_tol):
    """[(model, valset, metric, ours, ref, rel_delta, ok)] for every
    expected number present in the measured table."""
    out = []
    for model, per_set in (expected or {}).items():
        for valset, metrics in per_set.items():
            ours_row = table.get(model, {}).get(valset)
            if ours_row is None:
                continue
            for metric, ref in metrics.items():
                ours = ours_row.get(metric)
                if ours is None:
                    continue
                tol = epe_tol if metric in ("epe", "f1") else adv_tol
                rel = abs(ours - ref) / max(abs(ref), 1e-9)
                out.append((model, valset, metric, ours, ref, rel,
                            rel <= tol))
    return out


def _markdown(table, diffs):
    cols = ["epe", "ifgsm_epe", "ifgsm_cossim", "patch_epe",
            "patch_adv_epe"]
    present = [c for c in cols
               if any(c in r for m in table.values() for r in m.values())]
    lines = ["| Model | Set | " + " | ".join(present) + " |",
             "|---" * (2 + len(present)) + "|"]
    for model, per_set in table.items():
        for valset, row in per_set.items():
            cells = [f"{row[c]:.3f}" if c in row else "—" for c in present]
            lines.append(f"| {model} | {valset} | " + " | ".join(cells)
                         + " |")
    if diffs:
        lines += ["", "| Model | Set | Metric | ours | reference | Δrel | "
                  "ok |", "|---|---|---|---|---|---|---|"]
        for m, v, k, ours, ref, rel, ok in diffs:
            lines.append(f"| {m} | {v} | {k} | {ours:.3f} | {ref:.3f} | "
                         f"{rel:.2%} | {'✓' if ok else '✗ FAIL'} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    """Run the harness; 0, or 2 when an expected number is out of its
    tolerance."""
    args = build_parser().parse_args(argv)
    models = args.models.split(",") if args.models else DEFAULT_MODELS
    valsets = args.valsets.split(",")
    os.makedirs(args.out, exist_ok=True)

    table = {}
    for model_id in models:
        table[model_id] = {}
        for valset in valsets:
            row = _eval_model(args, model_id, valset, args.out)
            table[model_id][valset] = row
            print(f"{model_id:44s} {valset}: "
                  + "  ".join(f"{k}={v:.3f}" for k, v in row.items()),
                  flush=True)

    expected = None
    if args.expected:
        with open(args.expected) as f:
            expected = json.load(f)
    diffs = _diff(table, expected, args.epe_tol, args.adv_tol)

    with open(os.path.join(args.out, "parity.json"), "w") as f:
        json.dump({"table": table, "diffs": [list(d) for d in diffs]}, f,
                  indent=1)
    md = _markdown(table, diffs)
    with open(os.path.join(args.out, "parity_table.md"), "w") as f:
        f.write(md)
    print(md)

    bad = [d for d in diffs if not d[-1]]
    if bad:
        print(f"PARITY FAIL: {len(bad)} metric(s) out of tolerance")
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
