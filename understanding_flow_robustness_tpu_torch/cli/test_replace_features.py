"""Feature-replacement analysis, the paper's Table 2 (counterpart of
``understanding_flow_robustness_tpu/cli/test_replace_features.py``;
reference: patch_attacks/test_replace_features.py:140-599).

For each sample: place a uniform patch and the test patch under identical
transforms (``circle_transform_two_patches``); run the model on the
uniform-patch frames capturing the feature maps at the chosen keys (e.g.
``corr``, ``conv_redir``); run it again on the test-patch frames with
those maps injected (``overrides``), which measures how much of the
attack flows through each feature pathway.  Writes ``results.csv`` (one
row per key set) and ``key_sets.json`` (:171-191).  Injection exists in
the FlowNetC family only: another model raises a TypeError at the
injection, as in the JAX package.

The flags of ``test_patch`` plus ``-fk``, ``--all_key_subsets`` and
``--uniform_patch``; runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import itertools
import json
import os

import numpy as np

from ..attacks.losses import compute_cossim, compute_epe
from ..attacks.patch import circle_transform_two_patches, create_random_patch
from ..utils import AverageMeter, CsvLogger, on_device
from .test_patch import _val_samples, analysis_patch
from .test_patch import build_parser as _base_parser


def build_parser():
    p = _base_parser()
    p.description = __doc__
    p.add_argument("-fk", "--feature_keys", nargs="+", default=["corr"],
                   help="feature maps to replace (conv3a conv3b corr "
                        "conv_redir conv3_1)")
    p.add_argument("--all_key_subsets", action="store_true",
                   help="sweep every non-empty subset of --feature_keys")
    p.add_argument("--uniform_patch", type=str, default="gray",
                   help="reference patch type for the captured features")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)

    from ..models import (
        checkpoint_arg,
        device_arg,
        fetch_model,
        predict_flow,
        predict_flow_with_features,
    )

    device = device_arg(args.device)
    model = fetch_model(
        args.flownet,
        pretrained_path=checkpoint_arg(args.pretrained_path, args.flownet),
        device=device, return_features=True)

    patch, mask = analysis_patch(args)
    uniform = create_random_patch(args.uniform_patch, patch.shape[1])
    patch_shape = patch.shape

    out_dir = os.path.join(args.output, args.name)
    os.makedirs(out_dir, exist_ok=True)

    key_sets = [tuple(args.feature_keys)]
    if args.all_key_subsets:
        key_sets = [
            s for r in range(1, len(args.feature_keys) + 1)
            for s in itertools.combinations(args.feature_keys, r)
        ]
    with open(os.path.join(out_dir, "key_sets.json"), "w") as f:
        json.dump([list(s) for s in key_sets], f)

    csv = CsvLogger(
        os.path.join(out_dir, "results.csv"),
        ["keys", "epe", "adv_epe", "replaced_epe", "cos_sim", "adv_cos_sim",
         "replaced_cos_sim"],
    )

    for keys in key_sets:
        errors = AverageMeter(i=6)
        for i, _past, tgt, fut, gt, _d, _c, _p in _val_samples(args):
            c_uni, c_test, mc, *_ = circle_transform_two_patches(
                [uniform.copy(), patch.copy()], mask,
                [uniform.copy(), patch.copy()], tgt.shape, patch_shape,
                norotate=args.norotate,
            )

            def composite(canvas):
                a = np.clip((1 - mc) * tgt + mc * canvas, 0, 1)
                b = np.clip((1 - mc) * fut + mc * canvas, 0, 1)
                return on_device(a, device), on_device(b, device)

            uni_tgt, uni_fut = composite(c_uni)
            test_tgt, test_fut = composite(c_test)

            flow_clean = predict_flow_with_features(
                model, on_device(tgt, device), on_device(fut, device))[0]
            _, feats_uni = predict_flow_with_features(
                model, uni_tgt, uni_fut)
            # the selected features of the test-patch forward replaced by
            # the uniform patch's (test_replace_features.py:382-396)
            overrides = {k: feats_uni[k] for k in keys}
            flow_replaced = predict_flow(model, test_tgt, test_fut,
                                         overrides=overrides)
            flow_test = predict_flow_with_features(
                model, test_tgt, test_fut)[0]

            gt_j = on_device(gt, device)
            vals = [
                float(compute_epe(gt_j, flow_clean)),
                float(compute_epe(gt_j, flow_test)),
                float(compute_epe(gt_j, flow_replaced)),
                float(compute_cossim(gt_j, flow_clean)),
                float(compute_cossim(gt_j, flow_test)),
                float(compute_cossim(gt_j, flow_replaced)),
            ]
            errors.update(vals)
        csv.write(["+".join(keys)] + [round(v, 4) for v in errors.avg])
        print(f"keys={keys}: clean {errors.avg[0]:.3f} "
              f"adv {errors.avg[1]:.3f} replaced {errors.avg[2]:.3f}")
    return errors.avg


if __name__ == "__main__":
    main()
