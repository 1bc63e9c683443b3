"""Feature-embedding analysis, the paper's Fig. 3/9 (counterpart of
``understanding_flow_robustness_tpu/cli/test_patch_embeddings.py``;
reference: patch_attacks/test_patch_embeddings.py).

Collects the channel means of the feature maps with and without the patch
(:235-265), computes the Gaussian-kernel MMD per layer into ``mmd.csv``
(:130-163), and draws a 2-D t-SNE scatter of the clean and patched
embeddings per layer as ``tsne_{key}.pdf`` (:417-441), or without
matplotlib (the card's machine has none) saves the t-SNE points as
``tsne_{key}.npy``.

The flags of ``test_patch`` plus ``--feature_keys`` (taps of
``get_feature_map_keys``) and ``--max_samples``; runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import os

import numpy as np

from ..attacks.patch import circle_transform
from ..utils import CsvLogger, gaussian_mmd, on_device, tsne
from .test_patch import _val_samples, analysis_patch
from .test_patch import build_parser as _base_parser


def build_parser():
    p = _base_parser()
    p.description = __doc__
    p.add_argument("--feature_keys", nargs="+",
                   default=["conv3a", "corr", "conv_redir", "conv3_1"])
    p.add_argument("--max_samples", type=int, default=100)
    return p


def compute_feature_embedding(fm) -> np.ndarray:
    """The spatial mean per channel of an NCHW feature map, flattened
    (models/utils_model.py:562-624 compute_feature_map semantics), in
    float64 on the host."""
    return fm.double().mean(dim=(2, 3)).reshape(-1).cpu().numpy()


def save_scatter(emb2d: np.ndarray, n_clean: int, title: str,
                 out_dir: str, key: str) -> str:
    """The t-SNE scatter of the clean (first ``n_clean``) and patched points
    as ``tsne_{key}.pdf``, or without matplotlib the points as
    ``tsne_{key}.npy``; returns the path."""
    try:
        import matplotlib
    except ImportError:
        path = os.path.join(out_dir, f"tsne_{key}.npy")
        np.save(path, emb2d)
        return path
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(5, 5))
    plt.scatter(emb2d[:n_clean, 0], emb2d[:n_clean, 1], s=12, label="clean")
    plt.scatter(emb2d[n_clean:, 0], emb2d[n_clean:, 1], s=12,
                label="patched")
    plt.legend()
    plt.title(title)
    plt.tight_layout()
    path = os.path.join(out_dir, f"tsne_{key}.pdf")
    plt.savefig(path)
    plt.close()
    return path


def main(argv=None):
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)

    from ..models import (
        checkpoint_arg,
        device_arg,
        fetch_model,
        predict_flow_with_features,
    )

    device = device_arg(args.device)
    model = fetch_model(
        args.flownet,
        pretrained_path=checkpoint_arg(args.pretrained_path, args.flownet),
        device=device, return_features=True)

    def forward(a, b):
        return predict_flow_with_features(model, on_device(a, device),
                                          on_device(b, device))[1]

    patch, mask = analysis_patch(args)

    clean_embs: dict = {k: [] for k in args.feature_keys}
    adv_embs: dict = {k: [] for k in args.feature_keys}

    for i, _past, tgt, fut, _gt, _disp, _calib, _poses in _val_samples(args):
        if i >= args.max_samples:
            break
        feats_clean = forward(tgt, fut)
        pc, mc, _, _, _, _ = circle_transform(
            patch.copy(), mask, patch.copy(), tgt.shape, patch.shape,
            norotate=args.norotate, moving=True,
        )
        feats_adv = forward(np.clip((1 - mc) * tgt + mc * pc, 0, 1),
                            np.clip((1 - mc) * fut + mc * pc, 0, 1))
        for k in args.feature_keys:
            clean_embs[k].append(compute_feature_embedding(feats_clean[k]))
            adv_embs[k].append(compute_feature_embedding(feats_adv[k]))

    out_dir = os.path.join(args.output, args.name)
    os.makedirs(out_dir, exist_ok=True)
    csv = CsvLogger(os.path.join(out_dir, "mmd.csv"), ["layer", "mmd"])

    mmds = {}
    for k in args.feature_keys:
        c = np.stack(clean_embs[k])
        a = np.stack(adv_embs[k])
        mmds[k] = gaussian_mmd(c, a)
        csv.write([k, round(mmds[k], 6)])
        print(f"{k}: MMD {mmds[k]:.6f}")
        emb2d = tsne(np.concatenate([c, a]), n_iter=300, seed=args.seed)
        save_scatter(emb2d, len(c), f"{args.flownet} {k}", out_dir, k)
    return mmds


if __name__ == "__main__":
    main()
