#!/usr/bin/env python3
"""Why the port's unsharded I-FGSM on each half of a batch parts from the
same attack on the whole batch: the arithmetic of batch-size-dependent
kernels, or a batch-dependent fault in the attack path.

    python3 scripts/torch_dp_attack_cause.py

RAFT (f32, 24 iterations, the flow head x 0.05) attacks a batch of two
random pairs at the attack CLI's geometry (256x640, l2 loss, eps 0.02),
in three settings of the card: PyTorch's cuDNN defaults (TF32 off),
``cudnn.deterministic = True`` with ``benchmark = False``, and cuDNN off.
In each it reports:

- the image gradient of the first step, each pair alone against the
  batch: its relative L2 difference, the share of elements whose sign
  differs (the first step's share of elements apart), and the largest
  such element's magnitude against the gradient's RMS;
- the share of noise elements apart after 3 steps: each half
  alone against the whole batch, the whole batch against a rerun of
  itself, and the whole batch against itself with image 0 moved by one
  ulp (``nextafter``) in every element.

A batch-dependent fault gives a first-step gradient apart by far more
than f32 rounding; rounding gives ~1e-6 and sign flips only where the
gradient is near zero, and then the one-ulp nudge at a fixed batch size
parts the steps as much as the batch size does.  Prints the card's name
and power limit and one JSON line, also written to
``chiprun_out/dp_attack_cause.json``.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from understanding_flow_robustness_tpu_torch.attacks import (  # noqa: E402
    PerturbConfig,
    make_attack,
)
from understanding_flow_robustness_tpu_torch.attacks.losses import (  # noqa: E402
    EPSILON,
    flow_attack_loss,
)
from understanding_flow_robustness_tpu_torch.models import (  # noqa: E402
    fetch_model,
    predict_flow_differentiable,
    scale_flow_head,
)

H, W, ITERS, EPS, SEED, STEPS = 256, 640, 24, 0.02, 500, 3
SETTINGS = {
    "cuda": dict(deterministic=False, benchmark=False, enabled=True),
    "cuda_deterministic": dict(deterministic=True, benchmark=False,
                               enabled=True),
    "cuda_no_cudnn": dict(deterministic=False, benchmark=False,
                          enabled=False),
}


def inputs():
    """Two pairs and a dense target, from a CPU generator."""
    g = torch.Generator().manual_seed(SEED)
    img0 = torch.rand((2, H, W, 3), generator=g)
    img1 = torch.rand((2, H, W, 3), generator=g)
    gt = torch.cat([3 * torch.randn((2, H, W, 2), generator=g),
                    torch.ones((2, H, W, 1))], -1)
    return img0, img1, gt


def share_apart(a, b) -> float:
    return max(float(((x - y).abs() > 1e-6).float().mean())
               for x, y in zip(a, b))


def measure(model, img0, img1, gt, steps: int) -> dict:
    def predict(a, b):
        return predict_flow_differentiable(model, a, b)

    def grad(a, b, t):
        a, b = a.clone().requires_grad_(), b.clone().requires_grad_()
        return torch.autograd.grad(
            flow_attack_loss(predict(a, b), t, "l2"), (a, b))

    whole = grad(img0, img1, gt)
    halves = [grad(img0[i:i + 1], img1[i:i + 1], gt[i:i + 1])
              for i in range(2)]
    # the loss divides by the batch's valid pixels: one pair's gradient is
    # the batch's times this factor
    n = H * W
    c = (2 * n + EPSILON) / (n + EPSILON)
    out = {"grad_rel_l2": 0.0, "sign_flip_share": 0.0,
           "flip_max_over_rms": 0.0}
    for k in range(2):
        gw = whole[k]
        gh = torch.cat([h[k] for h in halves]) / c
        flip = torch.sign(gw) != torch.sign(gh)
        rms = float(gw.pow(2).mean().sqrt())
        out["grad_rel_l2"] = max(out["grad_rel_l2"],
                                 float((gw - gh).norm() / gw.norm()))
        out["sign_flip_share"] = max(out["sign_flip_share"],
                                     float(flip.float().mean()))
        if flip.any():
            out["flip_max_over_rms"] = max(out["flip_max_over_rms"],
                                           float(gw[flip].abs().max()) / rms)

    cfg = PerturbConfig(perturb_method="ifgsm", flow_loss="l2",
                        output_norm=EPS, n_step=steps)
    attack = make_attack(predict, cfg)

    def noise(a, b, t):
        gen = torch.Generator(device=a.device).manual_seed(SEED)
        return attack(a, b, t, gen)[:2]

    first = noise(img0, img1, gt)
    split = [noise(img0[i:i + 1], img1[i:i + 1], gt[i:i + 1])
             for i in range(2)]
    split = [torch.cat([s[k] for s in split]) for k in range(2)]
    out["halves_vs_whole_share"] = share_apart(split, first)
    out["rerun_share"] = share_apart(noise(img0, img1, gt), first)
    nudged = torch.nextafter(img0, torch.ones_like(img0))
    out["ulp_nudge_share"] = share_apart(noise(nudged, img1, gt), first)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {card}", flush=True)
    base = fetch_model("RAFT", mixed_precision=False, iters=ITERS,
                       device="cpu", seed=0)
    base.module = scale_flow_head(base.module, 0.05)
    host = inputs()
    res = {"card": card, "steps": STEPS, "shape": [2, H, W]}
    for name, flags in SETTINGS.items():
        for k, v in flags.items():
            setattr(torch.backends.cudnn, k, v)
        model = fetch_model("RAFT", mixed_precision=False, iters=ITERS,
                            device="cuda", seed=0)
        model.module.load_state_dict(base.module.state_dict())
        t0 = time.perf_counter()
        res[name] = measure(model, *(x.cuda() for x in host), STEPS)
        res[name]["seconds"] = time.perf_counter() - t0
        print(f"{name}: {json.dumps(res[name])}", flush=True)
    line = json.dumps(res)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "dp_attack_cause.json").write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
