"""Global adversarial attacks on torch autograd (counterpart of
``understanding_flow_robustness_tpu/attacks/global_attacks.py``).

Replaces global_attacks/perturb_model.py:148-821.  Each step is one
forward and one backward of the model with the gradient taken with respect
to the input images (``torch.autograd.grad``), then the update; the JAX
package compiles the whole n-step loop into one program, PyTorch runs it
eagerly, step by step, on the images' device.

Methods (global_attacks/global_constants.py:34): fgsm/fgm (one-step sign,
perturb_model.py:423-473), ifgsm/ifgm (n steps, each clamped to the image
range and then to the eps-ball, :475-619), mifgsm/mifgm (momentum 0.47 with
per-sample L1-normalised gradients, :621-757), gaussian (var = (eps/4)^2,
:274-330), uniform (:332-382), none.  The image corruptions are
``attacks/corruptions.py``, on the host.

``perturb_mode`` ("both"/"left"/"right") selects which frame is attacked;
``targeted`` negates the loss (:452-453).  Randomness (noise, the
diverse-input draws) comes from an explicit ``torch.Generator`` on the
images' device.  ``make_sharded_attack`` runs the attack data-parallel,
each rank on its slice of the batch (``parallel``); the JAX package's
spatially sharded ``make_spatial_attack`` is ROADMAP A13b.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .losses import flow_attack_loss

# Defaults from global_attacks/global_constants.py:19-61
PERTURB_METHOD = "fgsm"
PERTURB_MODE = "both"
OUTPUT_NORM = 0.02
N_STEP = 40
LEARNING_RATE = 2e-3
MOMENTUM = 0.47


@dataclasses.dataclass(frozen=True)
class PerturbConfig:
    perturb_method: str = PERTURB_METHOD
    perturb_mode: str = PERTURB_MODE
    output_norm: float = OUTPUT_NORM
    n_step: int = N_STEP
    learning_rate: float = LEARNING_RATE
    momentum: float = MOMENTUM
    targeted: bool = False
    flow_loss: str = "cossim"
    # perturb_model.py:759-821 / global_constants.py:32 -- probability of
    # applying the random resize-pad input diversification per step.
    probability_diverse_input: float = 0.0


# (img0, img1) NHWC in [0, 1] -> flow, differentiable in the images
# (models/registry.py::predict_flow_differentiable)
PredictFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _mode_mask(mode: str):
    if mode == "both":
        return 1.0, 1.0
    if mode == "left":
        return 1.0, 0.0
    if mode == "right":
        return 0.0, 1.0
    raise ValueError(f"invalid perturbation mode: {mode}")


def _loss_fn(predict: PredictFn, cfg: PerturbConfig):
    sign = -1.0 if cfg.targeted else 1.0

    def loss(img0, img1, ground_truth):
        flow = predict(img0, img1)
        return sign * flow_attack_loss(flow, ground_truth, cfg.flow_loss)

    return loss


def _resize_into_canvas(x: torch.Tensor, nh: int, nw: int, top: int,
                        left: int, mode: str) -> torch.Tensor:
    """Resize (B, H, W, C) ``x`` to (nh, nw) and zero-pad it at (top,
    left) inside the original H x W canvas: torch ``interpolate(size=(nh,
    nw)) + pad`` of perturb_model.py:783-820, with the JAX package's
    arithmetic (f32 scale H / nh, the same index clamps), so the two agree
    value for value."""
    B, H, W, C = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    nh_t = torch.tensor(nh, **f32)
    nw_t = torch.tensor(nw, **f32)
    iy = torch.arange(H, **f32) - torch.tensor(top, **f32)
    ix = torch.arange(W, **f32) - torch.tensor(left, **f32)
    inside = ((iy[:, None] >= 0) & (iy[:, None] < nh_t)
              & (ix[None, :] >= 0) & (ix[None, :] < nw_t))
    if mode == "bilinear":
        # torch area_pixel_compute_source_index (align_corners=False):
        # src = scale*(dst+0.5)-0.5, clamped below at 0.
        sy = torch.clamp((iy + 0.5) * (H / nh_t) - 0.5, min=0.0)
        sx = torch.clamp((ix + 0.5) * (W / nw_t) - 0.5, min=0.0)
        y0 = torch.clamp(torch.floor(sy), 0, H - 1).long()
        x0 = torch.clamp(torch.floor(sx), 0, W - 1).long()
        y1 = torch.clamp(y0 + 1, max=H - 1)
        x1 = torch.clamp(x0 + 1, max=W - 1)
        ly = (sy - y0.float())[:, None, None]
        lx = (sx - x0.float())[None, :, None]
        v00 = x[:, y0[:, None], x0[None, :], :]
        v01 = x[:, y0[:, None], x1[None, :], :]
        v10 = x[:, y1[:, None], x0[None, :], :]
        v11 = x[:, y1[:, None], x1[None, :], :]
        out = ((1 - ly) * ((1 - lx) * v00 + lx * v01)
               + ly * ((1 - lx) * v10 + lx * v11))
    elif mode == "nearest":
        # torch upsample_nearest2d: src = floor(dst * in/out), capped.
        y0 = torch.clamp(torch.floor(iy * (H / nh_t)), 0, H - 1).long()
        x0 = torch.clamp(torch.floor(ix * (W / nw_t)), 0, W - 1).long()
        out = x[:, y0[:, None], x0[None, :], :]
    else:
        raise ValueError(mode)
    return torch.where(inside[None, :, :, None], out, torch.zeros_like(out))


def apply_diverse_input(image0, image1, ground_truth, nh, nw, top, left):
    """The deterministic core of ``__diverse_input``
    (perturb_model.py:759-821): bilinear-resize the images and
    nearest-resize the GT to (nh, nw), zero-pad into the original canvas at
    (top, left), and scale the whole GT (valid channel included, as the
    reference does) by nw/W."""
    W = image0.shape[2]
    img0 = _resize_into_canvas(image0, nh, nw, top, left, "bilinear")
    img1 = _resize_into_canvas(image1, nh, nw, top, left, "bilinear")
    gt = _resize_into_canvas(ground_truth, nh, nw, top, left, "nearest")
    gt = gt * (torch.tensor(nw, dtype=gt.dtype, device=gt.device) / W)
    return img0, img1, gt


def diverse_input(image0, image1, ground_truth, generator: torch.Generator,
                  probability: float):
    """Random resize-pad input diversification (perturb_model.py:759-821):
    with probability p pick nh in [H-H/10, H], nw in [W-W/10, W], a random
    top/left pad, and apply :func:`apply_diverse_input`; otherwise pass the
    inputs through.  The five draws come from ``generator`` every call."""
    H, W = image0.shape[1:3]
    dev = generator.device

    def randint(lo, hi):
        return int(torch.randint(lo, hi, (), generator=generator, device=dev))

    u = float(torch.rand((), generator=generator, device=dev))
    nh = randint(int(H - H / 10.0), H + 1)
    nw = randint(int(W - W / 10.0), W + 1)
    top = randint(0, H - nh + 1)
    left = randint(0, W - nw + 1)
    if u <= probability:
        return apply_diverse_input(image0, image1, ground_truth, nh, nw, top,
                                   left)
    return image0, image1, ground_truth


def _make_grad_fn(predict: PredictFn, cfg: PerturbConfig,
                  generator: Optional[torch.Generator]):
    """Per-step gradient of the attack loss with respect to the
    (pre-diversification) images.  The diverse-input transform sits INSIDE
    the differentiated function, as in the reference's autograd graph
    (perturb_model.py:507-521)."""
    loss = _loss_fn(predict, cfg)
    p = cfg.probability_diverse_input
    diverse = p > 0.0 and generator is not None

    def grad_fn(img0, img1, ground_truth):
        a = img0.detach().requires_grad_()
        b = img1.detach().requires_grad_()
        with torch.enable_grad():
            ins = (diverse_input(a, b, ground_truth, generator, p) if diverse
                   else (a, b, ground_truth))
            return torch.autograd.grad(loss(*ins), (a, b))

    return grad_fn


@torch.no_grad()
def fgsm(predict, image0, image1, ground_truth, cfg: PerturbConfig):
    """One-step fast gradient sign method (perturb_model.py:423-473).  The
    reference routes both "fgsm" and "fgm" here and always takes the sign:
    one-step fgm has no non-sign branch upstream (only ifgm does,
    :529-539)."""
    m0, m1 = _mode_mask(cfg.perturb_mode)
    g0, g1 = _make_grad_fn(predict, cfg, None)(image0, image1, ground_truth)
    return (cfg.output_norm * torch.sign(g0) * m0,
            cfg.output_norm * torch.sign(g1) * m1)


def _ifgsm_step_fn(predict, image0, image1, ground_truth,
                   cfg: PerturbConfig, generator):
    """One step of ifgsm/ifgm, shared by ``ifgsm`` and
    ``perturb_trajectory``: ascend (by the sign for ifgsm, the raw gradient
    for ifgm), clamp the image to [0, 1], clamp the accumulated noise to
    the eps-ball, re-apply."""
    m0, m1 = _mode_mask(cfg.perturb_mode)
    grad_fn = _make_grad_fn(predict, cfg, generator)
    eps = cfg.output_norm
    use_sign = "ifgsm" in cfg.perturb_method

    @torch.no_grad()
    def step(carry):
        out0, out1 = carry
        g0, g1 = grad_fn(out0, out1, ground_truth)
        if use_sign:
            g0, g1 = torch.sign(g0), torch.sign(g1)
        out0 = torch.clamp(out0 + cfg.learning_rate * g0 * m0, 0.0, 1.0)
        out1 = torch.clamp(out1 + cfg.learning_rate * g1 * m1, 0.0, 1.0)
        n0 = torch.clamp(out0 - image0, -eps, eps)
        n1 = torch.clamp(out1 - image1, -eps, eps)
        return image0 + n0, image1 + n1

    return step, (image0, image1)


def _mifgsm_step_fn(predict, image0, image1, ground_truth,
                    cfg: PerturbConfig, generator):
    """One step of mifgsm/mifgm (see ``_ifgsm_step_fn``).  The L1
    normalisation is PER SAMPLE: the reference's whole-tensor torch.sum
    (perturb_model.py:673-679) is the per-sample norm at its only batch
    size, 1 (perturb_main.py:189); a batch-wide sum would couple the
    samples of a batched attack."""
    m0, m1 = _mode_mask(cfg.perturb_mode)
    grad_fn = _make_grad_fn(predict, cfg, generator)
    eps = cfg.output_norm
    mu = cfg.momentum

    @torch.no_grad()
    def step(carry):
        out0, out1, acc0, acc1 = carry
        g0, g1 = grad_fn(out0, out1, ground_truth)
        dims = tuple(range(1, g0.ndim))
        acc0 = mu * acc0 + (1.0 - mu) * g0 / torch.sum(
            torch.abs(g0), dim=dims, keepdim=True)
        acc1 = mu * acc1 + (1.0 - mu) * g1 / torch.sum(
            torch.abs(g1), dim=dims, keepdim=True)
        out0 = torch.clamp(out0 + cfg.learning_rate * torch.sign(acc0) * m0,
                           0.0, 1.0)
        out1 = torch.clamp(out1 + cfg.learning_rate * torch.sign(acc1) * m1,
                           0.0, 1.0)
        n0 = torch.clamp(out0 - image0, -eps, eps)
        n1 = torch.clamp(out1 - image1, -eps, eps)
        return image0 + n0, image1 + n1, acc0, acc1

    return step, (image0, image1, torch.zeros_like(image0),
                  torch.zeros_like(image1))


def _iterate(step_fn, predict, image0, image1, ground_truth, cfg, generator):
    step, carry = step_fn(predict, image0, image1, ground_truth, cfg,
                          generator)
    for _ in range(cfg.n_step):
        carry = step(carry)
    return carry[0] - image0, carry[1] - image1


def ifgsm(predict, image0, image1, ground_truth, cfg: PerturbConfig,
          generator: Optional[torch.Generator] = None):
    """n-step iterative FGSM/FGM (perturb_model.py:475-619): per step,
    optionally diversify the input, ascend, clamp the image to [0, 1],
    clamp the accumulated noise to the eps-ball, re-apply."""
    return _iterate(_ifgsm_step_fn, predict, image0, image1, ground_truth,
                    cfg, generator)


def mifgsm(predict, image0, image1, ground_truth, cfg: PerturbConfig,
           generator: Optional[torch.Generator] = None):
    """Momentum I-FGSM (perturb_model.py:621-757): L1-normalised gradients
    accumulated with momentum mu (default 0.47), sign steps."""
    return _iterate(_mifgsm_step_fn, predict, image0, image1, ground_truth,
                    cfg, generator)


def _batch_draw(draw, img: torch.Tensor, mesh) -> torch.Tensor:
    """``draw(shape)`` for ``img``'s shape; under a mesh, drawn for the
    global batch and sliced to this rank's part, so that a rank's noise is
    its slice of the one-device run's."""
    if mesh is None or mesh.world == 1:
        return draw(img.shape)
    b = img.shape[0]
    full = draw((b * mesh.world,) + tuple(img.shape[1:]))
    return full[mesh.rank * b:(mesh.rank + 1) * b]


@torch.no_grad()
def gaussian_noise(image0, image1, cfg: PerturbConfig,
                   generator: torch.Generator, mesh=None):
    """Gaussian noise, var = (eps/4)^2, output clipped to [0, 1] like
    skimage.random_noise (perturb_model.py:274-330)."""
    m0, m1 = _mode_mask(cfg.perturb_mode)
    sigma = cfg.output_norm / 4.0

    def draw(img):
        return _batch_draw(lambda shape: torch.randn(
            shape, generator=generator, device=img.device, dtype=img.dtype),
            img, mesh)

    out0 = torch.clamp(image0 + sigma * draw(image0), 0.0, 1.0)
    out1 = torch.clamp(image1 + sigma * draw(image1), 0.0, 1.0)
    return (out0 - image0) * m0, (out1 - image1) * m1


@torch.no_grad()
def uniform_noise(image0, image1, cfg: PerturbConfig,
                  generator: torch.Generator, mesh=None):
    """Uniform noise in [-eps, eps) (perturb_model.py:332-382)."""
    m0, m1 = _mode_mask(cfg.perturb_mode)
    eps = cfg.output_norm

    def draw(img):
        u = _batch_draw(lambda shape: torch.rand(
            shape, generator=generator, device=img.device, dtype=img.dtype),
            img, mesh)
        return (2.0 * eps) * u - eps

    return draw(image0) * m0, draw(image1) * m1


def perturb(
    predict: PredictFn,
    image0: torch.Tensor,
    image1: torch.Tensor,
    ground_truth: torch.Tensor,
    cfg: PerturbConfig,
    generator: Optional[torch.Generator] = None,
    mesh=None,
):
    """Run the configured attack on (B, H, W, 3) images in [0, 1] against
    the (B, H, W, 2 or 3) ground truth.  Returns (noise0, noise1, adv0,
    adv1): the adversarial images clamped to [0, 1] and the noises their
    final deltas (perturb_model.py:260-272).  gaussian and uniform need
    ``generator``; the iterative methods use it for the diverse input.
    ``mesh``: the images are this rank's slice of a data-parallel batch
    (``make_sharded_attack``)."""
    method = cfg.perturb_method
    if method in ("fgsm", "fgm"):
        noise0, noise1 = fgsm(predict, image0, image1, ground_truth, cfg)
    elif method in ("ifgsm", "ifgm"):
        noise0, noise1 = ifgsm(predict, image0, image1, ground_truth, cfg,
                               generator)
    elif method in ("mifgsm", "mifgm"):
        noise0, noise1 = mifgsm(predict, image0, image1, ground_truth, cfg,
                                generator)
    elif method in ("gaussian", "uniform"):
        if generator is None:
            raise ValueError(f"{method} noise needs a torch.Generator")
        fn = gaussian_noise if method == "gaussian" else uniform_noise
        noise0, noise1 = fn(image0, image1, cfg, generator, mesh)
    elif method == "none":
        noise0 = torch.zeros_like(image0)
        noise1 = torch.zeros_like(image1)
    else:
        raise ValueError(f"invalid perturbation method: {method}")

    with torch.no_grad():
        adv0 = torch.clamp(image0 + noise0, 0.0, 1.0)
        adv1 = torch.clamp(image1 + noise1, 0.0, 1.0)
        return adv0 - image0, adv1 - image1, adv0, adv1


def perturb_trajectory(
    predict: PredictFn,
    image0: torch.Tensor,
    image1: torch.Tensor,
    ground_truth: torch.Tensor,
    cfg: PerturbConfig,
    generator: Optional[torch.Generator] = None,
):
    """Like :func:`perturb` but also returns the per-step noise trajectory
    ``(n_step, B, H, W, C)`` of each frame -- the data behind the
    reference's ``--show_evolve`` GIFs (perturb_model.py:497,582,604-614).
    The iterative methods run the same step as ``perturb``; one-step and
    noise methods return a trajectory of length 1."""
    method = cfg.perturb_method
    if method in ("ifgsm", "ifgm", "mifgsm", "mifgm"):
        step_fn = (_ifgsm_step_fn if method in ("ifgsm", "ifgm")
                   else _mifgsm_step_fn)
        step, carry = step_fn(predict, image0, image1, ground_truth, cfg,
                              generator)
        tr0, tr1 = [], []
        for _ in range(cfg.n_step):
            carry = step(carry)
            tr0.append(carry[0] - image0)
            tr1.append(carry[1] - image1)
        noise0, noise1 = carry[0] - image0, carry[1] - image1
        tr0, tr1 = torch.stack(tr0), torch.stack(tr1)
    else:
        noise0, noise1, _, _ = perturb(predict, image0, image1, ground_truth,
                                       cfg, generator)
        tr0, tr1 = noise0[None], noise1[None]
    with torch.no_grad():
        adv0 = torch.clamp(image0 + noise0, 0.0, 1.0)
        adv1 = torch.clamp(image1 + noise1, 0.0, 1.0)
    return (adv0 - image0, adv1 - image1, adv0, adv1), (tr0, tr1)


def make_attack(predict: PredictFn, cfg: PerturbConfig):
    """The counterpart of ``make_jitted_attack``: the configured attack as
    one callable, ``run(image0, image1, ground_truth, generator=None) ->
    (noise0, noise1, adv0, adv1)``.  Nothing is compiled: each of its
    steps is one eager forward and backward of the model."""

    def run(image0, image1, ground_truth, generator=None):
        return perturb(predict, image0, image1, ground_truth, cfg, generator)

    return run


def make_sharded_attack(predict: PredictFn, cfg: PerturbConfig, mesh):
    """Data-parallel white-box attack (the JAX package's
    ``make_sharded_attack``, global_attacks.py:386-413): ``run(image0,
    image1, ground_truth, generator=None)`` attacks this rank's slice of
    the batch (``parallel.shard_batch``) and returns its slices of (noise0,
    noise1, adv0, adv1).  The attack is per sample (no gradient crosses the
    batch axis), so it needs no collective; noise drawn for the batch
    (gaussian, uniform) is drawn for the global batch from ``generator``
    (seeded alike on every rank) and sliced, and the diverse input's draws
    are per batch, so a rank's result is its slice of the one-device
    run's."""

    def run(image0, image1, ground_truth, generator=None):
        return perturb(predict, image0, image1, ground_truth, cfg, generator,
                       mesh)

    return run
