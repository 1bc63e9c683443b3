"""The cuDNN workspace each convolution of a model takes on the card,
unsharded and as a spatial mesh's halo convolution would call it, and
under other call forms of the same halo convolution.

Runs one unsharded forward of each model at 384x1280 (seeded weights,
random frames) with a hook on every ``nn.Conv2d`` that records its input,
then replays each distinct call alone and measures its workspace: the
allocator's peak during the call less what was live before and the
output.  It replays too the second of ``--blocks`` row blocks with its
halo under each form of ``forms``: "pad0" NCHW with padding 0 along H,
as ``parallel.spatial.SpatialConv2d`` calls a convolution of 8 or more
outputs (and once called every one), "sym" with the whole call's H padding and its extra rows
cut, "nhwc" channels-last, "wpad" with W padded outside the call,
"cout8" with zero filters up to 8 outputs, "nocudnn" without cuDNN; each
form's rows are held against the whole call's (max |d| / max |whole|).
Prints the ``--top`` calls by the "pad0" workspace, and with ``--out``
writes a JSON line per call to that file.

    python3 scripts/torch_spatial_conv_workspace.py [--models FlowNetC ...]
        [--out calls.jsonl]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from understanding_flow_robustness_tpu_torch.models import (  # noqa: E402
    fetch_model,
    predict_flow,
)

MODELS = {"FlowNetC": 1, "PWCNet": 1, "FlowNet2": 1, "SpyNet": 1, "RAFT": 2}


def workspace(fn) -> tuple:
    """(bytes of workspace, output) of ``fn()``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    y = fn()
    torch.cuda.synchronize()
    ws = torch.cuda.max_memory_allocated() - before \
        - y.untyped_storage().nbytes()
    return max(ws, 0), y


def halo_geometry(k: int, s: int, p: int, d: int) -> tuple:
    """Rows above and below a block that SpatialConv2d exchanges."""
    return p, d * (k - 1) - p - s + 1


def forms(x, w, b, conv, h) -> dict:
    """{form: fn() -> the block's output rows} for row block 1 of a conv
    (stride s, padding p along H) on its halo'd input."""
    k, s = conv.kernel_size[0], conv.stride[0]
    p, d = conv.padding[0], conv.dilation[0]
    top, bottom = halo_geometry(k, s, p, d)
    # block 1 of ``blocks`` with its halo, zero rows past the image as the
    # exchange gives them
    xh = F.pad(x, (0, 0, top, bottom))[:, :, h:2 * h + top + bottom]
    xh = xh.contiguous()
    pw, stride, dil = conv.padding[1], conv.stride, conv.dilation
    g = conv.groups
    out = {}
    out["pad0"] = lambda: F.conv2d(xh, w, b, stride, (0, pw), dil, g)
    if p % s == 0:
        # symmetric H padding as the unsharded call, its extra rows cut
        out["sym"] = lambda: F.conv2d(xh, w, b, stride, (p, pw), dil, g)[
            :, :, p // s:p // s + h // s]
    out["nhwc"] = lambda: F.conv2d(
        xh.contiguous(memory_format=torch.channels_last),
        w.contiguous(memory_format=torch.channels_last), b, stride, (0, pw),
        dil, g)
    out["wpad"] = lambda: F.conv2d(F.pad(xh, (pw, pw)), w, b, stride, 0, dil,
                                   g)
    cpad = -w.shape[0] % 8
    if cpad:
        wz = torch.cat([w, w.new_zeros((cpad,) + w.shape[1:])])
        bz = None if b is None else torch.cat([b, b.new_zeros(cpad)])
        out["cout8"] = lambda: F.conv2d(xh, wz, bz, stride, (0, pw), dil,
                                        g)[:, :w.shape[0]]

    def nocudnn():
        with torch.backends.cudnn.flags(enabled=False):
            return F.conv2d(xh, w, b, stride, (0, pw), dil, g)
    out["nocudnn"] = nocudnn
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", nargs="+", default=list(MODELS))
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--out", help="a JSON line per call to this file")
    args = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"gpu: {card}, torch {torch.__version__}", flush=True)
    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in args.models:
        b = MODELS[name]
        model = fetch_model(name, device="cuda", seed=600)
        calls, seen = [], set()

        def hook(mod, inp):
            x = inp[0]
            key = (id(mod), tuple(x.shape))
            if key not in seen and isinstance(mod, torch.nn.Conv2d):
                seen.add(key)
                calls.append((mod, x.detach().clone(),
                              torch.is_autocast_enabled("cuda")))

        hooks = [m.register_forward_pre_hook(hook)
                 for m in model.module.modules()
                 if isinstance(m, torch.nn.Conv2d)]
        imgs = [torch.rand((b, 384, 1280, 3), generator=gen, device="cuda")
                for _ in range(2)]
        predict_flow(model, *imgs)
        for hk in hooks:
            hk.remove()
        rows = []
        with torch.no_grad():
            for mod, x, autocast in calls:
                with torch.autocast("cuda", dtype=torch.bfloat16,
                                    enabled=autocast):
                    ws_whole, whole = workspace(lambda: mod(x))
                    h = x.shape[2] // args.blocks
                    k, s = mod.kernel_size[0], mod.stride[0]
                    if h % s or h < halo_geometry(
                            k, s, mod.padding[0], mod.dilation[0])[0]:
                        continue
                    w = mod.weight
                    ref = whole[:, :, h // s:2 * h // s].float()
                    del whole
                    res = {}
                    for form, fn in forms(x, w, mod.bias, mod, h).items():
                        ws, y = workspace(fn)
                        err = float((y.float() - ref).abs().max()
                                    / (ref.abs().max() + 1e-30))
                        res[form] = {"ws_mib": ws / 2 ** 20, "rel": err}
                rows.append({"model": name, "conv": tuple(w.shape),
                             "k": k, "s": s, "p": mod.padding[0],
                             "d": mod.dilation[0], "in": tuple(x.shape),
                             "bf16": autocast, "whole_ws_mib":
                             ws_whole / 2 ** 20, "block": res})
                rows_out.append(rows[-1])
        rows.sort(key=lambda r: -r["block"]["pad0"]["ws_mib"])
        for r in rows[:args.top]:
            print(f"{name} {r['conv']} k{r['k']} s{r['s']} p{r['p']} "
                  f"d{r['d']} in {r['in']} bf16={r['bf16']}: whole "
                  f"{r['whole_ws_mib']:.1f} MiB; block "
                  + ", ".join(f"{f} {v['ws_mib']:.1f} MiB ({v['rel']:.1e})"
                              for f, v in r["block"].items()), flush=True)
        del model, calls
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows_out))


if __name__ == "__main__":
    main()
