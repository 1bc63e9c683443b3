"""Weight bridge between reference checkpoints, the JAX package's flax
variables and the port (counterpart of
``understanding_flow_robustness_tpu/models/convert.py``).

Port modules carry the reference's parameter names, so a reference
checkpoint is a port ``state_dict`` once its wrappers are removed
(``load_reference_state_dict``; SPyNet's per-level files:
``load_spynet_dir``), and the JAX package's ``convert_raft`` /
``convert_pwcnet`` / ``convert_flownet_c`` / ``convert_flownet_c_flex`` /
``convert_flownet_c_larger`` / ``convert_flownet_s`` / ``convert_flownet2``
map a port ``state_dict`` to flax variables.  ``raft_state_dict_from_jax``,
``pwcnet_state_dict_from_jax``, ``spynet_state_dict_from_jax``,
``flownet_c_state_dict_from_jax``, ``flownet_c_flex_state_dict_from_jax``,
``flownet_s_state_dict_from_jax`` and ``flownet2_state_dict_from_jax`` go
the other way.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def load_reference_state_dict(path: str) -> dict:
    """A reference checkpoint file as a plain state dict: unwraps
    ``{"state_dict": ...}`` / ``{"model_state_dict": ...}`` / ``{"model":
    ...}``, strips the DataParallel ``module.`` prefix and drops
    ``num_batches_tracked`` (``convert.py::to_numpy_state_dict``).  Load
    the result with ``load_state_dict(..., strict=True)``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model_state_dict", "model"):
        if wrapper in obj and hasattr(obj[wrapper], "items"):
            obj = obj[wrapper]
            break
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.endswith("num_batches_tracked"):
            continue
        out[k] = v
    return out


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def raft_state_dict_from_jax(variables) -> dict:
    """Flax RAFT variables (nested dicts of arrays) -> reference/port
    state dict of f32 tensors; the inverse of ``convert_raft``.

    HWIO kernels go back to OIHW; batch- and group-norm scale/bias (and
    mean/var) to weight/bias (running_mean/running_var); ``layerX_Y`` to
    ``layerX.Y``, ``mask_0``/``mask_2`` to ``mask.0``/``mask.2``, the
    ``downsample`` conv to ``downsample.0`` and the norm after it to both
    its own name and ``downsample.1``: ``norm3`` in a residual block,
    ``norm4`` in the small encoder's bottleneck block (a block with a
    ``conv3``).  The JAX package's ``convert_raft`` maps every
    ``downsample.1`` to ``norm3`` (convert.py:309-313), harmless there only
    because the small encoders' norms carry no parameters.  A
    FlowNetCEncoder (an encoder with a ``conv3`` of its own) maps
    ``conv{i}`` to its Sequential's ``conv{i}.0`` (convert.py:314-317); the
    WoContext variant's top-level ``conv_redir`` keeps its name."""
    params = variables["params"]
    flownetc = {net for net in ("fnet", "cnet")
                if "conv3" in params.get(net, {})}
    # the blocks with a conv3 (bottlenecks): their downsample norm is norm4
    bottlenecks = {".".join(path[1:-2]) for path in _flatten(variables)
                   if path[-2] == "conv3" and path[1] not in flownetc}
    sd = {}
    for path, val in _flatten(variables).items():
        coll, *names, leaf = path
        if (coll, leaf) not in _LEAF:
            raise KeyError(f"unmapped flax variable: {'/'.join(path)}")
        arr = np.array(val, np.float32)  # a writable copy
        if leaf == "kernel":
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        mod = ".".join(names)
        mod = re.sub(r"layer(\d)_(\d)", r"layer\1.\2", mod)
        mod = re.sub(r"mask_(\d)", r"mask.\1", mod)
        mod = re.sub(r"downsample$", "downsample.0", mod)
        if names[0] in flownetc:
            mod += ".0"
        attr = _LEAF[(coll, leaf)]
        sd[f"{mod}.{attr}"] = torch.from_numpy(arr)
        block, _, leaf_mod = mod.rpartition(".")
        if leaf_mod == ("norm4" if ".".join(names[:-1]) in bottlenecks
                        else "norm3"):
            sd[f"{block}.downsample.1.{attr}"] = torch.from_numpy(arr)
    return sd


def _oihw(kernel) -> torch.Tensor:
    """A flax HWIO conv kernel as a torch Conv2d weight (O, I, kh, kw): the
    inverse of the JAX package's ``_conv_w``."""
    return torch.from_numpy(np.ascontiguousarray(
        np.array(kernel, np.float32).transpose(3, 2, 0, 1)))


def _iohw(kernel) -> torch.Tensor:
    """A flax (kh, kw, I, O) transposed-conv kernel as a torch
    ConvTranspose2d weight (I, O, kh, kw): the inverse of the JAX
    package's ``_convT_w`` (convert.py:30-31), not of ``_conv_w``."""
    return torch.from_numpy(np.ascontiguousarray(
        np.array(kernel, np.float32).transpose(2, 3, 0, 1)))


def _bias(b) -> torch.Tensor:
    return torch.from_numpy(np.array(b, np.float32))


_PWC_SEQ = re.compile(r"conv\d(aa|a|b)?|conv\d_\d|dc_conv[1-6]")
_PWC_DECONV = re.compile(r"deconv\d|upfeat\d")


def pwcnet_state_dict_from_jax(variables, deconv2: dict) -> dict:
    """Flax PWCNet variables -> reference/port state dict of f32 tensors;
    the inverse of ``convert_pwcnet``.  The Sequential conv blocks get
    their ``.0`` (``conv1a`` -> ``conv1a.0.weight``), ``deconv*`` and
    ``upfeat*`` are transposed convs.  The JAX module has no counterpart
    of the reference's dead ``deconv2``: its ``weight`` and ``bias`` come
    from ``deconv2`` (e.g. the port module's own initialisation)."""
    sd = {}
    for name, leaves in variables["params"].items():
        mod = f"{name}.0" if _PWC_SEQ.fullmatch(name) else name
        w = _iohw if _PWC_DECONV.fullmatch(name) else _oihw
        sd[f"{mod}.weight"] = w(leaves["kernel"])
        sd[f"{mod}.bias"] = _bias(leaves["bias"])
    sd["deconv2.weight"] = deconv2["weight"].detach().float().clone()
    sd["deconv2.bias"] = deconv2["bias"].detach().float().clone()
    return sd


# the FlowNet family's block leaves: (sub-module, flax leaf) -> (index in
# the reference's Sequential, torch name)
_FLOWNET_BLOCK = {
    ("conv", "kernel"): ("0", "weight"), ("conv", "bias"): ("0", "bias"),
    ("deconv", "kernel"): ("0", "weight"), ("deconv", "bias"): ("0", "bias"),
    ("bn", "scale"): ("1", "weight"), ("bn", "bias"): ("1", "bias"),
    ("bn", "mean"): ("1", "running_mean"), ("bn", "var"): ("1", "running_var"),
}


def _flownet_state_dict_from_jax(variables, rename=lambda name: name) -> dict:
    """Flax FlowNet-family variables -> reference/port state dict of f32
    tensors, the inverse of the JAX package's FlowNet rules
    (convert.py:140-171): a ConvBlock ``conv1/conv/kernel`` becomes
    ``conv1.0.weight`` (its batch norm ``conv1.1.*``), a DeconvBlock
    ``deconv5/deconv/kernel`` becomes ``deconv5.0.weight``, the plain
    ``predict_flow*`` and ``upsampled_flow*`` keep their names; transposed
    convs (``deconv*``, ``upsampled_flow*``) go back to (I, O, kh, kw).
    ``rename`` maps each flax module name to the port's."""
    sd = {}
    for path, val in _flatten(variables).items():
        _, *names, leaf = path
        transposed = names[-1] == "deconv" or names[-1].startswith(
            "upsampled_flow")
        if names[-1] in ("conv", "deconv", "bn"):
            idx, attr = _FLOWNET_BLOCK[(names[-1], leaf)]
            mod = f"{rename(names[-2])}.{idx}"
        else:
            attr = _LEAF[(path[0], leaf)]
            mod = rename(names[-1])
        if leaf == "kernel":
            sd[f"{mod}.{attr}"] = (_iohw if transposed else _oihw)(val)
        else:
            sd[f"{mod}.{attr}"] = _bias(val)
    return sd


def flownet_c_state_dict_from_jax(variables) -> dict:
    """Flax FlowNetC variables -> port state dict; the inverse of
    ``convert_flownet_c``."""
    return _flownet_state_dict_from_jax(variables)


def flownet_c_flex_state_dict_from_jax(variables,
                                       stage_names: str = "convs") -> dict:
    """Flax FlowNetCFlex variables -> state dict of the port's
    ``FlowNetCFlex(stage_names=...)``: the inverse of
    ``convert_flownet_c_flex`` ("convs": ``convs1_0`` -> ``convs1.0``;
    "flat": entries ``conv1`` stay, repetitions ``convs1_1`` ->
    ``convs1.1``) and, with "larger_field", of ``convert_flownet_c_larger``
    (``convs1_0`` -> ``conv1``, ``convs1_1`` -> ``conv11``)."""
    def rename(name):
        m = re.fullmatch(r"convs(\d)_(\d)", name)
        if m is None:
            return name
        if stage_names == "larger_field":
            stage, rep = m.groups()
            return f"conv{stage}" + (rep if rep != "0" else "")
        return f"convs{m.group(1)}.{m.group(2)}"
    return _flownet_state_dict_from_jax(variables, rename)


def flownet_s_state_dict_from_jax(variables) -> dict:
    """Flax FlowNetS2 variables (the registry's "FlowNetS", its layers
    under ``net``) -> port state dict with the layers at the top level, as
    in the reference's checkpoint; the inverse of ``convert_flownet_s``."""
    inner = {coll: tree["net"] for coll, tree in variables.items()}
    return _flownet_state_dict_from_jax(inner)


def flownet2_state_dict_from_jax(variables) -> dict:
    """Flax FlowNet2 variables (or a partial stack's) -> port state dict;
    the inverse of ``convert_flownet2``: each sub-network's FlowNet-family
    names under its own prefix (``flownetc``, ``flownets_1``,
    ``flownets_2``, ``flownets_d``, ``flownetfusion``; ``flownets`` in
    FlowNet2Single("S")), ``inter_conv*`` as conv blocks."""
    sd = {}
    for sub in variables["params"]:
        inner = {coll: tree[sub] for coll, tree in variables.items()
                 if sub in tree}
        sd.update({f"{sub}.{k}": v for k, v in
                   _flownet_state_dict_from_jax(inner).items()})
    return sd


def spynet_state_dict_from_jax(variables) -> dict:
    """Flax SpyNet variables -> port state dict: ``basic{L}/conv{k}`` to
    ``moduleBasic.{L}.moduleBasic.{2k}`` (the convs of the Sequential,
    between its ReLUs)."""
    sd = {}
    for level, convs in variables["params"].items():
        lvl = int(level[len("basic"):])
        for name, leaves in convs.items():
            k = int(name[len("conv"):])
            mod = f"moduleBasic.{lvl}.moduleBasic.{2 * k}"
            sd[f"{mod}.weight"] = _oihw(leaves["kernel"])
            sd[f"{mod}.bias"] = _bias(leaves["bias"])
    return sd


def load_spynet_dir(weights_dir: str, nlevels: int = 6,
                    strmodel: str = "F") -> dict:
    """The reference's per-level SPyNet weight files
    (``{weights_dir}/modelL{L}_{strmodel}-{k}-{weight,bias}.pth.tar``,
    models/spynet.py:81-127) as a port state dict.  Module level L reads
    file level L+1; the chairs models ('3', '4') reuse level 5's files for
    level 6 (the JAX package's ``convert_spynet_dir``)."""
    sd = {}
    for level in range(nlevels):
        file_level = 4 if level == 5 and strmodel in ("3", "4") else level
        for k in range(5):
            stem = f"{weights_dir}/modelL{file_level + 1}_{strmodel}-{k + 1}"
            mod = f"moduleBasic.{level}.moduleBasic.{2 * k}"
            for attr in ("weight", "bias"):
                sd[f"{mod}.{attr}"] = torch.load(
                    f"{stem}-{attr}.pth.tar", map_location="cpu",
                    weights_only=True).float()
    return sd
