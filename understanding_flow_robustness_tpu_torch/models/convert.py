"""Weight bridge between reference checkpoints, the JAX package's flax
variables and the port (counterpart of
``understanding_flow_robustness_tpu/models/convert.py``).

Port modules carry the reference's parameter names, so a reference
checkpoint is a port ``state_dict`` once its wrappers are removed
(``load_reference_state_dict``; SPyNet's per-level files:
``load_spynet_dir``).  ``convert_raft`` / ``convert_pwcnet`` /
``convert_flownet_c`` / ``convert_flownet_c_flex`` /
``convert_flownet_c_larger`` / ``convert_flownet_s`` / ``convert_flownet2``
are the port's copy of the JAX package's rules from a state dict to flax
variables, and ``convert_spynet`` lays SpyNet out as the JAX package's
``convert_spynet_dir`` does; ``flax_variables(module)`` picks the rules by
the module's type.  ``raft_state_dict_from_jax``,
``pwcnet_state_dict_from_jax``, ``spynet_state_dict_from_jax``,
``flownet_c_state_dict_from_jax``, ``flownet_c_flex_state_dict_from_jax``,
``flownet_s_state_dict_from_jax`` and ``flownet2_state_dict_from_jax`` go
the other way (``state_dict_from_flax(module, variables)``).
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


def _f32_tensor(x) -> torch.Tensor:
    """``x`` as an f32 CPU tensor sharing its memory where it can (a
    read-only array, e.g. a JAX array's, is copied first)."""
    a = np.asarray(x, np.float32)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _oihw(kernel) -> torch.Tensor:
    """A flax HWIO conv kernel as a torch Conv2d weight (O, I, kh, kw): the
    inverse of the JAX package's ``_conv_w``; a new tensor (torch's
    parallel copy: numpy's strided one takes 4x as long on FlowNet2)."""
    return _f32_tensor(kernel).permute(3, 2, 0, 1).contiguous()


def _iohw(kernel) -> torch.Tensor:
    """A flax (kh, kw, I, O) transposed-conv kernel as a torch
    ConvTranspose2d weight (I, O, kh, kw): the inverse of the JAX
    package's ``_convT_w`` (convert.py:30-31), not of ``_conv_w``; a new
    tensor."""
    return _f32_tensor(kernel).permute(2, 3, 0, 1).contiguous()


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


# ---------------------------------------------------------------------------
# Port state dict -> flax variables: the port's copy of the JAX package's
# convert_<model> rules (models/convert.py:26-384), in numpy
# ---------------------------------------------------------------------------

def _conv_w(x):
    return np.ascontiguousarray(np.transpose(x, (2, 3, 1, 0)))


def _convT_w(x):
    return np.ascontiguousarray(np.transpose(x, (2, 3, 0, 1)))


def _ident(x):
    return np.asarray(x)


def _set(tree: dict, path: tuple, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def to_numpy_state_dict(sd) -> dict:
    """A state dict (of tensors or arrays) as f32-or-native numpy arrays,
    without the ``module.`` prefix and ``num_batches_tracked`` entries
    (the JAX package's ``to_numpy_state_dict``)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.endswith("num_batches_tracked"):
            continue
        out[k] = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                            else v)
    return out


# a leaf's transform applied to its shape (flax_shapes)
_SHAPE_OF = {_conv_w: lambda s: (s[2], s[3], s[1], s[0]),
             _convT_w: lambda s: (s[2], s[3], s[0], s[1]),
             _ident: lambda s: s}


def _apply_rules(sd: dict, rules: list) -> dict:
    """Each key goes to the first rule whose pattern matches it in full;
    a rule returning None drops the key, and a key no rule matches
    raises (strict loading).  A value that is a shape tuple gives the
    converted leaf's shape."""
    params: dict = {}
    batch_stats: dict = {}
    for key, val in sd.items():
        for pattern, fn in rules:
            m = re.fullmatch(pattern, key)
            if m is None:
                continue
            res = fn(m)
            if res is None:
                break
            coll, path, xform = res
            _set(params if coll == "params" else batch_stats, path,
                 _SHAPE_OF[xform](val) if isinstance(val, tuple)
                 else xform(val))
            break
        else:
            raise KeyError(f"unmapped checkpoint key: {key}")
    out = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


def _bn_leaf(attr: str):
    return {
        "weight": ("params", "scale", _ident),
        "bias": ("params", "bias", _ident),
        "running_mean": ("batch_stats", "mean", _ident),
        "running_var": ("batch_stats", "var", _ident),
    }[attr]


def _seq_block_rule(prefix_map, name_pattern: str, deconv: bool = False):
    """The reference's Sequential conv()/deconv() blocks: ``<name>.0.*``
    the conv, ``<name>.1.*`` its batch norm."""
    sub = "deconv" if deconv else "conv"
    w_xform = _convT_w if deconv else _conv_w

    def fn(m):
        base = prefix_map(m.group(1))
        attr = m.group("attr")
        if m.group("idx") == "0":
            if attr == "weight":
                return ("params", base + (sub, "kernel"), w_xform)
            return ("params", base + (sub, "bias"), _ident)
        coll, leaf, xform = _bn_leaf(attr)
        return (coll, base + ("bn", leaf), xform)

    return (rf"({name_pattern})\.(?P<idx>[01])\."
            rf"(?P<attr>weight|bias|running_mean|running_var)", fn)


def _plain_conv_rule(name_pattern: str, prefix_map, deconv: bool = False):
    w_xform = _convT_w if deconv else _conv_w

    def fn(m):
        base = prefix_map(m.group(1))
        if m.group("attr") == "weight":
            return ("params", base + ("kernel",), w_xform)
        return ("params", base + ("bias",), _ident)

    return (rf"({name_pattern})\.(?P<attr>weight|bias)", fn)


_FLOWNET_DECODER_CONVT = r"upsampled_flow\d_to_\d"


def _flownet_rules(prefix: tuple = ()) -> list:
    def p(name):
        return prefix + (name,)
    return [
        _seq_block_rule(p, r"conv\d(?:_\d)?|conv_redir|conv0|inter_conv\d"),
        _seq_block_rule(p, r"deconv\d", deconv=True),
        _plain_conv_rule(r"predict_flow\d", p),
        _plain_conv_rule(_FLOWNET_DECODER_CONVT, p, deconv=True),
    ]


def convert_flownet_s(sd: dict) -> dict:
    """The registry's FlowNetS (FlowNet2-S): its layers under ``net``."""
    return _apply_rules(sd, _flownet_rules(("net",)))


def convert_flownet_c(sd: dict) -> dict:
    return _apply_rules(sd, _flownet_rules())


def convert_flownet_c_flex(sd: dict) -> dict:
    """FlowNetC_flexible_larger_field: ``convs1.0.0.weight`` ->
    ``convs1_0``; the flat names (``conv1``) take the base rules."""

    def flex_fn(m):
        base = (f"convs{m.group('stage')}_{m.group('rep')}",)
        if m.group("idx") == "0":
            if m.group("attr") == "weight":
                return ("params", base + ("conv", "kernel"), _conv_w)
            return ("params", base + ("conv", "bias"), _ident)
        coll, leaf, xform = _bn_leaf(m.group("attr"))
        return (coll, base + ("bn", leaf), xform)

    rules = [(r"convs(?P<stage>[123])\.(?P<rep>\d)\.(?P<idx>[01])\."
              r"(?P<attr>weight|bias|running_mean|running_var)", flex_fn)]
    return _apply_rules(sd, rules + _flownet_rules())


def convert_flownet_c_larger(sd: dict) -> dict:
    """FlowNetC_larger_field: ``conv1``/``conv11``/... renamed into the
    flexible layout."""
    stage_map = {"conv1": "convs1.0", "conv11": "convs1.1",
                 "conv2": "convs2.0", "conv21": "convs2.1",
                 "conv3": "convs3.0", "conv31": "convs3.1"}
    renamed = {}
    for k, v in sd.items():
        head, _, rest = k.partition(".")
        renamed[f"{stage_map[head]}.{rest}" if head in stage_map else k] = v
    return convert_flownet_c_flex(renamed)


def convert_flownet2(sd: dict) -> dict:
    """The FlowNet2 cascade: each sub-network's FlowNet-family keys under
    its prefix."""
    def fn_for(deconv: bool, seq: bool):
        w = _convT_w if deconv else _conv_w

        def fn(m):
            base = (m.group("sub"), m.group("name"))
            attr = m.group("attr")
            if seq:
                if m.group("idx") == "0":
                    leaf = "deconv" if deconv else "conv"
                    if attr == "weight":
                        return ("params", base + (leaf, "kernel"), w)
                    return ("params", base + (leaf, "bias"), _ident)
                coll, leaf, xform = _bn_leaf(attr)
                return (coll, base + ("bn", leaf), xform)
            if attr == "weight":
                return ("params", base + ("kernel",), w)
            return ("params", base + ("bias",), _ident)

        return fn

    subs = r"(?P<sub>flownetc|flownets_1|flownets_2|flownets_d|flownetfusion)"
    bn_attr = r"(?P<attr>weight|bias|running_mean|running_var)"
    rules = [
        (rf"{subs}\.(?P<name>conv\d(?:_\d)?|conv_redir|conv0|inter_conv\d)"
         rf"\.(?P<idx>[01])\.{bn_attr}", fn_for(False, True)),
        (rf"{subs}\.(?P<name>deconv\d)\.(?P<idx>[01])\.{bn_attr}",
         fn_for(True, True)),
        (rf"{subs}\.(?P<name>predict_flow\d)\.(?P<attr>weight|bias)",
         fn_for(False, False)),
        (rf"{subs}\.(?P<name>{_FLOWNET_DECODER_CONVT})"
         rf"\.(?P<attr>weight|bias)", fn_for(True, False)),
    ]
    return _apply_rules(sd, rules)


def convert_pwcnet(sd: dict) -> dict:
    """PWC-Net; the reference's dead ``deconv2`` (PWCNet.py:143) is
    dropped: the flax module has no counterpart."""
    sd = {k: v for k, v in sd.items() if not k.startswith("deconv2.")}

    def seq_conv_fn(m):
        base = (m.group(1),)
        if m.group("attr") == "weight":
            return ("params", base + ("kernel",), _conv_w)
        return ("params", base + ("bias",), _ident)

    def p(name):
        return (name,)

    return _apply_rules(sd, [
        (r"(conv\d(?:aa|a|b)?|conv\d_\d|dc_conv[1-6])\.0\."
         r"(?P<attr>weight|bias)", seq_conv_fn),
        _plain_conv_rule(r"predict_flow\d|dc_conv7", p),
        _plain_conv_rule(r"deconv\d|upfeat\d", p, deconv=True),
    ])


def convert_raft(sd: dict) -> dict:
    """RAFT: ``layerX.Y`` -> ``layerX_Y``, ``mask.0`` -> ``mask_0``, the
    ``downsample`` conv, and every ``downsample.1`` -> ``norm3``, as the
    JAX package maps it (convert.py:309-313; the reading side's
    ``raft_state_dict_from_jax`` bridges the small encoder's ``norm4``)."""

    def enc_fn(m):
        net, rest, attr = m.group("net"), m.group("rest"), m.group("attr")
        lm = re.fullmatch(r"layer(\d)\.(\d)\.(.*)", rest)
        if lm:
            base: tuple = (net, f"layer{lm.group(1)}_{lm.group(2)}")
            rest = lm.group(3)
        else:
            base = (net,)
        if rest == "downsample.0":
            rest = "downsample"
        elif rest == "downsample.1":
            rest = "norm3"
        elif rest.endswith(".0"):  # FlowNetCEncoder's Sequential blocks
            rest = rest[:-2]
        if rest.startswith("norm"):
            coll, leaf, xform = _bn_leaf(attr)
            return (coll, base + (rest, leaf), xform)
        if attr == "weight":
            return ("params", base + (rest, "kernel"), _conv_w)
        return ("params", base + (rest, "bias"), _ident)

    def upd_fn(m):
        name = m.group("name").replace("mask.0", "mask_0").replace(
            "mask.2", "mask_2")
        base = ("update_block",) + tuple(name.split("."))
        if m.group("attr") == "weight":
            return ("params", base + ("kernel",), _conv_w)
        return ("params", base + ("bias",), _ident)

    return _apply_rules(sd, [
        (r"(?P<net>fnet|cnet)\.(?P<rest>.+?)\."
         r"(?P<attr>weight|bias|running_mean|running_var)", enc_fn),
        (r"update_block\.(?P<name>.+?)\.(?P<attr>weight|bias)", upd_fn),
        _plain_conv_rule(r"conv_redir", lambda n: (n,)),
    ])


def convert_spynet(sd: dict) -> dict:
    """SpyNet: ``moduleBasic.{L}.moduleBasic.{2k}`` -> ``basic{L}/conv{k}``
    (the layout of the JAX package's ``convert_spynet_dir``, which reads
    the same weights from the per-level files)."""
    def fn(m):
        base = (f"basic{m.group('level')}", f"conv{int(m.group('idx')) // 2}")
        if m.group("attr") == "weight":
            return ("params", base + ("kernel",), _conv_w)
        return ("params", base + ("bias",), _ident)

    return _apply_rules(sd, [
        (r"moduleBasic\.(?P<level>\d+)\.moduleBasic\.(?P<idx>[02468])\."
         r"(?P<attr>weight|bias)", fn)])


def _family(module) -> str:
    """The converter family of a port module (the JAX registry's
    ``ModelSpec.converter``)."""
    from .flownet2 import FlowNet2, FlowNetS2
    from .flownet_family import FlowNetC, FlowNetCFlex
    from .pwcnet import PWCNet
    from .raft_model import RAFT
    from .spynet import SpyNet

    for cls, family in ((FlowNet2, "flownet2"), (FlowNetS2, "flownet_s"),
                        (FlowNetCFlex, "flownet_c_flex"),
                        (FlowNetC, "flownet_c"), (PWCNet, "pwcnet"),
                        (SpyNet, "spynet"), (RAFT, "raft")):
        if type(module) is cls:
            if family == "flownet_c_flex" and \
                    module.stage_names == "larger_field":
                return "flownet_c_larger"
            return family
    raise TypeError(f"no flax layout for {type(module).__name__}")


CONVERTERS = {
    "flownet_s": convert_flownet_s,
    "flownet_c": convert_flownet_c,
    "flownet_c_flex": convert_flownet_c_flex,
    "flownet_c_larger": convert_flownet_c_larger,
    "flownet2": convert_flownet2,
    "pwcnet": convert_pwcnet,
    "raft": convert_raft,
    "spynet": convert_spynet,
}


def flax_variables(module) -> dict:
    """A port module's weights as the JAX package's flax variables
    (``{"params": ..., "batch_stats": ...}`` where it has batch norm):
    the tree ``ufr-convert`` writes for the same weights."""
    return CONVERTERS[_family(module)](to_numpy_state_dict(
        module.state_dict()))


def flax_shapes(module) -> dict:
    """The tree of ``flax_variables(module)`` with each leaf's shape in
    place of its array (no weight is copied)."""
    return CONVERTERS[_family(module)]({
        k: tuple(v.shape) for k, v in module.state_dict().items()
        if not k.endswith("num_batches_tracked")})


def state_dict_from_flax(module, variables) -> dict:
    """Flax variables of ``module``'s family -> its state dict, through the
    family's inverse bridge; PWC-Net's dead ``deconv2`` keeps ``module``'s
    own weights."""
    family = _family(module)
    if family == "pwcnet":
        return pwcnet_state_dict_from_jax(variables,
                                          module.deconv2.state_dict())
    if family in ("flownet_c_flex", "flownet_c_larger"):
        return flownet_c_flex_state_dict_from_jax(variables,
                                                  module.stage_names)
    return {"raft": raft_state_dict_from_jax,
            "spynet": spynet_state_dict_from_jax,
            "flownet2": flownet2_state_dict_from_jax,
            "flownet_s": flownet_s_state_dict_from_jax,
            "flownet_c": flownet_c_state_dict_from_jax}[family](variables)
