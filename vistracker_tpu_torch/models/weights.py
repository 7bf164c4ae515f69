"""Weights for the port's networks (SIF-Net, SmoothNet, the infillers):
seeded random init, released torch checkpoints, and weights carried over
from the JAX package's flax params.

The port's modules use the reference's parameter names, so a released
tri-vis-l2 tar loads with load_state_dict after its "module." prefixes
are stripped. `sifnet_state_dict_from_flax` converts the JAX package's
flax params (numpy arrays) into the same state_dict, which is how the
tests hold the two packages to the same weights. Layouts:
  flax Conv kernel (kh, kw, in, out)  -> torch Conv2d (out, in, kh, kw)
  flax grouped Conv (kh, kw, in/g, out) -> torch Conv2d groups=g
                                         (out, in/g, kh, kw)
  flax Dense kernel (in, out)         -> torch Conv1d k=1 (out, in, 1)
  flax Dense kernel (in, out)         -> torch Linear (out, in)
  flax q_proj / k_proj / v_proj       -> torch in_proj_weight / in_proj_bias
  flax GroupNorm / LayerNorm scale    -> torch weight
"""
from __future__ import annotations

import glob
import json
import math
import os

import numpy as np
import torch
from torch import nn

from .hourglass import HGConfig, HGFilter
from .sifnet import SIFNet, SIFNetConfig
from .transformer import MultiheadSelfAttention


def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize every parameter from `generator` (a CPU generator):
    convs, linears and packed attention projections uniform in
    +-1/sqrt(fan_in) (PyTorch's default bound), norms weight 1 and bias
    0. Deterministic for a given seed on any device."""
    def fill(params, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        for p in params:
            if p is not None:
                u = torch.rand(p.shape, generator=generator)
                p.copy_(u * (2 * bound) - bound)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                fill((mod.weight, mod.bias), mod.weight[0].numel())
            elif isinstance(mod, MultiheadSelfAttention):
                fill((mod.in_proj_weight, mod.in_proj_bias), mod.d_model)
            elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)
    return model


def _flax_path(module_path: str) -> list:
    """Torch module path -> flax module path: downsample.0 is the block's
    bn4, downsample.2 its downsample_conv; head layer k is fc{k//2}."""
    parts, out, i = module_path.split("."), [], 0
    while i < len(parts):
        name = parts[i]
        if name == "downsample":
            out.append("bn4" if parts[i + 1] == "0" else "downsample_conv")
            i += 2
        elif i + 1 < len(parts) and parts[i + 1].isdigit():
            out += [name, f"fc{int(parts[i + 1]) // 2}"]
            i += 2
        else:
            out.append(name)
            i += 1
    return out


def module_state_dict_from_flax(model: nn.Module, params: dict) -> dict:
    """The flax params ({"params": ...} or the inner tree; arrays as
    numpy) of the JAX module that `model` ports -> `model`'s state_dict
    (CPU float32), matched by module path (_flax_path). Every tensor's
    shape is checked against the model's, grouped convs included."""
    tree = params.get("params", params)
    modules = dict(model.named_modules(remove_duplicate=False))
    sd = {}
    for key, want in model.state_dict().items():
        mod_path, leaf = key.rsplit(".", 1)
        mod = modules[mod_path]
        node = tree
        for name in _flax_path(mod_path):
            node = node[name]
        if isinstance(mod, nn.GroupNorm):
            w = node["scale" if leaf == "weight" else "bias"]
        elif leaf == "bias":
            w = node["bias"]
        elif isinstance(mod, nn.Conv2d):
            w = np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1))
        else:  # Conv1d head layer from a Dense kernel
            w = np.asarray(node["kernel"]).T[..., None]
        if tuple(np.shape(w)) != tuple(want.shape):
            raise ValueError(f"{key}: flax gives {tuple(np.shape(w))}, the "
                             f"port's module has {tuple(want.shape)}")
        sd[key] = torch.from_numpy(np.array(w, np.float32))
    return sd


def sifnet_state_dict_from_flax(params: dict, cfg: SIFNetConfig) -> dict:
    """The JAX package's flax SIF-Net params -> the port's state_dict, for
    every variant cfg names (chore, chore-triplane, chore-triplane-vis;
    shared or per-view triplane encoders). Any tree of the params' shape
    converts, gradients included."""
    return module_state_dict_from_flax(SIFNet(cfg), params)


def hgfilter_state_dict_from_flax(params: dict, cfg: HGConfig) -> dict:
    """The JAX package's flax HGFilter params (cfg.gconv: the
    HGFilterGConv variant) -> the port's HGFilter state_dict."""
    return module_state_dict_from_flax(HGFilter(cfg), params)


def _t(x, transpose=False) -> torch.Tensor:
    a = np.array(x, np.float32)
    return torch.from_numpy(a.T.copy() if transpose else a)


def _put_dense(sd: dict, key: str, node: dict):
    sd[f"{key}.weight"] = _t(node["kernel"], transpose=True)
    sd[f"{key}.bias"] = _t(node["bias"])


def _put_norm(sd: dict, key: str, node: dict):
    sd[f"{key}.weight"] = _t(node["scale"])
    sd[f"{key}.bias"] = _t(node["bias"])


def smoothnet_state_dict_from_flax(params: dict, smpl: bool = False) -> dict:
    """The JAX package's flax SmoothNet (smpl=False) or SmoothNetSMPL
    params -> the port's state_dict; the inverse of the JAX package's
    models/torch_import.py:smoothnet_params."""
    tree = params.get("params", params)

    def one(node, prefix):
        sd = {}
        _put_dense(sd, f"{prefix}encoder.0", node["encoder"])
        _put_dense(sd, f"{prefix}decoder", node["decoder"])
        i = 0
        while f"res{i}" in node:
            for lin in ("linear1", "linear2"):
                _put_dense(sd, f"{prefix}res_blocks.{i}.{lin}",
                           node[f"res{i}"][lin])
            i += 1
        return sd

    if smpl:
        return {**one(tree["pose_net"], "pose_net."),
                **one(tree["trans_net"], "trans_net.")}
    return one(tree, "")


def _put_transformer(sd: dict, prefix: str, node: dict):
    i = 0
    while f"layer{i}" in node:
        layer, lp = node[f"layer{i}"], f"{prefix}.encoder.layers.{i}"
        att = layer["self_attn"]
        sd[f"{lp}.self_attn.in_proj_weight"] = torch.cat(
            [_t(att[k]["kernel"], transpose=True)
             for k in ("q_proj", "k_proj", "v_proj")])
        sd[f"{lp}.self_attn.in_proj_bias"] = torch.cat(
            [_t(att[k]["bias"]) for k in ("q_proj", "k_proj", "v_proj")])
        _put_dense(sd, f"{lp}.self_attn.out_proj", att["out_proj"])
        _put_dense(sd, f"{lp}.linear1", layer["linear1"])
        _put_dense(sd, f"{lp}.linear2", layer["linear2"])
        _put_norm(sd, f"{lp}.norm1", layer["norm1"])
        _put_norm(sd, f"{lp}.norm2", layer["norm2"])
        i += 1
    if "norm" in node:
        _put_norm(sd, f"{prefix}.encoder.norm", node["norm"])


def infiller_state_dict_from_flax(params: dict) -> dict:
    """The JAX package's flax ConditionalMInfiller or MotionInfiller
    params -> the port's state_dict; the inverse of the JAX package's
    models/torch_import.py:infiller_params."""
    tree = params.get("params", params)
    sd = {}
    for name, node in tree.items():
        if name.startswith("feat_proj"):
            _put_dense(sd, name, node)
        elif name.startswith("encoder"):
            _put_transformer(sd, name, node)
    head, i = tree["predictor"], 0
    while f"hidden{i}" in head:
        _put_dense(sd, f"predictor.{2 * i}", head[f"hidden{i}"])
        i += 1
    _put_dense(sd, f"predictor.{2 * i}", head["out"])
    return sd


def is_torch_experiment_dir(path: str) -> bool:
    """Does `path` hold released torch checkpoint artifacts?"""
    return bool(
        glob.glob(os.path.join(path, "val_min=*"))
        or glob.glob(os.path.join(path, "checkpoints", "*.tar"))
        or os.path.isfile(os.path.join(path, "checkpoint.pth.tar")))


def find_checkpoint(exp_dir: str) -> str:
    """Resolve a file or experiment folder to a checkpoint file with the
    reference's precedence: val_min=<epoch>.npy, best_model.json, the
    checkpoints/*.tar with the largest training-time suffix, then
    checkpoint.pth.tar."""
    if os.path.isfile(exp_dir):
        return exp_dir
    ck_dir = os.path.join(exp_dir, "checkpoints")
    for vm in sorted(glob.glob(os.path.join(exp_dir, "val_min=*"))):
        log = np.load(vm, allow_pickle=True)
        path = os.path.join(ck_dir, str(log[2]))
        if os.path.isfile(path):
            return path
    bm = os.path.join(exp_dir, "best_model.json")
    if os.path.isfile(bm):
        with open(bm, encoding="utf-8") as f:
            ck = json.load(f).get("ck_file")
        if ck and os.path.isfile(os.path.join(ck_dir, ck)):
            return os.path.join(ck_dir, ck)
    tars = glob.glob(os.path.join(ck_dir, "*.tar"))
    if tars:
        def ttime(p):
            try:
                return float(os.path.splitext(os.path.basename(p))[0]
                             .split("_")[-1])
            except ValueError:
                return -1.0
        return max(tars, key=ttime)
    sn = os.path.join(exp_dir, "checkpoint.pth.tar")
    if os.path.isfile(sn):
        return sn
    raise FileNotFoundError(f"no torch checkpoint found under {exp_dir}")


def load_checkpoint_state_dict(path: str) -> dict:
    """Checkpoint file or experiment folder -> state_dict with "module."
    prefixes stripped (model_state_dict / state_dict / model containers)."""
    ck = torch.load(find_checkpoint(path), map_location="cpu",
                    weights_only=False)
    sd = ck
    for key in ("model_state_dict", "state_dict", "model"):
        if isinstance(ck, dict) and key in ck:
            sd = ck[key]
            break
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}
