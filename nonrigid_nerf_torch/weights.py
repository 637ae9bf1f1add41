"""Carry a JAX parameter tree into the port's modules, and back.

The JAX tree (nonrigid_nerf_tpu/engine/train_state.py:init_params) is
{"coarse", "fine"?, "bender"?, "latents"} with {"w", "b"} dense leaves,
`w` stored (fan_in, fan_out). `nn.Linear.weight` is (fan_out, fan_in), so
every `w` is transposed. The bending output layer has no bias; `latents`
is the (T, L) table indexed per frame. An optional "quant" leaf, the int8
calibration state {network: {"scales": (9,), "packed": 29-tuple}}, becomes
the model's `quant` buffers and comes back as it went in: int8 matrices stay
int8 and the bf16 head stays bf16 (as 2-byte void items where numpy has no
bfloat16 type, which is also how an npz file holds it).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from nonrigid_nerf_torch.config import ModelConfig
from nonrigid_nerf_torch.device import DeviceLike
from nonrigid_nerf_torch.models.model import NRNeRF, QuantState

N_PACKED_INT8 = 29      # weights of the int8 kernel in a "quant" leaf


def _copy_dense(layer: nn.Linear, leaf: Mapping[str, Any], where: str):
    w = torch.from_numpy(np.asarray(leaf["w"], np.float32)).t()
    if w.shape != layer.weight.shape:
        raise ValueError(f"{where}.w: shape {tuple(w.shape[::-1])} does not "
                         f"fit a layer of {tuple(layer.weight.shape[::-1])}")
    layer.weight.copy_(w)
    if (layer.bias is None) != ("b" not in leaf):
        raise ValueError(f"{where}: bias present in only one of the two trees")
    if layer.bias is not None:
        layer.bias.copy_(torch.from_numpy(np.asarray(leaf["b"], np.float32)))


def _copy_layers(layers: nn.ModuleList, leaves, where: str):
    if len(layers) != len(leaves):
        raise ValueError(f"{where}: {len(leaves)} layers in the tree, "
                         f"{len(layers)} in the model")
    for i, (layer, leaf) in enumerate(zip(layers, leaves)):
        _copy_dense(layer, leaf, f"{where}[{i}]")


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> NRNeRF:
    """Build an `NRNeRF` on `device` holding the values of the JAX tree
    (numpy or JAX arrays as leaves)."""
    latents = np.asarray(tree["latents"], np.float32)
    model = NRNeRF(cfg, num_timesteps=latents.shape[0], device=device)
    with torch.no_grad():
        for name in ("coarse", "fine"):
            net = getattr(model, name)
            if (net is None) != (name not in tree):
                raise ValueError(f"'{name}' is in only one of the tree and "
                                 "the model's configuration")
            if net is not None:
                _copy_layers(net.pts, tree[name]["pts"], f"{name}.pts")
                if ("output" in tree[name]) == cfg.use_viewdirs:
                    raise ValueError(
                        f"'{name}' has the single output head in only one of "
                        "the tree and the model's configuration")
                if cfg.use_viewdirs:
                    for head in ("feature", "alpha", "rgb"):
                        _copy_dense(getattr(net, head), tree[name][head],
                                    f"{name}.{head}")
                    _copy_layers(net.views, tree[name]["views"],
                                 f"{name}.views")
                else:
                    _copy_dense(net.output, tree[name]["output"],
                                f"{name}.output")
        if (model.bender is None) != ("bender" not in tree):
            raise ValueError("'bender' is in only one of the tree and the "
                             "model's configuration")
        if model.bender is not None:
            _copy_layers(model.bender.bend, tree["bender"]["bend"], "bender.bend")
            if (model.bender.rigidity is None) != ("rigidity" not in tree["bender"]):
                raise ValueError("'rigidity' is in only one of the tree and "
                                 "the model's configuration")
            if model.bender.rigidity is not None:
                _copy_layers(model.bender.rigidity, tree["bender"]["rigidity"],
                             "bender.rigidity")
        model.latents.copy_(torch.from_numpy(latents))
    if "quant" in tree:
        model = model.with_quant({
            network: _quant_state(leaf, f"quant.{network}").to(
                model.latents.device)
            for network, leaf in tree["quant"].items()})
    return model


def _tensor_from_leaf(a) -> torch.Tensor:
    """A leaf in its own type: bfloat16 arrives as ml_dtypes' type or, from an
    npz file, as 2-byte void items, and numpy has neither natively."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _leaf_from_tensor(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")).copy()
    return t.numpy().copy()


def _quant_state(leaf, where: str) -> QuantState:
    """A tree's quant[network]: {"scales", "packed"}, or the (9,) scales
    alone (the older form, packed at first use)."""
    if not isinstance(leaf, Mapping):
        return QuantState(_tensor_from_leaf(leaf).float())
    packed = [_tensor_from_leaf(a) for a in leaf["packed"]]
    if len(packed) != N_PACKED_INT8:
        raise ValueError(f"{where}.packed: {len(packed)} arrays, the int8 "
                         f"kernel takes {N_PACKED_INT8}")
    return QuantState(_tensor_from_leaf(leaf["scales"]).float(), packed)


def _jax_path(name: str):
    """"coarse.pts.3.weight" -> ("coarse", "pts", 3, "w"): the place of a
    parameter of `NRNeRF` in the JAX tree."""
    parts = name.split(".")
    if parts == ["latents"]:
        return ("latents",)
    leaf = {"weight": "w", "bias": "b"}[parts[-1]]
    return tuple(int(p) if p.isdigit() else p for p in parts[:-1]) + (leaf,)


def tree_from_named(named: Mapping[str, torch.Tensor]):
    """Tensors keyed by `NRNeRF` parameter name (the parameters, or Adam's
    moments) as a JAX-layout tree of numpy arrays: nested dicts and lists,
    `w` stored (fan_in, fan_out)."""
    root: dict = {}
    for name, t in named.items():
        path = _jax_path(name)
        a = t.detach().cpu().numpy()
        if path[-1] == "w":
            a = a.T
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(a)       # an own, contiguous copy

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def named_from_tree(tree: Mapping[str, Any], model: NRNeRF):
    """The inverse of `tree_from_named` for the parameter names of `model`:
    tensors on the model's device and in its parameters' dtypes."""
    out = {}
    for name, p in model.named_parameters():
        node = tree
        for key in _jax_path(name):
            node = node[key]
        a = np.asarray(node)
        if name.endswith(".weight"):
            a = a.T
        t = torch.as_tensor(np.ascontiguousarray(a), dtype=p.dtype,
                            device=p.device)
        if t.shape != p.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} in the tree, "
                             f"{tuple(p.shape)} in the model")
        out[name] = t
    return out


def params_to_jax(model: NRNeRF):
    """The model's parameters, and its int8 calibration state where it has
    one, as the JAX tree (numpy leaves): the inverse of `params_from_jax`."""
    tree = tree_from_named(dict(model.named_parameters()))
    if model.quant is not None:
        tree["quant"] = {}
        for network, state in model.quant.items():
            scales = _leaf_from_tensor(state.scales)
            packed = state.packed
            tree["quant"][network] = scales if packed is None else {
                "scales": scales,
                "packed": tuple(_leaf_from_tensor(t) for t in packed)}
    return tree
