"""Checkpoint interop with the PyTorch reference implementation
(counterpart of nonrigid_nerf_tpu/interop.py).

The reference keeps an experiment as a torch.save archive (reference
train.py:1668-1705):

    {"global_step", "network_fn_state_dict", "network_fine_state_dict",
     "ray_bender_state_dict", "optimizer_state_dict",
     "ray_bending_latent_codes",            # (timesteps, latent) tensor
     "intrinsics", "scripts_dict", "dataset_extras"}

This module converts such archives to and from the port's npz checkpoints
(checkpoints.py), Adam's moments included, so that a reference user can
move a half-trained experiment here and go on training it (or render it
with `python3 -m nonrigid_nerf_torch.cli.free_viewpoint_rendering`), and
take an experiment trained here back to the reference's tooling.

Everything here works on the port's parameter tree (weights.py: the JAX
layout, numpy leaves) and on Adam's (mu, nu) trees of the same shape, on
the host; no model is built and no device is touched.
`weights.params_to_jax(model)` and `weights.tree_from_named(state.mu)`
give those trees of a live train state.

The weights' layout: a torch nn.Linear stores (out, in) weights and the
tree (in, out), so every weight is transposed on the way. The reference's
optimizer orders its slots as grad_vars (reference train.py:560-633): the
latents one timestep each, then ray_bender.parameters(), then
model.parameters(), then model_fine.parameters(); inside an nn.Module in
registration order (pts_linears, views_linears, feature/alpha/rgb or
output_linear; views_linears is registered even when use_viewdirs=False,
an unused Linear that still holds optimizer slots).
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# structure inference


def describe_reference_tar(ckpt: dict) -> dict:
    """The model configuration a reference checkpoint's state-dict shapes
    imply. What can be ambiguous (time_conditioned_baseline) is settled by
    whether the positional encoding's width divides, and flagged."""
    sd = ckpt["network_fn_state_dict"]
    depth = max(int(k.split(".")[1])
                for k in sd if k.startswith("pts_linears.")) + 1
    width = int(sd["pts_linears.0.weight"].shape[0])
    in_total = int(sd["pts_linears.0.weight"].shape[1])
    skips = [i for i in range(depth - 1)
             if int(sd[f"pts_linears.{i + 1}.weight"].shape[1]) != width]

    use_viewdirs = "feature_linear.weight" in sd
    input_ch_views = 0
    if use_viewdirs:
        input_ch_views = int(sd["views_linears.0.weight"].shape[1]) - width

    latents = ckpt.get("ray_bending_latent_codes")
    n_timesteps, latent_size = (0, 0) if latents is None else (
        int(latents.shape[0]), int(latents.shape[1]))
    has_bender = ckpt.get("ray_bender_state_dict") is not None

    # the encoding is 3 + 3 * 2 * multires wide. If (in_total - 3) does not
    # divide by 6, the latent is part of the MLP's input: the
    # time-conditioned baseline (reference run_nerf_helpers.py:207-209).
    # Where both readings divide, the plain one wins (the baseline is an
    # ablation) and the ambiguity is flagged.
    def _multires(embed_width):
        return (embed_width - 3) // 6 if (embed_width - 3) % 6 == 0 else None

    time_conditioned = False
    ambiguous = False
    multires = _multires(in_total)
    if not has_bender and latent_size > 0:
        plain, baseline = _multires(in_total), _multires(
            in_total - latent_size)
        if plain is None and baseline is not None:
            time_conditioned, multires = True, baseline
        elif plain is not None and baseline is not None:
            ambiguous = True
            multires = plain
        elif plain is None and baseline is None:
            raise ValueError(
                f"cannot interpret pts_linears input width {in_total} as "
                f"positional encoding (with or without a {latent_size}-wide "
                "latent)")

    info = {
        "netdepth": depth, "netwidth": width, "skips": skips,
        "use_viewdirs": use_viewdirs, "input_ch_views": input_ch_views,
        "multires": multires,
        "multires_views": ((input_ch_views - 3) // 6 if use_viewdirs else 4),
        "has_fine": ckpt.get("network_fine_state_dict") is not None,
        "has_bender": has_bender,
        "n_timesteps": n_timesteps, "latent_size": latent_size,
        "time_conditioned_baseline": time_conditioned,
        "baseline_ambiguous": ambiguous,
        "output_ch": (None if use_viewdirs
                      else int(sd["output_linear.weight"].shape[0])),
        "global_step": int(ckpt.get("global_step", 0)),
    }
    if info["has_fine"]:
        fsd = ckpt["network_fine_state_dict"]
        info["netdepth_fine"] = max(
            int(k.split(".")[1])
            for k in fsd if k.startswith("pts_linears.")) + 1
        info["netwidth_fine"] = int(fsd["pts_linears.0.weight"].shape[0])
    if has_bender:
        bsd = ckpt["ray_bender_state_dict"]
        info["bending_depth"] = max(
            int(k.split(".")[1])
            for k in bsd if k.startswith("network.")) + 1
        info["bending_width"] = int(bsd["network.0.weight"].shape[0])
        info["rigidity_depth"] = max(
            int(k.split(".")[1])
            for k in bsd if k.startswith("rigidity_network.")) + 1
    return info


# ---------------------------------------------------------------------------
# tar -> parameter tree


def _to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _lin_from_sd(sd, name: str) -> dict:
    """One torch Linear -> a {'w': (in, out), 'b': (out,)} layer."""
    layer = {"w": np.ascontiguousarray(_to_np(sd[f"{name}.weight"]).T)}
    bkey = f"{name}.bias"
    if bkey in sd:
        layer["b"] = _to_np(sd[bkey]).copy()
    return layer


def _net_from_sd(sd, depth: int, use_viewdirs: bool) -> dict:
    net = {"pts": [_lin_from_sd(sd, f"pts_linears.{i}")
                   for i in range(depth)]}
    if use_viewdirs:
        net["feature"] = _lin_from_sd(sd, "feature_linear")
        net["alpha"] = _lin_from_sd(sd, "alpha_linear")
        net["views"] = [_lin_from_sd(sd, "views_linears.0")]
        net["rgb"] = _lin_from_sd(sd, "rgb_linear")
    else:
        net["output"] = _lin_from_sd(sd, "output_linear")
    return net


def params_from_reference_tar(ckpt: dict) -> Tuple[dict, dict]:
    """A loaded reference tar as the port's parameter tree (numpy leaves;
    `weights.params_from_jax` builds the model of it). Returns (params,
    info); the weights come out bit for bit, only transposed."""
    info = describe_reference_tar(ckpt)
    params: Dict[str, Any] = {
        "coarse": _net_from_sd(ckpt["network_fn_state_dict"],
                               info["netdepth"], info["use_viewdirs"])}
    if info["has_fine"]:
        params["fine"] = _net_from_sd(ckpt["network_fine_state_dict"],
                                      info["netdepth_fine"],
                                      info["use_viewdirs"])
    if info["has_bender"]:
        bsd = ckpt["ray_bender_state_dict"]
        params["bender"] = {
            "bend": [_lin_from_sd(bsd, f"network.{i}")
                     for i in range(info["bending_depth"])],
            "rigidity": [_lin_from_sd(bsd, f"rigidity_network.{i}")
                         for i in range(info["rigidity_depth"])],
        }
    lat = ckpt.get("ray_bending_latent_codes")
    params["latents"] = (np.zeros((0, 0), np.float32) if lat is None
                         else _to_np(lat).copy())
    return params, info


# ---------------------------------------------------------------------------
# optimizer-slot ordering


def _net_slot_paths(prefix: str, depth: int, use_viewdirs: bool
                    ) -> List[Optional[tuple]]:
    """Tree paths of one NeRF net's parameters in torch registration order.
    None marks a torch slot with no counterpart in the tree (the unused
    views_linears when use_viewdirs=False)."""
    paths: List[Optional[tuple]] = []
    for i in range(depth):
        paths += [(prefix, "pts", i, "w"), (prefix, "pts", i, "b")]
    if use_viewdirs:
        paths += [(prefix, "views", 0, "w"), (prefix, "views", 0, "b")]
        paths += [(prefix, "feature", "w"), (prefix, "feature", "b"),
                  (prefix, "alpha", "w"), (prefix, "alpha", "b"),
                  (prefix, "rgb", "w"), (prefix, "rgb", "b")]
    else:
        paths += [None, None]  # views_linears.0.{weight,bias}: unused slots
        paths += [(prefix, "output", "w"), (prefix, "output", "b")]
    return paths


def reference_optimizer_slots(params: dict, info: dict
                              ) -> List[Optional[tuple]]:
    """Tree paths in the reference's optimizer-slot order (grad_vars,
    reference train.py:560-633). Latent t is ('latents', t), one slot a
    timestep. A path ending in 'w' is the transpose of the torch tensor."""
    slots: List[Optional[tuple]] = [
        ("latents", t) for t in range(info["n_timesteps"])]
    if info["has_bender"]:
        for group in ("bend", "rigidity"):
            for i, layer in enumerate(params["bender"][group]):
                slots.append(("bender", group, i, "w"))
                if "b" in layer:
                    slots.append(("bender", group, i, "b"))
    slots += _net_slot_paths("coarse", info["netdepth"],
                             info["use_viewdirs"])
    if info["has_fine"]:
        slots += _net_slot_paths("fine", info["netdepth_fine"],
                                 info["use_viewdirs"])
    return slots


def _get_leaf(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def _set_leaf(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like_tree(v) for v in tree]
    return np.zeros_like(np.asarray(tree))


# ---------------------------------------------------------------------------
# tar -> Adam's moments


def opt_state_from_reference_tar(ckpt: dict, params: dict, info: dict
                                 ) -> Tuple[dict, dict]:
    """Adam's (mu, nu) trees, shaped like `params`, from the reference's
    torch Adam state; the port's Adam keeps one count, the step, which is
    `info["global_step"]` (`weights.named_from_tree` gives a TrainState's
    moments of them).

    torch's Adam keeps (step, exp_avg, exp_avg_sq) a parameter; the moments
    map one to one (both are the EMAs before bias correction, with the same
    b1, b2 and eps). A parameter whose torch step lags the global step (a
    latent gets a gradient only on the steps that draw its timestep)
    resumes with a slightly larger bias correction than the reference
    would apply, a difference that decays as b2^step and is nil past about
    10k steps. A parameter with no torch state (one that never had a
    gradient) gets zero moments, as torch's lazy init gives it."""
    torch_state = ckpt["optimizer_state_dict"]["state"]
    slots = reference_optimizer_slots(params, info)
    mu, nu = _zeros_like_tree(params), _zeros_like_tree(params)

    n_orphan = 0
    for idx, path in enumerate(slots):
        st = torch_state.get(idx, torch_state.get(str(idx)))
        if st is None:
            continue
        if path is None:
            # the reference's unused views_linears: all-zero unless
            # something unexpected trained them
            if float(np.abs(_to_np(st["exp_avg"])).max()) > 0:
                n_orphan += 1
            continue
        m, v = _to_np(st["exp_avg"]), _to_np(st["exp_avg_sq"])
        if path[0] == "latents":
            mu["latents"][path[1]] = m
            nu["latents"][path[1]] = v
        elif path[-1] == "w":
            _set_leaf(mu, path, np.ascontiguousarray(m.T))
            _set_leaf(nu, path, np.ascontiguousarray(v.T))
        else:
            _set_leaf(mu, path, m)
            _set_leaf(nu, path, v)
    if n_orphan:
        warnings.warn(
            f"{n_orphan} torch optimizer slot(s) with nonzero moments have "
            "no counterpart here (the reference's unused views_linears); "
            "their state was dropped")
    return mu, nu


# ---------------------------------------------------------------------------
# parameter tree -> tar (export)


def _sd_from_net(net: dict, use_viewdirs: bool):
    """A net of the tree as a torch state_dict, with the reference's
    always-registered views_linears for a net without view directions
    (unused by its forward pass; fresh default-init values, there only so
    that load_state_dict(strict=True) succeeds)."""
    sd = {}

    def put(name, layer):
        sd[f"{name}.weight"] = torch.tensor(
            np.ascontiguousarray(np.asarray(layer["w"], np.float32).T))
        if "b" in layer:
            sd[f"{name}.bias"] = torch.tensor(
                np.asarray(layer["b"], np.float32))

    for i, layer in enumerate(net["pts"]):
        put(f"pts_linears.{i}", layer)
    if use_viewdirs:
        put("views_linears.0", net["views"][0])
        put("feature_linear", net["feature"])
        put("alpha_linear", net["alpha"])
        put("rgb_linear", net["rgb"])
    else:
        width = int(np.asarray(net["pts"][0]["w"]).shape[1])
        filler = torch.nn.Linear(width, width // 2)
        sd["views_linears.0.weight"] = filler.weight.detach()
        sd["views_linears.0.bias"] = filler.bias.detach()
        put("output_linear", net["output"])
    return sd


def export_reference_tar(path: str, params: dict, step: int,
                         moments: Optional[Tuple[dict, dict]] = None,
                         extras: Optional[dict] = None,
                         lrate: Optional[float] = None) -> dict:
    """Write a parameter tree (and Adam's (mu, nu) trees, or zeros) as a
    reference archive, which the reference's create_nerf loads
    (load_state_dict strict, optimizer.load_state_dict): an experiment
    trained here renders, or trains on, with the reference's own tooling.
    Returns the dict that was saved."""
    info = _info_from_params(params)
    out = {
        "global_step": int(step),
        "network_fn_state_dict": _sd_from_net(params["coarse"],
                                              info["use_viewdirs"]),
        "network_fine_state_dict": (
            _sd_from_net(params["fine"], info["use_viewdirs"])
            if info["has_fine"] else None),
        "ray_bender_state_dict": None,
        "ray_bending_latent_codes": torch.tensor(
            np.asarray(params["latents"], np.float32)),
    }
    if info["has_bender"]:
        bsd = {}
        for group, prefix in (("bend", "network"),
                              ("rigidity", "rigidity_network")):
            for i, layer in enumerate(params["bender"][group]):
                bsd[f"{prefix}.{i}.weight"] = torch.tensor(
                    np.ascontiguousarray(
                        np.asarray(layer["w"], np.float32).T))
                if "b" in layer:
                    bsd[f"{prefix}.{i}.bias"] = torch.tensor(
                        np.asarray(layer["b"], np.float32))
        out["ray_bender_state_dict"] = bsd

    out["optimizer_state_dict"] = _torch_opt_state(params, info, moments,
                                                   step, lrate)

    extras = extras or {}
    intr = extras.get("intrinsics", {})
    out["intrinsics"] = ({int(k): dict(v) for k, v in intr.items()}
                         if isinstance(intr, dict) else intr)
    out["scripts_dict"] = dict(extras.get("scripts_dict", {}))
    out["dataset_extras"] = dict(extras.get("dataset_extras", {}))
    torch.save(out, path)
    return out


def _info_from_params(params: dict) -> dict:
    """The slot-ordering facts of a parameter tree."""
    coarse = params["coarse"]
    info = {
        "netdepth": len(coarse["pts"]),
        "use_viewdirs": "views" in coarse,
        "has_fine": "fine" in params,
        "has_bender": "bender" in params,
        "n_timesteps": int(np.asarray(params["latents"]).shape[0]),
    }
    if info["has_fine"]:
        info["netdepth_fine"] = len(params["fine"]["pts"])
    return info


def _torch_opt_state(params, info, moments, step, lrate):
    """Adam's (mu, nu) trees as a torch Adam state_dict (zeros if None)."""
    slots = reference_optimizer_slots(params, info)
    state = {}
    for idx, path in enumerate(slots):
        if path is None:
            continue  # unused views_linears: torch inits them lazily
        if moments is None:
            leaf = (params["latents"][path[1]] if path[0] == "latents"
                    else _get_leaf(params, path))
            m = v = np.zeros_like(np.asarray(leaf, dtype=np.float32))
        elif path[0] == "latents":
            m = np.asarray(moments[0]["latents"][path[1]], np.float32)
            v = np.asarray(moments[1]["latents"][path[1]], np.float32)
        else:
            m = np.asarray(_get_leaf(moments[0], path), np.float32)
            v = np.asarray(_get_leaf(moments[1], path), np.float32)
        if path[-1] == "w":
            m, v = np.ascontiguousarray(m.T), np.ascontiguousarray(v.T)
        state[idx] = {
            "step": torch.tensor(float(step)),
            "exp_avg": torch.tensor(m),
            "exp_avg_sq": torch.tensor(v),
        }
    group = {
        "params": list(range(len(slots))),
        "lr": (5e-4 if lrate is None else float(lrate)),
        "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0,
        "amsgrad": False, "maximize": False, "foreach": None,
        "capturable": False, "differentiable": False, "fused": None,
    }
    return {"state": state, "param_groups": [group]}


# ---------------------------------------------------------------------------
# experiment folders


def load_reference_tar(path: str) -> dict:
    """torch.load a reference archive onto the CPU. The tar embeds pickled
    Python metadata (intrinsics, scripts_dict), so weights_only stays off:
    convert only checkpoints you trained or trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


def find_reference_checkpoint(exp_dir: str) -> str:
    """The newest tar under <exp_dir>/logs (the reference resumes from the
    last of the sorted list, train.py:666-679; its numbered saves are also
    copied to latest.tar, so the lexicographic max is right)."""
    logdir = os.path.join(exp_dir, "logs")
    tars = sorted(f for f in os.listdir(logdir) if ".tar" in f)
    if not tars:
        raise FileNotFoundError(f"no .tar checkpoints under {logdir}")
    return os.path.join(logdir, tars[-1])


def convert_reference_args(src_path: str, overrides: Optional[dict] = None):
    """The reference's logs/args.txt as the port's Args. The flag names are
    shared (config.py mirrors the reference's parser); the reference's own
    keys (dead flags like no_batching) are dropped with a warning."""
    from nonrigid_nerf_torch.config import DEFAULTS, Args, parse_config_file

    raw = parse_config_file(src_path)
    dropped = sorted(k for k in raw if k not in DEFAULTS)
    kept = {k: v for k, v in raw.items() if k in DEFAULTS}
    if dropped:
        warnings.warn("dropped reference-only args: " + ", ".join(dropped))
    kept.update(overrides or {})
    return Args(**kept)


def _json_safe_extras(ckpt: dict) -> dict:
    """The tar's metadata, cut to what the npz's JSON meta holds (scalars,
    strings and lists, as the training CLI's checkpoint extras)."""
    def clean(v):
        if isinstance(v, (bool, int, float, str)) or v is None:
            return v
        if isinstance(v, (np.integer, np.floating)):
            return v.item()
        if isinstance(v, (list, tuple)):
            out = [clean(x) for x in v]
            return out if all(x is not None for x in out) else None
        if isinstance(v, dict):
            return {str(k): clean(vv) for k, vv in v.items()
                    if clean(vv) is not None}
        if isinstance(v, np.ndarray) and v.size <= 64:
            return v.tolist()
        return None

    extras = {}
    intr = ckpt.get("intrinsics")
    if intr is not None:
        items = intr.items() if isinstance(intr, dict) else enumerate(intr)
        extras["intrinsics"] = {
            str(k): {kk: clean(vv) for kk, vv in v.items()}
            for k, v in items}
    for key in ("scripts_dict", "dataset_extras"):
        val = ckpt.get(key)
        if isinstance(val, dict):
            extras[key] = {k: clean(v) for k, v in val.items()
                           if clean(v) is not None}
    return extras


def import_reference_experiment(src: str, out_dir: str,
                                with_optimizer: bool = True,
                                overrides: Optional[dict] = None) -> dict:
    """A reference experiment folder (or one tar) as an experiment folder
    the port trains on and renders:

        <out_dir>/logs/args.txt   (the converted flags, rootdir/expname
                                   set to out_dir)
        <out_dir>/logs/latest.npz (parameters [+ Adam's state] + metadata)

    Returns a summary dict (step, info, paths)."""
    from nonrigid_nerf_torch.checkpoints import write_checkpoint

    if os.path.isdir(src):
        tar_path = find_reference_checkpoint(src)
        args_path = os.path.join(src, "logs", "args.txt")
    else:
        tar_path, args_path = src, None

    ckpt = load_reference_tar(tar_path)
    params, info = params_from_reference_tar(ckpt)
    if info.get("baseline_ambiguous"):
        warnings.warn(
            "latent width divides evenly into the MLP input either way; "
            "assuming NOT time_conditioned_baseline (pass args.txt or "
            "overrides={'time_conditioned_baseline': True} to force)")

    out_logs = os.path.join(out_dir, "logs")
    os.makedirs(out_logs, exist_ok=True)

    ov = dict(overrides or {})
    ov.setdefault("rootdir", os.path.dirname(os.path.abspath(out_dir)))
    ov.setdefault("expname", os.path.basename(os.path.abspath(out_dir)))
    # the source args.txt often holds the flags of its FIRST launch
    # (no_reload=True for a fresh run, ft_path=... for fine-tuning); an
    # imported experiment must load the converted checkpoint, not skip it
    ov.setdefault("no_reload", False)
    ov.setdefault("ft_path", None)
    if args_path is not None and os.path.exists(args_path):
        args = convert_reference_args(args_path, ov)
        if info.get("baseline_ambiguous") and getattr(
                args, "time_conditioned_baseline", False):
            # args.txt settles the width's ambiguity the other way
            info["time_conditioned_baseline"] = True
            info["multires"] = (info["multires"] * 6 + 3
                                - info["latent_size"] - 3) // 6
        _check_args_against_info(args, info)
    else:
        args = _args_from_info(info, ov)
    args.dump(os.path.join(out_logs, "args.txt"))

    moments = None
    if with_optimizer and ckpt.get("optimizer_state_dict") is not None:
        moments = opt_state_from_reference_tar(ckpt, params, info)

    npz_path = os.path.join(out_logs, "latest.npz")
    write_checkpoint(npz_path, info["global_step"], params, moments,
                     _json_safe_extras(ckpt))
    return {"step": info["global_step"], "info": info,
            "checkpoint": npz_path, "args": args,
            "source_tar": tar_path}


def _check_args_against_info(args, info) -> None:
    """args.txt and the state-dict shapes must describe the same model."""
    checks = [
        ("netdepth", args.netdepth, info["netdepth"]),
        ("netwidth", args.netwidth, info["netwidth"]),
        ("use_viewdirs", bool(args.use_viewdirs), info["use_viewdirs"]),
        ("multires", args.multires, info["multires"]),
        ("N_importance>0", args.N_importance > 0, info["has_fine"]),
        ("ray_bending", args.ray_bending not in (None, "None"),
         info["has_bender"]),
        # skips is no reference flag (hard-coded [4]); compared as the
        # EFFECTIVE skip set (an entry past the layer count never fires)
        ("skips",
         sorted(s for s in getattr(args, "skips", (4,))
                if 0 <= s < args.netdepth - 1),
         info["skips"]),
    ]
    bad = [f"{name}: args={a!r} checkpoint={b!r}"
           for name, a, b in checks if a != b]
    if bad:
        raise ValueError("args.txt does not match the checkpoint: "
                         + "; ".join(bad))


def _args_from_info(info, overrides):
    """A minimal Args when no args.txt comes with the tar."""
    from nonrigid_nerf_torch.config import Args

    kw = {
        "netdepth": info["netdepth"], "netwidth": info["netwidth"],
        "use_viewdirs": info["use_viewdirs"],
        "multires": info["multires"] or 10,
        "multires_views": info["multires_views"],
        "N_importance": (64 if info["has_fine"] else 0),
        "ray_bending": ("simple_neural" if info["has_bender"] else None),
        "ray_bending_latent_size": info["latent_size"],
        "time_conditioned_baseline": info["time_conditioned_baseline"],
    }
    if info["has_fine"]:
        kw["netdepth_fine"] = info["netdepth_fine"]
        kw["netwidth_fine"] = info["netwidth_fine"]
    kw.update(overrides)
    return Args(**kw)


def export_experiment(exp_dir: str, out_tar: str,
                      with_optimizer: bool = True) -> dict:
    """An experiment folder of the port as a reference tar."""
    from nonrigid_nerf_torch.checkpoints import (latest_checkpoint,
                                                 read_checkpoint)
    from nonrigid_nerf_torch.config import (Args, parse_config_file,
                                            train_config_from_args)
    from nonrigid_nerf_torch.engine.train_state import lr_schedule

    logdir = os.path.join(exp_dir, "logs")
    ckpt_path = latest_checkpoint(logdir)
    if ckpt_path is None:
        raise FileNotFoundError(f"no checkpoint under {logdir}")
    step, params, extras, opt_state = read_checkpoint(ckpt_path,
                                                      with_opt_state=True)
    params.pop("quant", None)  # the int8 calibration: no reference leaf

    lrate = None
    args_path = os.path.join(logdir, "args.txt")
    if os.path.exists(args_path):
        args = Args(**parse_config_file(args_path))
        # the rate the reference would have set after its last step
        lrate = float(lr_schedule(train_config_from_args(args), step))
    moments = None
    if with_optimizer and opt_state is not None:
        moments = (opt_state[0]["mu"], opt_state[0]["nu"])
    export_reference_tar(out_tar, params, step, moments, extras, lrate)
    return {"step": step, "tar": out_tar, "source": ckpt_path}
