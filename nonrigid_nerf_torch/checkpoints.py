"""Read and write the JAX package's npz checkpoints
(counterpart of nonrigid_nerf_tpu/checkpoints.py:36-91,130-229).

The layout: every array leaf of {"params": ..., "opt_state": ...} sits under
a flattened key whose parts are `d:<key>` (dict), `l:<i>` / `t:<i>` (list /
tuple) and `n:<field>` (namedtuple field, in the optimizer state only),
joined by "/". A `__meta__` entry holds JSON with the step, the structural
markers (`__len__`, `__namedtuple__`) and the non-array extras.

The optimizer state is optax's for `optax.adam` with a schedule:
`(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))`, mu and nu
shaped like the params tree. The port's Adam state is (mu, nu) by parameter
name plus the step; both counts equal the step. A checkpoint written here
resumes in the JAX package and the other way round. A model's int8
calibration state is the params tree's "quant" leaf (`weights.py`), so a
calibrated model survives the round trip. `latest.npz` is rewritten at every
save; the Orbax format is not read or written.
"""

from __future__ import annotations

import collections
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from nonrigid_nerf_torch.config import ModelConfig
from nonrigid_nerf_torch.device import DeviceLike, resolve_device
from nonrigid_nerf_torch.engine.train_state import TrainState, zero_moments
from nonrigid_nerf_torch.models.model import NRNeRF
from nonrigid_nerf_torch.weights import (named_from_tree, params_from_jax,
                                         params_to_jax, tree_from_named)

ScaleByAdamState = collections.namedtuple("ScaleByAdamState",
                                          ["count", "mu", "nu"])
ScaleByScheduleState = collections.namedtuple("ScaleByScheduleState",
                                              ["count"])


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for key in sorted(tree):
            out.update(_flatten(tree[key], f"{prefix}d:{key}/"))
    elif isinstance(tree, (list, tuple)):
        if hasattr(tree, "_fields"):          # namedtuple
            out[prefix + "__namedtuple__"] = {
                "cls": type(tree).__name__, "fields": list(tree._fields)}
            for name, val in zip(tree._fields, tree):
                out.update(_flatten(val, f"{prefix}n:{name}/"))
        else:
            tag = "l" if isinstance(tree, list) else "t"
            out[prefix + "__len__"] = {"tag": tag, "n": len(tree)}
            for i, val in enumerate(tree):
                out.update(_flatten(val, f"{prefix}{tag}:{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(arrays: Dict[str, np.ndarray], structure: Dict[str, dict]):
    root: Dict[str, Any] = {}
    for key, val in list(arrays.items()) + list(structure.items()):
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    def materialize(node):
        if not isinstance(node, dict):
            return node
        if "__len__" in node:
            info = node.pop("__len__")
            items = [None] * info["n"]
            for k, v in node.items():
                items[int(k.split(":", 1)[1])] = materialize(v)
            return items if info["tag"] == "l" else tuple(items)
        node.pop("__namedtuple__", None)      # read as a plain dict of fields
        return {k.split(":", 1)[1]: materialize(v) for k, v in node.items()}

    return materialize(root)


def save_checkpoint(path: str, step: int, model: NRNeRF,
                    optimizer_state: Optional[Tuple[dict, dict]] = None,
                    extras: Optional[dict] = None) -> None:
    """Write one npz checkpoint (atomically, by rename): the model's
    parameters as the JAX tree and, when given, Adam's moments
    `optimizer_state = (mu, nu)` by parameter name as optax's state with
    both counts at `step`."""
    if not path.endswith(".npz"):
        raise ValueError(f"only npz checkpoints are written, not {path!r}")
    tree = {"params": params_to_jax(model)}
    if optimizer_state is not None:
        mu, nu = optimizer_state
        count = np.asarray(step, np.int32)
        tree["opt_state"] = (
            ScaleByAdamState(count, tree_from_named(mu), tree_from_named(nu)),
            ScaleByScheduleState(count))
    arrays, structure = {}, {}
    for key, val in _flatten(tree).items():
        if isinstance(val, dict):             # structural marker
            structure[key] = val
        else:
            arrays[key] = np.asarray(val)
    meta = {"step": int(step), "structure": structure,
            "extras": extras or {}, "format_version": 1}
    tmp = path + ".tmp.npz"
    np.savez(tmp, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8), **arrays)
    os.replace(tmp, path)


def read_checkpoint(path: str, with_opt_state: bool = False):
    """(step, params tree of numpy arrays, extras) of an npz checkpoint, and
    with `with_opt_state` a fourth item: the optimizer-state tree (tuples,
    lists and dicts of numpy arrays) or None."""
    if not path.endswith(".npz"):
        raise ValueError(f"only npz checkpoints are read, not {path!r}")
    want = ("d:params/", "d:opt_state/") if with_opt_state else ("d:params/",)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        arrays = {k: data[k] for k in data.files
                  if k != "__meta__" and k.startswith(want)}
    structure = {k: v for k, v in meta["structure"].items()
                 if k.startswith(want)}
    tree = _unflatten(arrays, structure)
    out = (meta["step"], tree["params"], meta.get("extras", {}))
    return out + (tree.get("opt_state"),) if with_opt_state else out


def load_checkpoint(path: str, cfg: ModelConfig,
                    device: DeviceLike = None) -> Tuple[int, NRNeRF, dict]:
    """(step, model on `device`, extras) of an npz checkpoint."""
    step, params, extras = read_checkpoint(path)
    return step, params_from_jax(params, cfg, device=device), extras


def load_train_state(path: str, cfg: ModelConfig, device: DeviceLike = None
                     ) -> Tuple[TrainState, dict]:
    """(train state on `device`, extras) of an npz checkpoint: the model,
    Adam's moments (zero where the checkpoint has no optimizer state) and
    the step."""
    device = resolve_device(device)        # before the file is read
    step, params, extras, opt_state = read_checkpoint(path, with_opt_state=True)
    model = params_from_jax(params, cfg, device=device)
    if opt_state is None:
        mu, nu = zero_moments(model), zero_moments(model)
    else:
        adam = opt_state[0]
        mu = named_from_tree(adam["mu"], model)
        nu = named_from_tree(adam["nu"], model)
    return TrainState(model=model, mu=mu, nu=nu, step=int(step)), extras


def find_checkpoints(logdir: str) -> List[str]:
    """All npz checkpoints of a log dir, the newest last: numbered ones by
    step, then `latest.npz` (reference auto-resume scan: train.py:666-694)."""
    if not os.path.isdir(logdir):
        return []
    names = [f for f in os.listdir(logdir)
             if f.endswith(".npz") and not f.endswith(".tmp.npz")]

    def sort_key(name):
        stem = name.rsplit(".", 1)[0]
        if stem == "latest":
            return (1, 0)
        m = re.match(r"(\d+)$", stem)
        return (0, int(m.group(1))) if m else (-1, 0)

    return [os.path.join(logdir, f) for f in sorted(names, key=sort_key)]


def latest_checkpoint(logdir: str) -> Optional[str]:
    """`latest.npz` if present, else the highest numbered checkpoint."""
    ckpts = find_checkpoints(logdir)
    return ckpts[-1] if ckpts else None
