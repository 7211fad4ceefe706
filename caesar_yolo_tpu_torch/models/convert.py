"""Weights in the reference's npz format.

The reference saves its params pytree flattened to '/'-joined keys
(caesar_yolo_tpu/models/convert.py:save_params).  The port's module tree
carries the same names, so carrying weights across is a mechanical walk:
'/' becomes '.', and conv kernels turn from HWIO to OIHW.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from caesar_yolo_tpu_torch.models.yolo import YOLO, build_model


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _unflatten(flat: dict):
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_params(path: str):
    """Load (params pytree of numpy arrays, meta) from a reference npz."""
    with np.load(path) as data:
        flat, meta = {}, {}
        for k in data.files:
            if k == "__meta__":
                meta = json.loads(bytes(data[k].tobytes()).decode())
            else:
                flat[k] = data[k]
    return _unflatten(flat), meta


def state_from_params(params) -> dict[str, torch.Tensor]:
    """The reference's params pytree (numpy arrays) -> the port's
    state_dict: '/' -> '.', 4-D conv kernels HWIO -> OIHW."""
    state = {}
    for key, value in _flatten(params):
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        state[key.replace("/", ".")] = torch.from_numpy(arr.copy())
    return state


def params_from_state(state: dict) -> dict:
    """The inverse of `state_from_params`: the port's state_dict -> the
    reference's params pytree of numpy f32 arrays ('.' -> '/', 4-D conv
    kernels OIHW -> HWIO)."""
    flat = {}
    for key, value in state.items():
        arr = value.detach().cpu().float().numpy()
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        # a copy: .numpy() of a CPU tensor shares its memory
        flat[key.replace(".", "/")] = np.array(arr, order="C")
    return _unflatten(flat)


def flat_params(state: dict) -> dict[str, np.ndarray]:
    """The port's state_dict (or a dict of the same keys, such as the
    trainer's EMA) -> {the reference's param path ('head/box/0/2/w',
    '.../bn/gamma'): f32 array in the reference's layout}, for comparing
    parameter trees leaf by leaf."""
    return dict(_flatten(params_from_state(state)))


def save_params(model: YOLO, path: str, meta: dict | None = None) -> str:
    """Save `model`'s weights in the reference's npz format (flat
    '/'-joined keys plus a `__meta__` JSON entry), which
    caesar_yolo_tpu/models/convert.py:load_params reads.  Returns the
    path written (".npz" appended when absent, as np.savez does)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    flat = flat_params(model.state_dict())
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **flat)
    return path


def load_jax_params(model: YOLO, params) -> YOLO:
    """Carry the reference's params pytree into `model` (strict: every
    key on both sides must match)."""
    model.load_state_dict(state_from_params(params), strict=True)
    return model


def load_model(path: str) -> tuple[YOLO, dict]:
    """Build the model named in a reference npz's meta and load its
    weights -> (model on the CPU in f32, meta)."""
    params, meta = load_params(path)
    model = build_model(meta["model"],
                        num_classes=int(meta.get("num_classes", 5)))
    return load_jax_params(model, params), meta
