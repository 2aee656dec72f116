"""Checkpoint reader and the JAX -> torch weight bridge (numpy only).

Reads the JAX package's v2 ``.npz`` format (``vqvae_tpu/train/checkpoint.py``):
a ``__meta__`` JSON string (format_version, step, metrics, hyperparameters)
plus one array per pytree leaf under ``leaf::<keystr>``, for example
``leaf::.params['encoder']['conv1_w']``. Only the model parameters are read;
optimizer and EMA leaves are ignored. Saving comes with the training slice.

``params_from_jax`` maps the JAX parameter tree (HWIO kernels) onto the
port's ``state_dict``: conv kernels (kh, kw, C_in, C_out) -> (C_out, C_in,
kh, kw) via transpose(3, 2, 0, 1); transposed-conv kernels -> (C_in, C_out,
kh, kw) via transpose(2, 3, 0, 1), with no spatial flip (torch's
ConvTranspose2d already has the semantics the JAX op emulates).
"""

from __future__ import annotations

import json
import re
from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch

_LEAF_PREFIX = "leaf::"
_PARAMS_PREFIX = _LEAF_PREFIX + ".params"
_KEY_RE = re.compile(r"\['([^']*)'\]")


def _read_meta(data) -> Dict[str, Any]:
    meta = json.loads(str(data["__meta__"]))
    version = int(meta.get("format_version", 1))
    if version < 2:
        raise ValueError(f"checkpoint format v{version} is not supported (need v2)")
    return meta


def read_checkpoint(path: str) -> Tuple[Dict[str, Any], int, Dict, Dict]:
    """-> (params as a nested dict of numpy arrays, step, metrics, hyperparameters)."""
    params: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as data:
        meta = _read_meta(data)
        for key in data.files:
            if not key.startswith(_PARAMS_PREFIX):
                continue
            path_keys = _KEY_RE.findall(key[len(_PARAMS_PREFIX):])
            if "".join(f"['{k}']" for k in path_keys) != key[len(_PARAMS_PREFIX):]:
                raise ValueError(f"unrecognised parameter key {key!r}")
            node = params
            for k in path_keys[:-1]:
                node = node.setdefault(k, {})
            node[path_keys[-1]] = np.asarray(data[key])
    if not params:
        raise ValueError(f"{path}: no '.params' leaves found")
    return params, int(meta["step"]), meta.get("metrics", {}), meta.get("hyperparameters", {}) or {}


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flatten(v, name + ".")
        else:
            yield name, np.asarray(v)


def params_from_jax(params_tree_or_npz) -> Dict[str, torch.Tensor]:
    """JAX VQVAE params (a nested mapping of arrays, or a checkpoint path) ->
    the port's ``VQVAE.state_dict()``.

    Names carry over one to one (``encoder.res_stack.layer_0.conv3x3``); only
    the 4-D kernels change layout.
    """
    tree = params_tree_or_npz
    if isinstance(tree, str):
        tree = read_checkpoint(tree)[0]
    state = {}
    for name, arr in _flatten(tree):
        if arr.ndim == 4:
            leaf = name.rsplit(".", 1)[-1]
            axes = (2, 3, 0, 1) if leaf.startswith("convt") else (3, 2, 0, 1)
            arr = arr.transpose(axes)
        state[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return state


__all__ = ["params_from_jax", "read_checkpoint"]
