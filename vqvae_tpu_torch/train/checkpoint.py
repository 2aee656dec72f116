"""Checkpoints in the JAX package's format, and the bridge between the two
packages' weights and train states (numpy and torch only).

The file is the JAX package's v2 ``.npz`` (``vqvae_tpu/train/checkpoint.py``):
a ``__meta__`` JSON string (format_version, step, metrics, hyperparameters,
n_leaves) plus one array per leaf of the JAX train state under its pytree
key path::

    leaf::.params['encoder']['conv1_w']            float32, HWIO
    leaf::.opt_state[0].count                      int32
    leaf::.opt_state[0].mu['encoder']['conv1_w']   float32 (also .nu, and .nu_max with AMSGrad)
    leaf::.step                                    int32
    leaf::.ema_counts, leaf::.ema_means            float32, only with an EMA codebook

so a file written here loads with the JAX package's ``load_checkpoint`` into
its train state and the reverse, optimizer state included. Two train states
travel this way: the VQ-VAE's (``TrainState``: AMSGrad's ``mu``, ``nu``,
``nu_max``; 94 leaves at full width) and the prior's (``PixelCNNState``:
Adam's ``mu``, ``nu``; 422 leaves at full width). The moments are the ones
the optimizer names in its ``MOMENTS`` (``train/optim.py``). In a prior's
file the meta ``step`` is the epoch it was saved after, while
``leaf::.step`` counts updates; both are kept as they are. v1 files
(positional ``leaf_{i}`` keys) are not supported and are refused.

Between the packages a train state travels as a *tree*: a nested dict of
numpy arrays in the JAX layouts and dtypes, ``{"params": {...}, "opt_state":
{"count", "mu": {...}, "nu": {...}[, "nu_max": {...}]}, "step"[,
"ema_counts", "ema_means"]}``. ``train_state_to_jax`` makes one from the
port's state (always copying, so the tree is a snapshot that later in-place
updates do not touch), ``train_state_from_jax`` loads one into it.

Layouts: conv kernels are (kh, kw, C_in, C_out) in JAX and (C_out, C_in, kh,
kw) here; transposed-conv kernels (kh, kw, C_in, C_out) and (C_in, C_out, kh,
kw), with no spatial flip (torch's ConvTranspose2d already has the semantics
the JAX op emulates). Optimizer moments take the layout of their parameter.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

FORMAT_VERSION = 2
_LEAF_PREFIX = "leaf::"
_PARAMS_PREFIX = _LEAF_PREFIX + ".params"
_KEY_RE = re.compile(r"\['([^']*)'\]")
# key-path prefix of each subtree of a JAX train state that holds a tree
# shaped like the parameters (an optimizer keeps some of the moments)
_SUBTREES = {".params": ("params",),
             **{f".opt_state[0].{m}": ("opt_state", m) for m in ("mu", "nu", "nu_max")}}
# key path of each single leaf
_SCALARS = {".opt_state[0].count": ("opt_state", "count"), ".step": ("step",),
            ".ema_counts": ("ema_counts",), ".ema_means": ("ema_means",)}


# -- layouts -----------------------------------------------------------------


def _is_convt(name: str) -> bool:
    return name.rsplit(".", 1)[-1].startswith("convt")


def _from_jax_layout(name: str, arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:
        arr = arr.transpose((2, 3, 0, 1) if _is_convt(name) else (3, 2, 0, 1))
    return np.array(arr, dtype=np.float32, order="C")


def _to_jax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    arr = t.detach().cpu().numpy()
    if arr.ndim == 4:
        arr = arr.transpose((2, 3, 0, 1) if _is_convt(name) else (2, 3, 1, 0))
    return np.array(arr, dtype=np.float32, order="C")  # a copy, also on the CPU


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flatten(v, name + ".")
        else:
            yield name, np.asarray(v)


def _nest(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, arr in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return tree


def params_from_jax(params_tree_or_npz) -> Dict[str, torch.Tensor]:
    """JAX VQVAE params (a nested mapping of arrays, or a checkpoint path) ->
    the port's ``VQVAE.state_dict()``.

    Names carry over one to one (``encoder.res_stack.layer_0.conv3x3``); only
    the 4-D kernels change layout.
    """
    tree = params_tree_or_npz
    if isinstance(tree, str):
        tree = read_checkpoint(tree)[0]
    return {name: torch.from_numpy(_from_jax_layout(name, arr)) for name, arr in _flatten(tree)}


def params_to_jax(state_dict: Mapping) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: the port's ``state_dict`` (or any
    mapping of its dotted names to tensors, such as optimizer moments) -> the
    JAX parameter tree, as a nested dict of float32 numpy arrays."""
    return _nest({name: _to_jax_layout(name, t) for name, t in state_dict.items()})


# -- train state <-> tree ----------------------------------------------------


def train_state_to_jax(state) -> Dict[str, Any]:
    """The port's ``TrainState`` or ``PixelCNNState`` -> the JAX train state
    as a tree (a copy)."""
    named = dict(state.model.named_parameters())  # shared residual weights are listed once
    opt = state.optimizer
    tree = {
        "params": params_to_jax(named),
        "opt_state": {
            "count": np.asarray(opt.count, np.int32),
            **{m: params_to_jax({n: opt.state[p][key] for n, p in named.items()})
               for m, key in opt.MOMENTS.items()},
        },
        "step": np.asarray(state.step, np.int32),
    }
    if getattr(state, "ema_counts", None) is not None:
        tree["ema_counts"] = np.array(state.ema_counts.detach().cpu().numpy(), np.float32)
        tree["ema_means"] = np.array(state.ema_means.detach().cpu().numpy(), np.float32)
    return tree


def _check_tree(want: Dict[str, np.ndarray], got: Dict[str, np.ndarray], what: str) -> None:
    """Key sets, shapes and dtypes of two flat {key path: array} dicts must agree."""
    if set(got) != set(want):
        missing = sorted(set(want) - set(got))[:5]
        extra = sorted(set(got) - set(want))[:5]
        raise ValueError(f"{what} tree mismatch: missing leaves {missing}, unexpected leaves {extra}")
    for key, tmpl in want.items():
        saved = got[key]
        if tuple(saved.shape) != tuple(tmpl.shape):
            raise ValueError(f"{key}: {what} shape {tuple(saved.shape)} != template {tuple(tmpl.shape)}")
        if saved.dtype != tmpl.dtype:
            raise ValueError(f"{key}: {what} dtype {saved.dtype} != template {tmpl.dtype}")


@torch.no_grad()
def train_state_from_jax(tree: Mapping, state, what: str = "state"):
    """Load a JAX train-state tree into the port's ``state``, in place:
    parameters, the optimizer's moments of every parameter (``mu``, ``nu``
    and, with AMSGrad, ``nu_max``), ``count``, ``step`` and the EMA
    statistics. The tree must have exactly the leaves,
    shapes and dtypes of ``state``'s own (``train_state_to_jax(state)``);
    anything else raises ``ValueError`` and leaves ``state`` as it was."""
    flat = flatten_tree(tree)
    _check_tree(flatten_tree(train_state_to_jax(state)), flat, what)
    opt = state.optimizer
    for name, p in state.model.named_parameters():
        key = "".join(f"['{k}']" for k in name.split("."))
        p.copy_(torch.from_numpy(_from_jax_layout(name, flat[f"{_LEAF_PREFIX}.params{key}"])))
        for m, slot in opt.MOMENTS.items():
            arr = flat[f"{_LEAF_PREFIX}.opt_state[0].{m}{key}"]
            opt.state[p][slot].copy_(torch.from_numpy(_from_jax_layout(name, arr)))
    opt.count = int(flat[_LEAF_PREFIX + ".opt_state[0].count"])
    state.step = int(flat[_LEAF_PREFIX + ".step"])
    if getattr(state, "ema_counts", None) is not None:
        state.ema_counts.copy_(torch.from_numpy(np.array(flat[_LEAF_PREFIX + ".ema_counts"])))
        state.ema_means.copy_(torch.from_numpy(np.array(flat[_LEAF_PREFIX + ".ema_means"])))
    return state


# -- tree <-> file -----------------------------------------------------------


def flatten_tree(tree: Mapping) -> Dict[str, np.ndarray]:
    """A train-state tree -> {"leaf::<JAX key path>": array}, the file's arrays."""
    def lookup(path):
        node = tree
        for k in path:
            node = node.get(k) if isinstance(node, Mapping) else None
        return node

    flat = {}
    for prefix, path in _SUBTREES.items():
        for name, arr in _flatten(lookup(path) or {}):
            flat[_LEAF_PREFIX + prefix + "".join(f"['{k}']" for k in name.split("."))] = arr
    for key, path in _SCALARS.items():
        if lookup(path) is not None:
            flat[_LEAF_PREFIX + key] = np.asarray(lookup(path))
    return flat


def unflatten_tree(flat: Mapping) -> Dict[str, Any]:
    """{"leaf::<JAX key path>": array} -> a train-state tree. A key path that
    is none of the JAX ``TrainState``'s raises ``ValueError``."""
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        path = key[len(_LEAF_PREFIX):]
        if path in _SCALARS:
            where = _SCALARS[path]
        else:
            prefix = next((p for p in _SUBTREES if path.startswith(p + "[")), None)
            names = _KEY_RE.findall(path[len(prefix):]) if prefix else []
            if not names or "".join(f"['{k}']" for k in names) != path[len(prefix):]:
                raise ValueError(f"unrecognised checkpoint key {key!r}")
            where = _SUBTREES[prefix] + tuple(names)
        node = tree
        for k in where[:-1]:
            node = node.setdefault(k, {})
        node[where[-1]] = np.asarray(arr)
    return tree


def _read_meta(data) -> Dict[str, Any]:
    meta = json.loads(str(data["__meta__"]))
    version = int(meta.get("format_version", 1))
    if version < 2:
        raise ValueError(f"checkpoint format v{version} is not supported (need v2)")
    return meta


def read_checkpoint(path: str) -> Tuple[Dict[str, Any], int, Dict, Dict]:
    """The model parameters alone, without a template (for ``load_model``):
    -> (params as a nested dict of numpy arrays, step, metrics, hyperparameters)."""
    with np.load(path, allow_pickle=False) as data:
        meta = _read_meta(data)
        flat = {k: data[k] for k in data.files if k.startswith(_PARAMS_PREFIX)}
    if not flat:
        raise ValueError(f"{path}: no '.params' leaves found")
    params = unflatten_tree(flat)["params"]
    return params, int(meta["step"]), meta.get("metrics", {}), meta.get("hyperparameters", {}) or {}


def save_checkpoint(
    path: str,
    state,
    step: int,
    metrics: Optional[Dict] = None,
    hyperparameters: Optional[Dict] = None,
) -> str:
    """Write ``state`` (the port's ``TrainState``, or a tree snapshot of one)
    with its metadata, atomically: a temporary file in the same directory,
    then a rename, so a crash never leaves a torn latest checkpoint."""
    tree = state if isinstance(state, Mapping) else train_state_to_jax(state)
    arrays = flatten_tree(tree)
    meta = {
        "format_version": FORMAT_VERSION,
        "step": int(step),
        "metrics": metrics or {},
        "hyperparameters": hyperparameters or {},
        "n_leaves": len(arrays),
    }
    dirname = os.path.dirname(path) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def read_state_tree(path: str) -> Tuple[Dict[str, Any], int, Dict, Dict]:
    """The whole train state of a file as a tree, without a template:
    -> (tree, step, metrics, hyperparameters)."""
    with np.load(path, allow_pickle=False) as data:
        meta = _read_meta(data)
        flat = {k: np.asarray(data[k]) for k in data.files if k.startswith(_LEAF_PREFIX)}
    return (unflatten_tree(flat), int(meta["step"]), meta.get("metrics", {}),
            meta.get("hyperparameters", {}) or {})


def load_checkpoint(path: str, state) -> Tuple[Any, int, Dict, Dict]:
    """Restore the full train state of ``path`` into ``state`` (the template),
    in place. Leaves are matched by key path with shape and dtype checks, so
    a file from another configuration fails loudly and never cross-loads.

    Returns (state, step, metrics, hyperparameters).
    """
    tree, step, metrics, hyperparameters = read_state_tree(path)
    train_state_from_jax(tree, state, what="checkpoint")
    return state, step, metrics, hyperparameters


def peek_hyperparameters(path: str) -> Dict:
    """A checkpoint's stored hyperparameters, read without a template: a model
    is rebuilt from what the file says it is, never from the loading
    process's flags."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
    return meta.get("hyperparameters", {}) or {}


def check_hyperparameters_compatible(path: str, current: Dict, fields: Tuple[str, ...]) -> None:
    """Before a resume: compare the tree-affecting ``fields`` of the current
    config with the checkpoint's stored hyperparameters and raise a
    ``ValueError`` that names each mismatch (the tree check would refuse the
    load too, but cannot say why). Files without stored hyperparameters pass."""
    hp = peek_hyperparameters(path)
    mismatched = {
        k: (hp[k], current[k])
        for k in fields
        if k in hp and k in current and hp[k] != current[k]
    }
    if mismatched:
        detail = ", ".join(
            f"{k}: checkpoint={s!r} vs flags={c!r}" for k, (s, c) in sorted(mismatched.items())
        )
        raise ValueError(
            f"cannot resume {path!r} with mismatched model flags ({detail}); "
            "pass flags matching the checkpoint (its full config is stored "
            "in the file's hyperparameters metadata)"
        )


class AsyncCheckpointer:
    """Write checkpoints off the training loop's path.

    ``save`` copies the state to host memory before it returns (the next
    update changes parameters and moments in place, so a snapshot by
    reference would race with it; a tree, ``train_state_to_jax``'s, is such
    a copy already) and hands the copy to a writer thread that
    serialises and renames. One save is in flight at a time: a new ``save``
    waits for the one before. An error of the writer is raised by the next
    ``save`` or ``wait``; call ``wait()`` before exit or restore.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(
        self,
        path: str,
        state,
        step: int,
        metrics: Optional[Dict] = None,
        hyperparameters: Optional[Dict] = None,
    ) -> str:
        self.wait()
        snapshot = state if isinstance(state, Mapping) else train_state_to_jax(state)

        def _write():
            try:
                save_checkpoint(path, snapshot, step, metrics, hyperparameters)
            except Exception as e:  # raised on the caller's thread by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, name=f"ckpt-writer-step{step}", daemon=True)
        self._thread.start()
        return path

    def wait(self) -> None:
        """Block until the save in flight (if any) is durable; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


_CKPT_RE = re.compile(r"_step(\d+)\.npz$")


def checkpoint_path(results_dir: str, name: str, step: int) -> str:
    return os.path.join(results_dir, f"vqvae_{name}_step{step}.npz")


def latest_checkpoint(results_dir: str, name: str) -> Optional[str]:
    """Newest step-tagged checkpoint for ``name``, or None."""
    if not os.path.isdir(results_dir):
        return None
    best, best_step = None, -1
    prefix = f"vqvae_{name}_step"
    for fn in os.listdir(results_dir):
        if not fn.startswith(prefix):
            continue
        m = _CKPT_RE.search(fn)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(results_dir, fn)
    return best


__all__ = [
    "AsyncCheckpointer",
    "check_hyperparameters_compatible",
    "checkpoint_path",
    "flatten_tree",
    "latest_checkpoint",
    "load_checkpoint",
    "params_from_jax",
    "params_to_jax",
    "peek_hyperparameters",
    "read_checkpoint",
    "read_state_tree",
    "save_checkpoint",
    "train_state_from_jax",
    "train_state_to_jax",
    "unflatten_tree",
]
