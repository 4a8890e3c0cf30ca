"""Checkpoint and resume of training state.

Port of ``videoquery/train/checkpoint.py``. A checkpoint is one ``.npz`` of
flat keys, readable with numpy alone:

    params/<layer>/w|b     the weights in the JAX package's layout (HWIO
                           convs, fc-action [1024, C]), float32
    opt_state/<layer>/w|b  the SGD momentum buffers, same layout
    step                   int64 scalar

(<layer> is the Caffe layer name, e.g. ``conv1/7x7_s2``, slashes kept.) The
JAX package saves through Orbax, or pickles a jax treedef beside numbered
leaves, so neither package reads the other's files without jax.
"""

from __future__ import annotations

import os

import numpy as np

_GROUPS = ("params", "opt_state")


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_train_state(path: str, params, opt_state, step: int) -> str:
    """Write {params, opt_state, step} to `path` (".npz" appended when
    missing); params and opt_state are {layer: {'w': array, 'b': array}}.
    Returns the file's path."""
    flat = {"step": np.asarray(int(step), np.int64)}
    for group, tree in zip(_GROUPS, (params, opt_state)):
        for layer, leaves in tree.items():
            for leaf, value in leaves.items():
                flat[f"{group}/{layer}/{leaf}"] = np.asarray(value)
    out = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    # written beside and renamed over: a failed save leaves the last one whole
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, out)
    return out


def load_train_state(path: str) -> dict:
    """Read a checkpoint written by save_train_state: {'params': {layer:
    {'w', 'b'}}, 'opt_state': the same, 'step': int}."""
    state: dict = {group: {} for group in _GROUPS}
    with np.load(_npz_path(path)) as f:
        for key in f.files:
            if key == "step":
                state["step"] = int(f[key])
                continue
            group, rest = key.split("/", 1)
            layer, leaf = rest.rsplit("/", 1)
            state[group].setdefault(layer, {})[leaf] = f[key]
    return state
