"""Checkpoints as ``.npz`` files (counterpart of ``vrdd_tpu/io/checkpoint.py``).

The layout of the JAX package's files: the leaves ``leaf_00000``,
``leaf_00001``, ... in the order JAX flattens the tree (dict keys sorted,
lists in order), ``__version__`` and ``__treedef__``. The JAX package
pickles its treedef there; the port writes the tree's structure as JSON
bytes instead, so a port checkpoint never needs JAX to load, and the arrays
``fit-hist`` writes (``hist``, ``loss``) sit under the same keys in both.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any

import numpy as np
import torch

_VERSION = 1


def _flatten(tree, leaves):
    """Structure of ``tree`` (dicts, lists, tuples; anything else a leaf),
    appending its leaves in JAX's order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return {"dict": [[k, _flatten(tree[k], leaves)] for k in keys]}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_flatten(v, leaves) for v in tree]}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    leaves.append(np.asarray(tree))
    return None


def _unflatten(struct, leaves):
    if struct is None:
        return next(leaves)
    if "dict" in struct:
        return {k: _unflatten(s, leaves) for k, s in struct["dict"]}
    kind = "list" if "list" in struct else "tuple"
    vals = [_unflatten(s, leaves) for s in struct[kind]]
    return vals if kind == "list" else tuple(vals)


def save_checkpoint(path: str, tree: Any) -> None:
    """Atomically write a tree of arrays (numpy or tensors) to ``path``."""
    leaves = []
    struct = _flatten(tree, leaves)
    payload = {f"leaf_{i:05d}": leaf for i, leaf in enumerate(leaves)}
    payload["__treedef__"] = np.frombuffer(json.dumps(struct).encode(),
                                           dtype=np.uint8)
    payload["__version__"] = np.asarray(_VERSION)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        fp.write(buf.getvalue())
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Any:
    """Restore the tree saved by :func:`save_checkpoint` (numpy leaves)."""
    leaves = load_leaves(path)
    with np.load(path, allow_pickle=False) as data:
        struct = json.loads(data["__treedef__"].tobytes().decode())
    return _unflatten(struct, iter(leaves))


def load_leaves(path: str) -> list:
    """The leaves of a checkpoint in their stored order, as numpy arrays,
    whichever package wrote it (JAX's pickled treedef is not read)."""
    with np.load(path, allow_pickle=False) as data:
        version = int(data["__version__"])
        if version != _VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        return [data[k] for k in sorted(k for k in data.files
                                        if k.startswith("leaf_"))]
