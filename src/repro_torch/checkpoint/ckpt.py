"""Flat-keyed numpy-archive checkpoints of nested dicts, lists and tuples of
tensors or arrays (port of ``repro.checkpoint.ckpt``, which writes msgpack).

Layout: ``<dir>/step_<n>.npz`` (``np.savez``, no pickle), one array per leaf
under the reference's key: the leaf's path, dict keys and sequence indices
joined by "/" (dict keys in sorted order, as JAX flattens them).  Restoring
onto a template checks that every key exists and that its shape matches.
Writes are atomic: a temporary file in the directory, then ``os.replace``.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch


def _is_node(tree: Any) -> bool:
    return isinstance(tree, (dict, list, tuple))


def _children(tree: Any):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), sub) for i, sub in enumerate(tree)]


def _as_array(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Leaves by their "/"-joined paths, in the template's order."""
    if not _is_node(tree):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in _children(tree):
        out.update(_flatten(sub, f"{prefix}/{key}" if prefix else key))
    return out


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.npz")


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write ``tree``'s leaves to ``directory/step_%08d.npz``; returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    arrays = {k: _as_array(v) for k, v in _flatten(tree).items()}
    path = _path(directory, step)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(directory)
             if (m := re.match(r"step_(\d+)\.npz$", fn))]
    return max(steps) if steps else None


def read_checkpoint(directory: str, step: int) -> Dict[str, np.ndarray]:
    """Every stored array by its flat key (no template needed)."""
    with np.load(_path(directory, step), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_checkpoint(directory: str, step: int, template: Any) -> Any:
    """``template``'s structure with the stored leaves: a tensor leaf comes
    back as a tensor on its device, any other leaf as a numpy array."""
    payload = read_checkpoint(directory, step)

    def build(tree: Any, prefix: str) -> Any:
        def key(k):
            return f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree, dict):
            return {k: build(sub, key(k)) for k, sub in tree.items()}
        if isinstance(tree, (list, tuple)):
            subs = [build(sub, key(i)) for i, sub in enumerate(tree)]
            return type(tree)(subs)
        if prefix not in payload:
            raise KeyError(f"checkpoint missing {prefix!r}")
        arr = payload[prefix]
        shape = tuple(tree.shape) if isinstance(tree, torch.Tensor) else np.shape(tree)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {prefix}: {arr.shape} vs {shape}")
        if isinstance(tree, torch.Tensor):
            return torch.from_numpy(arr).to(tree.device)
        return arr

    return build(template, "")
