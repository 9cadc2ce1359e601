"""Checkpoint / resume for progressive renders and inverse-rendering runs.

Port of rtm_tpu/runtime/checkpoint.py, with rtm_tpu's on-disk form: one
.npz holding the flattened leaves as `leaf_{i}` plus a `__meta__` JSON
header ({"n": leaf count, "extra": {...}}), so a file written by either
package loads in the other when both sides describe the same structure.

The port flattens its own trees in JAX's pytree order: dicts by sorted
key, lists and tuples (named tuples included) in order, dataclasses
(SceneParams, TracerScene, ...) field by field, None as no leaf; tensors,
NumPy arrays and Python scalars are leaves.  An optimizer's
`state_dict()` is such a tree.  Loading rebuilds the structure of a
`like` tree and casts each leaf back to its kind, dtype and device.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, bool, int,
                          float, complex))


def _children(tree):
    """(kind, child list) of an inner node of the tree."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    raise TypeError(f"checkpoint: cannot flatten a {type(tree).__name__}")


def tree_leaves(tree) -> list:
    """The leaves of `tree` in JAX's pytree order."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [tree]
    return [leaf for child in _children(tree) for leaf in tree_leaves(child)]


def _cast(saved: np.ndarray, like):
    """A saved leaf in the kind, dtype and device of the leaf `like`."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(saved, copy=True)).to(
            device=like.device, dtype=like.dtype)
    if isinstance(like, (np.ndarray, np.generic)):
        return np.asarray(saved).astype(np.asarray(like).dtype)
    return type(like)(np.asarray(saved).item())


def _unflatten(like, leaves):
    """`like`'s structure filled from the iterator `leaves`."""
    if like is None:
        return None
    if _is_leaf(like):
        return _cast(next(leaves), like)
    if isinstance(like, dict):
        filled = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten(c, leaves) for c in like]
        if isinstance(like, list):
            return vals
        return type(like)(*vals) if hasattr(like, "_fields") else tuple(vals)
    return dataclasses.replace(like, **{
        f.name: _unflatten(getattr(like, f.name), leaves)
        for f in dataclasses.fields(like)})


def _savable(x) -> np.ndarray:
    """A leaf as an npz array; bfloat16 and other dtypes NumPy cannot
    hold are widened to float32 on disk (rtm_tpu does the same) and cast
    back on load."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str, tree, extra: dict | None = None) -> None:
    """Save any tree (see the module doc) to `path` (.npz)."""
    leaves = tree_leaves(tree)
    arrays = {f"leaf_{i}": _savable(x) for i, x in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"n": len(leaves), "extra": extra or {}}).encode(),
        dtype=np.uint8)
    np.savez(path, **arrays)


def load_pytree(path: str, like):
    """Load leaves saved by save_pytree (either package's) into the
    structure of `like`.  Returns (tree, extra_dict)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        leaves = [z[f"leaf_{i}"] for i in range(meta["n"])]
    n_like = len(tree_leaves(like))
    if n_like != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, structure "
                         f"expects {n_like}")
    return _unflatten(like, iter(leaves)), meta["extra"]


def save_render_state(path: str, accum, frame_index: int,
                      scene=None, opt_state=None, rng_key=None) -> None:
    """Checkpoint a progressive render / optimization step (opt_state: an
    optimizer's state_dict())."""
    state = {"accum": accum}
    if scene is not None:
        state["scene"] = scene
    if opt_state is not None:
        state["opt"] = opt_state
    if rng_key is not None:
        state["key"] = rng_key
    save_pytree(path, state, extra={"frame_index": int(frame_index),
                                    "keys": sorted(state.keys())})


def load_render_state(path: str, like: dict):
    """Restore a checkpoint written by save_render_state.  `like` must have
    the same keys and structures.  Returns (state_dict, frame_index)."""
    state, extra = load_pytree(path, like)
    return state, extra["frame_index"]
