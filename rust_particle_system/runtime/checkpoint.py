"""Checkpoint / resume — a capability the reference never had (SURVEY.md §5).

The reference generates particle state once at startup and the GPU buffers are the only
copy (`src/main.rs:182-216`); killing the app loses the simulation.  Here any state (and
params) pytree round-trips through a single ``.npz`` file: leaves are saved by pytree
path, so arbitrary NamedTuple-based states (SPH, flow, N-body...) work unchanged.
Orbax is available in the environment for users who want async/multi-host
checkpointing of the same pytrees; this built-in path has zero extra dependencies.
"""

from __future__ import annotations

import os

import jax
import numpy as np


def _flatten_with_names(tree):
    leaves_with_paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, leaf in leaves_with_paths:
        name = "/".join(str(getattr(p, "name", getattr(p, "idx", p))) for p in path)
        out[name] = np.asarray(leaf)
    return out


def save(path: str, state, params=None) -> None:
    """Write state (and optionally params) pytrees to ``path`` (.npz)."""
    payload = {f"state/{k}": v for k, v in _flatten_with_names(state).items()}
    if params is not None:
        payload.update({f"params/{k}": v for k, v in _flatten_with_names(params).items()})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint


def load(path: str, state_like, params_like=None):
    """Read pytrees saved by :func:`save`, shaped like the given examples.

    Returns ``state`` or ``(state, params)`` depending on whether ``params_like`` is
    given.  Leaf names must match — i.e. restore with the same state/params types.
    """
    with np.load(path) as data:
        def restore(prefix, like):
            examples = _flatten_with_names(like)
            leaves = []
            for name, example in examples.items():
                key = f"{prefix}/{name}"
                if key not in data:
                    raise ValueError(
                        f"checkpoint {path!r} has no leaf {key!r} — was it saved "
                        f"with a different state/params type?"
                    )
                leaf = data[key]
                if leaf.shape != example.shape or leaf.dtype != example.dtype:
                    raise ValueError(
                        f"checkpoint leaf {key!r} is {leaf.dtype}{list(leaf.shape)} "
                        f"but the running simulation expects "
                        f"{example.dtype}{list(example.shape)} — resume with the "
                        f"same --n / state type it was saved with"
                    )
                leaves.append(leaf)
            treedef = jax.tree_util.tree_structure(like)
            return jax.tree_util.tree_unflatten(treedef, leaves)

        state = restore("state", state_like)
        if params_like is None:
            return state
        return state, restore("params", params_like)


def has_params(path: str) -> bool:
    """True if the checkpoint at ``path`` carries a saved params pytree."""
    with np.load(path) as data:
        return any(k.startswith("params/") for k in data.files)
