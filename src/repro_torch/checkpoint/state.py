"""Federation-state store: nested containers with array leaves (port of
``repro.checkpoint.state``).

* ``snapshot(state)`` walks a container of dicts, lists, scalars, tensors
  and numpy arrays and returns a decoupled host copy: a fresh skeleton in
  which every array leaf is an ``{"__ndarray__": i}`` placeholder, and the
  list of host ``np.ndarray`` copies.  After it returns, a writer thread can
  serialize the copy while the run goes on mutating its tensors in place.
* ``write_snapshot(path, snap)`` writes the skeleton as ``manifest.json``
  and the arrays as ``arrays.npz`` into a temporary directory, then
  publishes it atomically at ``path``.  Python's ``json`` round-trips floats
  exactly, so no scalar of the run state moves.
* ``load_state(path)`` is the inverse; a torn or inconsistent checkpoint
  raises ``ValueError``, never returns partial state.

``pack_tree`` / ``unpack_tree`` carry structured run state (``ServerState``,
``OrchestratorState``, optimizer states: named tuples, dicts and lists of
tensors and Python scalars) by leaf name.  Unpacking checks the
structure, every name, dtype and shape against the live template, and puts
each tensor on the template's device.

The reference writes its manifest with msgpack; the port writes JSON, and
neither package reads the other's checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

#: reserved skeleton key marking an array placeholder
ARRAY_KEY = "__ndarray__"
#: reserved key of a packed tree: its structure signature
TREE_KEY = "__pytree__"
STATE_VERSION = 2
MANIFEST = "manifest.json"


def _host_copy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        # copy=True always copies: on the CPU ``.cpu()`` would return the
        # live tensor and ``.numpy()`` share its memory; from the card the
        # copy is synchronous, so it is complete before the next round writes
        return a.detach().to("cpu", copy=True).numpy()
    return np.array(a, copy=True)


def _encode(obj: Any, arrays: list[np.ndarray]) -> Any:
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        arrays.append(_host_copy(obj))
        return {ARRAY_KEY: len(arrays) - 1}
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"state dict keys must be str (JSON round-trip), got {k!r}")
            if k == ARRAY_KEY:
                raise TypeError(f"{ARRAY_KEY!r} is a reserved state key")
            out[k] = _encode(v, arrays)
        return out
    if isinstance(obj, (list, tuple)):
        return [_encode(v, arrays) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"unserializable leaf in federation state: {type(obj)!r}")


def snapshot(state: Any) -> tuple[Any, list[np.ndarray]]:
    """Decoupled host copy of ``state``: (skeleton, host arrays).  Hand the
    result to :func:`write_snapshot`, possibly from another thread."""
    arrays: list[np.ndarray] = []
    return _encode(state, arrays), arrays


def _decode(obj: Any, arrays) -> Any:
    if isinstance(obj, dict):
        if set(obj) == {ARRAY_KEY}:
            return arrays[f"a{obj[ARRAY_KEY]}"]
        return {k: _decode(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, arrays) for v in obj]
    return obj


def atomic_replace_dir(tmp: str, final: str) -> None:
    """Publish directory ``tmp`` at ``final``.  An existing ``final`` is
    renamed aside first and removed after the swap, so a crash in between
    leaves the old or the new checkpoint whole."""
    old = final + ".old"
    shutil.rmtree(old, ignore_errors=True)
    if os.path.isdir(final):
        os.replace(final, old)
    os.replace(tmp, final)
    shutil.rmtree(old, ignore_errors=True)


def write_snapshot(path: str, snap: tuple[Any, list[np.ndarray]],
                   metadata: Optional[dict] = None) -> None:
    """Persist a :func:`snapshot` at ``path`` (a directory), atomically."""
    skeleton, arrays = snap
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **{f"a{i}": a for i, a in enumerate(arrays)})
        manifest = {"version": STATE_VERSION, "kind": "federation-state",
                    "n_arrays": len(arrays), "skeleton": skeleton, "metadata": metadata or {}}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        atomic_replace_dir(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def save_state(path: str, state: Any, metadata: Optional[dict] = None) -> None:
    """Snapshot and write in one call."""
    write_snapshot(path, snapshot(state), metadata=metadata)


def load_state(path: str) -> tuple[Any, dict]:
    """Load ``(state, metadata)`` written by :func:`save_state`; every parse
    error of a torn or truncated checkpoint is raised as ``ValueError``."""
    manifest_path = os.path.join(path, MANIFEST)
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        if not isinstance(manifest, dict) or manifest.get("kind") != "federation-state":
            raise ValueError(f"not a federation-state manifest: {manifest_path}")
        if manifest.get("version") != STATE_VERSION:
            raise ValueError(f"unsupported state version {manifest.get('version')!r} "
                             f"(expected {STATE_VERSION}) in {manifest_path}")
        with np.load(os.path.join(path, "arrays.npz")) as arrays:
            if len(arrays.files) != manifest["n_arrays"]:
                raise ValueError(f"array count mismatch in {path}: manifest says "
                                 f"{manifest['n_arrays']}, npz holds {len(arrays.files)}")
            state = _decode(manifest["skeleton"], arrays)
    except ValueError:
        raise
    except Exception as e:  # json, zipfile and numpy errors of a torn write
        raise ValueError(f"corrupt or incomplete checkpoint at {path}: {e}") from e
    return state, manifest.get("metadata", {})


# ----------------------------------------------------------------------
# structured run state <-> named leaves
# ----------------------------------------------------------------------
_SCALARS = (bool, int, float)
_CLOSE = {"{": "}", "[": "]", "(": ")"}


def _children(tree) -> Optional[tuple[str, list[tuple[str, str, Any]]]]:
    """(opening signature, [(field label, path suffix, child)]) of a
    container, or None for a leaf."""
    if isinstance(tree, dict):
        return "{", [(repr(k), f"[{k!r}]", v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return f"{type(tree).__name__}(", [(f, f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return ("[" if isinstance(tree, list) else "("), [
            (str(i), f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, path: str, leaves: dict) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, (torch.Tensor, *_SCALARS)):
        leaves[path] = tree
        return "*" if isinstance(tree, torch.Tensor) else type(tree).__name__
    node = _children(tree)
    if node is None:
        raise TypeError(f"unsupported leaf at {path or '<root>'}: {type(tree)!r}")
    head, kids = node
    body = ",".join(f"{label}:{_flatten(v, path + sfx, leaves)}" for label, sfx, v in kids)
    return head + body + _CLOSE[head[-1]]


def pack_tree(tree) -> dict:
    """Structured state -> plain container: its structure signature and its
    leaves (tensors and Python scalars) by path."""
    leaves: dict = {}
    return {TREE_KEY: _flatten(tree, "", leaves), "leaves": leaves}


def _numpy_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _rebuild(like, path: str, stored: dict):
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        arr = stored[path]
        if isinstance(arr, torch.Tensor):
            arr = _host_copy(arr)
        arr = np.asarray(arr)
        if arr.dtype != _numpy_dtype(like):
            raise ValueError(f"dtype mismatch at {path}: {arr.dtype} vs {like.dtype}")
        if arr.shape != tuple(like.shape):
            raise ValueError(f"shape mismatch at {path}: {arr.shape} vs {tuple(like.shape)}")
        return torch.as_tensor(arr, device=like.device)
    if isinstance(like, _SCALARS):
        v = stored[path]
        if type(v) is not type(like):
            raise ValueError(f"type mismatch at {path}: {type(v).__name__} vs "
                             f"{type(like).__name__}")
        return v
    _, kids = _children(like)
    vals = [_rebuild(v, path + sfx, stored) for _, sfx, v in kids]
    if isinstance(like, dict):
        return dict(zip(like, vals))
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def unpack_tree(packed: dict, like):
    """Rebuild structured state from :func:`pack_tree` output, checked
    against the live template ``like``: structure, leaf names, dtypes and
    shapes must all match, so a checkpoint of another model, optimizer or
    configuration never restores silently.  Tensors land on the devices of
    the template's tensors."""
    names: dict = {}
    signature = _flatten(like, "", names)
    if packed.get(TREE_KEY) != signature:
        raise ValueError(f"tree structure mismatch: checkpoint has {packed.get(TREE_KEY)!r}, "
                         f"template has {signature!r}")
    stored = packed["leaves"]
    if set(names) != set(stored):
        diff = sorted(set(names) ^ set(stored))
        raise ValueError(f"leaf-name mismatch; differing leaves: {diff[:8]}")
    return _rebuild(like, "", stored)
