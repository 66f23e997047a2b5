"""Numpy ``.npz`` checkpoints with a JSON ``__manifest__``, in the
reference's format (``repro/checkpoint/ckpt.py``), so either package reads
what the other writes.

A tree of arrays is flattened as the reference flattens its pytrees: dict
keys in sorted order, list/tuple entries by index, joined by "/"; a flat
dict state keeps its own keys. Commits are crash-safe: write to a temp file
in the same directory, fsync it, ``os.replace`` it over the destination,
fsync the directory.
"""
from __future__ import annotations

import json
import os
import tempfile
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

#: Signature of the optional I/O-warning sink: ``sink(kind, path, exc)``.
IOWarningSink = Callable[[str, str, BaseException], None]


def _warn_io(kind: str, path: str, exc: BaseException,
             sink: Optional[IOWarningSink]) -> None:
    warnings.warn(f"checkpoint I/O problem ({kind}) on {path}: {exc!r}",
                  RuntimeWarning, stacklevel=3)
    if sink is not None:
        sink(kind, path, exc)


def _fsync_dir(dirname: str) -> None:
    fd = os.open(dirname or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if tree is None:                  # an empty subtree, as in a pytree
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        if torch.is_tensor(tree):
            tree = tree.detach().cpu().numpy()
        out[prefix[:-1]] = np.asarray(tree)


def save_checkpoint(path: str, tree: Any, metadata: dict | None = None,
                    *, fsync: bool = True,
                    on_io_warning: Optional[IOWarningSink] = None) -> int:
    """Atomically write ``tree`` (+ JSON-able ``metadata``) to ``path``.

    Returns the committed file size in bytes. ``fsync=False`` skips the
    durability syncs (still atomic against concurrent readers). Secondary
    I/O failures that do not fail the commit (a temp file that cannot be
    unlinked after a failed write) go to ``on_io_warning``.
    """
    arrays: Dict[str, np.ndarray] = {}
    _flatten(tree, "", arrays)
    manifest = {"keys": list(arrays.keys()), "metadata": metadata or {}}
    dirname = os.path.dirname(path) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, prefix=".tmp-ckpt-",
                               suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, __manifest__=json.dumps(manifest), **arrays)
            fh.flush()
            if fsync:
                os.fsync(fh.fileno())
        nbytes = os.path.getsize(tmp)
        os.replace(tmp, path)              # atomic commit
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError as cleanup_exc:
            _warn_io("tmp-cleanup", tmp, cleanup_exc, on_io_warning)
        raise
    if fsync:
        _fsync_dir(dirname)
    return nbytes


def load_arrays(path: str) -> tuple[dict, dict]:
    """Load a checkpoint as (flat key -> np.ndarray, metadata)."""
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(data["__manifest__"].item())
        arrays = {k: np.asarray(data[k]) for k in manifest["keys"]}
    return arrays, manifest.get("metadata", {})
