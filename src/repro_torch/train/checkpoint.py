"""Checkpointing (the port of ``repro.train.checkpoint``): atomic, async,
restartable, in the JAX package's directory layout.

Layout:  ``<dir>/step_<N>/`` with one ``.npy`` per leaf plus
``manifest.json`` mapping tree paths (JAX's ``keystr`` form, e.g.
``['params']['embed']['embedding']``) to files, leaves numbered in sorted
key order as ``jax.tree_util`` flattens a dict — so a checkpoint directory
reads the same from either package.  Writes go to ``<dir>/.tmp_<N>`` and
are renamed into place, so a preemption mid-write never corrupts the
latest checkpoint.  ``AsyncCheckpointer`` copies the state to host memory,
then writes it on a background thread while training goes on.  bf16
leaves are stored as f32 (exact) and cast back on restore.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch


def _flatten(state, prefix: str = "") -> list:
    """(keystr path, leaf) pairs in sorted key order."""
    if isinstance(state, dict):
        return [pair for k in sorted(state)
                for pair in _flatten(state[k], f"{prefix}[{k!r}]")]
    return [(prefix, state)]


def _to_host(leaf) -> np.ndarray:
    """A host copy that later in-place updates of ``leaf`` cannot reach."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _host_tree(state):
    if isinstance(state, dict):
        return {k: _host_tree(v) for k, v in state.items()}
    return _to_host(state)


def save_checkpoint(ckpt_dir: str, step: int, state, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(_flatten(state)):
        fname = f"leaf_{i:05d}.npy"
        arr = leaf if isinstance(leaf, np.ndarray) else _to_host(leaf)
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": path, "file": fname})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, state_like, step: Optional[int] = None):
    """Restore into new tensors of ``state_like``'s structure, dtypes and
    devices (shapes are validated); leaves that require grad in
    ``state_like`` do so in the result.  Returns (state, step)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {l["path"]: l["file"] for l in manifest["leaves"]}
    vals = {}
    for path, like in _flatten(state_like):
        arr = np.load(os.path.join(d, by_path[path]))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{path}: checkpoint shape {arr.shape}, "
                             f"state shape {tuple(like.shape)}")
        t = torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
        vals[path] = t.requires_grad_(like.requires_grad)

    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}[{k!r}]") for k, v in tree.items()}
        return vals[prefix]

    return build(state_like), step


class AsyncCheckpointer:
    """Fire-and-forget saves on a background thread (one in flight)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state):
        self.wait()
        # copy to host before returning control to the training loop, which
        # updates the state in place
        host_state = _host_tree(state)

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_state, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
