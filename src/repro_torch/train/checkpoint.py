"""Checkpointing in the reference's format (port of
``repro.train.checkpoint``).

Format: one ``.npz`` file holding all leaves plus a JSON manifest whose
``keys`` map each leaf's ``jax.tree_util.keystr`` path to its array name,
with the step and extras.  So a checkpoint of ``repro`` restores into the
port, and the port's into ``repro``.  Leaves are stored unsharded and
undivided: saving a DTensor state gathers each leaf whole (every rank
takes part, rank 0 writes).  ``restore`` writes them into the tensors of
a template tree, on whatever device those live, or, with ``shardings``,
each rank takes its own shard of every whole leaf, so a checkpoint
written on one mesh (or one device) restores onto another (the
reference's elastic restore).  bfloat16 leaves are stored as float32
(exact) and cast back on restore.

Async mode: ``AsyncCheckpointer`` copies the state to the host before its
thread starts (the next step updates the parameters in place), then
serializes and writes in the background.
"""
from __future__ import annotations

import json
import pathlib
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..tree import tree_leaves, tree_leaves_with_path, tree_map, \
    tree_map_with_path


def _host(v) -> np.ndarray:
    """A tensor leaf as a numpy copy on the host (bfloat16 widened to
    float32; a DTensor gathered whole first); an array as it is."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    v = v.detach()
    if isinstance(v, DTensor):
        v = v.full_tensor()
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.to("cpu", copy=True).numpy()


def save(state, path, *, step: int | None = None, extra: dict | None = None):
    """Synchronous checkpoint write.  ``state`` is a nested dict of tensors
    or arrays.  A state holding DTensors is collective: every rank
    gathers, rank 0 writes."""
    path = pathlib.Path(path)
    arrays = {}
    manifest = {"keys": {}, "step": step, "extra": extra or {}}
    for i, (k, v) in enumerate(sorted(tree_leaves_with_path(state))):
        nk = f"a{i}"
        arrays[nk] = _host(v)
        manifest["keys"][k] = nk
    sharded = any(isinstance(v, DTensor) for v in tree_leaves(state))
    if sharded and dist.get_rank() != 0:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(str(path) + ".tmp.npz")   # ends in .npz: savez keeps it
    np.savez(tmp, **arrays)
    tmp.rename(str(path) + ".npz")
    pathlib.Path(str(path) + ".json").write_text(json.dumps(manifest))
    return path


class AsyncCheckpointer:
    """Fire-and-forget checkpoint writes on a background thread."""

    def __init__(self):
        self._thread: threading.Thread | None = None

    def save(self, state, path, **kw):
        host_state = tree_map(_host, state)          # snapshot now
        self.wait()
        if any(isinstance(v, DTensor) for v in tree_leaves(state)) and \
                dist.get_rank() != 0:
            return                                   # rank 0 writes
        self._thread = threading.Thread(
            target=save, args=(host_state, path), kwargs=kw, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr`` (``np.load``'s arrays are writable and
    C-ordered: no copy)."""
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = arr.copy(order="C")
    return torch.from_numpy(arr)


@torch.no_grad()
def restore(path, like, device=None, shardings=None):
    """Load a checkpoint into the structure of ``like`` (a nested dict of
    tensors).

    Every leaf of ``like`` on ``device`` (or every leaf, with ``device=None``)
    is written in place with ``copy_``, so a module whose parameters are
    ``like["params"]`` goes on training the restored values.  A leaf on
    another device than ``device`` is replaced by a new tensor on
    ``device`` (a restore onto another device).

    ``shardings``: a matching tree of ``sharding.NamedSharding`` (or
    ``None`` leaves).  Each rank then takes its own shard of every whole
    leaf, with no communication: into a DTensor leaf of ``like`` with
    those placements in place, else as a new DTensor.  Returns the tree.
    """
    path = pathlib.Path(path)
    manifest = json.loads(pathlib.Path(str(path) + ".json").read_text())
    dev = None if device is None else torch.device(device)
    shard_of = dict(tree_leaves_with_path(shardings)) if shardings else {}
    with np.load(str(path) + ".npz") as data:
        def leaf(key, template):
            nk = manifest["keys"].get(key)
            if nk is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[nk]
            if tuple(arr.shape) != tuple(template.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(template.shape)}")
            src = _from_numpy(arr)
            sh = shard_of.get(key)
            if sh is not None:
                return _restore_shard(src, template, sh)
            if dev is None or template.device == dev:
                return template.copy_(src)       # cast and copy in one
            return src.to(device=dev, dtype=template.dtype)
        return tree_map_with_path(leaf, like)


def _restore_shard(src, template, sharding):
    """This rank's shard of the whole ``src`` placed by ``sharding``:
    written into ``template`` when it is a DTensor placed alike."""
    from ..distributed.sharding import distribute
    mesh_dev = sharding.mesh.device_type
    new = distribute(src.to(dtype=template.dtype, device=mesh_dev), sharding)
    if isinstance(template, DTensor) and \
            tuple(template.placements) == tuple(sharding.placements):
        template.to_local().copy_(new.to_local())
        return template
    return new


def latest_step(ckpt_dir) -> int | None:
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return None
    steps = []
    for p in d.glob("step_*.json"):
        try:
            steps.append(int(p.stem.split("_")[1]))
        except (IndexError, ValueError):
            continue
    return max(steps) if steps else None
