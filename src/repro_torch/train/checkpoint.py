"""Checkpointing with atomic publish, retention, and async save.

Counterpart of ``repro.train.checkpoint``, with its layout and keys, so a
checkpoint written by either package restores in the other::

    <dir>/step_000042/          # staged as .tmp-step_000042, renamed when done
        manifest.json           # step, keys, tree structure, bytes
        arrays.npz              # flat {path: array}
    <dir>/LATEST                # text file: last complete step

A leaf's key is its path in the tree joined with ``/``, as
``jax.tree_util.tree_flatten_with_path`` names it: dict keys as they are
(sorted), list and tuple positions as numbers, named-tuple fields as
``.field``; empty tuples and ``None`` hold no leaf.  So ``adamw``'s state
gives ``opt/1/.count``, ``opt/1/.mu/w`` and ``opt/3``.

- *atomic publish*: writers stage into a tmp dir and ``os.rename`` —
  a reader never sees a partial checkpoint; LATEST is written after.
- *async*: ``save()`` copies the state to host memory before it returns,
  then writes on a worker thread — training continues, and a later step
  cannot change what is written; ``wait()`` joins (and raises what the
  write raised) before the next save.
- *retention*: keep the newest K complete checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.optimizer import tree_map, tree_unflatten
from repro_torch.utils import DeviceLike, resolve_device

SEP = "/"


def _paths(tree: Any, prefix: tuple = ()):
    """(key, leaf) for every leaf of ``tree``, in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _paths(v, prefix + ("." + f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    elif tree is not None:
        yield SEP.join(prefix), tree


def _flatten(tree: Any) -> dict[str, Any]:
    return dict(_paths(tree))


def _describe(tree: Any) -> str:
    """The tree's structure with every leaf as ``*`` (the manifest's
    ``treedef``; neither package reads it back)."""
    return repr(tree_map(lambda _: "*", tree))


def _to_host(v) -> np.ndarray:
    """A host copy of ``v`` that later in-place writes to ``v`` leave
    alone (``.cpu()`` of a CPU tensor is the tensor itself)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        host = v.cpu().numpy()
        return host.copy() if v.device.type == "cpu" else host
    return np.array(v)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------------
    def save(self, state: Any, step: int, blocking: bool = False) -> None:
        self.wait()
        # snapshot to host memory synchronously: the write sees this step
        host = {k: _to_host(v) for k, v in _flatten(state).items()}
        treedef = _describe(state)

        def write():
            name = f"step_{step:08d}"
            tmp = os.path.join(self.directory, f".tmp-{name}")
            final = os.path.join(self.directory, name)
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            manifest = {
                "step": step,
                "keys": sorted(host.keys()),
                "treedef": treedef,
                "time": time.time(),
                "nbytes": int(sum(a.nbytes for a in host.values())),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=2)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            with open(os.path.join(self.directory, "LATEST"), "w") as f:
                f.write(str(step))
            self._retain()

        if blocking:
            write()
            return

        def write_async():
            try:
                write()
            except BaseException as e:          # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write_async, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self) -> list[int]:
        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.directory, "LATEST")
        if os.path.exists(path):
            with open(path) as f:
                step = int(f.read().strip())
            if step in self.all_steps():
                return step
        steps = self.all_steps()          # LATEST missing/stale: recover
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                device: DeviceLike = None) -> Any:
        """Restore into the structure of ``like`` (tensors, meta tensors or
        arrays: only its structure is read), every array on ``device``
        with the dtype and bytes it was saved with."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}", "arrays.npz")
        leaves = []
        with np.load(path) as data:
            for key in _flatten(like):
                if key not in data:
                    raise KeyError(f"checkpoint missing {key}")
                leaves.append(torch.from_numpy(data[key]).to(dev))
        return tree_unflatten(like, leaves)
