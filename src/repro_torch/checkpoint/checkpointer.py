"""Atomic, async, resumable checkpointing in the JAX package's format,
from :mod:`repro.checkpoint.checkpointer`.

* **Format**: ``arrays.npz`` keyed by each leaf's path, its dict keys and
  list indices joined with ``/`` (``params/segments/0/attn/q/w``,
  ``opt/step``; :mod:`repro_torch.tree`), ``None`` leaves absent, and
  beside it ``manifest.json`` with ``step``, ``time``, ``n_arrays`` and
  ``extra``.  Each tensor is saved as its numpy array (the optimizer's
  step a 0-d int32), so a JAX checkpoint restores into the port and a
  port checkpoint into JAX.  bfloat16 has no numpy dtype: saving a
  bfloat16 leaf raises (params and moments are float32 in both
  trainers).
* **Atomicity**: a checkpoint directory becomes visible only through a
  final rename of its ``.tmp`` directory.
* **Async**: ``save_async`` copies every tensor to host memory now, then
  writes on a background thread; the train loop stalls only for the
  copy, and at most one save is outstanding.
* **Retention**: the ``keep`` newest checkpoints survive.
* **Restore** is into a template's structure, each leaf onto the
  template's device and dtype, with a ``KeyError`` for a missing key and
  a ``ValueError`` for a wrong shape; with ``shardings`` (a tree of
  :class:`repro_torch.distributed.sharding.NamedSharding`) each leaf is
  then placed as a DTensor on its mesh, each rank keeping its own shard
  (the elastic restore onto a new mesh).  A DTensor template leaf reads
  its global shape.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from .. import tree


def _flatten(state: Any) -> dict[str, np.ndarray]:
    """path -> a host copy of the leaf (the copy outlives in-place
    updates of the state)."""
    from torch.distributed.tensor import DTensor
    flat = {}
    for key, leaf in tree.paths(state):
        if isinstance(leaf, DTensor):          # a sharded state's whole leaf
            leaf = leaf.full_tensor()
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"{key}: bfloat16 has no numpy dtype; "
                            "checkpoints hold float32 state")
        flat[key] = leaf.detach().to("cpu", copy=True).numpy()
    return flat


def _unflatten_into(template: Any, flat: dict[str, np.ndarray]) -> Any:
    leaves = []
    for key, leaf in tree.paths(template):
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: ckpt shape {arr.shape} != "
                             f"expected {tuple(leaf.shape)}")
        leaves.append(torch.from_numpy(arr).to(
            device=leaf.device, dtype=leaf.dtype))
    return tree.unflatten(template, leaves)


class Checkpointer:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:010d}"

    def save(self, step: int, state: Any, extra: dict | None = None) -> None:
        self._write(step, _flatten(state), extra or {})

    def save_async(self, step: int, state: Any,
                   extra: dict | None = None) -> None:
        self.wait()                        # one outstanding save max
        flat = _flatten(state)             # the host copy, now
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, extra or {}), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, extra: dict) -> None:
        final = self._step_dir(step)
        tmp = final.with_name(final.name + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {"step": step, "time": time.time(),
                    "n_arrays": len(flat), "extra": extra}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Restore into ``template``'s structure, devices and dtypes;
        optionally placing leaves with ``shardings`` (elastic restore onto
        a new mesh).  Returns (state, manifest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoints")
        d = self._step_dir(step)
        with np.load(d / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        state = _unflatten_into(template, flat)
        if shardings is not None:
            from ..distributed.sharding import place_tree
            state = place_tree(state, shardings)
        manifest = json.loads((d / "manifest.json").read_text())
        return state, manifest
