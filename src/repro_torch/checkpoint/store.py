"""Fault-tolerant checkpointing: round-granular, atomic, elastic-resume
(the port of ``repro/checkpoint/store.py``, in its on-disk format).

Layout:
  <dir>/step_000123/
      manifest.json      # tree structure + shapes/dtypes + metadata
      arrays.npz         # flat leaf arrays keyed by path
  <dir>/LATEST           # atomically updated pointer (write temp + rename)

Write protocol: serialize into a temp directory, fsync, rename into place,
then rename-update LATEST — a crash at any point leaves either the old or
the new checkpoint fully intact.

The format is the reference's, byte for byte: leaf keys are the
``/``-joined dict paths in sorted-key order (``[i]`` for sequence
indices), bf16 leaves ride as their uint16 bits with an ``orig_dtypes``
entry, and the manifest carries the same keys. A checkpoint written by
either package restores in the other. Leaves may be tensors on any device
or numpy arrays; ``load_tree`` gives back the kind of the template's leaf
(a tensor on the template leaf's device and of its dtype, or a numpy
array). bf16 crosses as bits (``view(torch.int16)`` <-> uint16), never
through a float.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_tree", "load_tree", "load_slot_maps"]


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """Leaves keyed by their ``/``-joined path, in ``jax.tree`` order:
    dict keys sorted, sequences by index as ``[i]``; None is an empty
    subtree."""
    flat: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat.update(_flatten_with_paths(tree[k], prefix + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten_with_paths(v, prefix + (f"[{i}]",)))
    elif tree is not None:
        flat["/".join(prefix)] = tree
    return flat


def _rebuild(template, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """``template``'s structure filled from path-keyed ``leaves``."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves, prefix + (str(k),)) for k in template}
    if isinstance(template, (list, tuple)):
        out = [_rebuild(v, leaves, prefix + (f"[{i}]",)) for i, v in enumerate(template)]
        return type(template)(out) if isinstance(template, tuple) else out
    if template is None:
        return None
    return leaves["/".join(prefix)]


def _dtype_name(dtype) -> str:
    """numpy's name for a torch or numpy dtype ("float32", "bfloat16", ...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def _to_numpy(v) -> Tuple[np.ndarray, str]:
    """(array as stored in the npz, original dtype name)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        orig = _dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            # npz can't hold bf16: the raw bits as uint16, viewed back on load
            return t.view(torch.int16).numpy().view(np.uint16), orig
        try:
            return t.numpy(), orig
        except TypeError:  # dtypes numpy has no twin for (float8 ...)
            return t.to(torch.float32).numpy(), orig
    a = np.asarray(v)
    orig = str(a.dtype)
    if orig == "bfloat16":
        return a.view(np.uint16), orig
    if a.dtype.kind not in "fiub":  # exotic dtypes npz can't round-trip
        return a.astype(np.float32), orig
    return a, orig  # f16 and every native numpy dtype save as-is


def save_tree(
    directory: str,
    tree,
    *,
    metadata: Optional[Dict] = None,
    slot_maps: Optional[Dict] = None,
) -> str:
    """Atomic checkpoint write. Returns the final directory path.

    ``slot_maps`` is the manifest's sparse-plane entry: for each sparsely
    stored array node, the population slots its saved rows belong to, in
    row order. Dense checkpoints omit it; readers default to ``{}``."""
    os.makedirs(os.path.dirname(directory.rstrip("/")) or ".", exist_ok=True)
    converted = {k: _to_numpy(v) for k, v in _flatten_with_paths(tree).items()}
    arrays = {k: a for k, (a, _) in converted.items()}
    manifest = {
        "keys": list(arrays.keys()),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": {k: str(a.dtype) for k, a in arrays.items()},  # as stored
        "orig_dtypes": {k: o for k, (_, o) in converted.items()},
        "metadata": metadata or {},
    }
    if slot_maps:
        manifest["slot_maps"] = {k: [int(s) for s in v] for k, v in slot_maps.items()}
    parent = os.path.dirname(directory.rstrip("/")) or "."
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=parent)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(directory):
            shutil.rmtree(directory)
        os.rename(tmp, directory)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return directory


def _as_template_kind(arr: np.ndarray, orig: Optional[str], tmpl):
    """A stored array restored to its original dtype, then to the kind and
    dtype of its template leaf."""
    bf16 = orig == "bfloat16" and arr.dtype == np.uint16
    if isinstance(tmpl, torch.Tensor):
        # ``arr`` is the npz reader's own fresh, writable array: the tensor
        # takes its memory without a copy (a Qwen-scale checkpoint is tens
        # of GB, and each copy costs seconds)
        if bf16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
            if orig is not None and orig != str(arr.dtype) and hasattr(torch, orig):
                t = t.to(getattr(torch, orig))
        return t.to(device=tmpl.device, dtype=tmpl.dtype)
    if bf16:
        # numpy has no bf16 of its own: a numpy template gets the f32 values
        # (exact); a tensor template above keeps the bits
        t = torch.from_numpy(np.array(arr.view(np.int16))).view(torch.bfloat16)
        arr = t.float().numpy()
    elif orig is not None and orig != str(arr.dtype):
        arr = arr.astype(np.dtype(orig))
    want = getattr(tmpl, "dtype", None)
    if want is not None and str(want) != "bfloat16" and arr.dtype != want:
        arr = arr.astype(want)
    return arr


def load_tree(directory: str, template) -> Tuple[Any, Dict]:
    """Load into the structure of ``template`` (shape-checked)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    orig_dtypes = manifest.get("orig_dtypes", {})
    leaves = {}
    with np.load(os.path.join(directory, "arrays.npz")) as data:
        for key, tmpl in _flatten_with_paths(template).items():
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arr.shape} vs template "
                    f"{tuple(tmpl.shape)}"
                )
            leaves[key] = _as_template_kind(arr, orig_dtypes.get(key), tmpl)
    return _rebuild(template, leaves), manifest["metadata"]


def load_slot_maps(directory: str) -> Dict:
    """The manifest's slot-map entry; ``{}`` for dense checkpoints."""
    with open(os.path.join(directory, "manifest.json")) as f:
        return json.load(f).get("slot_maps", {})


class CheckpointManager:
    """Round/step-granular manager with a crash-safe LATEST pointer."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def save(
        self,
        step: int,
        tree,
        *,
        metadata: Optional[Dict] = None,
        slot_maps: Optional[Dict] = None,
    ) -> str:
        meta = dict(metadata or {}, step=step)
        path = save_tree(self._step_dir(step), tree, metadata=meta, slot_maps=slot_maps)
        tmp = os.path.join(self.root, ".LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, "LATEST"))
        self._gc()
        return path

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.root, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore_latest(self, template) -> Optional[Tuple[Any, Dict]]:
        step = self.latest_step()
        if step is None:
            return None
        return load_tree(self._step_dir(step), template)

    def metadata(self, step: int) -> Dict:
        """A checkpoint's metadata without loading its arrays."""
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)["metadata"]

    def slot_maps(self, step: int) -> Dict:
        """The step's manifest slot-map entry (``{}`` when dense)."""
        return load_slot_maps(self._step_dir(step))

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.root) if d.startswith("step_")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
