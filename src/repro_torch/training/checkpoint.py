"""Checkpoint manager: async save, keep-k, hashes, restore onto a device.

Counterpart of `repro.training.checkpoint`, with its file layout:
    <dir>/step_000000123/
        manifest.json        {step, extra, none_keys, leaves: {path:
                              {shape, dtype}}, sha256}
        arrays.npz           flattened leaves (key = joined tree path)

Writes go to a tmp dir + atomic rename, so a killed process never leaves
a half checkpoint; `restore_latest` skips corrupt or partial steps. bf16
leaves are stored as the reference's `np.savez` stores them, raw 2-byte
`|V2` records, with dtype "bfloat16" in the manifest (float8_e4m3fn as
`|V1`), so each package reads the other's files without `ml_dtypes`. The
trees differ (the port's `layers/<i>/...` against the reference's stacked
`blocks/<j>/...`), so a file restores only into the package whose tree
wrote it. `restore` puts every leaf on one `device`, or, given
`shardings` (a tree of placements, `parallel.sharding.shardings_for`),
each leaf that has one as a DTensor on the ambient mesh
(`parallel.shardctx`): every rank reads the same file and keeps its own
shard, with no scatter.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# torch dtypes numpy has no type for: (manifest name, the integer type of
# the same size that carries the bits, in torch and in numpy)
_RAW = {torch.bfloat16: ("bfloat16", torch.int16, np.int16),
        torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8)}
_RAW_BY_NAME = {name: (dt, bits) for dt, (name, _, bits) in _RAW.items()}


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def visit(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                visit(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(v, path + (str(i),))
        elif node is None:
            flat["/".join(path) + "#none"] = None
        else:
            flat["/".join(path)] = node
    visit(tree, ())
    return flat


def _flatten_placements(shardings) -> Dict[str, Any]:
    """A placements tree flattened by `_flatten`'s paths; a tuple of
    placements is a leaf."""
    from torch.distributed.tensor import Placement
    flat = {}

    def visit(node, path):
        if isinstance(node, dict):
            for k in node:
                visit(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)) and not (
                node and all(isinstance(p, Placement) for p in node)):
            for i, v in enumerate(node):
                visit(v, path + (str(i),))
        else:
            flat["/".join(path)] = node
    visit(shardings, ())
    return flat


def _unflatten_into(template, flat: Dict[str, Any]):
    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v, path + (str(i),))
                              for i, v in enumerate(node))
        if node is None:
            return None
        return flat["/".join(path)]
    return visit(template, ())


def _to_host(v) -> Tuple[np.ndarray, str]:
    """(array as `np.savez` writes it, the manifest's dtype name), a copy:
    the optimizer writes parameters and state in place, so an async save
    must not share memory with the live tree."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True).contiguous()
        if t.dtype in _RAW:
            name, bits, _ = _RAW[t.dtype]
            raw = t.view(bits).numpy()
            return raw.view(f"V{raw.dtype.itemsize}"), name
        a = t.numpy()
    else:
        a = np.array(v)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, name: str, device) -> torch.Tensor:
    if name in _RAW_BY_NAME:
        dt, bits = _RAW_BY_NAME[name]
        return torch.from_numpy(np.array(a).view(bits)).view(dt).to(device)
    return torch.from_numpy(np.array(a.view(np.dtype(name)))).to(device)


def _digest(arrays: Dict[str, np.ndarray]) -> str:
    digest = hashlib.sha256()
    for k in sorted(arrays):
        digest.update(k.encode())
        digest.update(arrays[k].tobytes())
    return digest.hexdigest()


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:09d}"

    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[dict] = None):
        """Snapshot to host, then (optionally) write on a background thread
        — training continues while bytes hit disk."""
        host = {k: (None if v is None else _to_host(v))
                for k, v in _flatten(tree).items()}
        self.wait()

        def write():
            tmp = self.dir / f".tmp_step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            arrays = {k: v[0] for k, v in host.items() if v is not None}
            np.savez(tmp / "arrays.npz", **arrays)
            manifest = {
                "step": step,
                "extra": extra or {},
                "none_keys": [k for k, v in host.items() if v is None],
                "leaves": {k: {"shape": list(v[0].shape), "dtype": v[1]}
                           for k, v in host.items() if v is not None},
                "sha256": _digest(arrays),
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self._step_dir(step)
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: int, template, shardings=None,
                verify: bool = True, device="cpu") -> Tuple[Any, dict]:
        """The tree saved at `step`, in `template`'s structure, and the
        saved `extra`. Every leaf is on `device`; a leaf with placements in
        `shardings` is a DTensor at them on the ambient mesh instead
        (`distribute_tensor(..., src_data_rank=None)`: this rank's shard
        of the file's leaf). A leaf without one stays as it is."""
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "arrays.npz") as z:
            arrays = {k: z[k] for k in z.files}
        if verify and _digest(arrays) != manifest["sha256"]:
            raise IOError(f"checkpoint {step}: hash mismatch (corrupt)")
        flat = {k: _from_host(v, manifest["leaves"][k]["dtype"], device)
                for k, v in arrays.items()}
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor
            from repro_torch.parallel.sharding import current_mesh
            mesh = current_mesh()
            for k, pl in _flatten_placements(shardings).items():
                if pl is not None and k in flat:
                    flat[k] = distribute_tensor(flat[k], mesh, pl,
                                                src_data_rank=None)
        for k in manifest["none_keys"]:
            flat[k.replace("#none", "")] = None
        return _unflatten_into(template, flat), manifest["extra"]

    def restore_latest(self, template, shardings=None, device="cpu"):
        """Newest non-corrupt checkpoint as (step, tree, extra), or None.
        Skips damaged steps — the restart-after-failure path."""
        for step in reversed(self.all_steps()):
            try:
                tree, extra = self.restore(step, template, shardings,
                                           device=device)
                return step, tree, extra
            except Exception:
                continue
        return None
