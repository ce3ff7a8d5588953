"""Fault-tolerant checkpointing: atomic writes, checksums, async save.

* **Atomic**: a checkpoint is written to ``step_N.tmp/`` and ``os.replace``d
  into ``step_N/`` only after every leaf + the manifest land — a crash
  mid-save never corrupts the latest good checkpoint.
* **Verified**: the manifest records per-leaf SHA-256; restore checks them.
* **Async**: ``save_async`` snapshots to host then writes on a thread;
  ``wait()`` joins before the next save.
* **Placed**: ``restore(template, device=...)`` puts the restored leaves on
  an explicit torch device.

A tree is nested dicts (keys in sorted order), tuples and lists whose
leaves are torch tensors or numpy arrays; a leaf's key is its path joined
by ``/``.  The directory layout, the raw ``.bin`` leaves and the manifest
are the JAX package's, so a flat checkpoint written by either package
restores with the other's :meth:`CheckpointManager.restore_flat`.  The
elastic re-mesh restore (``mesh=`` / ``specs=``) belongs to the sharded
paths (ROADMAP Queue A item 14d) and is refused.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np


def _fsync_write(path: Path, data) -> None:
    """Write ``data`` (bytes or str) and fsync before returning — the
    durability half of the tmp-dir + ``os.replace`` publish protocol: a
    power cut after the rename can never expose a published checkpoint
    whose contents still sit in the page cache."""
    mode = "wb" if isinstance(data, bytes) else "w"
    with open(path, mode) as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())


def _fsync_dir(path: Path) -> None:
    """fsync a directory so a just-published rename survives power loss
    (no-op on platforms whose dirfd fsync is unsupported)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` of ``tree`` in flattening order (dict keys sorted,
    sequences in order, ``None`` holds no leaf)."""
    out: Dict[str, Any] = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}" if path else str(k))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}" if path else str(i))
        else:
            out[path] = node

    walk(tree, prefix)
    return out


def _unflatten(template, leaves: Dict[str, Any], prefix: str = ""):
    """``template``'s structure with each leaf replaced from ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix
                              else str(k)) for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(
            _unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    return leaves[prefix]


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a bfloat16 tensor as its bits, typed
    ``bfloat16`` in the manifest by :meth:`CheckpointManager._write`)."""
    import torch

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _Bf16(t.view(torch.int16).numpy())
        return t.numpy()
    return np.asarray(leaf)


class _Bf16(np.ndarray):
    """The int16 bits of a bfloat16 tensor, named ``bfloat16``."""

    def __new__(cls, bits: np.ndarray):
        return np.asarray(bits).view(cls)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if isinstance(arr, _Bf16) else str(arr.dtype)


def _from_raw(raw: bytes, ent: Dict):
    """The manifest entry's leaf: a numpy array, or for ``bfloat16`` a
    torch tensor (numpy has no such type)."""
    if ent["dtype"] == "bfloat16":
        import torch

        bits = np.frombuffer(raw, np.int16).reshape(ent["shape"]).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(ent["dtype"])) \
        .reshape(ent["shape"]).copy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> Path:
        return self._write(step, self._host(tree), extra or {})

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict] = None) -> None:
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, self._host(tree), extra or {}),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _host(tree: Any) -> Dict[str, np.ndarray]:
        return {k: _to_host(v) for k, v in _flatten(tree).items()}

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               extra: Dict) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for key, leaf in flat.items():
            fname = key.replace("/", "__") + ".bin"
            raw = np.ascontiguousarray(leaf).tobytes()
            _fsync_write(tmp / fname, raw)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(leaf.shape),
                "dtype": _dtype_name(leaf),
                "sha256": hashlib.sha256(raw).hexdigest(),
            }
        _fsync_write(tmp / "manifest.json", json.dumps(manifest, indent=1))
        _fsync_dir(tmp)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic publish
        _fsync_dir(self.dir)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if not p.name.endswith(".tmp")]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def _leaves(self, step: Optional[int], verify: bool):
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        cdir = self.dir / f"step_{step:08d}"
        manifest = json.loads((cdir / "manifest.json").read_text())

        def leaf(key):
            ent = manifest["leaves"].get(key)
            if ent is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            raw = (cdir / ent["file"]).read_bytes()
            if verify:
                digest = hashlib.sha256(raw).hexdigest()
                if digest != ent["sha256"]:
                    raise IOError(f"checksum mismatch for {key!r}")
            return _from_raw(raw, ent)

        return manifest, leaf, step

    def restore(self, template: Any, step: Optional[int] = None,
                mesh=None, specs: Any = None, verify: bool = True, *,
                device="cpu"):
        """Restore into the structure of ``template``: tensor leaves come
        back as tensors on ``device``, array leaves as numpy arrays.
        Returns ``(tree, extra, step)``."""
        import torch

        if mesh is not None or specs is not None:
            raise NotImplementedError(
                "elastic re-mesh restore (mesh=, specs=) comes with the "
                "sharded paths, ROADMAP Queue A item 14d")
        manifest, leaf, step = self._leaves(step, verify)
        restored = {}
        for key, tmpl in _flatten(template).items():
            arr = leaf(key)
            if list(arr.shape) != list(tmpl.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(arr.shape)} vs {tuple(tmpl.shape)}")
            if isinstance(tmpl, torch.Tensor):
                t = arr if isinstance(arr, torch.Tensor) \
                    else torch.from_numpy(arr)
                arr = t.to(device)
            restored[key] = arr
        return _unflatten(template, restored), manifest["extra"], step

    def restore_flat(self, step: Optional[int] = None, verify: bool = True):
        """Restore a checkpoint as the flat ``{key: ndarray}`` mapping it
        was saved from, shapes/dtypes taken from the manifest — no
        structural template needed.  The streaming-replay resume path uses
        this: its snapshot leaves (per-chunk output parts, fault-builder
        accumulators) have shapes only the checkpoint itself knows."""
        manifest, leaf, step = self._leaves(step, verify)
        flat = {key: leaf(key) for key in manifest["leaves"]}
        return flat, manifest["extra"], step

    def restore_latest_good(self, template: Any = None, mesh=None,
                            specs: Any = None, verify: bool = True, *,
                            device="cpu"):
        """Restore the newest checkpoint that passes verification, walking
        backwards over older steps when the latest is torn or corrupt
        (truncated leaf, checksum mismatch, unparseable manifest, missing
        file).  ``.tmp`` directories — crashes mid-save — are invisible by
        construction (:meth:`all_steps` excludes them).  With
        ``template=None`` restores the flat mapping (:meth:`restore_flat`).
        Raises ``FileNotFoundError`` when no checkpoint restores cleanly."""
        if mesh is not None or specs is not None:
            raise NotImplementedError(
                "elastic re-mesh restore (mesh=, specs=) comes with the "
                "sharded paths, ROADMAP Queue A item 14d")
        errors = []
        for step in sorted(self.all_steps(), reverse=True):
            try:
                if template is None:
                    return self.restore_flat(step, verify=verify)
                return self.restore(template, step, verify=verify,
                                    device=device)
            except (OSError, KeyError, ValueError,
                    json.JSONDecodeError) as exc:
                errors.append(f"step {step}: {type(exc).__name__}: {exc}")
        detail = ("; ".join(errors) if errors
                  else f"no checkpoints under {self.dir}")
        raise FileNotFoundError(
            f"no restorable checkpoint under {self.dir} ({detail})")
