"""Atomic, resumable checkpointing for the port, in the reference's format
(``repro/train/checkpoint.py``) byte for byte in layout, so each package
restores the other's checkpoints::

    <dir>/step_00000420/
        manifest.json        # step, leaf names, shard CRC32s, extra
        host00.npz           # this host's leaves (flat dict)
    <dir>/LATEST             # atomic pointer file -> "step_00000420"

Leaves are named by their keys joined with ``/`` (``params/blocks/attn/wq``,
``opt/count``), as ``jax.tree_util.tree_flatten_with_path`` names them in
the reference; bf16 leaves are widened to f32 on disk and cast back to the
reference tree's type at restore. Shards are written to ``<step>.tmp/``
and renamed into place after the manifest's fsync; ``LATEST`` is replaced
atomically; every shard carries a CRC32 and a corrupt checkpoint is
passed over for an older one; the ``keep`` newest survive.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch.models.params import Leaf, _from_numpy


def _flat(tree, prefix: str = ""):
    """``(key, leaf)`` pairs of a nested dict in sorted-key order, keys
    joined with ``/``."""
    for key in sorted(tree):
        node = tree[key]
        name = f"{prefix}{key}"
        if isinstance(node, dict):
            yield from _flat(node, name + "/")
        else:
            yield name, node


def _to_numpy(t) -> np.ndarray:
    """A leaf as an npz-safe array: tensors to the host, bf16 widened to
    f32 (numpy has no bf16)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    arr = np.asarray(t)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def save(ckpt_dir: str | os.PathLike, step: int, tree, *, host_id: int = 0,
         num_hosts: int = 1, extra: dict | None = None, keep: int = 3) -> Path:
    """Write one checkpoint of ``tree`` (nested dicts of tensors or arrays)
    and return its directory. Host 0 writes the manifest and the ``LATEST``
    pointer; other hosts write their shard only."""
    ckpt_dir = Path(ckpt_dir)
    name = f"step_{step:08d}"
    final = ckpt_dir / name
    tmp = ckpt_dir / (name + ".tmp")
    tmp.mkdir(parents=True, exist_ok=True)

    flat = {key: _to_numpy(leaf) for key, leaf in _flat(tree)}
    shard_file = tmp / f"host{host_id:02d}.npz"
    np.savez(shard_file, **flat)
    crc = _crc32(shard_file)

    if host_id == 0:
        manifest = {
            "step": step,
            "num_hosts": num_hosts,
            "leaves": sorted(flat),
            "shards": {f"host{host_id:02d}.npz": crc},
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        with open(tmp / "manifest.json", "rb") as f:
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        _update_latest(ckpt_dir, name)
        _retain(ckpt_dir, keep)
    return final


def _update_latest(ckpt_dir: Path, name: str) -> None:
    tmp = ckpt_dir / "LATEST.tmp"
    tmp.write_text(name)
    os.replace(tmp, ckpt_dir / "LATEST")


def _retain(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(d for d in ckpt_dir.glob("step_*") if d.is_dir()
                   and not d.name.endswith(".tmp"))
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    """The step of the checkpoint ``LATEST`` names, else of the newest
    directory with a manifest; None if there is none."""
    ckpt_dir = Path(ckpt_dir)
    pointer = ckpt_dir / "LATEST"
    candidates = []
    if pointer.exists():
        candidates.append(ckpt_dir / pointer.read_text().strip())
    # fall back to directory scan (the pointer may predate a crash)
    candidates += sorted((d for d in ckpt_dir.glob("step_*") if d.is_dir()), reverse=True)
    for c in candidates:
        if (c / "manifest.json").exists():
            return int(json.loads((c / "manifest.json").read_text())["step"])
    return None


def _crc32(path: Path, block: int = 1 << 26) -> int:
    """The file's CRC32, read a block at a time (the value of
    ``zlib.crc32`` over its whole bytes, without holding them)."""
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(block):
            crc = zlib.crc32(chunk, crc)
    return crc


def _verify(ckpt: Path) -> bool:
    try:
        manifest = json.loads((ckpt / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError):
        return False
    for shard, crc in manifest["shards"].items():
        f = ckpt / shard
        if not f.exists() or _crc32(f) != crc:
            return False
    return True


def _dtype_of(ref) -> torch.dtype | None:
    if isinstance(ref, (Leaf, torch.Tensor)):
        return ref.dtype
    return None


def _unflatten(pairs) -> dict:
    out: dict = {}
    for key, value in pairs:
        *path, last = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = value
    return out


def restore(ckpt_dir: str | os.PathLike, tree, *, step: int | None = None, host_id: int = 0,
            device="cpu", place=None):
    """Restore ``tree``-structured tensors from the newest valid checkpoint
    (or ``step``), passing over corrupt ones for older ones. ``tree`` is a
    nested dict of :class:`Leaf` descriptors or tensors naming the leaves
    and their types. Leaves are read one at a time; ``place(key, t)``
    (a rank on a mesh: its block of the whole leaf ``t``, keyed as
    ``params/blocks/attn/wq``) replaces each as it is read, else it is
    moved to ``device``. Returns ``(tree_of_tensors, step, extra)``."""
    ckpt_dir = Path(ckpt_dir)
    if step is not None:
        order = [ckpt_dir / f"step_{step:08d}"]
    else:
        order = sorted((d for d in ckpt_dir.glob("step_*") if d.is_dir()), reverse=True)
    for ckpt in order:
        if not _verify(ckpt):
            continue
        manifest = json.loads((ckpt / "manifest.json").read_text())
        vals = []
        with np.load(ckpt / f"host{host_id:02d}.npz") as z:
            for key, ref in _flat(tree):
                t = _from_numpy(z[key])
                want = _dtype_of(ref)
                if want is not None and t.dtype != want:
                    t = t.to(want)
                vals.append((key, t.to(device) if place is None else place(key, t)))
        return _unflatten(vals), manifest["step"], manifest.get("extra", {})
    raise FileNotFoundError(f"no valid checkpoint under {ckpt_dir}")
