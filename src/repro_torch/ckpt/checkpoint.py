"""Atomic, verified checkpoint/restart, in the JAX package's on-disk
format, so that either package reads the other's checkpoints.

  * atomic:   write to ``step-<n>.tmp`` then ``os.rename`` — a crash
              mid-write never corrupts the previous checkpoint; a
              ``latest`` pointer file names the newest step;
  * verified: every array payload carries a CRC32 in the JSON manifest
              (``manifest_version`` 2), recomputed at load — bit-rot,
              truncation and torn writes are detected, never restored;
              :func:`load_checkpoint` walks back to the newest intact step
              when the newest one fails verification;
  * portable: arrays go to the host and are stored as plain ``.npy``
              payloads, keyed by their tree paths (``"a/b/c"`` for nested
              dicts, as the JAX package's ``_flatten`` names them), with
              the JAX package's dtypes: a :class:`PRNGKey` leaf as its two
              uint32 words under the tag ``prng_key:threefry2x32``,
              int64 as int32 (the JAX package's integer width), bfloat16
              as its uint16 view under the tag ``bfloat16``.

A loaded leaf takes the device and dtype of the template's leaf.  Tensors
leave the device only here, between the driver's chunks.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

# Version 2 added per-array ``crc32``; version-1 manifests (no checksums)
# still load, without verification.
MANIFEST_VERSION = 2
KEY_TAG = "prng_key:threefry2x32"

# Bounded retry around filesystem IO: transient errors get _IO_RETRIES
# attempts with exponential backoff before the error propagates.
_IO_RETRIES = 3
_IO_BACKOFF_S = 0.05
_INT32 = np.iinfo(np.int32)


class PRNGKey(NamedTuple):
    """Marks a threefry key (the port's (2,) int64 words) as one leaf,
    stored as the JAX package stores a typed key."""
    data: torch.Tensor


class CheckpointError(RuntimeError):
    """A checkpoint cannot be restored for a STRUCTURAL reason (missing
    directory, tree/manifest key mismatch).  Not retried, no walk-back:
    the same mismatch would hold for every step."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint failed integrity verification (CRC mismatch,
    truncated payload, unreadable manifest) and no intact fallback step
    existed.  Carries ``reasons`` — one line per candidate tried."""

    def __init__(self, message: str, reasons: Optional[List[str]] = None):
        super().__init__(message)
        self.reasons = reasons or []


def _retry_io(fn, what: str):
    """Run ``fn()`` with bounded retry-with-backoff on OSError."""
    last = None
    for attempt in range(_IO_RETRIES):
        try:
            return fn()
        except OSError as e:          # noqa: PERF203 — bounded, tiny loop
            last = e
            if attempt + 1 < _IO_RETRIES:
                time.sleep(_IO_BACKOFF_S * (2 ** attempt))
    raise CheckpointError(
        f"{what} failed after {_IO_RETRIES} attempts: {last}") from last


def _encode(leaf):
    """Leaf -> (numpy array ``np.save`` understands, dtype tag)."""
    if isinstance(leaf, PRNGKey):
        return leaf.data.cpu().numpy().astype(np.uint32), KEY_TAG
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    if arr.dtype == np.int64:
        if arr.size and (arr.min() < _INT32.min or arr.max() > _INT32.max):
            raise ValueError("an int64 leaf outside the int32 range cannot "
                             "be stored in the shared format")
        arr = arr.astype(np.int32)
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, tag: str, like):
    """Stored array -> a leaf placed like ``like`` (device and dtype)."""
    if tag.startswith("prng_key:"):
        data = torch.from_numpy(arr.astype(np.int64))
        return PRNGKey(data.to(like.data.device))
    if tag == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))      # keeps 0-d
    return t.to(device=like.device, dtype=like.dtype)


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} over nested dicts, as the JAX package's tree paths
    name them."""
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: tree}


def _unflatten(tree, flat: Dict[str, Any], prefix: str = ""):
    """``tree``'s structure with its leaves taken from ``flat``."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    return flat[prefix[:-1]]


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[dict] = None) -> str:
    """Atomic, checksummed save; returns the final checkpoint path."""
    _retry_io(lambda: os.makedirs(directory, exist_ok=True),
              f"creating checkpoint directory {directory!r}")
    final = os.path.join(directory, f"step-{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "manifest_version": MANIFEST_VERSION,
                "extra": extra or {}, "arrays": {}}
    for i, (key, leaf) in enumerate(sorted(_flatten(tree).items())):
        arr, tag = _encode(leaf)
        fname = f"arr-{i:06d}.npy"
        _retry_io(lambda a=arr, f=fname: np.save(os.path.join(tmp, f), a),
                  f"writing checkpoint array {fname!r}")
        manifest["arrays"][key] = {"file": fname, "dtype": tag,
                                   "shape": list(arr.shape),
                                   "crc32": _crc32(arr)}

    def _write_manifest():
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)

    _retry_io(_write_manifest, "writing checkpoint manifest")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish
    latest = os.path.join(directory, "latest")
    with open(latest + ".tmp", "w") as f:
        f.write(os.path.basename(final))
    os.rename(latest + ".tmp", latest)
    return final


def _step_dirs(directory: str) -> List[str]:
    """All complete ``step-*`` dirs, newest first."""
    if not os.path.isdir(directory):
        return []
    names = [d for d in os.listdir(directory)
             if d.startswith("step-") and not d.endswith(".tmp")
             and os.path.isdir(os.path.join(directory, d))]
    return sorted(names, reverse=True)


def _read_latest(directory: str) -> Optional[str]:
    """The ``latest`` pointer's target when it names a real step dir."""
    latest = os.path.join(directory, "latest")
    try:
        with open(latest) as f:
            name = f.read().strip()
    except OSError:
        return None
    return name if name and os.path.isdir(os.path.join(directory, name)) \
        else None


def _candidate_steps(directory: str) -> List[str]:
    """Restore candidates, newest-intact-first: the ``latest`` pointer's
    target (a deleted or torn pointer is skipped), then every ``step-*``
    dir descending."""
    first = _read_latest(directory)
    candidates = [first] if first else []
    return candidates + [n for n in _step_dirs(directory) if n != first]


def _load_step(path: str, flat_like: Dict[str, Any]):
    """Load + verify one step dir against the template's flat keys.

    Raises :class:`CheckpointCorruptError` for integrity problems
    (candidate for walk-back) and :class:`CheckpointError` for a tree
    mismatch (structural — every step of this run has the same tree)."""
    mpath = os.path.join(path, "manifest.json")
    try:
        def _read():
            with open(mpath) as f:
                return json.load(f)
        manifest = _retry_io(_read, f"reading manifest {mpath!r}")
    except (CheckpointError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest in {path!r}: {e}") from e
    arrays = manifest.get("arrays")
    if not isinstance(arrays, dict):
        raise CheckpointCorruptError(f"manifest in {path!r} has no "
                                     f"'arrays' table")

    missing = sorted(set(flat_like) - set(arrays))
    unexpected = sorted(set(arrays) - set(flat_like))
    if missing or unexpected:
        raise CheckpointError(
            f"checkpoint {path!r} does not match the restore template "
            f"(was it written by a different config?): "
            f"missing from checkpoint: {missing or 'none'}; "
            f"unexpected in checkpoint: {unexpected or 'none'}")

    versioned = manifest.get("manifest_version", 1) >= 2
    out = {}
    for key, like in flat_like.items():
        meta = arrays[key]
        fpath = os.path.join(path, meta["file"])
        try:
            arr = _retry_io(lambda p=fpath: np.load(p),
                            f"reading array {fpath!r}")
        except (CheckpointError, ValueError, EOFError, OSError) as e:
            raise CheckpointCorruptError(
                f"unreadable/truncated array {fpath!r}: {e}") from e
        if list(arr.shape) != list(meta.get("shape", arr.shape)):
            raise CheckpointCorruptError(
                f"array {fpath!r} shape {list(arr.shape)} != manifest "
                f"{meta['shape']}")
        if versioned and "crc32" in meta:
            got = _crc32(arr)
            if got != meta["crc32"]:
                raise CheckpointCorruptError(
                    f"CRC mismatch for {key!r} in {path!r}: stored "
                    f"{meta['crc32']:#010x}, recomputed {got:#010x}")
        out[key] = _decode(arr, meta["dtype"], like)
    return out, manifest


def load_checkpoint(directory: str, tree_like, step: Optional[int] = None,
                    shardings=None):
    """Restore into the structure of ``tree_like``, each leaf on the
    device and in the dtype of the template's leaf.  ``shardings``: a
    tree of the same structure (``None`` subtrees allowed) whose leaves
    are row slices or None; a leaf under a slice keeps only those rows,
    so each rank of a replica mesh loads its own block
    (``repro_torch.sharding.ensemble_shardings``).

    Every array's CRC32 is verified against the manifest (version-1
    manifests have none).  When ``step`` is None the newest intact
    checkpoint is restored: a corrupt or truncated newest step (or a
    stale ``latest`` pointer) walks back to the previous step; an
    explicit ``step`` loads that step or raises.  A tree/manifest key
    mismatch raises :class:`CheckpointError` naming the keys —
    structural, never walked back.  Returns (tree, step, extra)."""
    flat_like = _flatten(tree_like)
    fallback = step is None
    if fallback:
        candidates = _candidate_steps(directory)
        if not candidates:
            raise CheckpointError(
                f"no checkpoint found in {directory!r} (no 'latest' "
                f"pointer and no step-* directories)")
    else:
        candidates = [f"step-{step:08d}"]

    reasons: List[str] = []
    out = manifest = None
    for name in candidates:
        path = os.path.join(directory, name)
        if not os.path.isdir(path):
            reasons.append(f"{name}: directory missing")
            continue
        try:
            out, manifest = _load_step(path, flat_like)
            break
        except CheckpointCorruptError as e:
            reasons.append(f"{name}: {e}")
            if not fallback:
                raise
    if out is None:
        raise CheckpointCorruptError(
            f"no intact checkpoint in {directory!r} — tried "
            f"{len(reasons)} candidate(s):\n  " + "\n  ".join(reasons),
            reasons=reasons)
    if shardings is not None:
        for key, rows in _flatten(shardings).items():
            if isinstance(rows, slice):
                out[key] = out[key][rows].clone()
    return (_unflatten(tree_like, out), manifest["step"],
            manifest.get("extra", {}))


class CheckpointManager:
    """Retention + cadence policy around save/load."""

    def __init__(self, directory: str, keep: int = 3, every: int = 100):
        self.directory = directory
        self.keep = keep
        self.every = every

    def maybe_save(self, step: int, tree, extra: Optional[dict] = None,
                   force: bool = False) -> Optional[str]:
        if not force and (self.every <= 0 or step % self.every != 0):
            return None
        path = save_checkpoint(self.directory, step, tree, extra)
        self._retain()
        return path

    def _retain(self):
        if not os.path.isdir(self.directory):
            return
        ckpts = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step-") and not d.endswith(".tmp"))
        for old in ckpts[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, old))

    def latest_step(self) -> Optional[int]:
        """Newest restorable step number, or None.  The ``latest``
        pointer is validated: missing, torn, or naming a deleted step,
        the ``step-*`` dirs are scanned instead."""
        names = ([n] if (n := _read_latest(self.directory)) else []) \
            + _step_dirs(self.directory)
        for name in names:
            try:
                return int(name.split("-")[1])
            except (IndexError, ValueError):
                continue
        return None
