"""Default checkpoint engine: flattened-tree npz + JSON metadata (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/native_checkpoint_engine.py``).

The port writes the JAX package's format byte for byte in every array and
metadata entry, so each package loads the other's files:

- the tree flattened to ``||``-joined paths in one ``np.savez`` archive,
  its structure (dict keys in order, list lengths, scalars, ``None``) in
  ``<path>.meta.json``;
- ``<path>.manifest.json`` written last, with the CRC-32 of both files and
  the archive's size: a file without it is a torn write, one whose bytes
  disagree with it is corrupt, and both raise ``CheckpointCorruptError``
  (a file written before the manifest era, with its meta sidecar, loads
  unverified).

Leaves are numpy arrays or tensors. A ``torch.bfloat16`` leaf, which numpy
lacks, is stored as its uint16 view under ``"dtype": "bfloat16"``, as the
JAX package stores an ``ml_dtypes`` bfloat16 leaf, and read back as a CPU
bfloat16 tensor, the bits unchanged; no ``ml_dtypes`` is needed. Every
other array is read back as a numpy array.

``stats`` sums the seconds spent in ``np.savez`` (it also computes the
archive's own CRCs), in the manifest's CRC passes, in ``_verify`` and in
reading, and the bytes written.
"""

import json
import os
import time
import zipfile
import zlib

import numpy as np
import torch

from ...resilience.errors import CheckpointCorruptError
from ...utils.logging import logger
from .checkpoint_engine import CheckpointEngine

_SEP = "||"
_MANIFEST_VERSION = 1



def _file_crc32(path, chunk=1 << 20):
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


def _atomic_json_dump(obj, path):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _host_array(obj, path, meta):
    """One leaf as the array the archive holds, its meta entry recorded."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            meta[path] = {"kind": "array", "dtype": "bfloat16"}
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        meta[path] = {"kind": "array"}
        return t.numpy()
    arr = np.asarray(obj)
    if arr.dtype.kind == "V" or arr.dtype.name not in np.sctypeDict:
        # an ml_dtypes array handed in by the caller: the JAX package's view
        meta[path] = {"kind": "array", "dtype": arr.dtype.name}
        return arr.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[arr.dtype.itemsize])
    meta[path] = {"kind": "array"}
    return arr


def _walk(obj, path, flat, meta):
    if isinstance(obj, dict):
        meta[path or "<root>"] = {"kind": "dict", "keys": list(obj.keys())}
        for k, v in obj.items():
            _walk(v, f"{path}{_SEP}{k}" if path else str(k), flat, meta)
    elif isinstance(obj, (list, tuple)):
        meta[path or "<root>"] = {"kind": type(obj).__name__, "len": len(obj)}
        for i, v in enumerate(obj):
            _walk(v, f"{path}{_SEP}{i}" if path else str(i), flat, meta)
    elif obj is None:
        meta[path] = {"kind": "none"}
    elif isinstance(obj, (str, bool)):
        meta[path] = {"kind": "scalar", "value": obj}
    elif isinstance(obj, (int, float)):
        meta[path] = {"kind": "scalar", "value": obj}
    else:
        flat[path] = _host_array(obj, path, meta)


def _flatten(state_dict):
    """Flatten nested dict/list/tuple structure into (path, leaf) pairs.
    The walk is a module function, not a closure: a recursive closure is a
    reference cycle, which would hold every host array (on the card, the
    save's pinned buffers) until the garbage collector runs."""
    flat = {}
    meta = {}
    _walk(state_dict, "", flat, meta)
    return flat, meta


def _view_back(arr, name):
    if name != "bfloat16":
        raise NotImplementedError(
            f"checkpoint leaf of dtype {name!r}: the port reads bfloat16 views only")
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)


def _build(path, flat, meta):
    info = meta.get(path if path else "<root>")
    if info is None:
        raise KeyError(f"checkpoint missing metadata for '{path}'")
    kind = info["kind"]
    if kind == "dict":
        return {k: _build(f"{path}{_SEP}{k}" if path else str(k), flat, meta)
                for k in info["keys"]}
    if kind in ("list", "tuple"):
        items = [_build(f"{path}{_SEP}{i}" if path else str(i), flat, meta)
                 for i in range(info["len"])]
        return items if kind == "list" else tuple(items)
    if kind == "none":
        return None
    if kind == "scalar":
        return info["value"]
    arr = flat[path]
    if "dtype" in info:
        return _view_back(arr, info["dtype"])
    return arr


def _unflatten(flat, meta):
    return _build("", flat, meta)


class NativeCheckpointEngine(CheckpointEngine):
    def __init__(self, config_params=None):
        super().__init__(config_params)
        self.stats = {"saves": 0, "bytes_written": 0, "savez_s": 0.0, "crc_s": 0.0,
                      "loads": 0, "verify_s": 0.0, "read_s": 0.0}

    def makedirs(self, path, exist_ok=True):
        os.makedirs(path, exist_ok=exist_ok)

    def save(self, state_dict, path):
        flat, meta = _flatten(state_dict)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        t0 = time.perf_counter()
        np.savez(tmp, **flat)
        # numpy appends .npz to the name it writes
        os.replace(tmp + ".npz", path)
        _atomic_json_dump(meta, path + ".meta.json")
        t1 = time.perf_counter()
        # the manifest is the durability marker, written LAST: its presence
        # asserts the npz and meta files before it were completely written,
        # and its checksums let load() detect any later corruption of either.
        # A crash at any earlier point leaves no manifest → load() reports a
        # torn write (CheckpointCorruptError) instead of deserializing junk.
        _atomic_json_dump({
            "version": _MANIFEST_VERSION,
            "arrays": len(flat),
            "npz_crc32": _file_crc32(path),
            "meta_crc32": _file_crc32(path + ".meta.json"),
            "npz_bytes": os.path.getsize(path),
        }, path + ".manifest.json")
        st = self.stats
        st["saves"] += 1
        st["bytes_written"] += os.path.getsize(path)
        st["savez_s"] += t1 - t0
        st["crc_s"] += time.perf_counter() - t1
        logger.debug(f"[NativeCheckpointEngine] saved {path} ({len(flat)} arrays)")

    def _verify(self, path):
        """Check ``path`` against its manifest; raise typed on any tear.

        Checkpoints written before the manifest era (no ``.manifest.json``)
        load unverified for compatibility — but only if the meta sidecar is
        present; an npz with no sidecars at all is a torn write."""
        mpath = path + ".manifest.json"
        if not os.path.exists(mpath):
            if not os.path.exists(path + ".meta.json"):
                raise CheckpointCorruptError(
                    f"torn checkpoint write: {path} has neither manifest nor "
                    "metadata sidecar", path=path)
            return  # pre-manifest checkpoint: compat, unverified
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"unreadable checkpoint manifest {mpath}: {e}",
                path=path) from e
        for fpath, key in ((path, "npz_crc32"),
                           (path + ".meta.json", "meta_crc32")):
            want = manifest.get(key)
            if want is None:
                raise CheckpointCorruptError(
                    f"checkpoint manifest {mpath} missing '{key}'", path=path)
            try:
                got = _file_crc32(fpath)
            except OSError as e:
                raise CheckpointCorruptError(
                    f"checkpoint file missing/unreadable during verify: "
                    f"{fpath}: {e}", path=path) from e
            if got != want:
                raise CheckpointCorruptError(
                    f"checkpoint checksum mismatch for {fpath}: "
                    f"manifest crc32={want:#010x}, on-disk crc32={got:#010x}",
                    path=path)

    def load(self, path, map_location=None):
        t0 = time.perf_counter()
        self._verify(path)
        t1 = time.perf_counter()
        try:
            with open(path + ".meta.json") as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"unreadable checkpoint metadata {path}.meta.json: {e}",
                path=path) from e
        try:
            with np.load(path, allow_pickle=False) as z:
                flat = {k: z[k] for k in z.files}
        except (OSError, EOFError, ValueError, zipfile.BadZipFile) as e:
            raise CheckpointCorruptError(
                f"truncated/corrupt checkpoint archive {path}: {e}",
                path=path) from e
        try:
            out = _unflatten(flat, meta)
        except (KeyError, IndexError) as e:
            raise CheckpointCorruptError(
                f"checkpoint {path} metadata inconsistent with archive "
                f"contents: {e}", path=path) from e
        st = self.stats
        st["loads"] += 1
        st["verify_s"] += t1 - t0
        st["read_s"] += time.perf_counter() - t1
        return out
