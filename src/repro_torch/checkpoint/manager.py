"""Distributed checkpointing with elastic restore.

The port of ``repro.checkpoint.manager``, in the reference's on-disk
format, so a checkpoint written by either package restores into the
other's tree bit for bit:

  step_000042/
    manifest.json     — leaf paths, shapes, dtypes, shard layout, step meta
    shard_<i>.npz     — per-place payloads (leaf → local rows)

committed atomically by writing the manifest last and renaming the
directory.  Leaves are row-sharded through ``RangeDistribution.block``;
restoring re-partitions them for any world size.  Tensor leaves leave
the card as numpy copies and come back on the template leaf's device.

numpy has no bfloat16 of its own: the reference writes such a leaf with
``ml_dtypes``' extension dtype, an npy member whose header says ``<V2``
and a manifest entry ``"dtype": "bfloat16"``.  The port, which does not
import ``ml_dtypes`` (its package boundary), writes the same bytes from
a ``uint16`` view under the same header and entry.  Neither package
restores such a leaf: ``np.load`` gives the reference a ``|V2`` array
that ``astype("bfloat16")`` cannot cast, and the port's restore raises
where the reference's would.  Master parameters and f32 or int8 moments
are f32, int8 and int32.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import struct
import tempfile
import time
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch

from ..core import RangeDistribution

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]

_BF16 = ("checkpoint: a bfloat16 leaf is saved as the reference saves it "
         "(an npy '<V2' member under ml_dtypes' dtype name) but cannot be "
         "restored: the reference's own restore fails the same way (np.load "
         "gives '|V2', which astype('bfloat16') cannot cast); keep master "
         "parameters and moments in float32 (or int8 moments)")
_BF16_DESCR = "<V2"   # what np.save writes for ml_dtypes' bfloat16


def _flatten_with_paths(tree):
    flat = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            flat.append(("/".join(path), t))

    walk(tree, ())
    return flat


def _unflatten_into(template, values: dict):
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, path + (str(i),)) for i, v in enumerate(t))
        arr = values["/".join(path)]
        if isinstance(t, torch.Tensor):
            if not (arr.flags.writeable and arr.flags.c_contiguous):
                arr = np.array(arr)
            return torch.from_numpy(arr).to(t.device)
        return arr

    return walk(template, ())


def _host(leaf) -> tuple[np.ndarray, str]:
    """The leaf's host array and its manifest dtype: a bfloat16 leaf
    travels as its ``uint16`` bits under the name ``"bfloat16"``."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return leaf.numpy(), str(leaf.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":       # an ml_dtypes array handed in
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _savez(path, payload: dict, bf16: set) -> None:
    """``np.savez(path, **payload)``, member for member, except that the
    members named in ``bf16`` (``uint16`` bits) get the header
    ``np.save`` writes for ml_dtypes' bfloat16."""
    fmt = np.lib.format
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in payload.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if key not in bf16:
                    fmt.write_array(fid, np.asanyarray(arr),
                                    allow_pickle=False)
                    continue
                arr = np.ascontiguousarray(arr)
                header = fmt.header_data_from_array_1_0(arr)
                header["descr"] = _BF16_DESCR
                fmt.write_array_header_1_0(fid, header)
                fid.write(arr.tobytes("C"))


def _read_npz(path) -> dict:
    """The arrays of a ``np.savez`` file, as ``np.load`` gives them.
    ``np.savez`` stores each member uncompressed; this reads it with one
    ``np.fromfile`` from its offset in the file (``np.load`` reads it in
    256 KiB pieces through ``zipfile``, about 3x slower for a full-size
    model's moments) and checks its CRC-32 as ``zipfile`` does.  A
    member that fails the check, is short, is compressed, holds Python
    objects or is not a version 1 or 2 npy array raises ``BadZipFile``."""
    fmt = np.lib.format
    headers = {(1, 0): fmt.read_array_header_1_0,
               (2, 0): fmt.read_array_header_2_0}
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as fh:
        for info in zf.infolist():
            def bad(why):
                raise zipfile.BadZipFile(f"{path}: {info.filename} {why}")
            if info.compress_type != zipfile.ZIP_STORED:
                bad("is compressed")
            # the local header: 30 bytes, then the name and extra field
            fh.seek(info.header_offset + 26)
            n_name, n_extra = struct.unpack("<HH", fh.read(4))
            start = info.header_offset + 30 + n_name + n_extra
            fh.seek(start)
            read_header = headers.get(fmt.read_magic(fh))
            if read_header is None:
                bad("is not a version 1 or 2 npy array")
            shape, fortran, dtype = read_header(fh)
            if dtype.hasobject:
                bad("holds Python objects")
            n_head = fh.tell() - start
            fh.seek(start)
            crc = zlib.crc32(fh.read(n_head))
            arr = np.fromfile(fh, dtype=dtype, count=math.prod(shape))
            if n_head + arr.nbytes != info.file_size:
                bad(f"holds {info.file_size} bytes, not {n_head + arr.nbytes}")
            if zlib.crc32(arr, crc) != info.CRC:
                bad("fails its CRC-32 check")
            out[info.filename.removesuffix(".npy")] = arr.reshape(
                shape, order="F" if fortran else "C")
    return out


def save_checkpoint(directory, step: int, tree, *, n_shards: int = 1,
                    extra_meta: dict | None = None) -> Path:
    """Shard leaves by rows over ``n_shards`` places and commit atomically."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat = [(path, *_host(leaf)) for path, leaf in _flatten_with_paths(tree)]
    tmp = Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_"))
    manifest = {"step": step, "n_shards": n_shards, "time": time.time(),
                "leaves": {}, "meta": extra_meta or {}}
    shards: list[dict] = [{} for _ in range(n_shards)]
    bf16 = {path for path, _, dtype in flat if dtype == "bfloat16"}
    for path, arr, dtype in flat:
        manifest["leaves"][path] = {"shape": list(arr.shape),
                                    "dtype": dtype}
        if arr.ndim == 0 or arr.shape[0] < n_shards:
            shards[0][path] = arr
            manifest["leaves"][path]["layout"] = "replicated"
        else:
            dist = RangeDistribution.block(arr.shape[0], n_shards)
            manifest["leaves"][path]["layout"] = "row"
            for p in range(n_shards):
                for r in dist.ranges_of(p):
                    shards[p][path] = arr[r.start:r.end]
    for i, payload in enumerate(shards):
        _savez(tmp / f"shard_{i}.npz", payload, bf16)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    final = directory / f"step_{step:08d}"
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                   if p.name.startswith("step_") and
                   (p / "manifest.json").exists())
    return steps[-1] if steps else None


def restore_checkpoint(directory, template, *, step: int | None = None):
    """Restore into ``template``'s structure (tensor leaves on their
    template leaf's device); works for any current world size (the row
    re-partition is the elastic relocation)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if any(info["dtype"] == "bfloat16"
           for info in manifest["leaves"].values()):
        raise TypeError(_BF16)
    n_shards = manifest["n_shards"]
    payloads = [_read_npz(d / f"shard_{i}.npz") for i in range(n_shards)]
    values = {}
    for path, info in manifest["leaves"].items():
        if info["layout"] == "replicated":
            values[path] = payloads[0][path]
        else:
            parts = [payloads[i][path] for i in range(n_shards)
                     if path in payloads[i]]
            values[path] = parts[0] if len(parts) == 1 \
                else np.concatenate(parts, axis=0)
        values[path] = values[path].astype(info["dtype"], copy=False)
    restored = _unflatten_into(template, values)
    return restored, manifest


class CheckpointManager:
    """Keep-last-k rotation + save-time accounting."""

    def __init__(self, directory, keep: int = 3, n_shards: int = 1):
        self.directory = Path(directory)
        self.keep = keep
        self.n_shards = n_shards
        self.save_seconds = 0.0

    def save(self, step: int, tree, **meta):
        t0 = time.time()
        path = save_checkpoint(self.directory, step, tree,
                               n_shards=self.n_shards, extra_meta=meta)
        self.save_seconds += time.time() - t0
        self._gc()
        return path

    def restore(self, template, step: int | None = None):
        return restore_checkpoint(self.directory, template, step=step)

    def _gc(self):
        steps = sorted(p for p in self.directory.iterdir()
                       if p.name.startswith("step_"))
        for p in steps[:-self.keep]:
            shutil.rmtree(p)
