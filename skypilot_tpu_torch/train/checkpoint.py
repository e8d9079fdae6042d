"""Crash-consistent training checkpoints: the port's copy of the JAX
package's ``train/checkpoint.py``, writing and reading the same on-disk
format, so a checkpoint directory is readable by either package.

* **Atomicity.** Every durable write goes write-to-temp, flush,
  ``os.fsync``, ``os.rename`` (and a directory fsync): a checkpoint exists
  completely or not at all; a SIGKILL mid-save leaves a ``.tmp`` that
  restore never reads.
* **Integrity.** Each payload carries a sha256 in its manifest;
  ``restore_latest`` verifies it and falls back to the previous valid
  checkpoint when the newest is torn or corrupt.
* **Off the step path.** ``Checkpointer`` enqueues each CUDA leaf's copy
  into pinned host memory on the leaf's stream and returns; a background
  thread waits for the copies and writes. The copies are enqueued before
  any later in-place update of the same tensors, so the bytes written are
  the state at the save; a CPU leaf is cloned before ``save`` returns. One
  save is in flight at a time.
* **Retention.** ``keep`` newest checkpoints survive.

On-disk layout (one directory per run)::

    <dir>/ckpt-00000040.bin    raw concatenated leaf buffers
    <dir>/ckpt-00000040.json   manifest: step, sha256, leaf index
                               (key/dtype/shape/offset), user meta

The tree may nest dict / list / tuple / dataclass with leaves that are
torch tensors, numpy arrays, python scalars or None; ``flatten_tree``'s
order is the payload's byte order. A tensor goes to the host as its raw
bytes: bfloat16 is written as its 16 bits under the dtype name
``"bfloat16"`` (the name ``ml_dtypes`` gives it in the JAX package) and
read back as ``torch.bfloat16``. Restored leaves are CPU tensors (a 0-d
one for a scalar).

Left out beside the JAX module: its metrics and tracing spans (the port
has no observability modules yet).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import re
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.utils import fault_injection

# Env var the jobs controller stamps into every managed task pointing at
# the job's stable checkpoint directory; recipes default --checkpoint-dir
# to it.
CKPT_DIR_ENV = "STPU_JOB_CKPT_DIR"

FORMAT_VERSION = 1
_PAYLOAD_FMT = "ckpt-{step:08d}.bin"
_MANIFEST_FMT = "ckpt-{step:08d}.json"
_MANIFEST_RE = re.compile(r"^ckpt-(\d{8})\.json$")
DEFAULT_KEEP = 3
BFLOAT16 = "bfloat16"


class CheckpointError(Exception):
    """A checkpoint could not be saved or restored."""


# ------------------------------------------------------------ atomic IO
def _fsync_dir(path: pathlib.Path) -> None:
    """Durably record a rename in its directory."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: os.PathLike, data: bytes) -> None:
    """temp + fsync + rename + dir fsync: a crash at any instant leaves
    either the old file or the new one."""
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + f".tmp-{os.getpid()}")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(path.parent)


# ------------------------------------------------------- tree flattening
def _is_leaf(obj: Any) -> bool:
    if obj is None or isinstance(obj, torch.Tensor):
        return True
    if isinstance(obj, (dict, list, tuple)):
        return False
    return not (dataclasses.is_dataclass(obj) and not isinstance(obj, type))


def flatten_tree(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """Deterministic (key, leaf) list: dict keys sorted lexically,
    dataclass fields by name, sequences in order; the JAX module's order,
    which is the payload's byte order."""
    if _is_leaf(tree):
        return [(prefix or ".", tree)]
    items: List[Tuple[str, Any]] = []
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            sub = f"{prefix}/{key}" if prefix else str(key)
            items.extend(flatten_tree(tree[key], sub))
    elif dataclasses.is_dataclass(tree):
        for field in sorted(dataclasses.fields(tree),
                            key=lambda f: f.name):
            sub = f"{prefix}/{field.name}" if prefix else field.name
            items.extend(flatten_tree(getattr(tree, field.name), sub))
    else:  # list / tuple / NamedTuple
        for i, child in enumerate(tree):
            sub = f"{prefix}/{i}" if prefix else str(i)
            items.extend(flatten_tree(child, sub))
    return items


def unflatten_like(like: Any, flat: Dict[str, Any],
                   prefix: str = "") -> Any:
    """Rebuild ``like``'s structure with leaves from ``flat`` (keyed as
    flatten_tree produces). A missing key raises."""
    if _is_leaf(like):
        key = prefix or "."
        if key not in flat:
            raise CheckpointError(
                f"checkpoint is missing leaf {key!r} required by the "
                "restore template (model/optimizer shape changed?)")
        return flat[key]
    if isinstance(like, dict):
        return type(like)(
            (key, unflatten_like(
                like[key], flat,
                f"{prefix}/{key}" if prefix else str(key)))
            for key in like)
    if dataclasses.is_dataclass(like):
        kwargs = {
            field.name: unflatten_like(
                getattr(like, field.name), flat,
                f"{prefix}/{field.name}" if prefix else field.name)
            for field in dataclasses.fields(like)}
        return type(like)(**kwargs)
    children = [
        unflatten_like(child, flat, f"{prefix}/{i}" if prefix else str(i))
        for i, child in enumerate(like)]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*children)
    return type(like)(children)


# ------------------------------------------------------ leaves and bytes
@dataclasses.dataclass
class _HostLeaf:
    """A leaf's bytes on the host: ``array`` holds them (bf16 as int16,
    named by ``dtype``); ``ready`` is the event its copy from the card
    must reach first, or None."""
    dtype: str
    array: np.ndarray
    ready: Optional[torch.cuda.Event] = None


def _to_host(leaf: Any) -> Optional[_HostLeaf]:
    """The leaf's bytes on the host, copied now (CPU) or enqueued on the
    leaf's stream into pinned memory (CUDA)."""
    if leaf is None:
        return None
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return _HostLeaf(arr.dtype.name, arr)
    t = leaf.detach()
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    dtype = BFLOAT16 if t.dtype == torch.bfloat16 else None
    ready = None
    if t.is_cuda:
        host = torch.empty(raw.shape, dtype=raw.dtype, pin_memory=True)
        host.copy_(raw, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(t.device))
    else:
        host = raw.clone(memory_format=torch.contiguous_format)
    arr = host.numpy()
    return _HostLeaf(dtype or arr.dtype.name, arr, ready)


def _resolve_dtype(name: str) -> Tuple[np.dtype, bool]:
    """(numpy dtype of the stored bytes, whether they are bf16)."""
    if name == BFLOAT16:
        return np.dtype(np.int16), True
    try:
        return np.dtype(name), False
    except TypeError as e:
        # CheckpointError so restore_latest's torn/corrupt fallback
        # absorbs it: an unknown dtype costs one checkpoint, not the run.
        raise CheckpointError(f"unresolvable leaf dtype {name!r}") from e


class _FlatLeaves(list):
    """Pre-flattened ordered (key, host leaf) pairs from the async
    Checkpointer, so the payload keeps flatten_tree's order."""


# ------------------------------------------------------------------ save
def save(ckpt_dir: os.PathLike, step: int, tree: Any,
         meta: Optional[Dict[str, Any]] = None,
         keep: Optional[int] = DEFAULT_KEEP) -> pathlib.Path:
    """Durably write ``tree`` as the step-``step`` checkpoint (blocking;
    ``Checkpointer`` is the step-path variant). Returns the manifest path.
    ``meta`` is stored in the manifest, never in the payload."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if not isinstance(tree, _FlatLeaves):
        tree = _FlatLeaves((key, _to_host(leaf))
                           for key, leaf in flatten_tree(tree))
    return _save_locked(ckpt_dir, int(step), tree, meta, keep)


def _save_locked(ckpt_dir: pathlib.Path, step: int, leaves: _FlatLeaves,
                 meta: Optional[Dict[str, Any]],
                 keep: Optional[int]) -> pathlib.Path:
    entries: List[Dict[str, Any]] = []
    offset = 0
    payload = ckpt_dir / _PAYLOAD_FMT.format(step=step)
    manifest = ckpt_dir / _MANIFEST_FMT.format(step=step)
    sha = hashlib.sha256()
    tmp = payload.with_name(payload.name + f".tmp-{os.getpid()}")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        with os.fdopen(fd, "wb") as f:
            # One leaf at a time: the serialized copy never exists in
            # full beside the host arrays.
            for key, leaf in leaves:
                if leaf is None:
                    entries.append({"key": key, "dtype": "none",
                                    "shape": [], "offset": offset,
                                    "nbytes": 0})
                    continue
                if leaf.ready is not None:
                    leaf.ready.synchronize()
                buf = np.ascontiguousarray(leaf.array).tobytes()
                entries.append({"key": key, "dtype": leaf.dtype,
                                "shape": list(leaf.array.shape),
                                "offset": offset, "nbytes": len(buf)})
                f.write(buf)
                sha.update(buf)
                offset += len(buf)
            f.flush()
            # Chaos seam between the payload bytes and the rename.
            if fault_injection.ENABLED:
                fault_injection.fire("ckpt.write", step=step,
                                     path=str(payload))
            os.fsync(f.fileno())
        os.rename(tmp, payload)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(ckpt_dir)

    doc = {
        "version": FORMAT_VERSION,
        "step": step,
        "sha256": sha.hexdigest(),
        "payload": payload.name,
        "payload_bytes": offset,
        "created_at": time.time(),
        "leaves": entries,
        "meta": meta or {},
    }
    atomic_write_bytes(manifest, json.dumps(doc).encode())
    if keep is not None:
        gc(ckpt_dir, keep=keep)
    return manifest


# ------------------------------------------------------------- retention
def steps(ckpt_dir: os.PathLike) -> List[int]:
    """Steps with a manifest on disk, ascending (no integrity check)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        m = _MANIFEST_RE.match(name)
        if m:
            found.append(int(m.group(1)))
    return sorted(found)


def latest_step(ckpt_dir: os.PathLike) -> Optional[int]:
    """Newest manifest's step, or None (no checksum)."""
    found = steps(ckpt_dir)
    return found[-1] if found else None


def gc(ckpt_dir: os.PathLike, keep: int = DEFAULT_KEEP) -> List[int]:
    """Delete all but the ``keep`` newest checkpoints (manifest first),
    and temp files of dead writers older than a minute. Returns the
    deleted steps."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    doomed = steps(ckpt_dir)[:-keep] if keep > 0 else []
    for step in doomed:
        for fmt in (_MANIFEST_FMT, _PAYLOAD_FMT):
            try:
                os.unlink(ckpt_dir / fmt.format(step=step))
            except OSError:
                pass
    if ckpt_dir.is_dir():
        for name in os.listdir(ckpt_dir):
            if ".tmp-" in name:
                tmp = ckpt_dir / name
                try:
                    # mtime is a wall stamp from a possibly dead process.
                    if time.time() - tmp.stat().st_mtime > 60:
                        os.unlink(tmp)
                except OSError:
                    pass
    return doomed


# --------------------------------------------------------------- restore
@dataclasses.dataclass
class Restored:
    step: int
    tree: Any                      # template shape, or flat {key: tensor}
    meta: Dict[str, Any]
    manifest_sha256: str           # payload sha: the byte-parity handle


def _load_one(ckpt_dir: pathlib.Path, step: int) -> Restored:
    manifest = ckpt_dir / _MANIFEST_FMT.format(step=step)
    doc = json.loads(manifest.read_text())
    payload = ckpt_dir / doc["payload"]
    # A writable buffer, so the tensors built on it own writable memory.
    data = bytearray(payload.read_bytes())
    if len(data) != doc["payload_bytes"]:
        raise CheckpointError(
            f"step {step}: payload is {len(data)} bytes, manifest "
            f"says {doc['payload_bytes']} (torn write)")
    if hashlib.sha256(data).hexdigest() != doc["sha256"]:
        raise CheckpointError(
            f"step {step}: payload checksum mismatch (corrupt)")
    flat: Dict[str, Any] = {}
    for entry in doc["leaves"]:
        if entry["dtype"] == "none":
            flat[entry["key"]] = None
            continue
        dtype, bf16 = _resolve_dtype(entry["dtype"])
        arr = np.frombuffer(
            data, dtype=dtype, count=entry["nbytes"] // dtype.itemsize,
            offset=entry["offset"]).reshape(entry["shape"])
        t = torch.from_numpy(arr)
        flat[entry["key"]] = t.view(torch.bfloat16) if bf16 else t
    return Restored(step=step, tree=flat, meta=doc.get("meta", {}),
                    manifest_sha256=doc["sha256"])


def restore_latest(ckpt_dir: os.PathLike,
                   like: Any = None) -> Optional[Restored]:
    """Load the newest valid checkpoint, skipping torn or corrupt ones
    (missing payload, size or checksum mismatch, unreadable manifest);
    None when no valid one exists. With ``like`` the tree mirrors the
    template's structure, else it is the flat {key: tensor} mapping."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    for step in reversed(steps(ckpt_dir)):
        try:
            result = _load_one(ckpt_dir, step)
        except (OSError, ValueError, KeyError, json.JSONDecodeError,
                CheckpointError):
            continue
        if like is not None:
            result = dataclasses.replace(
                result, tree=unflatten_like(like, result.tree))
        return result
    return None


# ------------------------------------------------------------ async save
class Checkpointer:
    """Step-path saver: host copies enqueued on the caller's thread, the
    write on a background thread, one save in flight. ``wait()`` (or
    ``close()``) before exiting so the last save is durable; a failed
    background save re-raises on the next call."""

    def __init__(self, ckpt_dir: os.PathLike, keep: int = DEFAULT_KEEP,
                 async_save: bool = True):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self.async_save = async_save
        self.last_saved_step: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any,
             meta: Optional[Dict[str, Any]] = None) -> None:
        self.wait()  # one in flight: on-disk order == step order
        if not self.async_save:
            save(self.ckpt_dir, step, tree, meta=meta, keep=self.keep)
            self.last_saved_step = step
            return
        host_flat = _FlatLeaves(
            (key, _to_host(leaf)) for key, leaf in flatten_tree(tree))

        def _write():
            try:
                save(self.ckpt_dir, step, host_flat, meta=meta,
                     keep=self.keep)
                self.last_saved_step = step
            except BaseException as e:  # noqa: BLE001 - re-raised on
                self._error = e         # the caller's next save/wait
        self._thread = threading.Thread(
            target=_write, name=f"ckpt-save-{step}", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(
                f"background checkpoint save failed: {err!r}") from err

    close = wait


# ------------------------------------------------------- SIGTERM grace
class GraceHandler:
    """Preemption grace: installed, SIGTERM sets a flag; the loop finishes
    its step, saves, and exits with ``GRACE_EXIT_CODE``, so the task is
    recorded as interrupted with a fresh checkpoint to resume from."""

    GRACE_EXIT_CODE = 143  # 128 + SIGTERM

    def __init__(self):
        self._event = threading.Event()
        self.signum: Optional[int] = None

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def _handle(self, signum, frame):
        del frame
        self.signum = signum
        self._event.set()

    @classmethod
    def install(cls, signals=(signal.SIGTERM,)) -> "GraceHandler":
        handler = cls()
        if threading.current_thread() is threading.main_thread():
            for sig in signals:
                signal.signal(sig, handler._handle)
        return handler
