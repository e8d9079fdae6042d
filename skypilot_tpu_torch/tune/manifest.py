"""The tuning manifest: sha256-pinned JSON of per-config engine constants.

The port's copy of the JAX package's ``tune/manifest.py`` (it imports
nothing of that package). The file format is the same byte for byte
(canonical payload encoding, sha, schema), so either package reads a
manifest the other wrote; the default path is the same too
(``~/.stpu/tuning/manifest.json``, under ``utils/paths.home()``). The
provenance's ``device_kind`` says which card or chip measured it: the
engine trusts the operator, as the JAX package does, and applies no
device filter, so a manifest tuned on a TPU and left at the default path
steers the port's engine too. Set ``STPU_TUNE_MANIFEST`` (a path, or
``0``) where both run on one host. The port's sweep is
``python -m skypilot_tpu_torch.tune.sweep``.

The JAX module's text follows.

One document maps tuning keys — ``family|batch-band|tp-degree|quant-mode``
(e.g. ``llama|b5-16|tp1|bf16``) — to the engine constants the offline
sweep (:mod:`skypilot_tpu_torch.tune.sweep`) found and parity-gated for that
configuration:

* ``block``          split-KV attention tile width (dense path; also
                     the paged window derivation's default input);
* ``chunk``          prefill chunk == paged KV block size, tokens;
* ``window_blocks``  paged gather window, in blocks per tile;
* ``spec_k``         speculative draft depth (0 = off).

Document shape (``SCHEMA_VERSION`` pins it; a tier-1 test pins this
module's constants so the shape cannot drift silently)::

    {"schema": 1,
     "sha256": "<hex of the canonical payload encoding>",
     "payload": {
        "provenance": {"device_kind": ..., "commit": ...,
                       "created": ..., "tool": ...},
        "entries": {"<key>": {"block": 256, "chunk": 64, ...,
                              "objective": {"leg": ..., "tok_s": ...},
                              "parity": "pass"}}}}

The sha256 pins the payload byte-for-byte: a hand-edited (or
truncated, or bit-rotted) manifest fails closed to defaults rather
than silently steering the engine with unvalidated constants. The
same fail-closed rule applies to any schema violation and to a
``schema`` version this build does not speak (a *stale* manifest).

Stdlib-only: ``serve/decode_engine.resolve_kv_geometry`` loads this at
engine startup and the env analyzer / CLI import the contract side —
none of them want jax. Trust note for operators: a manifest encodes
MEASUREMENTS of one device kind; the provenance records which, and
``resolve_kv_geometry`` trusts the operator to not ship a v5e manifest
to a v4 pod — the handshake only guarantees every gang member resolves
the SAME constants, not that they are optimal.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import sys
from typing import Any, Dict, Optional, Tuple

SCHEMA_VERSION = 1

# The tunable engine constants an entry may carry (all optional — a
# sweep mode updates its subset; at least one must be present).
ENTRY_KNOBS = ("block", "chunk", "window_blocks", "spec_k")

# Provenance keys every manifest must record.
REQUIRED_PROVENANCE = ("device_kind", "commit", "created")

# Batch bands: slot counts are banded so a manifest tuned at 8 slots
# serves 5..16 — per-exact-slot-count entries would never be hit.
_BANDS = ((4, "b1-4"), (16, "b5-16"))
_BAND_OVERFLOW = "b17+"

ENV_MANIFEST = "STPU_TUNE_MANIFEST"


class ManifestError(ValueError):
    """The manifest is corrupt, stale, or schema-invalid."""


def batch_band(slots: int) -> str:
    for ceiling, name in _BANDS:
        if slots <= ceiling:
            return name
    return _BAND_OVERFLOW


def quant_mode(kv_quant: bool, weight_quant: bool) -> str:
    return {(False, False): "bf16", (True, False): "q8kv",
            (False, True): "q8w", (True, True): "q8kvw"}[
                (bool(kv_quant), bool(weight_quant))]


def tuning_key(family: str, slots: int, tp: int = 1,
               kv_quant: bool = False,
               weight_quant: bool = False) -> str:
    return (f"{family}|{batch_band(int(slots))}|tp{int(tp)}|"
            f"{quant_mode(kv_quant, weight_quant)}")


def default_path() -> pathlib.Path:
    from skypilot_tpu_torch.utils import paths
    return paths.home() / "tuning" / "manifest.json"


def resolve_path() -> Optional[pathlib.Path]:
    """The manifest the engine should load, or None (defaults).

    ``STPU_TUNE_MANIFEST``: ``0`` disables tuning outright, a path
    loads that file, unset falls back to ``~/.stpu/tuning/manifest.json``
    when it exists (``stpu tune``'s output lands there, so a tuned
    host picks it up on the next engine start with no extra config).
    """
    raw = os.environ.get(ENV_MANIFEST)
    if raw is not None:
        raw = raw.strip()
        if raw in ("0", ""):
            return None
        return pathlib.Path(raw).expanduser()
    path = default_path()
    return path if path.is_file() else None


# --------------------------------------------------------------- integrity
def canonical_payload_bytes(payload: Dict[str, Any]) -> bytes:
    """The byte encoding the sha256 pins: sorted keys, no whitespace —
    independent of how the file on disk happens to be pretty-printed."""
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def payload_sha(payload: Dict[str, Any]) -> str:
    return hashlib.sha256(canonical_payload_bytes(payload)).hexdigest()


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ManifestError(msg)


def validate(doc: Any) -> Dict[str, Any]:
    """Validate a full manifest document; returns its payload.

    Raises :class:`ManifestError` on a stale schema, a sha256/payload
    mismatch, or any shape violation — the caller falls back to
    default constants (fail closed, never half-apply)."""
    _require(isinstance(doc, dict), "manifest root must be an object")
    _require(doc.get("schema") == SCHEMA_VERSION,
             f"stale manifest schema {doc.get('schema')!r} "
             f"(this build speaks {SCHEMA_VERSION})")
    payload = doc.get("payload")
    _require(isinstance(payload, dict), "manifest payload missing")
    sha = doc.get("sha256")
    _require(isinstance(sha, str) and sha == payload_sha(payload),
             "manifest sha256 does not match payload (corrupt or "
             "hand-edited — re-run `stpu tune`)")
    prov = payload.get("provenance")
    _require(isinstance(prov, dict), "manifest provenance missing")
    for key in REQUIRED_PROVENANCE:
        _require(isinstance(prov.get(key), str) and prov[key],
                 f"manifest provenance missing {key!r}")
    entries = payload.get("entries")
    _require(isinstance(entries, dict), "manifest entries missing")
    for key, entry in entries.items():
        _require(isinstance(key, str) and len(key.split("|")) == 4,
                 f"bad tuning key {key!r} (family|band|tp|quant)")
        _require(isinstance(entry, dict), f"entry {key!r} not an object")
        knobs = [k for k in ENTRY_KNOBS if k in entry]
        _require(bool(knobs), f"entry {key!r} carries no tuned knob")
        for k in knobs:
            v = entry[k]
            _require(isinstance(v, int) and not isinstance(v, bool),
                     f"entry {key!r}.{k} must be an int")
            floor = 0 if k == "spec_k" else 1
            _require(v >= floor, f"entry {key!r}.{k} = {v} out of range")
        _require(entry.get("parity") == "pass",
                 f"entry {key!r} was not parity-gated "
                 "(parity != 'pass')")
    return payload


# ----------------------------------------------------------------- load/save
# (path, mtime_ns) -> (payload, tag): geometry resolution happens on
# every engine start AND in the serve recipe's handshake derivation —
# the cache keeps repeat lookups at one stat().
_CACHE: Dict[str, Tuple[int, Dict[str, Any], str]] = {}
_WARNED: set = set()


def _warn_once(path: pathlib.Path, err: Exception) -> None:
    key = str(path)
    if key not in _WARNED:
        _WARNED.add(key)
        sys.stderr.write(f"stpu-tune: ignoring manifest {path}: "
                         f"{err} — engine runs default constants\n")


def reset_for_tests() -> None:
    _CACHE.clear()
    _WARNED.clear()


def load(path: pathlib.Path) -> Tuple[Dict[str, Any], str]:
    """(validated payload, tag) for a manifest file; ManifestError /
    OSError on failure. The tag is the first 12 hex chars of the
    payload sha — the provenance token the geometry dict, /perf and
    BENCH jsons all carry."""
    key = str(path)
    mtime = os.stat(path).st_mtime_ns
    cached = _CACHE.get(key)
    if cached and cached[0] == mtime:
        return cached[1], cached[2]
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    payload = validate(doc)
    tag = doc["sha256"][:12]
    _CACHE[key] = (mtime, payload, tag)
    return payload, tag


def entry_for(*, family: str, slots: int, tp: int = 1,
              kv_quant: bool = False, weight_quant: bool = False
              ) -> Tuple[Optional[Dict[str, Any]], str]:
    """The tuned entry for an engine configuration, or (None,
    "default"). Never raises: a missing, corrupt, stale or
    sha-mismatched manifest warns once per path and falls back to
    defaults — a bad manifest must not keep a replica from serving."""
    path = resolve_path()
    if path is None:
        return None, "default"
    try:
        payload, tag = load(path)
    except (OSError, ManifestError, json.JSONDecodeError) as err:
        _warn_once(path, err)
        return None, "default"
    entry = payload["entries"].get(
        tuning_key(family, slots, tp, kv_quant, weight_quant))
    if entry is None:
        return None, "default"
    return entry, tag


def save(entries: Dict[str, Dict[str, Any]],
         provenance: Dict[str, str],
         path: Optional[pathlib.Path] = None,
         merge: bool = True) -> Dict[str, Any]:
    """Write (atomically) a schema-valid, sha-pinned manifest.

    ``merge=True`` folds ``entries`` over any existing valid manifest
    at ``path`` (new keys win) so ``stpu tune --family llama`` does
    not discard mixtral's entries. Returns the full document."""
    path = pathlib.Path(path) if path else default_path()
    merged: Dict[str, Dict[str, Any]] = {}
    if merge and path.is_file():
        try:
            old_payload, _ = load(path)
            merged.update(old_payload["entries"])
        except (OSError, ManifestError, json.JSONDecodeError):
            pass  # an invalid old file is replaced, not merged
    merged.update(entries)
    payload = {"provenance": dict(provenance), "entries": merged}
    doc = {"schema": SCHEMA_VERSION, "sha256": payload_sha(payload),
           "payload": payload}
    validate(doc)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    _CACHE.pop(str(path), None)
    return doc
