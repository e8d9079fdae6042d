"""The offline sweep of the port's engine constants: the port's copy of the
JAX package's ``tune/sweep.py`` and of its ``stpu tune`` command.

For each requested ``(family, mode)`` the sweep measures candidate
constant combinations through the SAME ``benchmark/decode_bench.py`` legs
the port records, on the card (so what it picks was measured on an H100,
not a TPU), prunes losers early at a small step count, re-runs the
survivors at the full budget, parity-gates the winner on the same device
(:mod:`skypilot_tpu_torch.tune.parity`), and persists it to the sha-pinned
manifest (:mod:`skypilot_tpu_torch.tune.manifest`).

Search space (declared, not discovered — every axis is a constant the
engine already threads through ``resolve_kv_geometry``):

====== ==================== ========================================
mode   axes                 objective leg
====== ==================== ========================================
ragged block x chunk        measure_engine_ragged (dense engine)
paged  chunk x window       measure_engine_paged  (block pool)
spec   spec_k               measure_engine_spec   (drafting depth)
q8     chunk x window       measure_engine_q8     (int8 KV+weights)
====== ==================== ========================================

tok/s is the headline objective; stepstats ``dispatch_ms_mean`` /
``device_ms_mean`` ride along as diagnostics in the manifest entry where
the leg reports them. Modes run in table order and merge into one entry
per tuning key — ``paged`` runs after ``ragged`` on purpose: both tune
``chunk`` and paged is the serving default, so its preference wins the
shared knob.

    python -m skypilot_tpu_torch.tune.sweep --family llama --mode paged \\
        --quick --out /tmp/manifest.json     # on the card
    python -m skypilot_tpu_torch.tune.sweep --tiny --quick --device cpu \\
        --out /tmp/m.json                    # plumbing only

``--tiny`` sweeps the families' test configs: constants tuned that way are
not representative of real model shapes.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.tune import manifest as tune_manifest
from skypilot_tpu_torch.tune.parity import ParityError, check_parity

FAMILIES = ("llama", "mixtral", "gemma")
MODES = ("ragged", "paged", "spec", "q8")

# Candidate axes per mode. Values are chosen to stay aligned with the
# engine's invariants by construction: chunk must divide max_seq
# (resolve_kv_geometry halves it until it does), window is derived in
# whole chunks, block is clamped to max_seq.
SEARCH_SPACE: Dict[str, Dict[str, Sequence[int]]] = {
    "ragged": {"block": (128, 256, 512), "chunk": (32, 64, 128)},
    "paged": {"chunk": (32, 64, 128), "window_blocks": (2, 4, 8)},
    "spec": {"spec_k": (0, 2, 4, 8)},
    "q8": {"chunk": (32, 64, 128), "window_blocks": (2, 4, 8)},
}

# The hand-pinned constants every sweep measures as its baseline
# candidate — the winner is reported NEXT TO this number, and when no
# candidate beats it the manifest simply records the default (tuned
# >= default holds by construction: both are measured the same way in
# the same process).
DEFAULTS: Dict[str, Dict[str, int]] = {
    "ragged": {"block": 256, "chunk": 64},
    "paged": {"chunk": 64, "window_blocks": 4},
    "spec": {"spec_k": 0},
    "q8": {"chunk": 64, "window_blocks": 4},
}

_LEG_KEY = {"ragged": "engine_ragged_tok_s",
            "paged": "engine_paged_tok_s",
            "spec": "engine_spec_tok_s",
            "q8": "engine_q8_tok_s"}

_QUANT = {"q8": (True, True)}   # mode -> (kv_quant, weight_quant)

# Prune rule: after the small-budget round, keep candidates within
# PRUNE_MARGIN_PCT of the round's best (capped at PRUNE_KEEP), plus
# the default. Small-step tok/s is noisy; the margin is deliberately
# loose so pruning only drops clear losers.
PRUNE_MARGIN_PCT = 15.0
PRUNE_KEEP = 3

TOOL = "python -m skypilot_tpu_torch.tune.sweep"


def _budgets(quick: bool) -> Dict[str, Dict[str, int]]:
    if quick:
        return {"prune": dict(n_requests=6, max_tokens=16,
                              max_prompt=48),
                "final": dict(n_requests=12, max_tokens=24,
                              max_prompt=96)}
    return {"prune": dict(n_requests=8, max_tokens=24,
                          max_prompt=96),
            "final": dict(n_requests=32, max_tokens=64,
                          max_prompt=192)}


def _candidates(mode: str) -> List[Dict[str, int]]:
    axes = SEARCH_SPACE[mode]
    combos: List[Dict[str, int]] = [{}]
    for name, values in axes.items():
        combos = [dict(c, **{name: v}) for c in combos
                  for v in values]
    default = DEFAULTS[mode]
    if default not in combos:
        combos.insert(0, default)
    return combos


def _measure(mode: str, family: str, cand: Dict[str, int],
             budget: Dict[str, int], slots: int,
             shape_kw: Dict[str, Any],
             device: DeviceLike = None) -> Dict[str, Any]:
    from skypilot_tpu_torch.benchmark import decode_bench
    if mode == "ragged":
        kw = {k: v for k, v in (("block", cand.get("block", 0)),
                                ("prefill_chunk",
                                 cand.get("chunk", 0))) if v}
        return decode_bench.measure_engine_ragged(
            family, slots=slots, engine_kw=kw, device=device, **budget,
            **shape_kw)
    if mode in ("paged", "q8"):
        kw = {}
        if cand.get("window_blocks"):
            kw["window_blocks"] = cand["window_blocks"]
        fn = (decode_bench.measure_engine_paged if mode == "paged"
              else decode_bench.measure_engine_q8)
        return fn(family, slots=slots,
                  block_tokens=cand.get("chunk", 0), engine_kw=kw,
                  device=device, **budget, **shape_kw)
    if mode == "spec":
        b = dict(budget)
        b.pop("max_prompt", None)
        return decode_bench.measure_engine_spec(
            family, slots=slots, spec_k=cand.get("spec_k", 0),
            shared_prefix=min(128, 4 * b["max_tokens"]),
            max_unique=max(8, b["max_tokens"] // 2), device=device, **b,
            **shape_kw)
    raise ValueError(f"unknown tune mode {mode!r}")


def _gate(mode: str, family: str, cand: Dict[str, int],
          device: DeviceLike = None) -> None:
    kv_quant, _ = _QUANT.get(mode, (False, False))
    check_parity(
        family,
        block=cand.get("block", 0), chunk=cand.get("chunk", 0),
        window_blocks=cand.get("window_blocks", 0),
        spec_k=cand.get("spec_k", 0),
        paged=(mode != "ragged"), kv_quant=kv_quant, device=device)


def _provenance(legs: Sequence[str], device: DeviceLike) -> Dict[str, str]:
    """Which card measured the manifest (``torch.cuda.get_device_name``;
    "cpu" for a CPU run), at which commit, when."""
    import torch
    device = resolve_device(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=pathlib.Path(__file__).resolve().parents[2],
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        commit = "unknown"
    return {
        "device_kind": kind,
        "commit": commit,
        "created": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "tool": TOOL,
        "legs": ",".join(legs),
    }


def sweep_one(family: str, mode: str, *, quick: bool = False,
              slots: int = 8, shape_kw: Optional[Dict[str, Any]] = None,
              log: Callable[[str], None] = print,
              device: DeviceLike = None) -> Optional[Dict[str, Any]]:
    """Sweep one (family, mode) on ``device``; returns the parity-gated
    winner as ``{"knobs": {...}, "objective": {...}}``, or None when no
    survivor, the default included, passed the parity gate."""
    shape_kw = dict(shape_kw or {})
    budgets = _budgets(quick)
    cands = _candidates(mode)
    leg = _LEG_KEY[mode]
    default = DEFAULTS[mode]

    # Round 1: every candidate at the small budget.
    scores: List[float] = []
    for cand in cands:
        r = _measure(mode, family, cand, budgets["prune"], slots,
                     shape_kw, device)
        scores.append(float(r[leg]))
        log(f"tune[{family}/{mode}] probe {cand} -> "
            f"{r[leg]:g} tok/s")
    best = max(scores)
    ranked = sorted(range(len(cands)), key=lambda i: -scores[i])
    keep = [i for i in ranked
            if scores[i] >= best * (1 - PRUNE_MARGIN_PCT / 100.0)]
    keep = keep[:PRUNE_KEEP]
    default_idx = cands.index(default)
    if default_idx not in keep:
        keep.append(default_idx)
    log(f"tune[{family}/{mode}] pruned {len(cands)} -> {len(keep)} "
        f"candidates")

    # Round 2: survivors at the full budget.
    finals: List[Dict[str, Any]] = []
    for i in keep:
        r = _measure(mode, family, cands[i], budgets["final"], slots,
                     shape_kw, device)
        finals.append({"cand": cands[i], "result": r,
                       "tok_s": float(r[leg])})
        log(f"tune[{family}/{mode}] final {cands[i]} -> "
            f"{r[leg]:g} tok/s")
    finals.sort(key=lambda f: -f["tok_s"])
    default_tok_s = next(f["tok_s"] for f in finals
                         if f["cand"] == default)

    # Winner = best survivor that passes the parity gate.
    for f in finals:
        try:
            _gate(mode, family, f["cand"], device)
        except ParityError as err:
            log(f"tune[{family}/{mode}] REJECTED {f['cand']}: {err}")
            continue
        r = f["result"]
        objective = {
            "leg": leg, "tok_s": f["tok_s"],
            "default_tok_s": default_tok_s,
            "dispatch_ms_mean": r.get("dispatch_ms_mean"),
            "device_ms_mean": r.get("device_ms_mean"),
        }
        log(f"tune[{family}/{mode}] winner {f['cand']} "
            f"({f['tok_s']:g} vs default {default_tok_s:g} tok/s)")
        return {"knobs": dict(f["cand"]), "objective": objective}
    log(f"tune[{family}/{mode}] no candidate survived the parity "
        f"gate — keeping defaults")
    return None


def run_sweep(families: Sequence[str] = FAMILIES,
              modes: Sequence[str] = MODES, *, quick: bool = False,
              slots: int = 8, tiny: bool = False,
              out_path=None, log: Callable[[str], None] = print,
              device: DeviceLike = None) -> Dict[str, Any]:
    """Full sweep on ``device`` (the card by default) -> manifest on
    disk. Returns the written document."""
    device = resolve_device(device)
    shape_kw = {"tiny": True} if tiny else {}
    entries: Dict[str, Dict[str, Any]] = {}
    legs: List[str] = []
    for family in families:
        for mode in modes:
            kv_quant, weight_quant = _QUANT.get(mode, (False, False))
            win = sweep_one(family, mode, quick=quick, slots=slots,
                            shape_kw=shape_kw, log=log, device=device)
            if win is None:
                continue
            key = tune_manifest.tuning_key(
                family, slots, tp=1, kv_quant=kv_quant,
                weight_quant=weight_quant)
            entry = entries.setdefault(
                key, {"parity": "pass", "objective": {}})
            entry.update(win["knobs"])
            entry["objective"][_LEG_KEY[mode]] = win["objective"]
            legs.append(f"{family}/{mode}")
    doc = tune_manifest.save(entries, _provenance(legs, device),
                             path=out_path)
    log(f"tune: wrote {len(entries)} entr"
        f"{'y' if len(entries) == 1 else 'ies'} "
        f"(sha {doc['sha256'][:12]}) to "
        f"{out_path or tune_manifest.default_path()}")
    return doc


def main(argv=None) -> Dict[str, Any]:
    """The JAX package's ``stpu tune``, with its options, plus
    ``--device`` (the card unless ``cpu`` is given)."""
    p = argparse.ArgumentParser(
        prog=TOOL, description="Autotune the decode engine's constants "
        "into a sha-pinned manifest (parity-gated winners).")
    p.add_argument("--family", dest="families", action="append",
                   choices=FAMILIES, help="model family to sweep "
                   "(repeatable; default all three)")
    p.add_argument("--mode", dest="modes", action="append", choices=MODES,
                   help="engine mode to sweep (repeatable; default all): "
                   "ragged = attention block x prefill chunk, paged/q8 = "
                   "chunk x gather window, spec = draft depth")
    p.add_argument("--out", default=None,
                   help="manifest path (default "
                   "~/.stpu/tuning/manifest.json, where engines load it "
                   "on their next start)")
    p.add_argument("--quick", action="store_true",
                   help="small step budgets: a fast, noisier sweep")
    p.add_argument("--tiny", action="store_true",
                   help="sweep the .tiny() configs (plumbing only: not "
                   "representative of real model shapes)")
    p.add_argument("--slots", type=int, default=8,
                   help="engine slot count to tune for (keys the entry's "
                   "batch band; default 8)")
    p.add_argument("--device", default=None,
                   help="torch device; default the card, which must "
                   "exist")
    args = p.parse_args(argv)
    doc = run_sweep(families=args.families or FAMILIES,
                    modes=args.modes or MODES, quick=args.quick,
                    slots=args.slots, tiny=args.tiny,
                    out_path=pathlib.Path(args.out) if args.out else None,
                    device=args.device)
    prov = doc["payload"]["provenance"]
    print(f"manifest sha {doc['sha256'][:12]}  device "
          f"{prov['device_kind']}  commit {prov['commit']}", flush=True)
    return doc


if __name__ == "__main__":
    main()
