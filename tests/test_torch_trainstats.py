"""The port's training telemetry (skypilot_tpu_torch.observability.trainstats
and the step recorder in skypilot_tpu_torch.callbacks) against the JAX
package's, on the CPU.

* One scripted configure / record_step / note_downtime sequence, on a
  patched clock, gives equal ``snapshot()`` documents, equal ring records,
  equal ``snapshot.json`` files and equal host JSONL lines in both
  packages.
* The JAX module's own cases, on the port's module: ring eviction, the
  one-step-delayed values, MFU and goodput math, MFU None without a peak,
  the sync cadence and ``sampled_sync`` (a CUDA tensor waits on
  ``torch.cuda.synchronize``, a CPU tensor on nothing), stragglers, the
  flight dump's round trip and retention, ``dump_dir_flight``.
* The port's host JSONL sink is opened once, by ``configure``, and each
  line can be read as soon as its step is recorded.
* ``peak_flops_for_device`` on H100 names, unknown names and the CPU.
* Files cross over: the JAX package's ``dump_dir_flight`` and
  ``read_dump`` read what the port wrote, and the port reads the JAX
  package's dumps.
* ``callbacks``' ``benchmark_summary.json`` equals the JAX package's for
  the same ``step_end`` timestamps.
"""
import json
import os
import time

import pytest
import torch

from skypilot_tpu import callbacks as cb_jax
from skypilot_tpu.observability import trainstats as ts_jax
from skypilot_tpu_torch import callbacks as cb
from skypilot_tpu_torch.observability import trainstats as ts
from skypilot_tpu_torch.utils import paths


@pytest.fixture
def armed(tmp_state_dir):
    for mod in (ts, ts_jax):
        mod.arm(ring=128, sync_every=0)
        mod.reset()
    yield tmp_state_dir
    for mod in (ts, ts_jax):
        mod.disarm()
        mod.reset()


@pytest.fixture
def clock(monkeypatch):
    """One fake clock behind time.perf_counter and time.time, so both
    packages see the same instants."""
    now = {"t": 1000.0}
    monkeypatch.setattr(time, "perf_counter", lambda: now["t"])
    monkeypatch.setattr(time, "time", lambda: 1.7e9 + now["t"])
    return now


# ------------------------------------------------------------ parity
# (ring, sync_every, peak FLOP/s, restart downtime before the loop)
SCRIPTS = {"plain": (64, 0, 1e6, 0.0), "evicting": (8, 3, 1e6, 0.0),
           "restarted": (32, 1, 4e5, 0.05), "no_peak": (64, 2, 0.0, 0.0)}


def _script(mod, clock, out_dir, ring, sync_every, peak, downtime):
    clock["t"] = 1000.0
    mod.arm(ring=ring, sync_every=sync_every)
    mod.reset()
    mod.configure(flops_per_token=200.0, peak_flops=peak, host=0,
                  hosts=1, out_dir=out_dir, job="parity")
    if downtime:
        mod.note_downtime(downtime)
    for s in range(1, 24):
        dur = 0.004 + 0.0003 * (s % 5)
        clock["t"] += dur + 0.001 + 0.0005 * (s % 2)
        device_s = 0.001 * (s % 3) if mod.sync_due() else None
        mod.record_step(
            step=s, dur=dur, tokens=50 + s, data_wait_s=0.0002 * (s % 4),
            ckpt_s=0.003 if s % 10 == 0 else 0.0,
            dispatch_s=0.0007 * s, device_s=device_s,
            delayed=({"loss": 3.0 - 0.01 * s, "grad_norm": 0.5}
                     if s > 1 else None))
    mod.flush()
    with open(os.path.join(out_dir, "snapshot.json")) as f:
        written = json.load(f)
    with open(os.path.join(out_dir, "host-0.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return mod.snapshot(), mod.steps_tail(), written, lines


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_snapshots_equal_jax(armed, clock, tmp_path, script):
    got = _script(ts, clock, str(tmp_path / "port"), *SCRIPTS[script])
    want = _script(ts_jax, clock, str(tmp_path / "jax"), *SCRIPTS[script])
    for name, g, w in zip(("snapshot", "ring", "snapshot.json", "jsonl"),
                          got, want):
        assert g == w, name
    snap = got[0]
    assert set(snap) == set(want[0])
    assert (snap["mfu"] is None) == (SCRIPTS[script][2] == 0.0)
    assert snap["steps"] == min(23, SCRIPTS[script][0])


# ------------------------------------------------------ module cases
def test_ring_aggregates_and_eviction(armed):
    ts.arm(ring=64)
    for s in range(1, 101):        # ring=64: oldest 36 evicted
        ts.record_step(step=s, dur=0.002, tokens=100,
                       data_wait_s=0.0005, ckpt_s=0.0001)
    snap = ts.snapshot()
    assert snap["armed"] is True
    assert snap["steps"] == 64
    assert snap["total_steps"] == 100
    assert snap["step_seconds_mean"] == pytest.approx(0.002, rel=1e-6)
    assert snap["tokens_per_sec"] > 0
    assert snap["last"]["step"] == 100
    tail = ts.steps_tail()
    assert [r["step"] for r in tail] == list(range(37, 101))


def test_delayed_values_attach_to_previous_record(armed):
    ts.record_step(step=1, dur=0.01, tokens=10)
    ts.record_step(step=2, dur=0.01, tokens=10,
                   delayed={"loss": 1.5, "grad_norm": 0.25})
    recs = ts.steps_tail()
    assert (recs[0]["step"], recs[0]["loss"], recs[0]["grad_norm"]) == (
        1, 1.5, 0.25)
    assert recs[1]["loss"] is None
    snap = ts.snapshot()
    assert snap["last"] == {"step": 2, "loss": 1.5, "grad_norm": 0.25,
                            "loss_step": 1}


def test_jsonl_sink_opens_once_and_flushes_every_line(armed, tmp_path,
                                                     monkeypatch):
    opened = []
    real_open = open

    def counting_open(path, *args, **kwargs):
        opened.append(os.path.basename(str(path)))
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr("builtins.open", counting_open)
    out_dir = str(tmp_path / "ts")
    ts.configure(out_dir=out_dir, host=1, hosts=2)
    assert opened == ["host-1.jsonl"]    # before the first step
    path = os.path.join(out_dir, "host-1.jsonl")
    for s in range(1, 4):
        ts.record_step(step=s, dur=0.01, tokens=10)
        with real_open(path) as f:
            assert [json.loads(line)["step"] for line in f] == list(
                range(1, s + 1))
    assert opened.count("host-1.jsonl") == 1
    # A new host (so a new path) gets a sink of its own; reset closes it.
    ts.configure(out_dir=out_dir, host=3, hosts=4)
    ts.record_step(step=4, dur=0.01, tokens=10)
    assert opened.count("host-3.jsonl") == 1 and ts._sink[0].endswith(
        "host-3.jsonl")
    sink = ts._sink[1]
    ts.reset()
    assert sink.closed and ts._sink is None
    with real_open(os.path.join(out_dir, "host-3.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [4]


def test_mfu_and_goodput_math(armed, clock):
    ts.configure(flops_per_token=200.0, peak_flops=1e6)
    for s in range(1, 21):
        clock["t"] += 0.004 + 0.001 + 0.0005 + 0.0005  # step+stalls+slack
        ts.record_step(step=s, dur=0.004, tokens=50,
                       data_wait_s=0.001, ckpt_s=0.0005)
    snap = ts.snapshot()
    assert snap["mfu"] == pytest.approx(
        snap["tokens_per_sec"] * 200.0 / 1e6, rel=0.01)
    g = snap["goodput"]
    assert set(g) == {"productive", "data_wait", "ckpt", "restart"}
    assert g["restart"] == 0.0 and g["data_wait"] > 0 and g["ckpt"] > 0
    assert 0 < g["productive"] <= 1.0
    assert sum(g.values()) <= 1.0 + 1e-6
    # Restart downtime dilutes the denominator.
    ts.note_downtime(snap["window_s"])
    clock["t"] += 0.006
    ts.record_step(step=21, dur=0.004, tokens=50)
    snap2 = ts.snapshot()
    assert snap2["downtime_s"] > 0
    assert snap2["goodput"]["restart"] > 0.3
    assert snap2["goodput"]["productive"] < g["productive"]
    # The live gauge carries the unrounded MFU of the same window.
    from skypilot_tpu_torch.observability import metrics
    assert metrics.gauge("stpu_train_mfu").get() == pytest.approx(
        metrics.gauge("stpu_train_tokens_per_sec").get() * 200.0 / 1e6,
        rel=1e-12)


def test_mfu_none_without_peak(armed):
    ts.record_step(step=1, dur=0.01, tokens=10)
    assert ts.snapshot()["mfu"] is None


def test_sync_cadence_and_sampled_sync(armed, monkeypatch):
    ts.arm(ring=128, sync_every=3)
    assert [ts.sync_due() for _ in range(7)] == [
        False, False, True, False, False, True, False]
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)

    class _OnCard:                  # a CUDA tensor's device, no card
        device = torch.device("cuda", 0)

    assert ts.sampled_sync(_OnCard()) >= 0.0
    assert synced == [torch.device("cuda", 0)]
    # A CPU tensor and a non-tensor wait on nothing.
    assert ts.sampled_sync(torch.ones(2)) >= 0.0
    assert ts.sampled_sync(1.0) >= 0.0
    assert len(synced) == 1
    ts.arm(ring=128, sync_every=0)
    assert not any(ts.sync_due() for _ in range(10))


@pytest.mark.parametrize("device,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12), ("NVIDIA A100-SXM4-80GB", 0.0),
    ("cpu", 0.0), (torch.device("cpu"), 0.0)])
def test_peak_flops_for_device(device, peak):
    assert ts.peak_flops_for_device(device) == peak
    assert ts.detect_peak_flops(device) == peak


def test_peak_flops_reads_the_cards_name(monkeypatch):
    names = []

    def name(dev):
        names.append(dev)
        return "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(torch.cuda, "get_device_name", name)
    assert ts.detect_peak_flops(torch.device("cuda", 0)) == 989e12
    assert ts.peak_flops_for_device("cuda:0") == 989e12
    assert names == [torch.device("cuda", 0)] * 2
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev: "NVIDIA GeForce RTX 4090")
    assert ts.detect_peak_flops("cuda:0") == 0.0


def _write_host_jsonl(out_dir, rank, stamp, step=5):
    with open(os.path.join(out_dir, f"host-{rank}.jsonl"), "a") as f:
        for i in range(3):
            f.write(json.dumps({
                "seq": i, "step": step - 2 + i, "ts": stamp - (2 - i),
                "mono": 0.0, "dur": 0.01, "tokens": 100,
                "data_wait_s": 0.0, "ckpt_s": 0.0}) + "\n")


def _train_events():
    path = paths.logs_dir() / "events.jsonl"
    if not path.exists():
        return []
    return [e for e in map(json.loads, path.read_text().splitlines())
            if e.get("kind") == "train"]


def test_straggler_detection_and_edge_trigger(armed, tmp_path):
    out_dir = str(tmp_path / "ts")
    os.makedirs(out_dir)
    now = time.time()
    ts.configure(host=0, hosts=2, out_dir=out_dir, job="mj-train",
                 straggler_s=1.0)
    _write_host_jsonl(out_dir, 0, now)            # fresh
    _write_host_jsonl(out_dir, 1, now - 10.0)     # 10s stale
    lag = ts.check_stragglers(now=now)
    assert set(lag) == {1}
    assert lag[1] == pytest.approx(5.0, abs=0.5)
    snap = ts.snapshot()
    assert snap["stragglers"] == [1]
    assert snap["host_skew_s"] == pytest.approx(5.0, abs=0.5)
    ts.check_stragglers(now=now)                  # still lagging
    evs = [e for e in _train_events() if e["event"] == "train_straggler"]
    assert len(evs) == 1
    assert (evs[0]["name"], evs[0]["host"]) == ("mj-train", 1)
    assert evs[0]["lag_s"] == pytest.approx(5.0, abs=0.5)


def test_straggler_needs_two_hosts_and_threshold(armed, tmp_path):
    out_dir = str(tmp_path / "ts")
    os.makedirs(out_dir)
    now = time.time()
    _write_host_jsonl(out_dir, 0, now)
    _write_host_jsonl(out_dir, 1, now - 10.0)
    ts.configure(host=0, hosts=1, out_dir=out_dir)
    assert ts.check_stragglers(now=now) == {}
    ts.configure(host=0, hosts=2, out_dir=out_dir, straggler_s=0.0)
    assert ts.check_stragglers(now=now) == {}


def test_dump_flight_roundtrip_and_retention(armed, tmp_path):
    out_dir = str(tmp_path / "ts")
    ts.configure(out_dir=out_dir, job="mj-train")
    for s in range(1, 6):
        ts.record_step(step=s, dur=0.01, tokens=10)
    path = ts.dump_flight("train_crash", error="boom()")
    assert path and os.path.exists(path)
    assert "train_crash" in os.path.basename(path)
    doc = ts.read_dump(dir_path=os.path.dirname(path))
    assert (doc["reason"], doc["error"]) == ("train_crash", "boom()")
    assert doc["snapshot"]["total_steps"] == 5
    assert [r["step"] for r in doc["steps"]] == [1, 2, 3, 4, 5]
    for _ in range(ts.KEEP_DUMPS + 5):
        ts.dump_flight("test_prune")
    assert len(ts.list_dumps(os.path.dirname(path))) <= ts.KEEP_DUMPS
    # Without an out_dir the dumps land under the port's logs dir.
    ts.reset()
    assert ts.flightrec_dir() == str(paths.logs_dir() / "flightrec_train")


def test_dump_dir_flight_synthesizes_gang_dump(armed, tmp_path):
    out_dir = str(tmp_path / "ts")
    os.makedirs(out_dir)
    now = time.time()
    _write_host_jsonl(out_dir, 0, now)
    _write_host_jsonl(out_dir, 1, now - 3.0)
    with open(os.path.join(out_dir, "snapshot.json"), "w") as f:
        json.dump({"mfu": 0.41, "host_skew_s": 1.5}, f)
    path = ts.dump_dir_flight("job_preempted", out_dir, tail=2)
    doc = json.load(open(path))
    assert doc["synthesized"] is True
    assert doc["reason"] == "job_preempted"
    assert set(doc["hosts"]) == {"0", "1"}
    assert len(doc["hosts"]["0"]) == 2
    assert doc["snapshot"]["mfu"] == 0.41
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert ts.dump_dir_flight("x", empty) is None


# ------------------------------------------------- files cross over
def test_jax_reads_the_ports_trainstats_dir(armed, tmp_path):
    """The jobs controller's path: the JAX package's dump_dir_flight over
    a directory the port's recipe loop wrote, then its read_dump."""
    out_dir = str(tmp_path / "ts")
    ts.configure(flops_per_token=100.0, peak_flops=1e6, out_dir=out_dir,
                 job="port")
    for s in range(1, 8):
        ts.record_step(step=s, dur=0.01, tokens=32,
                       delayed={"loss": 2.0} if s > 1 else None)
    ts.flush()
    path = ts_jax.dump_dir_flight("job_preempted", out_dir, tail=4)
    doc = ts_jax.read_dump(dir_path=os.path.dirname(path))
    assert doc["synthesized"] is True
    assert [r["step"] for r in doc["hosts"]["0"]] == [4, 5, 6, 7]
    assert doc["snapshot"] == json.loads(json.dumps(ts.snapshot()))
    # ... and the port reads a dump the JAX package wrote, and vice versa.
    assert ts.read_dump(path)["reason"] == "job_preempted"
    mine = ts.dump_flight("train_crash", error="boom()")
    theirs = ts_jax.read_dump(mine)
    assert (theirs["reason"], theirs["error"]) == ("train_crash", "boom()")
    assert [r["step"] for r in theirs["steps"]] == list(range(1, 8))


# ----------------------------------------------------- step recorder
def test_step_recorder_summary_equals_jax(tmp_path, clock, monkeypatch):
    monkeypatch.setattr(cb, "_state", None)
    monkeypatch.setattr(cb_jax, "_state", None)
    docs = []
    for mod, name in ((cb, "port"), (cb_jax, "jax")):
        clock["t"] = 1000.0
        assert mod.init(total_steps=25, log_dir=str(tmp_path / name))
        for step in range(23):
            clock["t"] += 0.5 + 0.01 * step
            for _ in mod.step_iterator([step]):
                clock["t"] += 0.25
        mod.flush()
        docs.append(json.loads(
            (tmp_path / name / "benchmark_summary.json").read_text()))
    assert docs[0] == docs[1]
    assert docs[0]["num_steps"] == 23 and docs[0]["total_steps"] == 25
    # The first step is excluded from the steady rate.
    assert docs[0]["seconds_per_step"] == pytest.approx(
        (docs[0]["last_step_done_at"] - docs[0]["first_step_done_at"]) / 22)


def test_step_recorder_is_off_without_a_log_dir(monkeypatch, tmp_path):
    monkeypatch.delenv(cb.ENV_LOG_DIR, raising=False)
    assert cb.init(total_steps=3) is False
    cb.step_begin()
    cb.step_end()
    cb.flush()
    monkeypatch.setenv(cb.ENV_LOG_DIR, str(tmp_path / "bench"))
    assert cb.init(total_steps=3) is True
    cb.step_end()
    doc = json.loads((tmp_path / "bench" / cb.SUMMARY_NAME).read_text())
    assert doc["num_steps"] == 0 and doc["seconds_per_step"] is None
    monkeypatch.setattr(cb, "_state", None)
