#!/usr/bin/env python3
"""chip_smoke.py of several checkouts in turns on one card, with clocks.

    python3 tools/chip_turns.py --out build/turns \\
        P=build/parent C=. C=. P=build/parent --sass build/parent .

Runs `python3 chip_smoke.py` in each checkout DIR in the order given (a
LABEL=DIR argument each; parent, change, change, parent compares two
trees on one card), while nvidia-smi samples the SM clock, power,
temperature and clock-limit reasons every 100 ms (chip_smoke.py's
ClockSampler, this checkout's). Each run's output goes to OUT/<n>-<label>
.log, every line prefixed by its host time and the medians of the samples
of the --window seconds before it (chip_smoke.py prints a family's kernel
lines after all of its timings). Then it prints, per run, its exit code
and the lines that hold times (--grep), so an older tree's timings get
the clocks its own chip_smoke.py does not sample.

--probe N, instead of the runs, times each checkout's flash_dq_streamed
and flash_dkv_streamed at (1, 8192, 32, 8, 128) non-causal, bf16, in a
process of its own, in N rounds: each after an idle gap, then right after
a burst of the kernel chip_smoke.py times just before it (the forward
before dq, dq before dk/dv), each timing beside the samples taken during
it: whether a kernel's time moves with the clock that the work before it
leaves.

--sass A B compares the SASS (cuobjdump -sass) of the libraries A's and B's
runs built, function by function, the anonymous namespace's hash taken
out of the names: which functions are identical and which differ.
Imports nothing of JAX; needs a CUDA card and the CUDA toolkit.
"""
import argparse
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the checkout's, for its clock sampler)

GREP = (r"^\[kernels\] (flash_\w+: |flash_\w+ f16: |resident kernels at|"
        r"flash_\w+ at )|^\[streamed\] attention|^\[(slice|long)\] step|"
        r"^\[summary\]|^\[done\]|^FAIL")
# The anonymous namespace in a mangled name carries a hash of its file.
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")


def _window(samples, t0, t1):
    """Medians of the samples taken in [t0, t1], as a line's prefix."""
    got = [x for x in samples if t0 <= x[0] <= t1]
    if not got:
        return "no sample"
    sm = statistics.median(x[1] for x in got)
    watts = statistics.median(x[3] for x in got)
    reasons = "/".join(sorted({x[5] for x in got}))
    return (f"SM {sm:.0f}/{max(x[2] for x in got):.0f} MHz {watts:.0f} W "
            f"{max(x[4] for x in got):.0f} C {reasons}")


# One checkout's streamed dq and dk/dv, each after an idle gap and right
# after the kernel chip_smoke.py times just before it (--probe): prints
# "<kernel> <state> <ms> <t0> <t1>", t0 and t1 on the host's monotonic
# clock.
PROBE = r'''
import sys, time, torch
sys.path.insert(0, sys.argv[1])
from skypilot_tpu_torch.ops import flash_attention as fa
b, s, h, kvh, d = 1, 8192, 32, 8, 128
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v, do = (torch.randn(*x, device="cuda", generator=g).bfloat16()
               for x in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                         (b, s, h, d)))
scale = d ** -0.5
o, lse = fa.flash_fwd_streamed(q, k, v, False, scale)
_, delta = fa.flash_dq_streamed(q, k, v, o, lse, do, False, scale)
runs = {
    "flash_fwd_streamed": lambda: fa.flash_fwd_streamed(q, k, v, False,
                                                        scale),
    "flash_dq_streamed": lambda: fa.flash_dq_streamed(q, k, v, o, lse, do,
                                                      False, scale),
    "flash_dkv_streamed": lambda: fa.flash_dkv_streamed(q, k, v, do, lse,
                                                        delta, False, scale),
}

def timed(name, reps):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        runs[name]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, t0, time.perf_counter()

for name in runs:
    timed(name, 3)
for _ in range(int(sys.argv[2])):
    for name, before in (("flash_dq_streamed", "flash_fwd_streamed"),
                         ("flash_dkv_streamed", "flash_dq_streamed")):
        time.sleep(3)
        print(name, "idle", "%f %f %f" % timed(name, 50), flush=True)
        timed(before, 100)
        print(name, "after-" + before, "%f %f %f" % timed(name, 50),
              flush=True)
'''


def probe(label, where, samples, rounds):
    """PROBE in `where`; prints each timing with the samples during it."""
    out = subprocess.run([sys.executable, "-c", PROBE, str(where),
                          str(rounds)], capture_output=True, text=True,
                         timeout=900)
    for line in out.stdout.splitlines():
        name, state, ms, t0, t1 = line.split()
        clocks = _window(samples, float(t0), float(t1))
        print(f"[probe] {label} ({where}) {name} {state}: {float(ms):.4f} "
              f"ms [{clocks}]", flush=True)
    if out.returncode:
        print(f"[probe] {label} ({where}) rc {out.returncode}: "
              f"{out.stderr[-2000:]}", flush=True)
    return out.returncode


def run(where, timeout):
    """chip_smoke.py in `where`, killed after `timeout` seconds; returns
    (exit code, [(host time, line)])."""
    proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=where,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    watchdog = threading.Timer(timeout, proc.kill)
    watchdog.start()
    lines = [(time.perf_counter(), line.rstrip("\n")) for line in proc.stdout]
    watchdog.cancel()
    return proc.wait(), lines


def sass_functions(checkout):
    """{library: {function: SASS}} of the newest build under checkout."""
    builds = sorted((checkout / "build" / "stpu_torch_kernels").glob(
        "*/libflash_fwd.so"), key=lambda p: p.stat().st_mtime)
    if not builds:
        raise RuntimeError(f"no build under {checkout}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for lib in sorted(builds[-1].parent.glob("lib*.so")):
        text = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        funcs = {}
        for part in text.split("Function : ")[1:]:
            body = _ANON.sub("", part)
            name, body = body.split(None, 1)
            funcs[name] = "\n".join(
                x for x in body.splitlines()
                if x.strip() and "identifier" not in x)
        out[lib.name] = funcs
    return out


def compare_sass(a, b):
    fa, fb = sass_functions(a), sass_functions(b)
    for lib in sorted(set(fa) | set(fb)):
        x, y = fa.get(lib, {}), fb.get(lib, {})
        same = sorted(n for n in set(x) & set(y) if x[n] == y[n])
        differ = sorted(n for n in set(x) & set(y) if x[n] != y[n])
        print(f"[sass] {lib}: {len(same)} functions identical, "
              f"{len(differ)} differ, {len(set(x) - set(y))} only in {a}, "
              f"{len(set(y) - set(x))} only in {b}", flush=True)
        for n in differ + sorted(set(x) ^ set(y)):
            print(f"[sass]   {lib} {n}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("runs", nargs="+", metavar="LABEL=DIR")
    ap.add_argument("--out", type=pathlib.Path,
                    default=REPO / "build" / "turns")
    ap.add_argument("--grep", default=GREP)
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--sass", nargs=2, type=pathlib.Path, metavar="DIR")
    ap.add_argument("--window", type=float, default=2.0)
    ap.add_argument("--probe", type=int, default=0, metavar="ROUNDS")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    pick = re.compile(args.grep)
    sampler = chip_smoke.ClockSampler()
    sampler.start()
    results = []
    try:
        if args.probe:
            checkouts = {}  # each once, under its first label
            for spec in args.runs:
                label, where = spec.split("=", 1)
                checkouts.setdefault(where, label)
            return max(probe(label, where, sampler.samples, args.probe)
                       for where, label in checkouts.items())
        for n, spec in enumerate(args.runs):
            label, where = spec.split("=", 1)
            log = args.out / f"{n}-{label}.log"
            t0 = time.perf_counter()
            rc, lines = run(where, args.timeout)
            with open(log, "w") as f:
                for t, line in lines:
                    clocks = _window(sampler.samples, t - args.window, t)
                    f.write(f"{t - t0:8.3f} [{clocks}] {line}\n")
            results.append((n, label, where, rc, log))
            print(f"[run] {n} {label} ({where}): rc {rc}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        sampler.stop()
    for n, label, where, rc, log in results:
        print(f"== {n} {label} ({where}) rc {rc}", flush=True)
        for line in log.read_text().splitlines():
            if pick.search(line.split("] ", 1)[-1]):
                print(line[:330], flush=True)
    if args.sass:
        compare_sass(*args.sass)
    return max(rc for *_, rc, _ in results)


if __name__ == "__main__":
    sys.exit(main())
