"""The width-512 Hopper flash bodies' designs, built side by side and timed
in turns on one card, for tools/flash_{fwd,dq,dkv}_variants.py --width 512.

A design is a copy of csrc/ with constants of its headers set (`{name:
value}`, each `constexpr ... name = value;` that occurs once) or lines
of them replaced (`[(old, new), ...]`, each old text occurring once), or
the sources of another checkout as they are (`--parent DIR`: "parent").
A design whose name starts with "probe_" is a measurement aid, not a
candidate: it leaves out part of the work (the exchange), so its
results are wrong and it is timed without being held to the plain
versions. Every
design's three family sources are built with the port's nvcc flags, all
nvcc processes at once, each instance's ptxas line printed; `Swap` runs
the port's own wrappers on a design's libraries, so every design is
launched, held against the plain versions and timed exactly as the port
is. Imports nothing of JAX; needs a CUDA card, the CUDA toolkit and this
file's checkout.
"""
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the checkout's, for its timer and checks)
from skypilot_tpu_torch.ops import _build  # noqa: E402
from skypilot_tpu_torch.ops import flash_attention as fa  # noqa: E402

SOURCES = {fa.RESIDENT: "flash_bwd", fa.TRIANGULAR: "flash_tri",
           fa.STREAMED: "flash_streamed"}
# The forward's sources by family (the resident forward has its own).
FWD_SOURCES = {fa.RESIDENT: "flash_fwd", fa.TRIANGULAR: "flash_tri",
               fa.STREAMED: "flash_streamed"}
# Each family's width-512 main shape (chip_smoke.py's [kernels d512]).
SHAPES = ((fa.TRIANGULAR, chip_smoke.TRI_X512_MAIN_SHAPE),
          (fa.RESIDENT, chip_smoke.X512_MAIN_SHAPE),
          (fa.STREAMED, chip_smoke.STR_X512_MAIN_SHAPE))


def with_constants(text, consts):
    """`text` with each named constexpr set to its value (each must occur
    once), or with each (old, new) pair of a list replaced (each old text
    must occur once)."""
    if isinstance(consts, list):
        for old, new in consts:
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        return text
    for name, value in consts.items():
        text, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        assert n == 1, name
    return text


def is_probe(name):
    """Whether design `name` is a measurement aid (its name starts with
    "probe_"): timed, never held to the plain versions."""
    return name.startswith("probe_")


def design_dirs(designs, root, parent=None):
    """{name: csrc directory}: a patched copy of csrc/ under root/NAME per
    design ({header file: {constant: value} or [(old, new), ...]}), and
    "parent": the parent checkout's csrc/ as it is."""
    dirs = {}
    for name, headers in designs.items():
        out = root / name
        if out.exists():
            shutil.rmtree(out)
        shutil.copytree(_build.CSRC, out)
        for header, consts in headers.items():
            hdr = out / header
            hdr.write_text(with_constants(hdr.read_text(), consts))
        dirs[name] = out
    if parent is not None:
        dirs["parent"] = parent.resolve() / "skypilot_tpu_torch" / "csrc"
    return dirs


def build(dirs, root, sources, tag):
    """{name: {source: loaded library}} of every directory's `sources`,
    all nvcc runs at once; prints each instance's ptxas line whose kernel
    name holds `tag` at head_dim 512. A design that does not build is
    dropped, its compiler's output printed."""
    procs = []
    for name, src in dirs.items():
        out = root / name / "lib"
        out.mkdir(parents=True, exist_ok=True)
        for source in sources:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
                   str(out / f"lib{source}.so"), str(src / f"{source}.cu")]
            procs.append((name, source, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs, failed = {}, set()
    for name, source, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            if name in ("base", "parent"):
                raise RuntimeError(f"nvcc {name} {source} failed:\n{log}")
            print(f"[ptxas] {name} {source}: nvcc failed, design dropped:\n"
                  f"{log[-3000:]}", flush=True)
            failed.add(name)
            continue
        libs.setdefault(name, {})[source] = _build.load_library(
            out / f"lib{source}.so", source)
        print(f"[ptxas] {name} {source}: " + "; ".join(
            line for line in chip_smoke._ptxas_summary(log)
            if tag in line and "<512" in line), flush=True)
    return {name: lib for name, lib in libs.items() if name not in failed}


class Swap:
    """The port's wrappers on other libraries within the block."""

    def __init__(self, libs):
        self.libs = libs

    def __enter__(self):
        self.saved = {s: _build._LIBS.get(s) for s in self.libs}
        _build._LIBS.update(self.libs)

    def __exit__(self, *exc):
        _build._LIBS.update(self.saved)


def runs_for(libs, source):
    """{"base": the checkout's own build, name: that design's library of
    `source`, ...}."""
    runs = {"base": Swap({})}
    runs.update((name, Swap({source: lib[source]}))
                for name, lib in libs.items())
    return runs


def turns(label, runs, fn, rounds, reps, bound_ms):
    """Times fn() under each run's libraries in turns (the runs, then
    reversed, each round), each timing beside the SM clock; prints each
    median against the base and the bound; returns the readings."""
    times = {name: [] for name in runs}
    clocks = {name: [] for name in runs}
    for _ in range(rounds):
        for name in list(runs) + list(runs)[::-1]:
            with runs[name]:
                times[name].append(chip_smoke.time_ms(fn, reps))
            clk = chip_smoke.CLOCKS.last()
            clocks[name].append(clk and clk["sm_mhz"])
    med = {name: statistics.median(ts) for name, ts in times.items()}
    for name, ts in times.items():
        print(f"[design] {label} {name}: median {med[name]:.4f} ms "
              f"({med[name] / med['base']:.3f}x base, "
              f"{bound_ms / med[name]:.1%} of the {bound_ms:.4f} ms bound; "
              f"turns {[round(x, 4) for x in ts]}; SM MHz {clocks[name]})",
              flush=True)
    return {"ms": med, "turns": times, "sm_mhz": clocks}
