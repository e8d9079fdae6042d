#!/usr/bin/env python3
"""The flash kernels of two checkouts, timed in turns on one card.

    git archive HEAD | tar -x -C build/parent     # the parent, gitignored
    python3 tools/kernel_turns.py P=build/parent C=. C=. P=build/parent

Each LABEL=DIR argument runs, in a process of its own from that checkout
(its own sources, its own build), every Hopper kernel at chip_smoke.py's
main shapes: the resident, triangular and streamed families at head_dim
128, and at head_dims 256 and 512 the families the checkout has there
(keyed "flash_dkv_tri@512"); then the fp32 kernels (flash_fwd_f32,
flash_dq_f32, flash_dkv_f32) at its F32_TIMED_SHAPES, keyed
"flash_dq_f32@(B, S, H, KVH, D)".
Each kernel is timed over 20 launches (the fp32 kernels over 5) by CUDA
events after a warm-up, beside the median SM clock nvidia-smi sampled
during it, and the run prints one line, `TIMES {"flash_fwd": [ms, MHz],
...}`. Parent, change,
change, parent compares two trees on one card. Then, once per checkout,
the SASS instruction count of each kernel instance (cuobjdump -sass of the
libraries it built), and whether the instructions themselves are
identical across the checkouts, each branch label read as the index of
the instruction it marks within its function (cuobjdump numbers labels
across a whole library, so a change to one function renames the labels
of every function after it; a branch to another instruction still reads
as a difference); where they differ, the first pair of lines that
differs. A change to a shared body
shows there before it shows in a time.

Imports nothing of JAX; needs a CUDA card, the CUDA toolkit and the
checkouts' chip_smoke.py.
"""
import pathlib
import re
import shutil
import subprocess
import sys

CHILD = r'''
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import flash_attention as fa
_build.build_all()
shapes = [(fa.RESIDENT, cs.MAIN_SHAPE, ""),
          (fa.TRIANGULAR, cs.TRI_MAIN_SHAPE, ""),
          (fa.STREAMED, cs.STR_MAIN_SHAPE, "")]
if 256 in getattr(fa, "HEAD_DIMS", ()):
    shapes.append((fa.RESIDENT, cs.WIDE_MAIN_SHAPE, "@256"))
if hasattr(cs, "TRI_WIDE_MAIN_SHAPE"):
    shapes += [(fa.TRIANGULAR, cs.TRI_WIDE_MAIN_SHAPE, "@256"),
               (fa.STREAMED, cs.STR_WIDE_MAIN_SHAPE, "@256")]
if hasattr(cs, "X512_MAIN_SHAPE"):
    shapes += [(fa.RESIDENT, cs.X512_MAIN_SHAPE, "@512"),
               (fa.TRIANGULAR, cs.TRI_X512_MAIN_SHAPE, "@512"),
               (fa.STREAMED, cs.STR_X512_MAIN_SHAPE, "@512")]
out = {}
cs.CLOCKS.start()
try:
    for fam, shape, tag in shapes:
        b, s, h, kvh, d, causal = shape
        fns = cs.Family(fa, fam, causal, d ** -0.5)
        q, k, v, do = cs._inputs(shape, 0)
        o, lse, dq, delta, dk, dv = fns.run(q, k, v, do)
        for name, fn in zip(fns.names, (
                lambda: fns.fwd(q, k, v),
                lambda: fns.dq(q, k, v, o, lse, do),
                lambda: fns.dkv(q, k, v, do, lse, delta))):
            ms = cs.time_ms(fn, 20)
            clk = cs.CLOCKS.last()
            out[name + tag] = [round(ms, 4), clk and clk["sm_mhz"]]
        del q, k, v, do, o, lse, dq, delta, dk, dv
    for shape in getattr(cs, "F32_TIMED_SHAPES", ()):
        b, s, h, kvh, d, causal = shape
        scale = d ** -0.5
        q, k, v, do = cs._inputs(shape, 22, torch.float32)
        o, lse = fa.flash_fwd_f32(q, k, v, causal, scale)
        dq, delta = fa.flash_dq_f32(q, k, v, o, lse, do, causal, scale)
        tag = "@" + str(tuple(shape[:5])).replace(" ", "")
        for name, fn in (
                ("flash_fwd_f32", lambda: fa.flash_fwd_f32(q, k, v, causal,
                                                           scale)),
                ("flash_dq_f32", lambda: fa.flash_dq_f32(q, k, v, o, lse, do,
                                                         causal, scale)),
                ("flash_dkv_f32", lambda: fa.flash_dkv_f32(
                    q, k, v, do, lse, delta, causal, scale))):
            ms = cs.time_ms(fn, 5, warmup=1)
            clk = cs.CLOCKS.last()
            out[name + tag] = [round(ms, 4), clk and clk["sm_mhz"]]
        del q, k, v, do, o, lse, dq, delta
finally:
    cs.CLOCKS.stop()
print("TIMES", json.dumps(out), flush=True)
'''
KERNEL = re.compile(
    r"\d(flash_[a-z0-9_]+_kernel)ILi(\d+)E(?:NS_\d(Bf16|F16)E)?")


def instructions(checkout: pathlib.Path) -> dict:
    """{"kernel<D, T>": (SASS instruction count, the instructions' text
    without their addresses)} of the checkout's newest build."""
    libs = sorted((checkout / "build" / "stpu_torch_kernels").glob(
        "*/libflash_fwd.so"), key=lambda p: p.stat().st_mtime)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for lib in sorted(libs[-1].parent.glob("lib*.so")):
        text = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for part in text.split("Function : ")[1:]:
            m = KERNEL.search(part.split(None, 1)[0])
            if m:
                code = _code(part)
                tag = f", {m.group(3)}" if m.group(3) else ""
                counts[f"{m.group(1)}<{m.group(2)}{tag}>"] = (
                    len(code), "\n".join(code))
    return counts


def _code(part):
    """One function's instructions without their addresses or padding,
    each branch label (.L_x_N) replaced by the index of the instruction
    its definition line (".L_x_N:") precedes; a label defined nowhere in
    the function keeps its name."""
    code, at = [], {}
    for line in part.splitlines():
        label = re.match(r"^\s*(\.L_x_\d+):", line)
        if label:
            at[label.group(1)] = len(code)
            continue
        ins = re.match(r"^\s+/\*[0-9a-f]{4,}\*/ +(.*)$", line)
        if ins:
            # Whitespace collapsed: cuobjdump pads the columns of every
            # function in a library to the widest instruction in it.
            code.append(" ".join(ins.group(1).split()))
    return [re.sub(r"\.L_x_\d+", lambda m: (
        f".L@{at[m.group(0)]}" if m.group(0) in at else m.group(0)), line)
        for line in code]


def main() -> int:
    runs = [arg.split("=", 1) for arg in sys.argv[1:]]
    if not runs:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for label, where in runs:
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=where,
                              capture_output=True, text=True, timeout=900)
        line = [x for x in proc.stdout.splitlines() if x.startswith("TIMES")]
        print(f"{label} {where} rc {proc.returncode}: "
              f"{line[0] if line else proc.stderr[-2000:]}", flush=True)
        rc = max(rc, proc.returncode)
    seen = {}
    for label, where in runs:
        if where not in seen:
            seen[where] = instructions(pathlib.Path(where))
    for name in sorted(set().union(*seen.values())):
        got = [counts.get(name, ("-", None)) for counts in seen.values()]
        same = len({text for _, text in got}) == 1
        print(f"[sass] {name}: " + ", ".join(
            f"{where} {n}" for where, (n, _) in zip(seen, got))
            + (" (instructions identical)" if same and len(got) > 1
               else ""), flush=True)
        if not same and all(text for _, text in got):
            first = next((pair for pair in zip(*(
                text.splitlines() for _, text in got))
                if len(set(pair)) > 1), None)
            print(f"[sass]   first difference: {first}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
