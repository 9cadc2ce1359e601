#!/usr/bin/env python3
"""Time the mxu kernel at chip_smoke.py's [main] and [wide] shapes, as
built and in variants of its source, on one CUDA card.

    python3 mxu_variants.py [--tree DIR] [--variants base,pair2,minblocks2]

--tree is the checkout whose rtm_tpu_torch is timed (default: the one
beside this file), so one command can time a parent checkout and this one
in turns.  Each variant is that tree's csrc/mxu_trace.cu with a text edit,
built with the tree's nvcc flags into rtm_tpu_torch/_build/variants/ (all
variants compiled in parallel) and launched through the tree's own
`mxu_trace` wrapper.  Variants:

  base         the source as it is
  pair2        the pair pass run twice over every chunk a block passed (the
               second pass finds the same minimum, so the rays' paths and
               every output stay the same): pair2 - base is the pair pass's
               own time where the two builds report the same registers and
               spills; elsewhere the script prints no share, since the
               difference then also measures register allocation.  It
               knows the tensor-core sweep and, for timing a checkout from
               before it, the per-thread FP32 loop.
  minblocksN   __launch_bounds__ with N blocks per SM (MIN_BLOCKS = N)
  blockN       N threads per block (BLOCK = N); the wrapper's BLOCK, the
               plain version's cull granule, follows the build
  a+b          both edits, e.g. block128+minblocks6

Every variant's outputs must equal the base's bitwise (hitrec, color,
miss, rec).  The cells are timed in 3 interleaved rounds of CUDA events
(20 launches a round on [main], 5 on [wide]); the script prints each
round and the median per (variant, cell), the card's nvidia-smi name and
power limit, and one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROUNDS = 3
REPS = {"main": 20, "wide": 5}

# the pair pass of each kernel generation, run twice; the trip count is
# hidden from the compiler so it cannot fold the second pass away
_TWICE = "int reps_ = 2; asm volatile(\"\" : \"+r\"(reps_));"
PAIR2 = (
    # the tensor-core sweep (per passed chunk)
    (re.compile(r"^(\s*)(sweep_chunk\(p, [^;]*\);)$", re.M),
     r"\1{ " + _TWICE.replace("\\", "\\\\")
     + r" for (int r_ = 0; r_ < reps_; ++r_) \2 }"),
    # the per-thread FP32 loop of the kernel before it
    (re.compile(r"^(\s*)(for \(int t = 0; t < t_end; \+\+t\) \{)$", re.M),
     r"\1" + _TWICE.replace("\\", "\\\\")
     + r" for (int r_ = 0; r_ < reps_; ++r_) \2"),
)
MIN_BLOCKS = re.compile(r"constexpr int MIN_BLOCKS = \d+;")
BLOCK = re.compile(r"constexpr int BLOCK = \d+;")


def variant_source(src: str, name: str) -> str:
    if name == "base":
        return src
    if name == "pair2":
        for pat, rep in PAIR2:
            out, k = pat.subn(rep, src)
            if k:
                return out
        raise SystemExit("mxu_variants: no pair pass found to repeat")
    if "+" in name:
        for part in name.split("+"):
            src = variant_source(src, part)
        return src
    for pat, key in ((MIN_BLOCKS, "minblocks"), (BLOCK, "block")):
        m = re.fullmatch(key + r"(\d+)", name)
        if m:
            out, k = pat.subn(pat.pattern.replace(r"\d+", m[1]), src)
            if k != 1:
                raise SystemExit(f"mxu_variants: no {key} constant")
            return out
    raise SystemExit(f"mxu_variants: unknown variant {name}")


def build_variants(build, names):
    """Compile each variant of csrc/mxu_trace.cu (in parallel); returns
    {name: (library path, ptxas lines, BLOCK)}."""
    src = (build.CSRC / "mxu_trace.cu").read_text()
    jobs = {}
    for name in names:
        vsrc = variant_source(src, name)
        block = int(re.search(r"constexpr int BLOCK = (\d+);", vsrc)[1])
        d = build.BUILD_DIR / "variants" / name
        if d.exists():
            shutil.rmtree(d)
        (d / "csrc").mkdir(parents=True)
        for h in build.CSRC.glob("*.cuh"):
            shutil.copy(h, d / "csrc" / h.name)
        (d / "csrc" / "mxu_trace.cu").write_text(vsrc)
        lib = d / "libmxu_trace.so"
        log = open(d / "build.log", "w")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
               str(d / "csrc" / "mxu_trace.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT), lib, log,
                      block)
    out = {}
    for name, (proc, lib, log, block) in jobs.items():
        rc = proc.wait()
        log.close()
        text = Path(log.name).read_text()
        if rc != 0:
            raise SystemExit(f"mxu_variants: nvcc failed for {name}:\n{text}")
        out[name] = (lib, [ln.strip() for ln in text.splitlines()
                           if "registers" in ln or "spill" in ln], block)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--variants", default="base,pair2")
    args = ap.parse_args()
    names = args.variants.split(",")
    if names[0] != "base":
        names.insert(0, "base")

    import torch
    if not torch.cuda.is_available():
        print("mxu_variants: no CUDA device is available", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import rtm_tpu_torch
    if Path(rtm_tpu_torch.__file__).resolve().parent != tree / "rtm_tpu_torch":
        print(f"mxu_variants: no rtm_tpu_torch package in {tree}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from rtm_tpu_torch import (Camera, RenderConfig, build_tracer_scene,
                               load_scene)
    from rtm_tpu_torch.models.scenes import dragon_grid
    from rtm_tpu_torch.ops.kernels import build
    from rtm_tpu_torch.ops.kernels import mxu_kernel as mk
    from rtm_tpu_torch.ops.kernels.megakernel import _pack_camera

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build_variants(build, names)
    for name, (_, lines, _) in libs.items():
        for ln in lines:
            print(f"[variants] {name}: {ln}", flush=True)

    per_dragon = dragon_grid(1).meshes[0].num_triangles
    grid_k = max(1, int((mk.MAX_TRIS / per_dragon) ** 0.5))
    cells = {"main": build_tracer_scene(load_scene(3)),
             "wide": build_tracer_scene(dragon_grid(grid_k))}
    res = 512
    cfg = RenderConfig(width=res, height=res, max_bounces=8, max_frames=1,
                       draw_environment=True, accumulate=True)
    n = res * res
    loaded = {name: ctypes.CDLL(str(lib)) for name, (lib, _, _)
              in libs.items()}

    def launch(name, scene, camf, tabs, hitrec=False):
        mk.load_kernel_library = lambda _k: loaded[name]
        mk.BLOCK = libs[name][2]
        return mk.mxu_trace(scene, tabs, camf, 1, 0, n, cfg,
                            return_hitrec=hitrec)

    ok = True
    times = {name: {c: [] for c in cells} for name in names}
    for cell, scene in cells.items():
        camf = _pack_camera(Camera().spec(res, res), scene.device)
        tabs = mk.side_tables(scene)
        ref = launch("base", scene, camf, tabs, True)
        for name in names[1:]:
            got = launch(name, scene, camf, tabs, True)
            same = all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(ref, got))
            if not same:
                print(f"[variants] FAIL {name} {cell}: outputs differ from "
                      f"base", flush=True)
                ok = False
        for _ in range(ROUNDS):
            for name in names:
                launch(name, scene, camf, tabs)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(REPS[cell]):
                    launch(name, scene, camf, tabs)
                end.record()
                torch.cuda.synchronize()
                times[name][cell].append(start.elapsed_time(end)
                                         / REPS[cell])
    summary = {}
    for name in names:
        for cell in cells:
            t = sorted(times[name][cell])
            med = t[len(t) // 2]
            summary.setdefault(name, {})[cell] = med
            print(f"[variants] tree={tree.name} {name} {cell} "
                  f"tris={cells[cell].num_triangles} kernel_ms="
                  f"{[round(x, 4) for x in times[name][cell]]} "
                  f"median={med:.4f}", flush=True)
    if "pair2" in summary:
        alike = libs["pair2"][1] == libs["base"][1]
        for cell in cells:
            b, p2 = summary["base"][cell], summary["pair2"][cell]
            share = (f"share {(p2 - b) / b:.3f}" if alike else
                     "no share: the builds' registers or spills differ")
            print(f"[variants] tree={tree.name} {cell} pair pass "
                  f"{p2 - b:.4f} ms of {b:.4f} ms: {share}", flush=True)
    print(f"[variants] {card}", flush=True)
    print(json.dumps({"tree": str(tree), "card": card, "median_ms": summary,
                      "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
