"""The benchmark harness: one run of one cell.

Everything is found by name from BENCHMARK.json at the checkout's root:
  * the configuration's file (`configs[].file`, a scene description);
  * the traffic mix, benchmark/traffic/<traffic>.json, whose `loop` names
    the general driver in benchmark/loops/<loop>.py that reads it;
  * each per-layer metric's reader, benchmark/metrics/<name>.py, whose
    `read(ctx)` returns the value or None (the metric is then left out);
  * the cell's correctness limits, benchmark/limits/<workload>.json.
A later cell, traffic mix or metric is new files; nothing here changes.

The run: set-up (scene build, warm-up) from process start to the window's
start, less the reference's own seconds in it, is `setup_s`; the loop
measures its window of `--seconds`; with `--trace 1` it then goes on
under the profiler for the traffic's `trace_seconds` and the per-layer
metrics are read from that.  After the window the peak memory is read,
the program's state is freed, the import guard looks at sys.modules, and
the plain reference decides `correct`.  The last stdout line is the
result; the numbers compared are printed beside their limits as the last
lines of stderr and, last, in the result.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import guard
from .reference import scene as ref_scene



class Refused(Exception):
    """The run cannot be made: nothing is printed on stdout."""


@dataclass
class Context:
    """What a loop and the metric readers see of one run."""

    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    desc: object = None
    tables: object = None
    spans: dict = field(default_factory=dict)
    split: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)
    trace_data: object = None
    device: object = None
    clock: object = time.perf_counter

    @contextlib.contextmanager
    def span(self, name: str):
        """Host seconds of the block, appended to spans[name]; the block
        ends its device work itself where that counts."""
        t = self.clock()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(self.clock() - t)

    def open_window(self) -> float:
        """Set-up ends here; returns the window's start on the host clock.
        The reference's seconds in set-up (spans named `reference_*`, such
        as a target it renders) are not the program's and are left out
        of setup_s."""
        t = self.clock()
        ref = sum(sum(v) for k, v in self.spans.items()
                  if k.startswith("reference_"))
        self.split["reference_in_setup_s"] = ref
        self.split["setup_s"] = t - self.t_start - ref
        return t

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        """Wait for the device's queued work (nothing to wait for on the
        CPU, where the tests drive a run)."""
        if self.on_card:
            import torch

            torch.cuda.synchronize()

    def rng(self, stream: int) -> np.random.Generator:
        """A NumPy generator of this run's seed, one stream per use."""
        return np.random.default_rng([self.seed, stream])


def load_manifest(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise Refused(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def find(manifest: dict, workload: str):
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise Refused(f"unknown workload {workload!r}; the manifest has "
                      f"{sorted(cells)}")
    cell = cells[workload]
    cfgs = {c["name"]: c for c in manifest["configs"]}
    return cell, cfgs[cell["config"]]


def metrics_for(manifest: dict, key: str, workload: str) -> list:
    """The manifest's `key` metrics that this cell reports."""
    return [m for m in manifest[key]
            if "workloads" not in m or workload in m["workloads"]]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_identity(device, count: int, peak_bytes: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number against its limit (a number passes at or below it);
    a number missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": None if v is None else float(v),
                        "limit": float(limit)}
    return ok, checks


def run(args, t_start: float, root: Path, device=None,
        on_context=None, clock=time.perf_counter) -> dict:
    """One run of the cell; returns the result line's object.  `device`
    is for the CPU tests alone: without it the run needs the cards the
    cell asks for.  `on_context(ctx)`, where given, sees the run's
    Context before the loop starts (benchmark/faults.py); `clock` is the
    host clock every span and window reads (a test injects its own)."""
    import torch

    manifest = load_manifest(root)
    cell, cfg_entry = find(manifest, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device is available")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"the cell asks for {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} are visible")
        device = torch.device("cuda")
    bench = root / "benchmark"
    try:
        import rtm_tpu_torch  # noqa: F401  the system under test
    except ImportError as e:
        raise Refused(f"the program (rtm_tpu_torch) is not here: {e}")
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((bench / "limits" / f"{cell['name']}.json")
                        .read_text())
    ctx = Context(traffic=traffic, limits=limits, seed=args.seed,
                  seconds=float(args.seconds),
                  trace=bool(args.trace), t_start=t_start,
                  device=torch.device(device), clock=clock)
    if ctx.on_card:
        torch.empty(1, device=ctx.device)       # the CUDA context
    ctx.split["interpreter_and_cuda_s"] = clock() - t_start
    ctx.desc = ref_scene.describe(config)
    ctx.tables = ref_scene.build_tables(ctx.desc)
    if on_context is not None:
        on_context(ctx)
    loop = load_module(bench / "loops" / f"{traffic['loop']}.py",
                       f"benchmark_loop_{traffic['loop']}")
    out = loop.run(ctx)

    ctx.sync()
    peak = torch.cuda.max_memory_allocated() if ctx.on_card else 0
    out.release()
    if ctx.on_card:
        torch.cuda.empty_cache()

    t = clock()
    numbers = out.check()
    ctx.split["check_s"] = clock() - t
    correct, checks = judge(numbers, limits["limits"])

    metrics = {}
    if not ctx.trace:
        values = dict(out.e2e, setup_s=ctx.split["setup_s"],
                      peak_mib=peak / 2**20)
        for m in metrics_for(manifest, "end_to_end", cell["name"]):
            if m["name"] not in values:
                raise RuntimeError(f"the cell reports no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in metrics_for(manifest, "per_layer", cell["name"]):
            reader = load_module(bench / "metrics" / f"{m['name']}.py",
                                 "benchmark_metric_" + m["name"].replace(
                                     ".", "_"))
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = device_identity(ctx.device, cell["chips"], peak)
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics,
              "device": device}
    if ctx.trace:
        tr = ctx.trace_data
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    print(json.dumps({"setup_split": ctx.split, "work": ctx.work,
                      "card": power_limit() if ctx.on_card else "cpu",
                      "spans": {k: [len(v), sum(v)] for k, v in
                                ctx.spans.items()}}), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    result["checks"] = checks
    found = guard.forbidden_modules()
    if found:
        raise Refused("modules of JAX or the JAX package are loaded: "
                      + ", ".join(found))
    return result


def p95(xs) -> float:
    """The 95th percentile of all samples (statistics' exclusive
    method over n+1 quantiles)."""
    return statistics.quantiles(xs, n=20)[-1]
