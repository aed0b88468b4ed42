#!/usr/bin/env python3
"""The benchmark of paffy_tpu_torch on one NVIDIA GPU: one cell of
BENCHMARK.json (a configuration under a traffic mix) per run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Set-up: imports, the kernel library (built
by nvcc into paffy_tpu_torch/_build/ on a checkout's first run), the
cell's inputs made from the seed by the builder its configuration names
(``inputs``, e.g. perfbench/synth.py's) and written to a directory of its
own under TMPDIR, the set-up of the jobs its traffic mix names (``job``,
e.g. perfbench/jobs.py's) and one warm job of each job key.  Then a closed loop
with one client runs jobs back to back until ``--seconds`` have passed
(the job in flight at the deadline finishes).  With ``--trace 1`` the
first jobs of the window (the mix's ``trace_jobs``) run under
torch.profiler.  After the window the program's state is freed, and the
plain reference the mix names (``reference``, e.g. perfbench/reference.py)
works out every job key's bytes: each job's output must equal them, byte
for byte.  Whatever a configuration, mix or metric brings is found by
name: a new one is new files, never an edit here.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (jobs run, the warm ones too), ``failed`` (jobs that
raised), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones, each read by perfbench/metrics/<name>.py),
``device``, with ``--trace 1`` ``breakdown``, ``launches`` (each
kernel's launches in the window), and last ``compared``: each
number compared with its limit, also the last lines on standard error.
Exit codes: 0 with a result; 2 for bad arguments; 3 without a usable
CUDA device; 4 when jax, jaxlib, flax or paffy_tpu was imported; 1 for
anything else, with no result line.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules that may not be loaded in a run (compared by top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "paffy_tpu")
# build and kernel caches of the program, at fixed places in the checkout
CACHE = os.path.join(ROOT, ".bench_cache")


def process_start() -> float:
    """time.time() at this process's start (Linux), else now."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lookup(name: str):
    """The object ``module:attribute`` names, the module found on the
    benchmark's path."""
    mod, attr = name.split(":")
    return getattr(importlib.import_module(mod), attr)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """A cell of the benchmark file, with its configuration, traffic mix and
    metrics, found by the names in it."""

    def __init__(self, workload: str, config: dict | None = None):
        with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
            bench = json.load(fh)
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.spec = cells[workload]
        self.name = workload
        conf = {c["name"]: c for c in bench["configs"]}[self.spec["config"]]
        if config is None:
            with open(os.path.join(ROOT, conf["file"])) as fh:
                config = json.load(fh)
        self.config = config
        with open(os.path.join(HERE, "traffic",
                               self.spec["traffic"] + ".json")) as fh:
            self.mix = json.load(fh)

        def mine(m):
            return workload in m.get("workloads", [workload])
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


class Job:
    __slots__ = ("key", "start", "end", "digest", "error", "phases",
                 "launches", "spans", "traced")

    def __init__(self, key):
        self.key, self.digest, self.error = key, None, None
        self.phases, self.launches, self.spans = {}, {}, {}
        self.traced = False

    @property
    def wall(self) -> float:
        return self.end - self.start


def run_job(traffic, key, phases, kernels, sync) -> Job:
    job = Job(key)
    phases.reset()
    kernels.reset_launch_counts()
    traffic.span_s.clear()
    job.start = time.perf_counter()
    try:
        job.digest = traffic.run(key)
        sync()
    except Exception as e:                      # counted as failed
        job.error = f"{type(e).__name__}: {e}"
    job.end = time.perf_counter()
    job.phases = dict(phases.SECONDS)
    job.launches = dict(kernels.LAUNCHES)
    job.spans = dict(traffic.span_s)
    return job


def gpu_card() -> dict:
    """The card's name, power limit and clocks from nvidia-smi (empty
    where it does not run)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        name, limit, sm, sm_max = [x.strip() for x in
                                   out.strip().splitlines()[0].split(",")]
        return {"name": name, "power_limit_w": float(limit),
                "sm_clock_mhz": float(sm), "sm_clock_max_mhz": float(sm_max)}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             require_cuda: bool = True, config: dict | None = None,
             fault=None) -> tuple[int, dict]:
    """One run of a cell: (exit code, result).  ``require_cuda`` False (the
    tests) runs on whatever device the program is given; ``config``
    replaces the cell's configuration file; ``fault(traffic)`` (the tests
    and perfbench/control.py) is called once the program is imported and
    the jobs are built, before their set-up, to break the timed path or to
    put the control in the program's place."""
    cell = Cell(workload, config=config)
    for p in (ROOT, HERE):          # the program, then the benchmark
        if p not in sys.path:
            sys.path.insert(0, p)
    for k, v in cell.mix.get("env", {}).items():
        os.environ[k] = str(v)
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        os.environ.setdefault(k, os.path.join(CACHE, k.lower()))
    marks = [("start", T_START)]

    def mark(what):
        marks.append((what, time.time()))
    import torch
    mark("torch imported")
    cuda = torch.cuda.is_available() and torch.cuda.device_count() > 0
    if require_cuda and (not cuda or torch.cuda.device_count()
                         < cell.spec["chips"]):
        log(f"no usable CUDA device: available {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} device(s), the cell asks for "
            f"{cell.spec['chips']}")
        return 3, {}
    from paffy_tpu_torch import devconf, kernels, native, phases
    dev = devconf.device()
    on_gpu = dev.type == "cuda"
    if on_gpu:
        torch.zeros(1, device=dev)
        mark("CUDA context")
        kernels.load()
    native.get_lib()
    mark("kernel and host libraries")
    card = gpu_card() if on_gpu else {}
    workdir = tempfile.mkdtemp(prefix=f"perfbench-{workload}-")
    try:
        inputs = lookup(cell.config["inputs"])(cell.config, seed, workdir)
        mark("inputs made and written")
        traffic = lookup(cell.mix["job"])(cell.mix, inputs, seed, workdir)
        if fault is not None:
            fault(traffic)
        traffic.prepare()
        mark("traffic set up")

        def sync():
            if on_gpu:
                torch.cuda.synchronize()
        done = [run_job(traffic, k, phases, kernels, sync)
                for k in traffic.job_keys]           # the warm jobs
        mark("warm jobs")
        t_window = time.time()
        setup_s = t_window - T_START
        log("set-up: " + ", ".join(f"{w} {b - a:.3f} s" for (_, a), (w, b)
                                   in zip(marks, marks[1:])))
        window, prof, spans = [], None, None
        keys = traffic.keys()
        n_trace = int(cell.mix["trace_jobs"]) if trace else 0
        if trace:
            from torch.profiler import ProfilerActivity, profile
            from torch.profiler import record_function
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_gpu else [])
            prof = profile(activities=acts)
            traffic.record = record_function
        w0 = time.perf_counter()
        deadline = w0 + seconds
        while True:
            key = next(keys)
            if len(window) == 0 and prof is not None:
                prof.start()
            if len(window) < n_trace:
                with traffic.record("job"):
                    job = run_job(traffic, key, phases, kernels, sync)
                job.traced = True
            else:
                job = run_job(traffic, key, phases, kernels, sync)
            window.append(job)
            if prof is not None and len(window) == n_trace:
                prof.stop()
                traffic.record = None
                spans = _trace_of(prof, workdir)
                prof = None
            if job.end >= deadline and len(window) >= max(n_trace, 1):
                break
        window_s = window[-1].end - w0
        peak = torch.cuda.max_memory_allocated(dev) if on_gpu else 0
        done += window
        traffic.release()
        del traffic
        gc.collect()
        if on_gpu:
            torch.cuda.empty_cache()

        log(f"window: {len(window)} jobs in {window_s:.3f} s, walls "
            + " ".join(f"{j.wall:.3f}" for j in window))
        per = {}
        for j in window:
            for n, v in list(j.phases.items()) + list(j.spans.items()):
                per[n] = per.get(n, 0.0) + v / len(window)
        log("seconds per job: " + ", ".join(
            f"{n} {v:.4f}" for n, v in sorted(per.items(),
                                             key=lambda x: -x[1])))
        # the check: every job's bytes against the plain reference's
        t_ref = time.perf_counter()
        fn = lookup(cell.mix["reference"])
        keys_used = sorted({j.key for j in done})
        expected, work = fn(inputs["records"][cell.mix["input"]],
                            inputs["seqs"], keys_used)
        want = {k: hashlib.sha256(v).hexdigest() for k, v in expected.items()}
        log(f"reference: {time.perf_counter() - t_ref:.3f} s")
        failed = [j for j in done if j.error is not None]
        wrong = [j for j in done if j.error is None and j.digest != want[j.key]]
        compared = {"jobs_failed": {"value": len(failed), "limit": 0},
                    "jobs_differing": {"value": len(wrong), "limit": 0}}
        correct = not failed and not wrong
        for j in failed[:3]:
            log(f"job {j.key} failed: {j.error}")

        run = RunData(cell=cell, jobs=window, window_s=window_s,
                      setup_s=setup_s, work=work, inputs=inputs,
                      spans=spans, card=card, device=dev)
        specs = cell.per_layer if trace else cell.end_to_end
        metrics = {}
        for m in specs:
            reader = load_module(os.path.join(HERE, "metrics",
                                              m["name"] + ".py"),
                                 "metric_" + m["name"].replace(".", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = {"platform": "gpu" if on_gpu else dev.type,
                  "kind": (torch.cuda.get_device_name(dev) if on_gpu
                           else "cpu"),
                  "count": 1, "memory_peak_bytes": int(peak)}
        result = {"correct": correct, "attempted": len(done),
                  "failed": len(failed), "metrics": metrics,
                  "device": device}
        if trace:
            device["busy_s"] = spans["busy_s"] if spans else 0.0
            device["window_s"] = spans["window_s"] if spans else 0.0
            if spans:
                result["breakdown"] = spans["breakdown"]
        launches = {}
        for j in window:
            for k, v in j.launches.items():
                launches[k] = launches.get(k, 0) + v
        log("launches in the window: " + ", ".join(
            f"{k} {v}" for k, v in sorted(launches.items())))
        result["launches"] = launches
        result["card"] = card
        result["window"] = {"jobs": len(window), "window_s": window_s,
                            "setup_s": setup_s}
        result["compared"] = compared
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 4, {}
    for name, c in compared.items():
        log(f"compared {name}: {c['value']} (limit {c['limit']})")
    return 0, result


class RunData:
    """What a metric's reader reads: the cell, its window's jobs (key,
    wall, phases, launches), the window's and set-up's seconds, the work
    of each job key as the reference counted it, the inputs, the parsed
    device trace (``--trace 1``), the card and the device."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _trace_of(prof, workdir) -> dict:
    import devtrace
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return devtrace.summarize(path)
    finally:
        os.remove(path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        rc, result = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace))
    except Exception:
        import traceback
        traceback.print_exc()
        return 1
    if rc != 0:
        return rc
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
