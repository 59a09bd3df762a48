#!/usr/bin/env python3
"""Run one cell of the benchmark of ``dna_ldpc_tpu_torch`` once.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell's entry
there names its configuration (``configs/<config>.json``, which names its
driver, ``drivers/<driver>.py``) and its traffic mix
(``traffic/<traffic>.json``); each per-layer metric is read by
``metrics/<metric>.py``. A cell, a mix, a configuration or a metric is
added by adding those files and entries: this file needs no edit.

A run: set-up (imports, the program's kernels loaded, inputs made from
``--seed``, one warm-up unit of the cell's traffic) -> the measured window
(units back to back until ``--seconds`` have passed; the last unit that
starts inside the window finishes and counts) -> the check of ``correct``
against the plain reference under ``reference/`` -> one JSON line, the
last of standard output. With ``--trace 1`` the window runs under
``torch.profiler`` and the line holds the per-layer metrics instead of the
end-to-end ones. With ``--control`` the drivers put the plain reference,
one precision below the configuration's, in the program's place before
the same check: the control of ``correct``, which must read false (the
benchmark's own runs never pass it). Without a CUDA device, or with fewer than the cell asks
for, it exits 3 and prints no result; if JAX or the JAX package is loaded
once the window has closed, it exits 4 and prints no result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "dna_ldpc_tpu")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(repo: str = REPO) -> dict:
    with open(os.path.join(repo, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(spec: dict, workload: str, bench_dir: str = BENCH_DIR):
    """(cell entry, configuration dict, traffic dict) of ``workload``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"run.py: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(os.path.dirname(bench_dir), cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``dna_ldpc_tpu_torch`` is the port, not the package)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def per_layer_for(spec: dict, cell: str) -> list[dict]:
    return [m for m in spec["per_layer"] if "workloads" not in m or cell in m["workloads"]]


def end_to_end_for(spec: dict, cell: str) -> list[dict]:
    return [m for m in spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def run(argv=None, device: str | None = None, repo: str = REPO, bench_dir: str = BENCH_DIR) -> int:
    """One run; returns the exit code. ``device`` other than None skips
    the look for a CUDA device and runs there (the CPU tests do)."""
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="put the plain reference, one precision below the configuration's, in the program's place "
                        "before the check (the control of correct, which must read false)")
    args = p.parse_args(argv)
    t_start = T_START if argv is None else time.time()

    spec = load_spec(repo)
    cell, config, traffic = resolve(spec, args.workload, bench_dir)
    chips = int(cell["chips"])

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"run.py: the cell needs {chips} CUDA device(s), {n} found", file=sys.stderr)
            return 3
        device = "cuda:0"
        kind = torch.cuda.get_device_name(0)
        print(f"card: {card_line()}", file=sys.stderr)
        torch.cuda.reset_peak_memory_stats(0)
    else:
        kind = torch.device(device).type
    on_card = torch.device(device).type == "cuda"

    from benchlib.records import Records

    rec = Records(traced=bool(args.trace))
    rec.counters["kind"] = kind
    driver_mod = load_module(os.path.join(bench_dir, "drivers", f"{config['driver']}.py"),
                             f"bench_driver_{config['driver']}")
    drv = driver_mod.Driver(config, traffic, args.seed, device, rec)
    info = drv.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    for k, v in info.items():
        print(f"setup {k}: {v}", file=sys.stderr)
    print(f"setup_s {setup_s:.4f}", file=sys.stderr)

    trace_path = os.path.join(bench_dir, ".cache", "trace", f"{args.workload}.json")
    prof = None
    if args.trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    t0 = time.time()
    with rec.span("bench.window"):
        while True:
            drv.unit()
            if time.time() - t0 >= args.seconds:
                break
        if on_card:
            torch.cuda.synchronize()
    elapsed = time.time() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated(0) if on_card else 0
    rec.restore()
    if prof is not None:
        from benchlib.trace import Trace

        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        prof.export_chrome_trace(trace_path)
        del prof
        try:
            rec.trace = Trace.load(trace_path)
        finally:
            os.remove(trace_path)

    e2e = drv.end_to_end(elapsed)
    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    if args.control:
        print(f"control: {drv.control()}", file=sys.stderr)
    checks = drv.check()
    found = forbidden_modules()
    if found:
        print(f"run.py: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 4

    metrics = {}
    if args.trace:
        for m in per_layer_for(spec, args.workload):
            reader = load_module(os.path.join(bench_dir, "metrics", f"{m['name']}.py"), f"bench_metric_{m['name']}")
            value = reader.read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in end_to_end_for(spec, args.workload):
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": chips,
                   "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": int(drv.attempted), "failed": int(drv.failed),
              "metrics": metrics, "device": device_info}
    if rec.trace is not None:
        device_info["busy_s"] = rec.trace.busy_s()
        device_info["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.top_ops(10), "idle_gaps": rec.trace.idle_gaps(10)}
    if args.control:
        result["control"] = True
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r}){' FAIL' if c['value'] > c['limit'] else ''}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [BENCH_DIR, REPO]   # the benchmark's modules, then the program at the checkout's root
    sys.exit(run())
