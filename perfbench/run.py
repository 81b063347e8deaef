"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from ``BENCHMARK.json``, its configuration and traffic from
the files named there, builds the program under test from the seed, warms
it up (set-up), measures for ``--seconds``, checks what the timed path
produced against the plain reference under ``perfbench/reference``, and
prints one JSON line: the end-to-end metrics (``--trace 0``) or the
per-layer ones read from a profiler trace (``--trace 1``).

``--readings s1,s2,...`` instead prints, for each seed, the numbers the
comparison reads from the program, from the reference computed in TF32
(the control) and, for training, from the reference on half the batch (a
fault): the readings the limits in ``limits/`` were set from.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, is where packages are found
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
sys.path.insert(0, str(ROOT))

from perfbench import core  # noqa: E402

# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(ROOT / "build" / "perfbench" / _sub)


def _reader(cell, name: str):
    return core.load_module(cell.bench_dir / "metrics" / f"{name}.py",
                            f"perfbench.metrics.{name}")


def _device_info(device, cell) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell.chips}


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def make_job(cell, seed, seconds, trace, device, process_start) -> SimpleNamespace:
    """What a traffic kind is given; ``mark(name)`` notes the time since
    the process started at the end of a phase of set-up."""
    job = SimpleNamespace(cell=cell, seed=seed, seconds=seconds, trace=trace,
                          device=device, process_start=process_start, marks=[])
    job.mark = lambda name: job.marks.append(
        (name, time.time() - process_start))
    return job


def execute(cell, seed: int, seconds: float, trace: bool, device,
            process_start: float):
    """One run of ``cell``: (result without ``checks``, checks)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(seed)
    kind = importlib.import_module(f"perfbench.kinds.{cell.traffic['kind']}")
    job = make_job(cell, seed, seconds, trace, device, process_start)
    job.mark("imports")
    out = kind.run(job)
    sys.stderr.write("set-up, s since the process started: " + ", ".join(
        f"{name} {t:.2f}" for name, t in job.marks) + "\n")
    correct, checks = core.judge(out.readings, cell.limits)
    device_info = _device_info(device, cell)
    device_info["memory_peak_bytes"] = int(out.memory_peak_bytes)
    result = {"correct": correct, "attempted": int(out.attempted),
              "failed": sum(1 for c in checks.values()
                            if c["value"] is None or c["limit"] is None
                            or not c["value"] <= c["limit"])}
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        values = dict(out.end_to_end, setup_s=out.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = out.layer
        ctx.trace = (core.Trace(ctx.window.prof, "perfbench.window")
                     if ctx.window.prof is not None else None)
        ctx.peak = None
        ctx.precision = cell.config.get("precision", "float32")
        if device_info["platform"] == "gpu":
            from perfbench.yardstick import peaks

            ctx.peak = peaks(device_info["kind"])
        for m in cell.per_layer:
            value = _reader(cell, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        if ctx.trace is not None:
            device_info["busy_s"] = ctx.trace.busy_s
            device_info["window_s"] = ctx.trace.window_s
            result["breakdown"] = {
                "device_ops": [list(x) for x in ctx.trace.device_ops()],
                "idle_gaps": [list(x) for x in ctx.trace.idle_gaps()]}
    if device_info["platform"] == "gpu":
        device_info["power_limit"] = _power_limit()
    result["metrics"] = metrics
    result["device"] = device_info
    # the breakdown is optional; the keys the driver reads come first
    result = {k: result[k] for k in ("correct", "attempted", "failed", "metrics",
                                     "device", "breakdown") if k in result}
    return result, checks


def readings(cell, seeds, seconds: float, device, process_start: float) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = importlib.import_module(f"perfbench.kinds.{cell.traffic['kind']}")
    for seed in seeds:
        torch.manual_seed(seed)
        job = make_job(cell, seed, seconds, False, device, process_start)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          **kind.control_readings(job)}), flush=True)


def main(argv=None) -> int:
    process_start = core.process_start_wall()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings", default="",
                    help="comma-separated seeds: print the comparison's "
                         "readings of the program, the control and the faults")
    args = ap.parse_args(argv)

    cell = core.Cell(core.load_spec(), args.workload)
    if importlib.util.find_spec("slotformer_tpu_torch") is None:
        sys.stderr.write("the program under test (slotformer_tpu_torch) is not "
                         "in this checkout\n")
        return 4
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"{cell.name} needs {cell.chips} CUDA device(s); "
                         f"found {torch.cuda.device_count()}\n")
        return 2
    device = torch.device("cuda", 0)
    if args.readings:
        readings(cell, [int(s) for s in args.readings.split(",")], args.seconds,
                 device, process_start)
        return 0
    result, checks = execute(cell, args.seed, args.seconds, bool(args.trace),
                             device, process_start)
    banned = core.banned_modules()
    if banned:
        sys.stderr.write(f"modules that may not be loaded: {banned}\n")
        return 3
    core.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
