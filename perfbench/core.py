"""The benchmark's general parts: the specification (``BENCHMARK.json``
and the files it names), the seeded weights and inputs, the reduction of a
profiler trace, and the result line.

Nothing here imports the program under test.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in a run's process
BANNED_MODULES = ("jax", "jaxlib", "flax", "slotformer_tpu")


# ----------------------------------------------------------------- spec
class Cell:
    """One entry of ``workloads`` with its configuration and traffic files
    read, and the metrics ``BENCHMARK.json`` gives it."""

    def __init__(self, spec: dict, name: str, bench_dir: Path = BENCH):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        cfg_entry = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        self.config = json.loads((bench_dir.parent / cfg_entry["file"]).read_text())
        self.traffic = json.loads(
            (bench_dir / "traffic" / f"{self.entry['traffic']}.json").read_text())
        limits = bench_dir / "limits" / f"{name}.json"
        self.limits = json.loads(limits.read_text()) if limits.exists() else {}
        self.end_to_end = [m for m in spec["end_to_end"] if self._has(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", ())
                          or ("workloads" not in m and m["moves"] in reported)]
        self.bench_dir = bench_dir

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name`` (file names may hold
    dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_module(cell: Cell):
    return load_module(cell.bench_dir / "reference" / f"{cell.config['reference']}.py",
                       f"perfbench.reference.{cell.config['reference']}")


def seeded_reference(cell: Cell, seed: int, device):
    """(the reference model on ``device`` holding the seed's weights, those
    weights as a state dict)."""
    ref = reference_module(cell).build(cell.config["params"]).to(device)
    sd = make_weights(ref, seed, device)
    ref.load_state_dict(sd)
    return ref, sd


# ------------------------------------------------------------- process
def process_start_wall() -> float:
    """The wall-clock time at which this process started (from
    ``/proc``; ``time.time()`` at import where that is missing)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED_AT


_IMPORTED_AT = time.time()


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is banned, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in BANNED_MODULES})


# ---------------------------------------------------------- seeded data
def make_weights(model, seed: int, device) -> Dict[str, "torch.Tensor"]:
    """A state dict for ``model`` (a reference module) from ``seed``: every
    trainable parameter from one uniform draw of a ``torch.Generator`` on
    ``device``, scaled by its shape: matrices U(+-1/sqrt(fan_in)) (torch's
    default for a Linear), convolution kernels U(+-sqrt(6/fan_in)) (He's,
    so that the ReLU CNNs keep their signal), 1-d weights 1 + U(+-0.1),
    biases U(+-0.1), ``init_latents`` of unit variance; buffers and frozen
    tables as the reference builds them. ``fan_in`` is the numel over the
    first dimension, as torch counts it."""
    import torch

    sd = {k: v.detach().to(device).clone() for k, v in model.state_dict().items()}
    leaves = [(k, p.shape) for k, p in model.named_parameters() if p.requires_grad]
    total = sum(int(np.prod(s)) for _, s in leaves)
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=g, device=device).mul_(2.0).sub_(1.0)
    o = 0
    for k, shape in leaves:
        n = int(np.prod(shape))
        x = u[o:o + n].view(shape)
        o += n
        if k.endswith("init_latents"):
            w = x * 3.0 ** 0.5
        elif len(shape) >= 3:
            w = x * (6.0 / (n // shape[0])) ** 0.5
        elif len(shape) == 2:
            w = x * (1.0 / shape[1]) ** 0.5
        elif k.endswith("weight"):
            w = 1.0 + 0.1 * x
        else:
            w = 0.1 * x
        sd[k] = w.contiguous()
    return sd


def batch_dims(cell: Cell, batch: int) -> Dict[str, int]:
    """The symbols a batch spec may use: B, T (clip frames), S (slots), D
    (slot size), H, W (frame size), the configuration's own ``dims`` (such
    as P, the patches of a frame, and V, the vocabulary) and the traffic's
    own whole numbers."""
    p = cell.config["params"]
    dims = {"B": batch, "T": p["n_sample_frames"],
            "S": p["slot_dict"]["num_slots"],
            "D": p["slot_dict"]["slot_size"], "H": p["resolution"][0],
            "W": p["resolution"][1]}
    dims.update(cell.config.get("dims", {}))
    dims.update({k: v for k, v in cell.traffic.items() if isinstance(v, int)})
    return dims


def make_batches(spec: dict, dims: Dict[str, int], count: int, seed: int,
                 device) -> List[Dict[str, np.ndarray]]:
    """``count`` collated batches as host numpy arrays, after ``spec``:
    ``{key: [dtype, [dim, ...], fill]}`` with dims whole numbers or symbols
    of ``dims``; fill ``uniform`` (U[-1, 1), frames), ``normal`` (slots),
    ``index`` (the rows' numbers), ``false``, or ``["randint", n]`` (whole
    numbers uniform over [0, n), n a whole number or a symbol: token ids).
    Drawn on ``device`` from one generator seeded with ``seed``, batch
    after batch."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for i in range(count):
        b = {}
        for key, (dtype, shape, fill) in spec.items():
            shape = [dims[d] if isinstance(d, str) else int(d) for d in shape]
            if isinstance(fill, list) and fill[0] == "randint":
                high = dims[fill[1]] if isinstance(fill[1], str) else int(fill[1])
                x = torch.randint(0, high, shape, generator=g, device=device)
            elif fill == "uniform":
                x = torch.rand(shape, generator=g, device=device).mul_(2).sub_(1)
            elif fill == "normal":
                x = torch.randn(shape, generator=g, device=device)
            elif fill == "index":
                x = torch.arange(i * shape[0], (i + 1) * shape[0])
            elif fill == "false":
                x = torch.zeros(shape, dtype=torch.bool)
            else:
                raise ValueError(f"fill {fill!r}")
            b[key] = x.cpu().numpy().astype(dtype)
        out.append(b)
    return out


# --------------------------------------------------------------- traces
class Trace:
    """A profiler trace reduced to what the readers need: the window, the
    device activity in it (kernels, copies, sets) and the host's ops."""

    def __init__(self, prof, marker: str):
        from torch.autograd import DeviceType

        dev, cpu, window = [], [], None
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns()
            end = s + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                dev.append((s, end, e.name(), _annotation(e)))
            elif e.name() == marker:
                window = (s, end)
            else:
                cpu.append((s, end, e.name()))
        # a host span (record_function) is mirrored on the device's timeline
        # as an annotation: it is no device activity
        host_names = {n for _, _, n in cpu} | {marker}
        dev = [(s, e, n) for s, e, n, note in dev
               if not note and n not in host_names]
        if window is None:
            raise RuntimeError(f"the trace has no {marker!r} span")
        w0, w1 = window
        self.window_ns = (w0, w1)
        self.device = [(max(s, w0), min(e, w1), n) for s, e, n in dev
                       if e > w0 and s < w1]
        self.cpu = [(s, e, n) for s, e, n in cpu if e > w0 and s < w1]
        self.busy = _union(self.device)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name holds ``pattern``."""
        return sum(e - s for s, e, n in self.device if pattern in n) * 1e-9

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        totals: Dict[str, float] = {}
        for s, e, n in self.device:
            totals[n] = totals.get(n, 0.0) + (e - s) * 1e-9
        return sorted(totals.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The device's idle time in the window by the innermost host op
        that was running at the middle of each gap."""
        w0, w1 = self.window_ns
        edges = [w0] + [x for iv in self.busy for x in iv] + [w1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        if not gaps:
            return []
        mids = np.array([(a + b) // 2 for a, b in gaps], dtype=np.int64)
        order = np.argsort(mids)
        mids_sorted = mids[order]
        owner = np.full(len(gaps), -1, dtype=np.int64)
        names = [n for _, _, n in self.cpu]
        # longest first, so that an inner op overwrites the ops around it
        for idx in sorted(range(len(self.cpu)),
                          key=lambda i: self.cpu[i][0] - self.cpu[i][1]):
            s, e, _ = self.cpu[idx]
            i0, i1 = np.searchsorted(mids_sorted, [s, e], side="left")
            if i1 > i0:
                owner[order[i0:i1]] = idx
        totals: Dict[str, float] = {}
        for (a, b), o in zip(gaps, owner):
            n = names[o] if o >= 0 else "host outside any op"
            totals[n] = totals.get(n, 0.0) + (b - a) * 1e-9
        return sorted(totals.items(), key=lambda kv: -kv[1])[:top]


def _annotation(event) -> bool:
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def _union(intervals) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e, _ in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


# ------------------------------------------------------------- results
def gap(a, b) -> float:
    """max |a - b| / max |b| over two arrays."""
    import torch

    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max())


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Each reading against its limit; a reading without a limit, or one
    that is not a number, fails."""
    checks, ok = {}, True
    for name, value in readings.items():
        limit = limits.get(name)
        good = (limit is not None and value == value and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    missing = sorted(set(limits) - set(readings))
    for name in missing:
        checks[name] = {"value": None, "limit": limits[name]}
        ok = False
    return ok and bool(readings), checks


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The numbers compared as the last lines of standard error, then the
    result as the last line of standard output, ``checks`` its last key."""
    for name, c in checks.items():
        sys.stderr.write(f"check {name} {c['value']!r} limit {c['limit']!r}\n")
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = checks
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
