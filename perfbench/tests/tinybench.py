"""A copy of the benchmark at tiny widths, for CPU tests: the real folder
copied under a temporary directory, every configuration and traffic file
cut down, and ``BENCHMARK.json`` copied beside it."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
import torch

from perfbench import core
from perfbench.run import make_job

REAL = Path(__file__).resolve().parents[1]
CELLS = ("slotformer_clevrer.train", "stosavi_clevrer.train",
         "slotformer_clevrer.rollout", "stosavi_clevrer.extract")
SEED = 2 ** 31 + 11


def tiny_tree(tmp: Path):
    """(spec, bench dir) of the tiny copy under ``tmp``."""
    bench = Path(tmp) / "perfbench"
    shutil.copytree(REAL, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REAL.parent / "BENCHMARK.json").read_text())
    for name in ("stosavi_clevrer", "slotformer_clevrer"):
        path = bench / "configs" / f"{name}.json"
        c = json.loads(path.read_text())
        p = c["params"]
        p["resolution"] = [16, 16]
        p["train_batch_size"] = 4
        p["dec_dict"].update(dec_channels=[16, 8, 8])
        if name.startswith("stosavi"):
            p["slot_dict"].update(num_slots=3, slot_size=16, slot_mlp_size=32)
            p["enc_dict"].update(enc_channels=[3, 8, 8], enc_out_channels=16)
            p["n_sample_frames"] = p["input_frames"] = 3
            c["slot_attention"] = {"N": 256, "D": 16, "S": 3, "H": 32, "iters": 2}
        else:
            p["slot_dict"].update(num_slots=3, slot_size=16)
            p["rollout_dict"].update(num_slots=3, slot_size=16, history_len=3,
                                     d_model=32, num_heads=2, ffn_dim=64,
                                     num_layers=2)
            p["input_frames"], p["n_sample_frames"] = 3, 5
            p["loss_dict"]["rollout_len"] = 2
        path.write_text(json.dumps(c))
    for t, upd in (("rollout", {"batch": 2, "history": 3, "rollout": 45,
                                "frames": 48, "pool_batches": 3}),
                   ("extract", {"batch": 2, "chunk_len": 4, "video_len": 10,
                                "pool_videos": 4})):
        path = bench / "traffic" / f"{t}.json"
        d = json.loads(path.read_text())
        d.update(upd)
        path.write_text(json.dumps(d))
    (Path(tmp) / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec, bench


def job(spec, bench, name: str, seed: int = SEED, seconds: float = 0.3,
        trace: bool = False):
    return make_job(core.Cell(spec, name, bench_dir=bench), seed, seconds, trace,
                torch.device("cpu"), time.time())
