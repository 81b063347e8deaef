"""A copy of the benchmark at tiny widths, for CPU tests: the real folder
copied under a temporary directory, every configuration and traffic file
cut down, and ``BENCHMARK.json`` copied beside it.

The copy also holds ``steve_physion.train`` (STEVE under bf16 autocast,
two learning-rate groups, token ids), a cell that ``BENCHMARK.json`` does
not list yet, with limits of its own set from tiny readings on the CPU
(``STEVE_LIMITS``)."""

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
STEVE = "steve_physion.train"
# tiny STEVE on the CPU, 12 seeds: the program's largest readings, loss
# 9.1e-5, grad 0.27, change 0.25; the pure-bfloat16 control's least loss
# 3.4e-3 (its change reads 1); the faults' least: half the batch loss
# 1.1e-2, one rate for both groups change 9.4, dropout left out loss
# 2.2e-3, a state left unchanged change 1. The exact comparison (dropout
# inactive on both sides), 12 seeds: the program's largest loss 9.2e-5,
# grad 0.35, change 0.41; the control's least loss 1.9e-3 (change 1); half
# the batch loss 5.8e-3, one rate change 9.4, a state left unchanged
# change 1; the reference under autocast at most loss 1.1e-4, grad 0.35,
# change 0.41
STEVE_LIMITS = {"loss_gap": 1e-3, "grad_gap": 0.6, "change_gap": 0.6,
                "exact_loss_gap": 6e-4, "exact_grad_gap": 0.6,
                "exact_change_gap": 0.6}
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
    path = bench / "configs" / "steve_physion.json"
    c = json.loads(path.read_text())
    p = c["params"]
    p["resolution"] = [16, 16]
    p["train_batch_size"] = 4
    p["n_sample_frames"] = p["input_frames"] = 3
    p["slot_dict"].update(num_slots=3, slot_size=16, slot_mlp_size=32)
    p["enc_dict"].update(enc_channels=[3, 8, 8], enc_out_channels=16)
    p["dvae_dict"].update(vocab_size=32)
    p["dec_dict"].update(dec_num_layers=2, dec_num_heads=2, dec_d_model=16)
    p["pred_dict"].update(pred_num_layers=1, pred_num_heads=2, pred_ffn_dim=32)
    c["dims"] = {"P": 16, "V": 32}
    c["slot_attention"] = {"N": 256, "D": 16, "S": 3, "H": 32, "iters": 2}
    path.write_text(json.dumps(c))
    (bench / "limits" / f"{STEVE}.json").write_text(json.dumps(STEVE_LIMITS))
    spec["configs"].append({"name": "steve_physion", "source": c["source"],
                            "file": "perfbench/configs/steve_physion.json",
                            "reduced": [], "why": "tiny STEVE"})
    spec["workloads"].append({"name": STEVE, "config": "steve_physion",
                              "traffic": "train", "chips": 1, "why": "tiny STEVE"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "stosavi_clevrer.train" in m.get("workloads", ()):
            m["workloads"].append(STEVE)
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
