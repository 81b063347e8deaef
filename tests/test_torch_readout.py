"""Port vs JAX: the readout heads (PHYREReadout, PhysionReadout), the Physion
label dataset, ``ReadoutMethod`` and ``cli.test_physion_vqa``.

The goldens ``g_phyrero`` and ``g_physro`` through the port's heads on their
reference ``sd/`` keys (``comb_idx`` included); both heads against JAX on the
same weights (``from_jax_params``): logits, ``eval_loss`` with its ``acc_*``
sweep, and the gradients of the training loss (JAX's deterministic forward,
the port in ``eval()`` mode: the heads' dropout cannot be switched off in
JAX's config); the standardization of the raw slots folded into the first
projection (``in_proj``, ``linear1``), which runs in float32, exactly; the
label dataset's items against JAX's on the golden Physion fixture (the test
subset: ``bad_stimuli.txt``, the ``-redyellow`` key) and on a mini readout
tree the test writes; ``cli.train`` of a PhysionReadout on that tree
(``ReadoutMethod``'s sample video and its JSON); the ``physion_vqa_golden.npz``
gate through the port's ``cli.test_physion_vqa``.

Tolerances: logits and losses 1e-5 relative (atol 1e-6), float32 on both
sides; gradients 1e-5 of each gradient's largest entry; the goldens at the
JAX package's own golden tolerances (rtol 1e-4, atol 1e-5); the fold at the
JAX test's 1e-4 (tests/test_readout_fold.py); every cell of the golden sweep
at 1e-6 (tests/test_physion_vqa_e2e_parity.py).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import slotformer_tpu.datasets.physion as jax_physion
import slotformer_tpu_torch.datasets.physion as port_physion
from slotformer_tpu.models.readout import PHYREReadout as JaxPHYREReadout
from slotformer_tpu.models.readout import PhysionReadout as JaxPhysionReadout
from slotformer_tpu.runtime import BaseParams as JaxParams
from slotformer_tpu_torch.cli import test_physion_vqa
from slotformer_tpu_torch.cli import train as train_cli
from slotformer_tpu_torch.datasets import build_dataset
from slotformer_tpu_torch.models import PHYREReadout, PhysionReadout, build_model
from slotformer_tpu_torch.runtime import BaseParams, dump_obj, load_checkpoint
from slotformer_tpu_torch.runtime.weights import from_jax_params
from torch_port_helpers import (
    GOLDEN,
    close,
    golden_group,
    jax_init,
    randn,
    rng,
    state_dict,
    write_params,
)

FWD_RTOL, FWD_ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-5
FIXTURE = os.path.join(GOLDEN, "physion_fixture")
THRESHS = [0.4, 0.45, 0.5, 0.55, 0.6, 0.65]

PHYRE_RD = dict(num_slots=3, slot_size=8, t_pe="sin", d_model=16,
                num_layers=2, num_heads=2, ffn_dim=32, norm_first=True,
                sel_slots=[0, 2, 3])


def _physion_rd(agg="max"):
    return dict(num_slots=5, slot_size=16, agg_func=agg, feats_dim=24)


# ------------------------------------------------------------------ goldens

def test_golden_phyre_readout():
    sd, ins, outs = golden_group("g_phyrero")
    model = PHYREReadout(PHYRE_RD).eval()
    model.load_state_dict(state_dict(sd))
    with torch.no_grad():
        got = model({"slots": torch.from_numpy(ins["slots"])})["logits"]
    close(got, outs["logits"])


def test_golden_physion_readout():
    sd, ins, outs = golden_group("g_physro")
    model = PhysionReadout(_physion_rd()).eval()
    # the reference's int64 pair buffer loads as it is
    assert sd["comb_idx"].dtype == np.int64
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        got = model({"slots": torch.from_numpy(ins["slots"])})["logits"]
    close(got, outs["logits"])


# ------------------------------------------------------------ against JAX

def _heads(kind, seed=0):
    """(JAX module, its params, port module with the same weights, batch,
    the port's kind and config)."""
    r = rng(seed)
    if kind == "phyre":
        jmod, rd, T, N, C = JaxPHYREReadout(readout_dict=PHYRE_RD), PHYRE_RD, 5, 3, 8
        port_cls, name = PHYREReadout, "PHYREReadout"
    else:
        rd = _physion_rd(kind.split("_")[1])
        jmod, T, N, C = JaxPhysionReadout(readout_dict=rd), 4, 5, 16
        port_cls, name = PhysionReadout, "PhysionReadout"
    batch = {"slots": randn(r, 6, T, N, C),
             "label": np.array([0, 1, 1, 0, 1, 0], np.int32)}
    params = jax_init(jmod, {"slots": batch["slots"]}, seed=seed)
    if kind == "phyre":  # CLS starts at zero: give it a value
        params["CLS"] = 0.1 * randn(r, *params["CLS"].shape)
    cfg = BaseParams(readout_dict=rd)
    port = port_cls(rd).eval()
    port.load_state_dict(from_jax_params(params, name, cfg))
    return jmod, params, port, batch, name, cfg


@pytest.mark.parametrize("kind", ["phyre", "physion_max", "physion_sum",
                                  "physion_mean"])
def test_readout_matches_jax(kind):
    jmod, params, port, batch, name, cfg = _heads(kind)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    want = jmod.apply({"params": params}, batch)["logits"]
    with torch.no_grad():
        got = port(tb)["logits"]
    close(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)

    want_ev = jmod.apply({"params": params}, batch, method="eval_loss")
    with torch.no_grad():
        got_ev = port.eval_loss(tb)
    assert sorted(got_ev) == sorted(want_ev) == sorted(
        ["vqa_loss", "acc_0.10", "acc_0.30", "acc_0.50", "acc_0.70", "acc_0.90"])
    for k in want_ev:
        close(got_ev[k], want_ev[k], rtol=FWD_RTOL, atol=FWD_ATOL)

    # the training loss's gradients, both sides deterministic
    def jloss(p):
        out = jmod.apply({"params": p}, batch)
        return jmod.apply({"params": p}, batch, out,
                          method="calc_train_loss")["vqa_loss"]

    jgrads = jax.grad(jloss)(params)
    loss = port.calc_train_loss(tb, port(tb))["vqa_loss"]
    close(loss, jloss(params), rtol=FWD_RTOL, atol=FWD_ATOL)
    loss.backward()
    want_g = from_jax_params(jax.tree.map(np.asarray, jgrads), name, cfg)
    trained = [(n, p) for n, p in port.named_parameters() if p.requires_grad]
    # every trained weight has its JAX gradient (the sinusoid and the pair
    # buffer are constants)
    assert {n for n, _ in trained} == set(want_g) - {"enc_t_pe", "comb_idx"}
    for n, p in trained:
        g, w = p.grad.numpy(), want_g[n].numpy()
        assert np.abs(g - w).max() <= GRAD_RTOL * max(np.abs(w).max(), 1e-12), n


@pytest.mark.parametrize("kind", ["phyre", "physion"])
def test_standardization_folds_exactly_into_the_first_projection(kind):
    """Raw slots with disparate per-channel scales and offsets: the head on
    standardized slots equals the head with the standardization folded into
    its first layer's weights, on the raw slots."""
    S, D = 4, 24
    r = np.random.default_rng(0)
    raw = (r.normal(size=(6, 3, S, D)) * r.uniform(0.01, 30.0, D)
           + r.uniform(-5.0, 5.0, D)).astype(np.float32)
    mu, sd = raw.mean((0, 1, 2)), raw.std((0, 1, 2)) + 1e-6
    std = ((raw - mu) / sd).astype(np.float32)
    torch.manual_seed(0)
    if kind == "phyre":
        model = PHYREReadout(dict(num_slots=S, slot_size=D, t_pe="sin",
                                  d_model=32, num_layers=1, num_heads=2,
                                  ffn_dim=64, norm_first=True,
                                  sel_slots=(0, 2))).eval()
        layer, mu_in, sd_in = model.in_proj, mu, sd
    else:
        model = PhysionReadout(dict(num_slots=S, slot_size=D, agg_func="max",
                                    feats_dim=32)).eval()
        # a pair concatenates two slots
        layer, mu_in, sd_in = model.linear1, np.tile(mu, 2), np.tile(sd, 2)
    with torch.no_grad():
        lg_std = model({"slots": torch.from_numpy(std)})["logits"].numpy()
        W = layer.weight.numpy().astype(np.float64)  # [out, in]
        b = layer.bias.numpy().astype(np.float64)
        layer.weight.copy_(torch.from_numpy(W / sd_in[None]))
        layer.bias.copy_(torch.from_numpy(b - W @ (mu_in / sd_in)))
        lg_fold = model({"slots": torch.from_numpy(raw)})["logits"].numpy()
    np.testing.assert_allclose(lg_fold, lg_std, rtol=0, atol=1e-4)


def test_build_model_and_first_projection_in_float32():
    from slotformer_tpu_torch.models.readout import _f32_linear

    p = BaseParams(model="PhysionReadout", readout_dict=_physion_rd())
    model = build_model(p, device="cpu")
    assert isinstance(model, PhysionReadout)
    assert model.comb_idx.dtype == torch.int64 and model.comb_idx.shape == (20,)
    p = BaseParams(model="PHYREReadout", readout_dict=PHYRE_RD)
    assert isinstance(build_model(p, device="cpu"), PHYREReadout)
    # under bf16 autocast the first projection stays the float32 product
    x = torch.randn(2, 3, 10, 32)
    with torch.no_grad():
        want = torch.nn.functional.linear(x, model.linear1.weight,
                                          model.linear1.bias)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got = _f32_linear(x, model.linear1)
    assert got.dtype == torch.float32 and torch.equal(got, want)


# ---------------------------------------------------- the label dataset

def _label_params(params_cls, **over):
    """The label dataset's config on the golden fixture's test subset, as
    ``params_cls`` (either package's BaseParams), with ``over`` set."""
    return params_cls(**{**dict(
        dataset="physion_slots_label_test", data_root=FIXTURE,
        slots_root=os.path.join(FIXTURE, "test_slots.pkl"), tasks=["all"],
        n_sample_frames=6, frame_offset=1, video_len=6, resolution=(64, 64),
        loss_dict=dict(use_img_recon_loss=False)), **over})


def test_label_dataset_matches_jax_on_the_golden_fixture(monkeypatch):
    from slotformer_tpu.datasets import build_dataset as jax_build

    split_dir = os.path.join(FIXTURE, "splits")
    monkeypatch.setattr(jax_physion, "_SPLIT_DIR", split_dir)
    monkeypatch.setattr(port_physion, "_SPLIT_DIR", split_dir)
    want = jax_build(_label_params(JaxParams))
    got = build_dataset(_label_params(BaseParams))
    assert got.files == want.files and len(got) == len(want) == 11
    assert got.all_tasks == want.all_tasks
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(a["slots"], b["slots"])
        assert (a["label"], a["task_idx"], a["data_idx"]) == (
            b["label"], b["task_idx"], b["data_idx"])
    # the -redyellow video reads its label without the suffix
    red = [i for i, f in enumerate(got.files) if "-redyellow" in f]
    assert red and got[red[0]]["label"] == 0


def _readout_tree(root, T=4, res=16):
    """A mini readout subset: frame folders, split files, labels and the
    rolled-out slots of 3 train + 2 val videos."""
    r = np.random.default_rng(3)
    from PIL import Image

    splits = os.path.join(root, "splits")
    os.makedirs(splits)
    slots, labels = {"train": {}, "val": {}}, []
    for split, n in (("train", 3), ("val", 2)):
        listing = {}
        for i in range(n):
            task = ("Collide", "Drop")[i % 2]
            name = f"{task.lower()}_{split}_{i}_img"
            rel = f"PhysionTrainMP4s/{task}_readout_MP4s/{name}"
            folder = os.path.join(root, rel)
            os.makedirs(folder)
            for t in range(T):
                Image.fromarray(r.integers(0, 255, (res, res, 3), np.uint8)).save(
                    os.path.join(folder, f"{t:06d}.jpg"))
            listing.setdefault(task, []).append(rel + ".mp4")
            slots[split][name] = randn(r, T, 5, 16)
            labels.append((name[:-4], (i + len(labels)) % 2 == 0))
        with open(os.path.join(splits, f"readout_{split}.json"), "w") as f:
            json.dump(listing, f)
    with open(os.path.join(root, "PhysionTrainMP4s", "readout_labels.csv"),
              "w") as f:
        f.write(",ground truth outcome\n" + "".join(
            f"{n},{v}\n" for n, v in labels))
    dump_obj(slots, os.path.join(root, "readout_slots.pkl"))
    return splits


def test_label_dataset_matches_jax_on_a_readout_tree(tmp_path, monkeypatch):
    from slotformer_tpu.datasets import build_dataset as jax_build

    splits = _readout_tree(str(tmp_path))
    monkeypatch.setattr(jax_physion, "_SPLIT_DIR", splits)
    monkeypatch.setattr(port_physion, "_SPLIT_DIR", splits)
    over = dict(dataset="physion_slots_label_readout", data_root=str(tmp_path),
                slots_root=str(tmp_path / "readout_slots.pkl"), video_len=4,
                resolution=(16, 16))
    got = build_dataset(_label_params(BaseParams, **over))
    want = jax_build(_label_params(JaxParams, **over))
    for g, w, n in zip(got, want, (3, 2)):
        assert len(g) == len(w) == n
        for i in range(len(g)):
            a, b = g[i], w[i]
            np.testing.assert_array_equal(a["slots"], b["slots"])
            assert (a["label"], a["task_idx"]) == (b["label"], b["task_idx"])
        g.load_img, w.load_img = True, True
        np.testing.assert_allclose(g[0]["img"], w[0]["img"], atol=1e-6)


def test_physion_readout_trains_through_the_cli(tmp_path, monkeypatch):
    """``cli.train`` of a PhysionReadout on the mini readout tree:
    ``ReadoutMethod``, finite losses, the ``acc_*`` sweep in validation, the
    sample video with its (label, prediction) JSON, and the checkpoint the
    VQA sweep reads."""
    splits = _readout_tree(str(tmp_path))
    monkeypatch.setattr(port_physion, "_SPLIT_DIR", splits)
    cfg = write_params(tmp_path / "readout_tiny.py", dict(
        model="PhysionReadout", dataset="physion_slots_label_readout",
        data_root=str(tmp_path), slots_root=str(tmp_path / "readout_slots.pkl"),
        tasks=["all"], n_sample_frames=6, frame_offset=1, video_len=4,
        resolution=(16, 16), num_workers=0, train_batch_size=2,
        val_batch_size=2, readout_dict=_physion_rd(), vqa_loss_w=1.0,
        loss_dict=dict(use_img_recon_loss=False), optimizer="Adam", lr=1e-3,
        warmup_steps_pct=0.0, max_epochs=2, n_samples=2, print_iter=1,
        seed=0))
    from slotformer_tpu_torch.runtime import load_params

    params = load_params(cfg)
    ckp = str(tmp_path / "ckpt")
    method = train_cli.run(params, ckp, device="cpu")
    assert type(method).__name__ == "ReadoutMethod" and method.it == 2
    logs = [json.loads(ln) for ln in open(os.path.join(ckp, "log.jsonl"))]
    val = [r for r in logs if r["phase"] == "val"]
    assert val and all(np.isfinite(r["vqa_loss"]) and "acc_0.50" in r
                       for r in val)
    with open(os.path.join(ckp, "vis", "readout_2.json")) as f:
        pairs = json.load(f)
    assert len(pairs) == 2 and all(0 <= p["pred"] <= 1 for p in pairs)
    assert os.path.exists(os.path.join(ckp, "vis", "readout_2.mp4"))
    sd = load_checkpoint(os.path.join(ckp, "model_2.pth"))["state_dict"]
    assert sd["comb_idx"].dtype == torch.int64


# ------------------------------------------------------ the golden gate

def test_physion_vqa_sweep_matches_the_reference_flow(tmp_path, monkeypatch):
    """``physion_vqa_golden.npz`` (the reference flow on the fixture): every
    (checkpoint, threshold) accuracy and per-task accuracy, read by the
    port's CLI straight from the reference ``.pth`` files."""
    gold = np.load(os.path.join(GOLDEN, "physion_vqa_golden.npz"))
    monkeypatch.setattr(port_physion, "_SPLIT_DIR",
                        os.path.join(FIXTURE, "splits"))
    # tests/golden/physion_vqa_cfg.py's values (that file imports the JAX
    # package)
    cfg = write_params(tmp_path / "physion_vqa_cfg.py", dict(
        project="golden", model="PhysionReadout",
        dataset="physion_slots_label_readout", data_root=FIXTURE,
        slots_root=os.path.join(FIXTURE, "readout_slots.pkl"), tasks=["all"],
        n_sample_frames=6, frame_offset=1, video_len=6, resolution=(64, 64),
        num_workers=0, train_batch_size=8, val_batch_size=8,
        readout_dict=dict(num_slots=6, slot_size=16, agg_func="max",
                          feats_dim=16),
        loss_dict=dict(use_img_recon_loss=False), optimizer="Adam", lr=1e-3,
        warmup_steps_pct=0.1, max_epochs=1))
    wdir = tmp_path / "weights"
    wdir.mkdir()
    for name in ("a", "b"):
        sd = {k[len(f"sd_{name}/"):]: torch.from_numpy(gold[k])
              for k in gold.files if k.startswith(f"sd_{name}/")}
        torch.save({"state_dict": sd}, str(wdir / f"{name}.pth"))
    out = test_physion_vqa.main(["--params", cfg, "--weight", str(wdir),
                                 "--batch_size", "4", "--device", "cpu"])
    all_tasks = [str(t) for t in gold["all_tasks"]]
    sweep = {(c["weight"].split(".")[0], c["thresh"]): c for c in out["sweep"]}
    assert len(sweep) == 2 * len(THRESHS)
    for wname in ("a", "b"):
        for thresh in THRESHS:
            cell = sweep[(wname, thresh)]
            np.testing.assert_allclose(
                cell["acc"], float(gold[f"sweep/{wname}/{thresh}/acc"]),
                rtol=1e-6, err_msg=f"{wname}@{thresh}")
            for task in all_tasks:
                np.testing.assert_allclose(
                    cell["task_acc"][task],
                    float(gold[f"sweep/{wname}/{thresh}/task/{task}"]),
                    rtol=1e-6, err_msg=f"{wname}@{thresh}/{task}")
    np.testing.assert_allclose(out["best"]["acc"], float(gold["best/acc"]),
                               rtol=1e-6)
