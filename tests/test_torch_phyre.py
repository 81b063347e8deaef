"""Port vs JAX: PHYRE planning (SingleStepSlotFormer, AUCCESS, the PHYRE
datasets and the extract -> rollout -> plan CLIs).

The golden ``g_ssroll`` (the reference's iterative-overlap rollout, growing
and sliding) through the port's ``SingleStepSlotRollouter``; the port's
``SingleStepSlotFormer`` against JAX's on the same weights
(``from_jax_params``) at rollout lengths below and above ``cond_len``, and
one training-loss step with dropout off (the losses with ``vid_len``
masking, every gradient); ``auccess_from_conf`` against JAX's; the port's
fold-0 split files against the JAX package's, bit for bit. Then, on a
stand-in ``phyre`` module (this file's own copy of
tests/test_phyre_fixture_e2e.py's, put into ``sys.modules``) with
``_SPLIT_DIR`` pointed at a temporary directory in both packages: the
regenerated splits equal JAX's file for file; ``PHYREDataset`` and
``PHYRESlotsDataset`` items equal JAX's; ``cli.extract_phyre_slots`` ->
``cli.rollout_phyre_slots`` -> ``cli.test_phyre_planning`` (sharded, then
``--collect``) with ``--device cpu`` against the JAX CLIs on the same
weights, untrained; and the port's ``cli.train`` of SingleStepSlotFormer
and PHYREReadout on those files.

Tolerances: the losses 1e-5 relative (atol 1e-6), the rollouts and the
gradients 1e-5 of their largest entry, float32 on both sides; the
golden at the JAX package's golden tolerances (rtol 1e-4, atol 1e-5); slots
and confidences from the CLIs within 1e-5; AUCCESS equal (1e-9).
"""

import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

import slotformer_tpu.cli.rollout_phyre_slots as jax_rollout_cli
import slotformer_tpu.datasets.phyre as jax_phyre
import slotformer_tpu_torch.datasets.phyre as port_phyre
from slotformer_tpu.metrics.auccess import auccess_from_conf as jax_auccess
from slotformer_tpu.models.slotformer import SingleStepSlotFormer as JaxSSF
from slotformer_tpu_torch.cli import (
    extract_phyre_slots,
    rollout_phyre_slots,
    test_phyre_planning,
)
from slotformer_tpu_torch.cli import train as train_cli
from slotformer_tpu_torch.datasets import build_dataset
from slotformer_tpu_torch.metrics.auccess import auccess_from_conf
from slotformer_tpu_torch.models import SingleStepSlotFormer, build_model
from slotformer_tpu_torch.models.slotformer import SingleStepSlotRollouter
from slotformer_tpu_torch.runtime import BaseParams, load_params, save_checkpoint
from slotformer_tpu_torch.runtime.weights import from_jax_params
from torch_port_helpers import close, golden_group, jax_init, randn, rng, state_dict

FWD_RTOL, FWD_ATOL, GRAD_RTOL, CLI_ATOL = 1e-5, 1e-6, 1e-5, 1e-5

# ------------------------------------------------------- SingleStepSlotFormer

SSF = dict(
    resolution=(16, 16),
    slot_dict=dict(num_slots=3, slot_size=16),
    dec_dict=dict(dec_channels=(16, 8, 8), dec_resolution=(4, 4), dec_ks=3,
                  dec_norm=""),
    rollout_dict=dict(num_slots=3, slot_size=16, history_len=1, cond_len=4,
                      t_pe="sin", slots_pe="", d_model=16, num_layers=2,
                      num_heads=2, ffn_dim=32, norm_first=True, dropout=0.0),
    loss_dict=dict(rollout_len=6, use_img_recon_loss=False),
)


def test_golden_single_step_rollouter():
    sd, ins, outs = golden_group("g_ssroll")
    model = SingleStepSlotRollouter(
        num_slots=3, slot_size=8, history_len=1, cond_len=4, t_pe="sin",
        slots_pe="", d_model=16, num_layers=2, num_heads=2, ffn_dim=32,
        norm_first=True).eval()
    model.load_state_dict(state_dict(sd))
    with torch.no_grad():
        got = model(torch.from_numpy(ins["x"]), 6)
    close(got, outs["pred"])


def test_history_len_must_be_one():
    with pytest.raises(ValueError, match="history_len=1"):
        SingleStepSlotRollouter(num_slots=3, slot_size=8, history_len=2,
                                cond_len=4)


def _ssf_pair(seed=0):
    jmod = JaxSSF(**SSF)
    batch = {"slots": randn(rng(seed), 2, 7, 3, 16)}
    params = jax_init(jmod, batch, seed=seed)
    cfg = BaseParams(model="SingleStepSlotFormer", n_sample_frames=7, **SSF)
    port = build_model(cfg, device="cpu")
    port.load_state_dict(from_jax_params(params, "SingleStepSlotFormer", cfg))
    return jmod, params, port


@pytest.mark.parametrize("pred_len", [3, 9])
def test_single_step_slotformer_rollout_matches_jax(pred_len):
    """Below cond_len (the context still growing) and above it (sliding)."""
    jmod, params, port = _ssf_pair()
    assert isinstance(port, SingleStepSlotFormer)
    past = randn(rng(1), 2, 1, 3, 16)
    want = jmod.apply({"params": params}, past, pred_len, method="rollout")
    with torch.no_grad():
        got = port.rollout(torch.from_numpy(past), pred_len)
    assert got.shape == (2, pred_len, 3, 16)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= FWD_RTOL * np.abs(want).max()


def test_single_step_slotformer_train_step_matches_jax():
    """One training-loss step with dropout off and ``vid_len`` masking: the
    loss and every rollouter gradient."""
    jmod, params, port = _ssf_pair()
    r = rng(2)
    batch = {"slots": randn(r, 2, 7, 3, 16),
             "vid_len": np.array([4, 7], np.int32)}

    def jloss(p):
        return jmod.apply({"params": p}, batch, method="train_loss",
                          rngs={"dropout": jax.random.PRNGKey(0)}
                          )["slot_recon_loss"]

    want, jgrads = jax.value_and_grad(jloss)(params)
    port.train()
    loss = port.train_loss({k: torch.from_numpy(v) for k, v in batch.items()})
    close(loss["slot_recon_loss"], want, rtol=FWD_RTOL, atol=FWD_ATOL)
    loss["slot_recon_loss"].backward()
    cfg = BaseParams(**SSF)
    want_g = from_jax_params(jax.tree.map(np.asarray, jgrads),
                             "SingleStepSlotFormer", cfg)
    n = 0
    for name, p in port.named_parameters():
        if not name.startswith("rollouter.") or not p.requires_grad:
            continue
        g, w = p.grad.numpy(), want_g[name].numpy()
        assert np.abs(g - w).max() <= GRAD_RTOL * max(np.abs(w).max(), 1e-12), name
        n += 1
    assert n == 4 + 2 * 12  # in/out projections, 2 layers of 12 tensors


# ------------------------------------------------------------------ AUCCESS

@pytest.mark.parametrize("num_acts", [60, 400])
def test_auccess_matches_jax(num_acts):
    """Random tables with invalid actions; at 60 actions every task has
    fewer than 100 valid ones, and one task none at all."""
    r = np.random.default_rng(num_acts)
    conf = r.random((7, num_acts))
    gt = r.choice([-1, 0, 1], size=(7, num_acts), p=[0.6, 0.25, 0.15])
    gt[3] = 0
    got, got_s = auccess_from_conf(conf, gt.copy())
    want, want_s = jax_auccess(conf, gt.copy())
    assert got == want
    np.testing.assert_array_equal(got_s, want_s)
    assert got_s.shape == (100,)


def test_fold0_split_files_equal_the_jax_packages():
    names = sorted(os.listdir(port_phyre._SPLIT_DIR))
    assert names == [
        "within-fold_0-train-data_0.1-pos_0.2-label.npy",
        "within-fold_0-val-data_0.1-pos_0.2-label.npy",
        "within-fold_0-val-data_0.1-pos_0.2.npy"]
    for n in names:
        with open(os.path.join(port_phyre._SPLIT_DIR, n), "rb") as a, \
                open(os.path.join(jax_phyre._SPLIT_DIR, n), "rb") as b:
            assert a.read() == b.read(), n


# --------------------------------------------- the stand-in phyre simulator

SIM_FRAMES, N_CACHE_ACTS, RES, S, D, VID_LEN = 8, 50, 16, 3, 16, 6
TRAIN_TASKS = ["00000:000", "00001:000"]
DEV_TASKS = ["00002:000"]
TEST_TASKS = ["00003:000", "00004:000"]


def _status_of(action) -> int:
    """The status of an action, shared by the stand-in cache and simulator
    (the datasets check the simulated label against the split's)."""
    a0 = float(np.asarray(action).ravel()[0])
    return 1 if a0 >= 0.6 else (-1 if a0 >= 0.2 else 0)


class _Sim:
    def __init__(self, images, status):
        self.images, self.status = images, status


class _Simulator:
    def __init__(self, tasks):
        self.tasks = tasks

    def simulate_action(self, task_id, action, stride=60, need_images=True,
                        need_featurized_objects=False):
        a = np.asarray(action).ravel()
        imgs = np.zeros((SIM_FRAMES, 20, 20), np.int64)
        x0 = int(a[1] * 12)
        for t in range(SIM_FRAMES):
            x = (x0 + 2 * t) % 15
            imgs[t, 4:9, x:x + 5] = 1 + (task_id % 5)  # a moving blob
            imgs[t, 14:17, 2:18] = 6  # a static floor
        return _Sim(imgs, _status_of(a))


class _Cache:
    def __init__(self):
        self.action_array = np.random.default_rng(7).random((N_CACHE_ACTS, 3))

    def get_sample(self, tasks, _):
        st = np.stack([[_status_of(a) for a in self.action_array]] * len(tasks))
        return {"actions": self.action_array.copy(),
                "simulation_statuses": st.astype(np.int64)}


def _stand_in_phyre():
    m = types.ModuleType("phyre")
    m.get_fold = lambda eval_setup, fold: (
        list(TRAIN_TASKS), list(DEV_TASKS), list(TEST_TASKS))
    m.get_default_100k_cache = lambda tier: _Cache()
    m.eval_setup_to_action_tier = lambda eval_setup: "ball"
    m.initialize_simulator = lambda tasks, tier: _Simulator(tasks)
    return m


COMMON = dict(data_root="data/PHYRE", resolution=(RES, RES), fps=1,
              frame_offset=1, video_len=VID_LEN, n_sample_frames=VID_LEN,
              phyre_protocal="within", phyre_fold=0, data_ratio=0.004,
              pos_ratio=0.5, reverse_color=True, train_batch_size=4,
              val_batch_size=4, num_workers=0)
SAVI = dict(model="StoSAVi", dataset="phyre", input_frames=VID_LEN,
            slot_dict=dict(num_slots=S, slot_size=D, slot_mlp_size=32,
                           num_iterations=2, kernel_mlp=False),
            enc_dict=dict(enc_channels=(3, 8, 8), enc_ks=3, enc_out_channels=D),
            dec_dict=dict(dec_channels=(16, 8, 8), dec_resolution=(4, 4),
                          dec_ks=3),
            pred_dict=dict(pred_type="mlp", pred_rnn=False,
                           pred_norm_first=True),
            loss_dict=dict(use_post_recon_loss=True, kld_method="none"),
            post_recon_loss_w=1.0, kld_loss_w=0.0)
SF = dict(model="SingleStepSlotFormer", dataset="phyre_slots", input_frames=1,
          slot_dict=dict(num_slots=S, slot_size=D),
          rollout_dict=dict(num_slots=S, slot_size=D, history_len=1,
                            cond_len=4, t_pe="sin", slots_pe="", d_model=16,
                            num_layers=1, num_heads=2, ffn_dim=32,
                            norm_first=True),
          dec_dict=dict(dec_channels=(16, 8, 8), dec_resolution=(4, 4),
                        dec_ks=3, dec_ckp_path=""),
          loss_dict=dict(rollout_len=VID_LEN - 1, use_img_recon_loss=False),
          slot_recon_loss_w=1.0)
READOUT = dict(model="PHYREReadout", dataset="phyre_rollout_slots",
               readout_dict=dict(num_slots=S, slot_size=D, t_pe="sin",
                                 d_model=16, num_layers=1, num_heads=2,
                                 ffn_dim=32, sel_slots=[0, 3]),
               vqa_loss_w=1.0)


def _write_cfg(path, pkg, attrs):
    """A config file of ``pkg`` (slotformer_tpu or slotformer_tpu_torch)."""
    mod = ("slotformer_tpu.runtime" if pkg == "slotformer_tpu"
           else "slotformer_tpu_torch.runtime.params")
    with open(path, "w") as f:
        f.write(f"from {mod} import BaseParams\n\n\n"
                "class SlotFormerParams(BaseParams):\n"
                + "".join(f"    {k} = {v!r}\n" for k, v in attrs.items()))
    return str(path)


def _configs(root, pkg, slots=None, ro=None):
    """(savi, sf, readout) config paths of ``pkg`` under ``root``; their
    file names are the runs' names in both packages."""
    os.makedirs(root, exist_ok=True)
    return (_write_cfg(os.path.join(root, "savi_phyre_tiny.py"), pkg,
                       {**COMMON, **SAVI}),
            _write_cfg(os.path.join(root, "sf_phyre_tiny.py"), pkg,
                       {**COMMON, **SF, "slots_root": slots or ""}),
            _write_cfg(os.path.join(root, "readout_phyre_tiny.py"), pkg,
                       {**COMMON, **READOUT, "slot_root": ro or ""}))


def _slot_dir(save, split):
    return os.path.join(save, "slots", "savi_phyre_tiny",
                        f"within-fold_0-{split}-data_0.004-pos_0.5")


def _ro_dir(save, split):
    return os.path.join(save, "rollout_slots", "sf_phyre_tiny",
                        f"within-fold_0-{split}")


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Both packages' CLIs over the stand-in, on the same untrained weights:
    extraction (two shards), rollout, planning (two shards + collect)."""
    from slotformer_tpu.cli.extract_phyre_slots import main as jax_extract
    from slotformer_tpu.cli.rollout_phyre_slots import main as jax_rollout
    from slotformer_tpu.cli.test_phyre_planning import main as jax_plan
    from slotformer_tpu.models import build_model as jax_build_model
    from slotformer_tpu.runtime import load_params as jax_load_params
    from slotformer_tpu.runtime import save_checkpoint as jax_save

    root = str(tmp_path_factory.mktemp("phyre"))
    split_dirs = {p: os.path.join(root, p, "splits") for p in ("jax", "port")}
    out = {"root": root, "split_dirs": split_dirs}
    cwd = os.getcwd()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "phyre", _stand_in_phyre())
        mp.setattr(jax_phyre, "_SPLIT_DIR", split_dirs["jax"])
        mp.setattr(jax_rollout_cli, "_SPLIT_DIR", split_dirs["jax"])
        mp.setattr(port_phyre, "_SPLIT_DIR", split_dirs["port"])
        os.chdir(root)
        try:
            # the weights: JAX's random init, carried to the port
            cfgs = {"jax": _configs(os.path.join(root, "jax", "cfg"),
                                    "slotformer_tpu"),
                    "port": _configs(os.path.join(root, "port", "cfg"),
                                     "slotformer_tpu_torch")}
            weights = {"jax": {}, "port": {}}
            init_in = {"StoSAVi": {"img": np.zeros((1, 2, RES, RES, 3),
                                                   np.float32)},
                       "SingleStepSlotFormer": {"slots": np.zeros(
                           (1, VID_LEN, S, D), np.float32)},
                       "PHYREReadout": {"slots": np.zeros(
                           (1, VID_LEN, S, D), np.float32)}}
            for i, (name, cfg) in enumerate(zip(
                    ("StoSAVi", "SingleStepSlotFormer", "PHYREReadout"),
                    cfgs["jax"])):
                p = jax_load_params(cfg)
                m = jax_build_model(p)
                key = jax.random.PRNGKey(i)
                tree = jax.tree.map(np.asarray, dict(m.init(
                    {"params": key, "sample": key}, init_in[name])["params"]))
                if name == "PHYREReadout":
                    tree["CLS"] = 0.1 * randn(rng(5), *tree["CLS"].shape)
                stem = os.path.splitext(os.path.basename(cfg))[0]
                weights["jax"][stem] = os.path.join(root, "jax", "ckpts", stem,
                                                    "model.ckpt.pkl")
                jax_save(weights["jax"][stem], tree)
                weights["port"][stem] = os.path.join(root, "port", "ckpts",
                                                     stem, "model.pth")
                os.makedirs(os.path.dirname(weights["port"][stem]))
                save_checkpoint(weights["port"][stem],
                                from_jax_params(tree, name, load_params(
                                    cfgs["port"][i])))
            out["weights"] = weights

            # the regenerated splits (the datasets draw them on first use)
            from slotformer_tpu.datasets import build_dataset as jax_build

            out["jax_sets"] = jax_build(jax_load_params(cfgs["jax"][0]))
            out["port_sets"] = build_dataset(load_params(cfgs["port"][0]))

            for pkg, extract in (("jax", jax_extract),
                                 ("port", extract_phyre_slots.main)):
                save = os.path.join(root, pkg, "data")
                for shard in (0, 1):
                    extract(["--params", cfgs[pkg][0], "--weight",
                             weights[pkg]["savi_phyre_tiny"], "--save_path",
                             save, "--vid_len", str(VID_LEN), "--split",
                             str(shard), "--total_split", "2", "--bs", "4"]
                            + (["--device", "cpu"] if pkg == "port" else []))
            cfgs = {pkg: _configs(
                os.path.join(root, pkg, "cfg"),
                "slotformer_tpu" if pkg == "jax" else "slotformer_tpu_torch",
                slots=_slot_dir(os.path.join(root, pkg, "data"), "{}"),
                ro=_ro_dir(os.path.join(root, pkg, "data"), "{}"))
                for pkg in ("jax", "port")}
            out["cfgs"] = cfgs
            for pkg, rollout in (("jax", jax_rollout),
                                 ("port", rollout_phyre_slots.main)):
                rollout(["--params", cfgs[pkg][1], "--weight",
                         weights[pkg]["sf_phyre_tiny"], "--save_path",
                         os.path.join(root, pkg, "data"), "--bs", "4"]
                        + (["--device", "cpu"] if pkg == "port" else []))
            for pkg, plan in (("jax", jax_plan),
                              ("port", test_phyre_planning.main)):
                common = ["--params", cfgs[pkg][1],
                          "--weight", weights[pkg]["sf_phyre_tiny"],
                          "--task_cls_params", cfgs[pkg][2],
                          "--task_cls_weight",
                          weights[pkg]["readout_phyre_tiny"],
                          "--savi_params", cfgs[pkg][0],
                          "--savi_weight", weights[pkg]["savi_phyre_tiny"],
                          "--bs", "4", "--num_acts", "10"]
                if pkg == "port":
                    common += ["--device", "cpu"]
                for shard in (0, 1):
                    plan(common + ["--split", str(shard), "--total_split", "2"])
                test_dir = os.path.join(
                    os.path.dirname(weights[pkg]["readout_phyre_tiny"]), "test")
                got = plan(["--collect", test_dir, "--total_split", "2"])
                if pkg == "port":
                    out["port_auccess"] = got[0]
                out[f"{pkg}_test_dir"] = test_dir
            yield out
        finally:
            os.chdir(cwd)


def test_regenerated_splits_equal_jax(chain):
    jax_dir, port_dir = chain["split_dirs"]["jax"], chain["split_dirs"]["port"]
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir)) and len(names) == 4
    for n in names:
        np.testing.assert_array_equal(np.load(os.path.join(port_dir, n)),
                                      np.load(os.path.join(jax_dir, n)))
    train, val = chain["port_sets"]
    assert train.video_info.shape == (24, 4) and val.video_info.shape == (4, 4)


def test_phyre_dataset_items_equal_jax(chain):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "phyre", _stand_in_phyre())
        for got_ds, want_ds in zip(chain["port_sets"], chain["jax_sets"]):
            for i in (0, len(got_ds) - 1):
                got, want = got_ds[i], want_ds[i]
                assert sorted(got) == sorted(want)
                np.testing.assert_allclose(got["img"], want["img"], atol=1e-6)
                assert (got["label"], got["vid_len"]) == (want["label"],
                                                           want["vid_len"])
                gv, wv = got_ds.get_video(i), want_ds.get_video(i)
                np.testing.assert_allclose(gv["video"], wv["video"], atol=1e-6)
                assert gv["vid_len"] == wv["vid_len"] == VID_LEN


def test_extracted_slots_equal_jax(chain):
    root = chain["root"]
    for split, n in (("train", 24), ("val", 4)):
        port_dir = _slot_dir(os.path.join(root, "port", "data"), split)
        jax_dir = _slot_dir(os.path.join(root, "jax", "data"), split)
        files = sorted(os.listdir(port_dir))
        assert files == sorted(os.listdir(jax_dir)) and len(files) == n
        for f in files:
            got, want = (np.load(os.path.join(d, f)) for d in (port_dir, jax_dir))
            assert got.shape == (VID_LEN, S, D) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, atol=CLI_ATOL)
    link = os.path.join(os.path.dirname(
        chain["weights"]["port"]["savi_phyre_tiny"]), "train_slots")
    assert os.path.realpath(link) == os.path.realpath(
        _slot_dir(os.path.join(root, "port", "data"), "train"))


def test_slots_datasets_equal_jax(chain):
    from slotformer_tpu.datasets import build_dataset as jax_build
    from slotformer_tpu.runtime import load_params as jax_load_params

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "phyre", _stand_in_phyre())
        mp.setattr(jax_phyre, "_SPLIT_DIR", chain["split_dirs"]["jax"])
        mp.setattr(port_phyre, "_SPLIT_DIR", chain["split_dirs"]["port"])
        for k in (1, 2):  # phyre_slots, phyre_rollout_slots
            got = build_dataset(load_params(chain["cfgs"]["port"][k]))
            want = jax_build(jax_load_params(chain["cfgs"]["jax"][k]))
            for g, w in zip(got, want):
                for i in (0, 3):
                    a, b = g[i], w[i]
                    assert sorted(a) == sorted(b)
                    np.testing.assert_allclose(a["slots"], b["slots"],
                                               atol=CLI_ATOL)
                    assert (a["label"], a["vid_len"]) == (b["label"], b["vid_len"])
                    if "img" in b:
                        np.testing.assert_allclose(a["img"], b["img"], atol=1e-6)


def test_rolled_out_slots_equal_jax(chain):
    root = chain["root"]
    for split in ("train", "val"):
        port_dir = _ro_dir(os.path.join(root, "port", "data"), split)
        jax_dir = _ro_dir(os.path.join(root, "jax", "data"), split)
        files = sorted(os.listdir(port_dir))
        assert files == sorted(os.listdir(jax_dir))
        for f in files:
            got, want = (np.load(os.path.join(d, f)) for d in (port_dir, jax_dir))
            np.testing.assert_allclose(got, want, atol=CLI_ATOL)
            # the observed slots pass through
            first = np.load(os.path.join(_slot_dir(
                os.path.join(root, "port", "data"), split), f))[0]
            np.testing.assert_array_equal(got[0], first)


def test_planning_confidences_and_auccess_equal_jax(chain):
    tables = {}
    for pkg in ("jax", "port"):
        d = chain[f"{pkg}_test_dir"]
        tables[pkg] = (np.load(os.path.join(d, "all_conf.npy")),
                       np.load(os.path.join(d, "all_gt.npy")))
    (jc, jg), (pc, pg) = tables["jax"], tables["port"]
    assert pc.shape == (len(TEST_TASKS), 10)
    np.testing.assert_array_equal(pg, jg)
    np.testing.assert_array_equal(pg[0], [_status_of(a) for a in
                                          _Cache().action_array[:10]])
    np.testing.assert_allclose(pc, jc, atol=CLI_ATOL)
    assert (pc[pg == 0] == -1).all()
    assert np.isclose(chain["port_auccess"], jax_auccess(jc, jg)[0],
                      rtol=0, atol=1e-9)


def test_port_trains_the_phyre_stages(chain, tmp_path):
    """The port's ``cli.train`` on the extracted and rolled-out files: one
    epoch of SingleStepSlotFormer (``SlotFormerMethod``, ``vid_len`` in the
    batches) and of PHYREReadout (``ReadoutMethod``, its sample video and
    JSON)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "phyre", _stand_in_phyre())
        mp.setattr(port_phyre, "_SPLIT_DIR", chain["split_dirs"]["port"])
        for k, run in ((1, "sf"), (2, "readout")):
            params = load_params(chain["cfgs"]["port"][k])
            params.seed, params.max_epochs, params.n_samples = 0, 1, 2
            params.optimizer, params.lr, params.warmup_steps_pct = "Adam", 1e-3, 0.0
            ckp = str(tmp_path / run)
            method = train_cli.run(params, ckp, device="cpu")
            assert type(method).__name__ == ("SlotFormerMethod" if k == 1
                                             else "ReadoutMethod")
            logs = [json.loads(ln) for ln in open(os.path.join(ckp,
                                                               "log.jsonl"))]
            assert method.it == 6 and all(
                np.isfinite(v) for r in logs for v in r.values()
                if isinstance(v, float))
        with open(os.path.join(ckp, "vis", "readout_6.json")) as f:
            assert len(json.load(f)) == 2


def test_resumed_extraction_draws_what_a_whole_run_does(chain, tmp_path):
    """A sharded extraction cut after some files and run again writes the
    files of an uncut run bit for bit, with StoSAVi's kernel noise on
    (``kld_method`` samples, seeded per batch): the resumed run keeps the
    uncut run's batches."""
    cfg = _write_cfg(tmp_path / "savi_phyre_tiny.py", "slotformer_tpu_torch",
                     {**COMMON, **SAVI, "loss_dict": dict(
                         SAVI["loss_dict"], kld_method="var-0.01")})
    torch.manual_seed(0)
    weight = str(tmp_path / "savi" / "model.pth")
    save_checkpoint(weight, build_model(load_params(cfg),
                                        device="cpu").state_dict())

    def extract(save):
        extract_phyre_slots.main(
            ["--params", cfg, "--weight", weight, "--save_path", save,
             "--vid_len", str(VID_LEN), "--split", "0", "--total_split", "1",
             "--bs", "3", "--device", "cpu"])
        return _slot_dir(save, "train")

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "phyre", _stand_in_phyre())
        mp.setattr(port_phyre, "_SPLIT_DIR", chain["split_dirs"]["port"])
        whole = extract(str(tmp_path / "whole"))
        cut = extract(str(tmp_path / "cut"))
        names = sorted(os.listdir(whole))
        assert len(names) > 8
        for n in names[5:]:  # cut inside the second batch of 3
            os.remove(os.path.join(cut, n))
        extract(str(tmp_path / "cut"))
        assert sorted(os.listdir(cut)) == names
        for n in names:
            np.testing.assert_array_equal(np.load(os.path.join(cut, n)),
                                          np.load(os.path.join(whole, n)))
