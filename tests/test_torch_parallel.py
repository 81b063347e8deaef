"""Port vs JAX: ``parallel/`` (the grid, batch placement, the tensor-parallel
rules) and the trainer over several ranks.

The multi-rank checks run on the CPU over gloo, in two process groups
started by ``parallel.launch.spawn`` (a file rendezvous under a temporary
directory, no fixed port): two ranks for data parallelism (rows of
differing ``vid_len``, ``accum_grad`` 2, StoSAVi's kernel noise) and TP 2
with its checkpoints, four for the 2 x 2 dryrun. Each is held against one
process on the same global batches: losses and ``grad_norm`` at 1e-5
relative, parameters at max |d| < 1e-4 (float32 sums in other orders, then
one Adam step, which moves each weight by about lr), checkpoints equal.
"""

import json
import os
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotformer_tpu.methods import build_method as jax_build_method
from slotformer_tpu.models import SlotFormer as JaxSlotFormer
from slotformer_tpu.models.readout import PhysionReadout as JaxPhysionReadout
from slotformer_tpu.models.steve import STEVE as JaxSTEVE
from slotformer_tpu.models.steve_slotformer import (
    STEVESlotFormer as JaxSTEVESlotFormer)
from slotformer_tpu.parallel import pad_batch_to as jax_pad_batch_to
from slotformer_tpu.parallel import pad_rows as jax_pad_rows
from slotformer_tpu.parallel import param_specs as jax_param_specs
from slotformer_tpu.runtime import BaseDataModule as JaxDataModule
from slotformer_tpu.runtime import BaseMethod as JaxBaseMethod
from slotformer_tpu.runtime import BaseParams as JaxParams
from slotformer_tpu_torch import entry
from slotformer_tpu_torch.cli import train as train_cli
from slotformer_tpu_torch.models import (STEVE, PhysionReadout, SlotFormer,
                                         STEVESlotFormer)
from slotformer_tpu_torch.parallel import (Grid, RowShard, get_mesh,
                                           pad_batch_to, pad_rows,
                                           param_specs, shard_batch,
                                           shard_or_replicate)
from slotformer_tpu_torch.parallel.launch import spawn
from slotformer_tpu_torch.parallel.mesh import randn as row_randn
from slotformer_tpu_torch.runtime import (BaseDataModule, BaseMethod,
                                          BaseParams, DataLoader)
from slotformer_tpu_torch.runtime.weights import from_jax_params
from test_torch_savi import CFG as SAVI_CFG
from test_torch_steve import sf_cfg, steve_cfg

LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4


# ------------------------------------------------------------------ grid

def test_single_process_grid():
    grid = get_mesh()
    assert (grid.n_data, grid.n_model, grid.rank) == (1, 1, 0)
    assert grid.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="tp_size 2"):
        get_mesh(n_model=2)


def test_shard_batch_layout():
    """Rank 5 of a 4 x 2 grid is data rank 2: rows [4, 6) of 8 (JAX's
    row-major mesh, tests/test_mesh.py); non-arrays untouched."""
    grid = Grid(n_data=4, n_model=2, rank=5)
    assert (grid.data_rank, grid.model_rank) == (2, 1)
    batch = {"img": np.arange(16 * 3).reshape(16, 3), "name": ["a"] * 16,
             "t": torch.arange(8)}
    sb = shard_batch(grid, batch)
    np.testing.assert_array_equal(sb["img"], batch["img"][8:12])
    assert torch.equal(sb["t"], torch.arange(4, 6))
    assert sb["name"] == ["a"] * 16
    with pytest.raises(ValueError, match="do not divide"):
        shard_batch(grid, {"x": np.zeros((6, 2))})
    # not divisible: every rank keeps the whole batch
    whole = shard_or_replicate(grid, {"x": np.ones((6, 2))})
    assert whole["x"].shape == (6, 2)


def test_pad_rows_and_pad_batch_to_match_jax():
    x = np.arange(10.0).reshape(5, 2)
    np.testing.assert_array_equal(pad_rows(x, 8), jax_pad_rows(x, 8))
    assert pad_rows(x, 3) is x
    batch = {"x": x, "scalar": 1}
    got, mask = pad_batch_to(batch, 8)
    want, want_mask = jax_pad_batch_to(batch, 8)
    np.testing.assert_array_equal(got["x"], want["x"])
    np.testing.assert_array_equal(mask, want_mask)
    assert got["scalar"] == 1 and mask.sum() == 5
    same, mask2 = pad_batch_to({"x": np.ones((8, 3))}, 8)
    assert same["x"].shape == (8, 3) and mask2.all()


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.array([i], np.float32)}


def test_loader_yields_each_rank_its_rows():
    """The global batches of one process, cut into data ranks' blocks; a
    batch whose rows do not divide the data axis whole on every rank."""
    one = DataLoader(_Range(11), 4, shuffle=True, seed=3, num_workers=0)
    ranks = [DataLoader(_Range(11), 4, shuffle=True, seed=3, num_workers=0,
                        shard=(2, k)) for k in range(2)]
    for loader in [one] + ranks:
        loader.set_epoch(1)
    want = [b["x"][:, 0] for b in one]
    got = [[b["x"][:, 0] for b in r] for r in ranks]
    assert [len(w) for w in want] == [4, 4, 3]
    assert all(len(g) == len(want) for g in got)
    for i in range(2):
        np.testing.assert_array_equal(np.concatenate([got[0][i], got[1][i]]),
                                      want[i])
    # the last batch holds 3 rows: both ranks take all of them
    np.testing.assert_array_equal(got[0][2], want[2])
    np.testing.assert_array_equal(got[1][2], want[2])


def test_row_shard_draws_the_global_batch_rows():
    g = torch.Generator().manual_seed(5)
    want = torch.randn((6, 3), generator=g)
    for k in range(3):
        g = torch.Generator().manual_seed(5)
        got = row_randn((2, 3), RowShard(g, 3, k), "cpu", torch.float32)
        assert torch.equal(got, want[2 * k:2 * k + 2])


# ------------------------------------------------------------- TP rules

def _indicator_tree(shapes, n):
    """JAX leaves of ``shapes`` filled with 1 + the model rank JAX places
    each element on under ``param_specs`` (0 where replicated)."""
    specs = jax_param_specs(shapes, n)

    def fill(leaf, spec):
        arr = np.zeros(leaf.shape, np.float32)
        for axis, name in enumerate(spec):
            if name is not None:
                idx = np.arange(leaf.shape[axis]) // (leaf.shape[axis] // n) + 1
                shape = [1] * len(leaf.shape)
                shape[axis] = -1
                arr = arr + idx.reshape(shape)
        return arr

    return jax.tree.map(fill, shapes, specs,
                        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))


def _port_indicator(t, split, n):
    if split is None:
        return torch.zeros_like(t)
    out = torch.zeros_like(t)
    size = t.shape[split.dim] // split.blocks
    idx = torch.arange(t.shape[split.dim]) % size // (size // n) + 1
    shape = [1] * t.dim()
    shape[split.dim] = -1
    return out + idx.reshape(shape).float()


def _tiny_sf():
    p = entry.flagship_params(tiny=True)
    return dict(resolution=p.resolution, slot_dict=p.slot_dict,
                dec_dict=p.dec_dict, rollout_dict=p.rollout_dict,
                loss_dict=p.loss_dict)


PHYSION_RD = dict(num_slots=5, slot_size=16, agg_func="max", feats_dim=24)
SPEC_MODELS = {
    # kind: (JAX module, port module, config, init batch)
    "SlotFormer": (JaxSlotFormer, SlotFormer, _tiny_sf,
                   lambda: {"slots": np.zeros((1, 6, 4, 16), np.float32),
                            "img": np.zeros((1, 6, 16, 16, 3), np.float32)}),
    "STEVE": (JaxSTEVE, STEVE, lambda: steve_cfg((16, 16)),
              lambda: {"img": np.zeros((1, 2, 16, 16, 3), np.float32)}),
    "STEVESlotFormer": (JaxSTEVESlotFormer, STEVESlotFormer,
                        lambda: sf_cfg((16, 16)),
                        lambda: {"slots": np.zeros((1, 5, 3, 16), np.float32)}),
    "PhysionReadout": (JaxPhysionReadout, PhysionReadout,
                       lambda: dict(readout_dict=PHYSION_RD),
                       lambda: {"slots": np.zeros((1, 4, 5, 16), np.float32)}),
}


@pytest.mark.parametrize("kind", sorted(SPEC_MODELS))
def test_param_specs_cut_what_jax_cuts(kind):
    """Each element of every parameter lies on the model rank where the JAX
    package's ``param_specs`` puts it: the JAX tree filled with each
    element's rank, carried through ``from_jax_params``, equals the port's
    ``param_specs`` filled the same way (TP 2, the transformer layers of
    each model family: MHA heads, linear1/linear2, proj_q..o, fc1/fc2)."""
    jcls, pcls, cfg_fn, batch_fn = SPEC_MODELS[kind]
    cfg = cfg_fn()
    jmod = jcls(**cfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda k: jmod.init({"params": k, "sample": k, "dropout": k},
                            batch_fn())["params"], key)
    n = 2
    converted = from_jax_params(_indicator_tree(shapes, n), kind,
                                types.SimpleNamespace(**cfg))
    port = pcls(**cfg)
    specs = param_specs(port, n)
    sharded = {k for k, s in specs.items() if s is not None}
    assert sharded, "no parameter cut"
    for k, split in specs.items():
        if k not in converted:
            continue
        want = converted[k]
        got = _port_indicator(want, split, n)
        # (tables rebuilt from the config, the sinusoidal PE, hold no ranks)
        marked = want.abs().sum() > 0 and torch.equal(want, want.round())
        if split is not None or marked:
            assert torch.equal(got, want), k
    # one process: nothing cut
    assert all(s is None for s in param_specs(port, 1).values())


# ----------------------------------------------- several ranks, one process

def _savi_params():
    return dict(SAVI_CFG, model="StoSAVi", input_frames=3, optimizer="Adam",
                lr=1e-3, warmup_steps_pct=0.1, clip_grad=0.05, max_epochs=1,
                post_recon_loss_w=1.0, kld_loss_w=1e-4, seed=0)


def _sf_batches(rows, seed, vid_lens):
    b = entry.tiny_batch(rows, seed)
    b["vid_len"] = np.asarray(vid_lens, np.int32)
    return b


def test_data_and_tensor_parallel_steps_match_one_process(tmp_path):
    """Two ranks: (a) data parallel SlotFormer, rows of differing vid_len
    (3 and 9 valid rollout frames on the two ranks, then 5 and 6) and
    accum_grad 2, then a validation over 7 rows; (b) data parallel StoSAVi drawing its kernel noise from
    the trainer's generator; (c) TP 2 SlotFormer, its checkpoint loaded in
    one process and one process's loaded on the grid, tensors equal;
    (d) TP 2 SingleStepSlotFormer (its key-padding mask)."""
    sf = entry.flagship_params(tiny=True)
    ss = entry.flagship_params(
        tiny=True, model="SingleStepSlotFormer", n_sample_frames=4,
        input_frames=1,
        rollout_dict=dict(sf.rollout_dict, history_len=1, cond_len=2),
        loss_dict=dict(sf.loss_dict, rollout_len=3))
    cases = [
        dict(params=dict(sf.to_dict(), accum_grad=2, val_batch_size=4),
             batches=[_sf_batches(4, 1, [4, 4, 6, 6]),
                      _sf_batches(4, 2, [5, 6, 4, 6])],
             val=_sf_batches(7, 3, [4, 6, 6, 5, 4, 6, 5])),
        dict(params=_savi_params(),
             batches=[{"img": np.tanh(np.random.RandomState(3).randn(
                 4, 3, 16, 16, 3)).astype(np.float32)}]),
        dict(params=dict(sf.to_dict(), tp_size=2),
             batches=[_sf_batches(4, 4, [4, 6, 5, 6])],
             ckp_dir=str(tmp_path / "tp")),
        dict(params=dict(ss.to_dict(), tp_size=2),
             batches=[{"slots": entry.tiny_batch(4, 5)["slots"][:, :4],
                       "img": entry.tiny_batch(4, 5)["img"][:, :4]}]),
    ]
    lead = spawn(entry.run_cases, 2, (cases,))[0]
    for name, rec in zip(("ddp_slotformer", "ddp_stosavi", "tp_slotformer",
                          "tp_singlestep"), lead):
        assert rec["loss_rel_err"] < LOSS_RTOL, (name, rec)
        assert rec["max_param_diff"] < PARAM_ATOL, (name, rec)
    assert lead[0]["grid"] == {"data": 2, "model": 1}
    # validation: a batch of 4 sharded 2 + 2, then 3 rows on both ranks
    assert lead[0]["val_rel_err"] < LOSS_RTOL, lead[0]
    tp = lead[2]
    assert tp["grid"] == {"data": 1, "model": 2}
    assert tp["linear1"] == ((16, 16), (32, 16))  # half the rows here
    assert tp["ckp_grid_to_one"] and tp["ckp_one_to_grid"]


def test_dryrun_multichip_2x2():
    recs = entry.dryrun_multichip(4)
    assert [r["rank"] for r in recs] == [0, 1, 2, 3]
    assert recs[0]["grid"] == {"data": 2, "model": 2}
    assert all(r["linear1"] == ((16, 16), (32, 16)) for r in recs)
    assert recs[0]["max_param_diff"] < PARAM_ATOL


def test_entry_is_the_flagship_forward():
    """``entry()``: the CLEVRER SlotFormer's rollout of 10 frames from 6,
    decoded, at B=2 (on the CPU here, the card by default)."""
    fn, args = entry.entry("cpu")
    out = fn(*args)
    assert out["recon_combined"].shape == (2, 10, 64, 64, 3)
    assert out["pred_slots"].shape == (2, 10, 7, 128)
    assert torch.isfinite(out["recon_combined"]).all()


def test_ddp_without_process_group_environment_raises(tmp_path, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    cfg = tmp_path / "cfg.py"
    cfg.write_text("from slotformer_tpu_torch.runtime.params import BaseParams\n"
                   "class SlotFormerParams(BaseParams):\n    model = 'SlotFormer'\n")
    with pytest.raises(RuntimeError, match="torchrun"):
        train_cli.main(["--params", str(cfg), "--ddp", "--device", "cpu"])


# ------------------------------------------------------- steps_per_call

class _Pairs:
    def __init__(self, n=24, seed=0):
        r = np.random.RandomState(seed)
        self.x = r.randn(n, 3).astype(np.float32)
        self.y = r.randn(n, 1).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


class _JaxToy(fnn.Module):
    @fnn.compact
    def __call__(self, batch):
        return fnn.Dense(1)(batch["x"])

    def train_loss(self, batch):
        return {"mse": jnp.mean((self(batch) - batch["y"]) ** 2)}

    eval_loss = train_loss


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(3, 1)

    def train_loss(self, batch, generator=None):
        return {"mse": ((self.fc(batch["x"]) - batch["y"]) ** 2).mean()}

    eval_loss = train_loss


def _toy_params(cls, k):
    return cls(max_epochs=2, train_batch_size=4, num_workers=0, lr=1e-2,
               optimizer="Adam", print_iter=2, save_interval=0.5,
               steps_per_call=k, mse_loss_w=1.0, seed=0)


def _logged(ckp):
    with open(os.path.join(ckp, "log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["step"] for r in recs if r["phase"] == "train"]


def _port_fit(k, ckp):
    params = _toy_params(BaseParams, k)
    torch.manual_seed(0)
    method = BaseMethod(_Toy(), BaseDataModule(params, _Pairs(), None),
                        params, ckp_path=ckp)
    method.fit(san_check_val_step=0)
    saves = sorted(int(f[6:-4]) for f in os.listdir(ckp)
                   if f.startswith("model_") and f.endswith(".pth"))
    return method, _logged(ckp), saves


def test_steps_per_call_runs_single_steps_in_jax_windows(tmp_path):
    """steps_per_call 4 over 6-step epochs (one call of 4, then 2 single
    steps): the parameters of 12 single steps, exactly; the logged and
    checkpointed steps those of the JAX trainer at steps_per_call 4."""
    fused, fused_log, fused_saves = _port_fit(4, str(tmp_path / "fused"))
    single, single_log, _ = _port_fit(1, str(tmp_path / "single"))
    assert fused.it == single.it == 12
    for k, v in single.model.state_dict().items():
        assert torch.equal(fused.model.state_dict()[k], v), k
    assert single_log == [2, 4, 6, 8, 10, 12]

    jparams = _toy_params(JaxParams, 4)
    jm = JaxBaseMethod(_JaxToy(), JaxDataModule(jparams, _Pairs(), None),
                       jparams, ckp_path=str(tmp_path / "jax"))
    jm.fit(san_check_val_step=0)
    jsaves = sorted(int(f[6:-9]) for f in os.listdir(tmp_path / "jax")
                    if f.startswith("model_") and f.endswith(".ckpt.pkl"))
    assert fused_log == _logged(str(tmp_path / "jax")) == [4, 6, 10, 12]
    assert fused_saves == jsaves


# ------------------------------------------- one process, several devices

def test_offline_clis_spread_rows_over_replicas():
    """Two replicas (CPU here; cards with ``--device cuda``) give the slots
    and rollouts of one: StoSAVi's kernel noise drawn for the whole batch
    by each replica (5 videos: a batch of 4 split 2 + 2, then one video on
    both), and SlotFormer's interleaved rollout."""
    import copy

    from slotformer_tpu_torch.cli.extract_slots import extract_video_slots
    from slotformer_tpu_torch.cli.rollout_slots import interleaved_rollout
    from slotformer_tpu_torch.datasets.synthetic import SyntheticVideoDataset
    from slotformer_tpu_torch.models import build_model

    torch.manual_seed(0)
    savi = build_model(BaseParams(**_savi_params()), device="cpu")
    assert savi.cell.stochastic
    ds = SyntheticVideoDataset("val", num_videos=5, video_len=5,
                               resolution=(16, 16))
    one = extract_video_slots(savi, ds, 4, 3, seed=7)
    two = extract_video_slots([savi, copy.deepcopy(savi)], ds, 4, 3, seed=7)
    assert sorted(one) == sorted(two) and len(one) == 5
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=1e-5, atol=1e-6)

    torch.manual_seed(0)
    sf = build_model(entry.flagship_params(tiny=True), device="cpu")
    slots = {f"v{i}": np.random.RandomState(i).randn(8, 4, 16).astype(
        np.float32) for i in range(6)}
    one = interleaved_rollout(sf, slots, 6, 10, 3, 2, batch_size=4)
    two = interleaved_rollout([sf, copy.deepcopy(sf)], slots, 6, 10, 3, 2,
                              batch_size=4)
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=1e-5, atol=1e-6)
