"""Port vs JAX: the Aloe VQA head on CLEVRER.

``PosEnc('learnable')``; the golden ``g_aloe`` through the port's
``CLEVRERTransformerModel`` on its reference ``sd/`` keys; the port's
``CLEVRERAloe`` against JAX's on the same weights (``from_jax_params``):
logits, losses, eval metrics, per-row predictions and one train step's
gradients; the VQA dataset's rows, eval start indices and predictive tail
shift against JAX's on a tree the test writes; the ``vqa_golden.npz`` gate
(the reference flow's ``CLEVRER.json`` and question-level accuracies)
through ``cli.test_clevrer_vqa``; ``VQAMethod``'s validation against the
CLI; the trainer's validation unchanged for a model without ``_bs`` keys;
``cli.train`` on the golden config.

Tolerances: the forward 1e-5 abs (float32 on both sides, two layers);
losses rtol 1e-6; gradients 1e-5 of each gradient's largest entry; the
golden ``g_aloe`` at the JAX package's own golden tolerances (rtol 1e-4,
atol 1e-5, tests/test_golden_parity.py); the golden submission identical
and its accuracies equal (rtol 1e-6, tests/test_vqa_e2e_parity.py).
"""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from slotformer_tpu.datasets.clevrer_vqa import (
    CLEVRERVQASlotsDataset as JaxVQADataset,
)
from slotformer_tpu.models.aloe import CLEVRERAloe as JaxAloe
from slotformer_tpu.models.nn import PosEnc as JaxPosEnc
from slotformer_tpu.runtime import torch_compat as tc
from slotformer_tpu_torch.cli import test_clevrer_vqa
from slotformer_tpu_torch.cli import train as train_cli
from slotformer_tpu_torch.datasets import build_dataset
from slotformer_tpu_torch.datasets.clevrer_vqa import (
    CLEVRERVQASlotsDataset,
    build_vocab,
)
from slotformer_tpu_torch.methods import VQAMethod, build_method
from slotformer_tpu_torch.models import CLEVRERAloe, build_model
from slotformer_tpu_torch.models import nn as tnn
from slotformer_tpu_torch.models.aloe import CLEVRERTransformerModel
from slotformer_tpu_torch.runtime import (
    BaseDataModule,
    BaseParams,
    dump_obj,
    load_obj,
    load_params,
)
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

FWD_ATOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-6, 1e-5
ACCS = ["descriptive", "multiple-choice", "explanatory", "predictive",
        "counterfactual"]
FIXTURE = os.path.join(GOLDEN, "vqa_fixture")

# the values of tests/golden/vqa_cfg.py, which imports the JAX package
VQA_CFG = dict(
    project="golden", model="CLEVRERAloe", dataset="clevrer_vqa",
    data_root=FIXTURE, slots_root=os.path.join(GOLDEN, "vqa_slots.pkl"),
    vocab_file=os.path.join(FIXTURE, "vocab.json"), video_len=4,
    n_sample_frames=4, max_n_objects=2, slot_size=16, max_question_len=6,
    max_choice_len=4, shuffle_obj=False, num_workers=0, train_batch_size=8,
    val_batch_size=8,
    transformer_dict=dict(input_len=4 * 3 + 10, input_dim=16,
                          pos_enc="learnable", num_layers=2, num_heads=2,
                          ffn_dim=32, norm_first=True, cls_mlp_size=16),
    vision_dict=dict(vision_dim=16), loss_dict=dict(use_mask_obj_loss=False),
    optimizer="Adam", lr=1e-3, warmup_steps_pct=0.1, max_epochs=1)

# a tiny model over 2 frames x 3 slots and 4 + 3 question tokens
TINY = dict(
    transformer_dict=dict(input_len=2 * 3 + 7, input_dim=16,
                          pos_enc="learnable", num_layers=2, num_heads=2,
                          ffn_dim=32, norm_first=True, cls_mlp_size=8),
    lang_dict=dict(question_len=4, question_vocab_size=20, answer_vocab_size=5),
    vision_dict=dict(vision_dim=16), loss_dict=dict(use_mask_obj_loss=False))


def _rows(seed=0, B=6):
    """A row batch: the first half descriptive, then choice rows, padded
    question tokens and labels of each kind."""
    r = rng(seed)
    is_cls = np.arange(B) < B // 2
    pad = np.zeros((B, 7), bool)
    pad[:, 5:] = r.random((B, 2)) > 0.4
    label = np.where(is_cls, r.integers(0, 5, B), r.integers(0, 2, B))
    return {"video_emb": randn(r, B, 2, 3, 16),
            "q_tokens": r.integers(1, 20, (B, 7)).astype(np.int32),
            "q_pad_mask": pad, "is_cls": is_cls,
            "label": label.astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _pair(seed=0):
    batch = _rows(seed)
    jmod = JaxAloe(**TINY)
    params = jax_init(jmod, batch, seed=seed)
    # learnable tables and CLS start at zero: give them values, so that the
    # positions and the CLS token are tested too
    r = rng(seed + 100)
    tm = params["transformer_model"]
    tm["pos_enc"]["pos_embedding"] = 0.1 * randn(r, *tm["pos_enc"]["pos_embedding"].shape)
    tm["CLS"] = 0.1 * randn(r, *tm["CLS"].shape)
    port = CLEVRERAloe(**TINY).eval()
    port.load_state_dict(from_jax_params(params, "CLEVRERAloe",
                                         types.SimpleNamespace(**TINY)))
    return jmod, params, port, batch


# -------------------------------------------------------------- modules

def test_learnable_pos_enc_matches_jax():
    pe = tnn.PosEnc("learnable", 5, 8)
    assert isinstance(pe, torch.nn.Parameter) and pe.requires_grad
    want = JaxPosEnc("learnable", 5, 8).init(jax.random.PRNGKey(0))
    np.testing.assert_array_equal(
        pe.detach().numpy(), np.asarray(want["params"]["pos_embedding"]))
    assert tnn.PosEnc("learnable", 5, 8) is not pe  # a fresh table each


def test_golden_g_aloe():
    """The reference's separate descriptive and multiple-choice forwards,
    mapped onto rows (the video repeated per choice through ``mc_flag``, as
    tests/test_golden_parity.py::test_aloe_parity does)."""
    sd, ins, outs = golden_group("g_aloe")
    model = CLEVRERTransformerModel(
        transformer_dict=dict(input_len=2 * 3 + 7, input_dim=16,
                              pos_enc="learnable", num_layers=2, num_heads=2,
                              ffn_dim=32, norm_first=True, cls_mlp_size=8),
        lang_dict=dict(question_len=4, question_vocab_size=20,
                       answer_vocab_size=5),
        vision_dict=dict(vision_dim=16)).eval()
    model.load_state_dict(state_dict(sd))
    mc_flag = ins["mc_flag"].astype(int)
    n_cls = len(ins["cls_q_tokens"])
    batch = {
        "video_emb": np.concatenate([ins["cls_video_emb"],
                                     ins["mc_video_emb"][mc_flag]]),
        "q_tokens": np.concatenate([ins["cls_q_tokens"], ins["mc_q_tokens"]]),
        "q_pad_mask": np.concatenate([ins["cls_q_pad_mask"], ins["mc_q_pad_mask"]]),
        "is_cls": np.array([True] * n_cls + [False] * len(mc_flag)),
    }
    with torch.no_grad():
        got = model(_torch(batch))
    close(got["cls_answer_logits"][:n_cls], outs["cls_logits"])
    close(got["mc_answer_logits"][n_cls:], outs["mc_logits"])


def test_aloe_forward_losses_and_preds_match_jax():
    jmod, params, port, batch = _pair(seed=1)
    japply = jax.jit(lambda p, b, m: jmod.apply({"params": p}, b, method=m),
                     static_argnums=2)
    want = jmod.apply({"params": params}, batch)
    jl = japply(params, batch, "eval_loss")
    jcls, jmc = japply(params, batch, "eval_preds")
    tb = _torch(batch)
    with torch.no_grad():
        got = port(tb)
        pl, (pcls, pmc) = port.eval_step(tb)
        assert sorted(port.eval_loss(tb)) == sorted(pl)
    for k in ("cls_answer_logits", "mc_answer_logits"):
        close(got[k], want[k], rtol=0, atol=FWD_ATOL)
    assert sorted(pl) == sorted(jl)
    for k in jl:
        close(pl[k], jl[k], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_array_equal(pcls.numpy(), np.asarray(jcls))
    np.testing.assert_array_equal(pmc.numpy(), np.asarray(jmc))
    # the counts: 3 descriptive and 3 choice rows
    assert float(pl["cls_answer_loss_bs"]) == float(pl["mc_answer_loss_bs"]) == 3.0


def test_aloe_train_step_matches_jax():
    """Losses and every parameter's gradient (dropout off on both sides:
    JAX ``deterministic=True``, the port in ``eval()`` with gradients on)."""
    jmod, params, port, batch = _pair(seed=2)

    def loss_fn(p):
        out = jmod.apply({"params": p}, batch, deterministic=True)
        losses = jmod.apply({"params": p}, batch, out, method="calc_train_loss")
        return losses["cls_answer_loss"] + losses["mc_answer_loss"], losses

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    pl = port.train_loss(_torch(batch))
    (pl["cls_answer_loss"] + pl["mc_answer_loss"]).backward()
    for k in jl:
        close(pl[k], jl[k], rtol=LOSS_RTOL, atol=0)
    want = from_jax_params(jax.tree.map(np.asarray, jg), "CLEVRERAloe",
                           types.SimpleNamespace(**TINY))
    n = 0
    for name, p in port.named_parameters():
        scale = float(np.abs(want[name].numpy()).max())
        close(p.grad, want[name], rtol=GRAD_RTOL, atol=GRAD_RTOL * scale + 1e-9)
        n += 1
    # 12 a layer; the embedding, 2 projections (4), CLS, PE, 2 MLPs (8)
    assert n == 2 * 12 + 15
    # every trained value has its key in the reference layout
    assert sorted(dict(port.named_parameters())) == sorted(
        k for k in port.state_dict() if not k.endswith("_token"))


def test_from_jax_params_inverts_torch_compat():
    """``tc.aloe`` of the port's state_dict is the JAX tree it came from,
    the tags are the reference's, and the port accepts the reference's bare
    keys under ``transformer_model``."""
    _, params, port, _ = _pair(seed=3)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = tc.aloe(sd, num_layers=2, num_heads=2)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    gsd, _, _ = golden_group("g_aloe")
    for name in ("text_token", "vision_token", "cls_token", "mc_question_token",
                 "mc_choice_token"):
        np.testing.assert_array_equal(sd[f"transformer_model.{name}"], gsd[name])


def test_build_model_reads_the_vocab(tmp_path):
    params = load_params(write_params(tmp_path / "vqa_cfg.py", VQA_CFG))
    model = build_model(params, device="cpu")
    tm = model.transformer_model
    assert tm.q_embedding.num_embeddings == 28  # the fixture vocab
    assert tm.cls_answer_mlp[2].out_features == 6
    assert tm.question_len == 6 and tm.d_model == 36 and tm.input_len == 23
    assert not model.training


def test_shipped_configs_give_the_published_shape():
    import slotformer_tpu_torch

    cfg_dir = os.path.join(os.path.dirname(slotformer_tpu_torch.__file__), "configs")
    for name in ("aloe_clevrer_params.py", "aloe_clevrer_params-rollout.py"):
        params = load_params(os.path.join(cfg_dir, name))
        vocab = load_obj(params.vocab_file)
        assert (len(vocab["q_vocab"]), len(vocab["a_vocab"])) == (82, 22)
        with torch.device("meta"):
            model = build_model(params, device="meta")
        tm = model.transformer_model
        assert (tm.d_model, tm.input_len) == (144, 208)
        assert len(tm.transformer_encoder.transformer_encoder.layers) == 12


def test_configs_and_vocab_match_the_jax_package():
    from slotformer_tpu.runtime import load_params as jax_load_params
    import slotformer_tpu
    import slotformer_tpu_torch

    jdir = os.path.join(os.path.dirname(slotformer_tpu.__file__), "configs")
    pdir = os.path.join(os.path.dirname(slotformer_tpu_torch.__file__), "configs")
    for name in ("aloe_clevrer_params.py", "aloe_clevrer_params-rollout.py"):
        ref = jax_load_params(os.path.join(jdir, name)).to_dict()
        got = load_params(os.path.join(pdir, name)).to_dict()
        assert load_obj(got.pop("vocab_file")) == load_obj(ref.pop("vocab_file"))
        assert got == ref
    ref = jax_load_params(os.path.join(GOLDEN, "vqa_cfg.py")).to_dict()
    assert {k: ref[k] for k in VQA_CFG} == VQA_CFG


# -------------------------------------------------------------- dataset

VIDEO_LEN, N_FRAMES = 32, 4  # frame offset 8, starts 0..7


@pytest.fixture(scope="module")
def vqa_tree(tmp_path_factory):
    """The golden fixture's questions over slots long enough for the eval
    start indices to vary; video 07000 (and 15000) holds 170 frames, as a
    rollout file does, so its predictive rows read the tail."""
    root = tmp_path_factory.mktemp("vqa")
    os.symlink(os.path.join(FIXTURE, "questions"), root / "questions")
    r = rng(7)
    slots = {}
    for split, first in (("train", 7000), ("val", 7000), ("test", 15000)):
        slots[split] = {f"video_{first + i:05d}.mp4":
                        randn(r, 170 if i == 0 else VIDEO_LEN, 3, 16)
                        for i in range(3)}
    dump_obj(slots, str(root / "slots.pkl"))
    return root, slots


def _datasets(root, slots, split, **kw):
    args = dict(data_root=str(root), video_slots=slots[split],
                vocab_file=os.path.join(FIXTURE, "vocab.json"), split=split,
                max_n_objects=2, video_len=VIDEO_LEN, n_sample_frames=N_FRAMES,
                max_question_len=6, max_choice_len=4)
    return (CLEVRERVQASlotsDataset(**args, **kw), JaxVQADataset(**args))


@pytest.mark.parametrize("split", ["val", "test"])
def test_vqa_eval_rows_match_jax(vqa_tree, split):
    """Every item equal: tokens, masks, labels, metadata, and the slots of
    the seeded eval start index (the rollout tail for predictive rows)."""
    root, slots = vqa_tree
    ours, ref = _datasets(root, slots, split)
    assert len(ours) == len(ref) > 0 and ours.frame_offset == 8
    starts, tail = set(), 0
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{split}[{i}].{k}")
        row = ours.rows[i]
        start = ours._start_idx(row)
        assert start == ref._start_idx(ref.rows[i])
        starts.add(start)
        emb = slots[split][row["video_fn"]]
        if row["q_subtype"] == 2 and emb.shape[0] > 150:
            start += emb.shape[0] - VIDEO_LEN
            tail += 1
        np.testing.assert_array_equal(a["video_emb"],
                                      emb[start + 8 * np.arange(N_FRAMES)])
    assert len(starts) > 1 and tail > 0
    assert ours.label2answer == ref.label2answer


def test_vqa_train_rows_and_test_borrowing(vqa_tree):
    """Training rows: all but the slots equal to JAX's; the slots a window of
    the row's video at a start drawn from the dataset's own generator (the
    same draws for the same seed; numpy's global state untouched). A test
    row of a missing video keeps its question and borrows slots."""
    root, slots = vqa_tree
    ours, ref = _datasets(root, slots, "train", seed=3)
    again, _ = _datasets(root, slots, "train", seed=3)
    state = np.random.get_state()[1].copy()
    for i in range(len(ref)):
        a, b, c = ours[i], ref[i], again[i]
        for k in a:
            if k != "video_emb":
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        np.testing.assert_array_equal(a["video_emb"], c["video_emb"])
        emb = slots["train"][ours.rows[i]["video_fn"]]
        windows = [emb[s + 8 * np.arange(N_FRAMES)] for s in range(len(emb) - 24)]
        assert any(np.array_equal(a["video_emb"], w) for w in windows)
    np.testing.assert_array_equal(np.random.get_state()[1], state)

    missing = dict(slots, test={k: v for k, v in slots["test"].items()
                                if not k.endswith("15001.mp4")})
    ours, ref = _datasets(root, missing, "test")
    for i, row in enumerate(ours.rows):
        if row["video_fn"].endswith("15001.mp4"):
            a = ours[i]
            assert a["video_emb"].shape == (N_FRAMES, 3, 16)
            assert (int(a["scene_index"]), int(a["question_id"])) == (
                row["scene_index"], row["question_id"])
            break
    else:
        pytest.fail("no row of the missing video")


def test_build_vocab_matches_jax(tmp_path):
    from slotformer_tpu.datasets.clevrer_vqa import build_vocab as jax_build_vocab

    out = str(tmp_path / "vocab.json")
    got = build_vocab(FIXTURE, save_path=out)
    assert got == jax_build_vocab(FIXTURE) == load_obj(out)
    with pytest.raises(FileNotFoundError, match="no question corpus"):
        build_vocab(str(tmp_path / "nowhere"))


def test_collated_rows_reach_the_model(vqa_tree, tmp_path):
    """``default_collate`` and the trainer's ``_to_device`` carry the bool
    and int fields: the model's forward on a loader batch equals its forward
    on the items one by one."""
    root, _ = vqa_tree
    params = load_params(write_params(tmp_path / "cfg.py", dict(
        VQA_CFG, data_root=str(root), slots_root=str(root / "slots.pkl"),
        video_len=VIDEO_LEN, n_sample_frames=N_FRAMES,
        transformer_dict=dict(VQA_CFG["transformer_dict"],
                              input_len=N_FRAMES * 3 + 10))))
    val = build_dataset(params, val_only=True)
    batch = next(iter(BaseDataModule(params, None, val).val_loader))
    assert batch["is_cls"].dtype == np.int32 and batch["q_pad_mask"].dtype == bool
    torch.manual_seed(0)
    model = build_model(params, device="cpu")
    with torch.no_grad():
        together = model(VQAMethod._to_device(
            types.SimpleNamespace(device=torch.device("cpu")), batch))
        for i in range(len(batch["is_cls"])):
            item = val[i]
            one = model({k: torch.from_numpy(np.asarray(item[k])[None])
                         for k in ("video_emb", "q_tokens", "q_pad_mask", "is_cls")})
            for k, v in one.items():
                close(together[k][i:i + 1], v, rtol=0, atol=FWD_ATOL)


# ------------------------------------------------- the vqa golden gate

@pytest.fixture(scope="module")
def vqa_gold():
    return np.load(os.path.join(GOLDEN, "vqa_golden.npz"))


@pytest.fixture
def golden_run(vqa_gold, tmp_path):
    """(config path, the golden's reference ``sd/`` saved as a ``.pth``)."""
    sd = {k[3:]: torch.from_numpy(vqa_gold[k])
          for k in vqa_gold.files if k.startswith("sd/")}
    assert all(k.startswith("transformer_model.") for k in sd)
    weight = str(tmp_path / "ref_aloe.pth")
    torch.save({"state_dict": sd}, weight)
    return write_params(tmp_path / "vqa_cfg.py", VQA_CFG), weight


def _normalize(results):
    """Scenes by scene_index, questions by question_id, choices by id."""
    norm = {}
    for scene in results:
        qs = []
        for q in sorted(scene["questions"], key=lambda q: q["question_id"]):
            q = dict(q)
            if "choices" in q:
                q["choices"] = sorted(q["choices"], key=lambda c: c["choice_id"])
            qs.append(q)
        norm[scene["scene_index"]] = qs
    return norm


def test_vqa_golden_submission(vqa_gold, golden_run, tmp_path):
    cfg, weight = golden_run
    ours = test_clevrer_vqa.main(["--params", cfg, "--weight", weight,
                                  "--batch_size", "8", "--device", "cpu"])
    saved = os.path.join(os.path.dirname(weight), "CLEVRER.json")
    assert load_obj(saved) == ours  # beside the weight, as JSON
    ref = json.loads(str(vqa_gold["clevrer_json"]))
    assert len(ours) == len(ref) == 5000
    ours_n, ref_n = _normalize(ours), _normalize(ref)
    assert ours_n == ref_n
    assert sum(bool(qs) for qs in ref_n.values()) == 3


def test_vqa_golden_val_accuracies(vqa_gold, golden_run):
    cfg, weight = golden_run
    metrics = test_clevrer_vqa.main(["--params", cfg, "--weight", weight,
                                     "--split", "val", "--batch_size", "8",
                                     "--device", "cpu"])
    for q in ACCS:
        assert metrics[f"{q}_n"] == int(vqa_gold[f"metric/{q}_n"]), q
        np.testing.assert_allclose(metrics[f"{q}_acc"],
                                   float(vqa_gold[f"metric/{q}_acc"]),
                                   rtol=1e-6, atol=1e-9, err_msg=q)


def test_vqa_method_validation_matches_the_cli(golden_run, tmp_path):
    """``VQAMethod``'s question-level scores on the golden weights equal
    ``cli.test_clevrer_vqa --split val``'s; its row-level metrics are each
    weighted by their own rows (batches of 5 rows mix the two kinds)."""
    cfg, weight = golden_run
    params = load_params(cfg)
    params.val_batch_size = 5
    train, val = build_dataset(params)
    model = build_model(params, device="cpu")
    model.load_state_dict(torch.load(weight)["state_dict"])
    method = build_method(model=model, datamodule=BaseDataModule(params, train, val),
                          params=params, ckp_path=str(tmp_path / "ckp"))
    assert isinstance(method, VQAMethod)
    got = method.validation_epoch()
    want = test_clevrer_vqa.main(["--params", cfg, "--weight", weight,
                                  "--split", "val", "--device", "cpu"])
    for q in ACCS:
        np.testing.assert_allclose(got[f"{q}_acc"], want[f"{q}_acc"], rtol=1e-6)
    # row-level, by hand over all rows at once
    rows = BaseDataModule(params, None, val)
    batch = method._to_device(next(iter(type(rows.val_loader)(
        val, batch_size=len(val), num_workers=0))))
    with torch.no_grad():
        whole = model.eval_loss(batch)
    for k in ("cls_answer_loss", "mc_answer_loss", "descriptive_acc", "choice_acc"):
        np.testing.assert_allclose(got[k], float(whole[k]), rtol=1e-5, err_msg=k)
    assert not any(k.endswith("_bs") for k in got)


def test_validation_without_bs_keys_is_unchanged(tmp_path):
    """For a model whose ``eval_loss`` has no ``_bs`` key the log is what the
    trainer gave before the row counts: each metric weighted by its batch's
    rows (val batches of 2, 2 and 1 rows here)."""
    from test_torch_training import TRAIN, _Video

    from slotformer_tpu_torch.runtime import MeterBank

    params = BaseParams(**{**TRAIN, "val_batch_size": 2})
    dm = BaseDataModule(params, _Video(4), _Video(5, seed=1))
    torch.manual_seed(0)
    method = build_method(model=build_model(params, device="cpu"),
                          datamodule=dm, params=params,
                          ckp_path=str(tmp_path / "ckp"))
    got = method.validation_epoch()
    want = MeterBank()
    method.model.eval()
    with torch.no_grad():
        for i, batch in enumerate(dm.val_loader):
            db = method._to_device(batch)
            losses = method.model.eval_loss(
                db, generator=torch.Generator().manual_seed(i))
            want.update(losses, n=db["img"].shape[0])
    assert [len(b["img"]) for b in dm.val_loader] == [2, 2, 1]
    assert got == want.averages()
    assert sorted(got) == ["kld_loss", "post_recon_loss"]


def test_cli_trains_aloe_with_question_level_validation(tmp_path, monkeypatch):
    """``cli.train`` on the golden config: the row losses and the
    question-level accuracies in the log, a checkpoint the eval CLI reads."""
    from slotformer_tpu_torch.runtime import latest_checkpoint
    from slotformer_tpu_torch.runtime import method as method_mod

    cfg = write_params(tmp_path / "vqa_train_cfg.py", dict(VQA_CFG, print_iter=1))
    log = []
    orig = method_mod.BaseMethod._log
    monkeypatch.setattr(method_mod.BaseMethod, "_log",
                        lambda self, rec: (log.append(rec), orig(self, rec)))
    ckp = str(tmp_path / "ckp")
    train_cli.main(["--params", cfg, "--ckp_path", ckp, "--device", "cpu",
                    "--san_check_val_step", "1"])
    train = [r for r in log if r["phase"] == "train"]
    val = [r for r in log if r["phase"] == "val"]
    assert [r["step"] for r in train] == [1, 2, 3, 4]  # 32 rows // 8
    assert all(np.isfinite(r["cls_answer_loss"]) and np.isfinite(r["mc_answer_loss"])
               for r in train)
    assert len(val) == 2 and all(f"{q}_acc" in val[-1] for q in ACCS)
    metrics = test_clevrer_vqa.main(["--params", cfg, "--weight",
                                     latest_checkpoint(ckp), "--split", "val",
                                     "--device", "cpu"])
    assert metrics["multiple-choice_n"] == 9
