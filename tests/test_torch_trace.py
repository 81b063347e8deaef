"""The port's spans (``slotformer_tpu_torch/trace.py``): nothing recorded
without a profiler, and under ``torch.profiler`` each span by name, as many
times as the work has boundaries, nested as the layers are. Tiny widths, on
the CPU.
"""

import json
import subprocess
import sys
import types

import numpy as np
import torch

from slotformer_tpu_torch.cli.extract_slots import extract_video_slots
from slotformer_tpu_torch.kernels import slot_attention as k1
from slotformer_tpu_torch.methods import build_method
from slotformer_tpu_torch.models import build_model
from slotformer_tpu_torch.models.slotformer import SingleStepSlotRollouter
from slotformer_tpu_torch.runtime import BaseDataModule, BaseParams
from slotformer_tpu_torch import trace
from torch_port_helpers import randn, rng, sf_batch, sf_cfg, t

T = 3  # frames of a StoSAVi clip
SAVI = dict(
    model="StoSAVi", max_epochs=1, save_interval=1.0, eval_interval=1,
    print_iter=1, optimizer="Adam", lr=1e-3, clip_grad=0.05,
    warmup_steps_pct=0.1, train_batch_size=2, val_batch_size=2, num_workers=0,
    resolution=(16, 16), input_frames=T, post_recon_loss_w=1.0, kld_loss_w=1e-4,
    slot_dict=dict(num_slots=3, slot_size=16, slot_mlp_size=32,
                   num_iterations=2, kernel_mlp=False),
    enc_dict=dict(enc_channels=(3, 8, 8), enc_ks=5, enc_out_channels=16,
                  enc_norm=""),
    dec_dict=dict(dec_channels=(16, 8, 8), dec_resolution=(4, 4), dec_ks=5,
                  dec_norm=""),
    pred_dict=dict(pred_type="mlp", pred_rnn=False, pred_norm_first=True),
    loss_dict=dict(use_post_recon_loss=True, kld_method="var-0.01"))
NAMES = ("step.forward", "step.backward", "step.optimizer",
         "slotformer.rollouter", "slotformer.image_loss", "savi.frame_step",
         "k1.backward", "extract.load")


class _Rows:
    """A dataset of the rows of a collated batch."""

    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return len(next(iter(self.batch.values())))

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.batch.items()}


class _Videos:
    """What ``extract_video_slots`` reads: ``files``, ``get_video`` and
    ``load_video``."""

    def __init__(self, n, frames, res, seed=0):
        r = np.random.default_rng(seed)
        self.videos = r.uniform(-1, 1, (n, frames, res, res, 3)).astype(np.float32)
        self.files = [f"video_{i}.mp4" for i in range(n)]
        self.load_video = False

    def get_video(self, i):
        return {"video": self.videos[i]}


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def _spans(prof):
    """{span name: [(start, end)] in time order} of the port's spans."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in NAMES:
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return {n: sorted(iv) for n, iv in out.items()}


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _savi_method(tmp_path, **over):
    """A StoSAVi method over 6 clips (3 steps an epoch) and a batch of 2."""
    params = BaseParams(**{**SAVI, **over})
    img = np.tanh(randn(rng(0), 6, T, 16, 16, 3)).astype(np.float32)
    rows = {"img": img, "data_idx": np.arange(6)}
    torch.manual_seed(0)
    method = build_method(model=build_model(params, device="cpu"),
                          datamodule=BaseDataModule(params, _Rows(rows), None),
                          params=params, ckp_path=str(tmp_path / "ckp"))
    return method, {k: v[:2] for k, v in rows.items()}


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    """No profiler: every span is one shared no-op context, and no
    ``record_function`` is made."""
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    a, b = trace.span("step.forward"), trace.span("k1.backward")
    assert a is b is trace._OFF
    with a:
        torch.ones(2).sum()
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("step.forward"):
            pass
    assert made == ["step.forward"]
    assert trace.span("step.forward") is trace._OFF


def test_kernels_and_models_import_no_runtime():
    """``trace`` is a leaf: the kernels and models that mark spans load no
    module of the trainer's runtime."""
    code = ("import sys, slotformer_tpu_torch.kernels.slot_attention, "
            "slotformer_tpu_torch.models.savi, slotformer_tpu_torch.models.slotformer; "
            "print([m for m in sys.modules "
            "if m.startswith('slotformer_tpu_torch.runtime')])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_stosavi_train_step_spans(tmp_path):
    """step.forward holds one savi.frame_step a frame; then step.backward,
    then step.optimizer."""
    method, batch = _savi_method(tmp_path)
    got = _profiled(lambda: method._train_step(batch))
    assert sorted(got) == ["savi.frame_step", "step.backward", "step.forward",
                           "step.optimizer"]
    (fwd,), (bwd,), (opt,) = (got[n] for n in
                              ("step.forward", "step.backward", "step.optimizer"))
    assert len(got["savi.frame_step"]) == T
    assert all(_inside(s, fwd) for s in got["savi.frame_step"])
    assert fwd[1] <= bwd[0] and bwd[1] <= opt[0]


def test_accumulating_step_has_no_optimizer_span(tmp_path):
    method, batch = _savi_method(tmp_path, accum_grad=2)
    got = _profiled(lambda: method._train_step(batch))
    assert "step.optimizer" not in got and len(got["step.backward"]) == 1


def test_slotformer_train_step_spans_on_the_chunked_branch():
    """The chunked branch: slotformer.rollouter, then slotformer.image_loss,
    both inside step.forward."""
    params = BaseParams(**dict(
        model="SlotFormer", max_epochs=4, optimizer="Adam", lr=3e-4,
        warmup_steps_pct=0.0, train_batch_size=2, val_batch_size=2,
        num_workers=0, print_iter=1, input_frames=3, n_sample_frames=7,
        use_loss_decay=True, loss_decay_pct=0.5, slot_recon_loss_w=1.0,
        img_recon_loss_w=1.0, **sf_cfg(dec_chunk_frames=4)))
    batch = sf_batch(3)
    torch.manual_seed(0)
    model = build_model(params, device="cpu")
    method = build_method(model=model,
                          datamodule=BaseDataModule(params, _Rows(batch), None),
                          params=params, ckp_path="")
    got = _profiled(lambda: method._train_step(batch))
    (fwd,), (ro,), (img,) = (got[n] for n in (
        "step.forward", "slotformer.rollouter", "slotformer.image_loss"))
    assert _inside(ro, fwd) and _inside(img, fwd) and ro[1] <= img[0]
    assert len(got["step.backward"]) == len(got["step.optimizer"]) == 1


def test_rollout_has_one_rollouter_span():
    torch.manual_seed(0)
    model = build_model(BaseParams(model="SlotFormer", input_frames=3,
                                   n_sample_frames=7, **sf_cfg()),
                        device="cpu").eval()
    slots = t(sf_batch(1)["slots"])
    with torch.no_grad():
        got = _profiled(lambda: model({"slots": slots}))
    assert list(got) == ["slotformer.rollouter"]
    assert len(got["slotformer.rollouter"]) == 1


def test_single_step_rollout_has_one_rollouter_span():
    """PHYRE's rollouter, from one frame over a growing context."""
    torch.manual_seed(0)
    ro = SingleStepSlotRollouter(4, 16, 1, 3, d_model=16, num_layers=1,
                                 num_heads=2, ffn_dim=32, dropout=0.0).eval()
    x = t(randn(rng(2), 2, 1, 4, 16))
    out = []
    with torch.no_grad():
        got = _profiled(lambda: out.append(ro(x, 5)))
    assert out[0].shape == (2, 5, 4, 16)
    assert list(got) == ["slotformer.rollouter"]
    assert len(got["slotformer.rollouter"]) == 1


def test_extract_video_slots_has_one_load_span_a_batch():
    params = BaseParams(**SAVI)
    torch.manual_seed(0)
    model = build_model(params, device="cpu").eval()
    videos = _Videos(5, 4, 16)
    got = _profiled(lambda: extract_video_slots(model, videos, 2, 2))
    assert len(got["extract.load"]) == 3  # 5 videos in batches of 2
    # two chunks of two frames a batch
    assert len(got["savi.frame_step"]) == 3 * 4
    assert not any(_inside(s, load) for s in got["savi.frame_step"]
                   for load in got["extract.load"])


def test_k1_backward_equals_plain_autograd_and_is_recorded():
    """``_FusedSlotAttention.backward`` on a stub context of CPU tensors:
    the gradients of plain autograd, inside one k1.backward span."""
    r = rng(4)
    B, N, D, S, H = 2, 24, 16, 5, 32
    shapes = dict(wq=(D, D), w1=(D, H), b1=(H,), w2=(H, D))
    wp = {}
    for n in k1.WP_KEYS:
        shape = shapes.get(n, (D, D) if n.startswith("w_") else (D,))
        wp[n] = t(randn(r, *shape) * (shape[0] ** -0.5 if len(shape) == 2 else 0.1))
    packed = k1.pack_weights(wp)
    w = [packed[n].detach() for n in k1.PACKED_KEYS]
    k, v, slots = t(randn(r, B, N, D)), t(randn(r, B, N, D)), t(randn(r, B, S, D))
    g_slots, g_attn = t(randn(r, B, S, D)), t(randn(r, B, N, S))
    args = (2, S, D ** -0.5, 1e-6)
    ctx = types.SimpleNamespace(saved_tensors=(k, v, slots, *w), args=args)
    grads = []
    got = _profiled(lambda: grads.extend(
        k1._FusedSlotAttention.backward(ctx, g_slots, g_attn)))
    assert len(got["k1.backward"]) == 1
    assert grads[:4] == [None] * 4
    inputs = [x.clone().requires_grad_(True) for x in (k, v, slots, *w)]
    out = k1.fused_slot_attention_plain(
        *inputs[:3], dict(zip(k1.PACKED_KEYS, inputs[3:])), *args)
    want = torch.autograd.grad(out, inputs, (g_slots, g_attn), allow_unused=True)
    for g, wg in zip(grads[4:], want):
        if wg is None:
            assert g is None
        else:
            torch.testing.assert_close(g, wg, rtol=0, atol=0)


def test_profile_steps_trace_holds_the_spans(tmp_path):
    """The trace ``profile_steps`` exports holds the trainer's spans."""
    method, _ = _savi_method(tmp_path, profile_steps=(1, 2))
    method.fit(san_check_val_step=0)
    with open(tmp_path / "ckp" / "profile" / "trace_2.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("step.forward") == 1
    assert names.count("savi.frame_step") == T

