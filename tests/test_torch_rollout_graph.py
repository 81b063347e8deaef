"""SlotRollouter's rollout as one CUDA graph, on the card: the replay against
the eager loop at CLEVRER's widths, outputs held across calls, weights
updated in place or replaced, one graph per batch size in a bounded cache,
the cases that keep the loop eager, and a capture that fails.

Marked ``cuda`` and skipped without a card. Imports no JAX:

    python -m pytest tests/test_torch_rollout_graph.py --noconftest -q -s

The replay launches the kernels the eager loop launches, in the same order,
on the same inputs: the two are compared bit for bit (``-s`` prints the
largest difference).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from torch import nn

from slotformer_tpu_torch.models.slotformer import SlotRollouter
from slotformer_tpu_torch.parallel.mesh import Grid
from slotformer_tpu_torch.parallel.tp import ColumnParallelLinear

ROOT = Path(__file__).resolve().parents[1]
# slotformer_tpu_torch/configs/slotformer_clevrer_params.py's rollouter
CLEVRER = dict(num_slots=7, slot_size=128, history_len=6, t_pe="sin",
               slots_pe="", d_model=256, num_layers=4, num_heads=8,
               ffn_dim=1024, norm_first=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rollouter(device, seed=0):
    torch.manual_seed(seed)
    return SlotRollouter(**CLEVRER).to(device).eval()


def _slots(B, device, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, 6, 7, 128, generator=g).to(device)


def _eager(m, x, pred_len):
    with torch.no_grad():
        return m._rollout(x, pred_len)


@pytest.mark.cuda
@pytest.mark.parametrize("B,pred_len", [(8, 42), (128, 10)])
def test_replay_matches_the_eager_loop(cuda, B, pred_len):
    """test_vp's rollout (B=8, 42 steps) and the training shape (B=128, 10
    steps): the replay gives the eager loop's bits, the first call (the
    capture's) and a later one alike."""
    m, x = _rollouter(cuda), _slots(B, cuda)
    want = _eager(m, x, pred_len)
    with torch.no_grad():
        first, second = m(x, pred_len), m(x, pred_len)
    assert len(m._graphs.by_key) == 1
    err = max(float((y - want).abs().max()) for y in (first, second))
    print(f"B={B} pred_len={pred_len}: max |replay - eager| = {err}")
    assert first.shape == (B, pred_len, 7, 128)
    assert err == 0.0


@pytest.mark.cuda
def test_each_call_keeps_its_own_answer(cuda):
    """Two inputs through one graph: each output is its own input's, and the
    second call does not write over the first's output."""
    m, a, b = _rollouter(cuda), _slots(8, cuda, 1), _slots(8, cuda, 2)
    with torch.no_grad():
        ya = m(a, 42)
        kept = ya.clone()
        yb = m(b, 42)
    assert len(m._graphs.by_key) == 1
    assert torch.equal(ya, kept) and not torch.equal(ya, yb)
    assert torch.equal(ya, _eager(m, a, 42)) and torch.equal(yb, _eager(m, b, 42))


@pytest.mark.cuda
def test_weights_updated_in_place_are_read(cuda):
    """An optimizer's step or ``load_state_dict`` writes the weights where
    they are: the graph reads them there, without a new capture."""
    m, x = _rollouter(cuda), _slots(8, cuda)
    other = _rollouter(cuda, seed=3).state_dict()
    with torch.no_grad():
        before = m(x, 42)
        m.out_proj.bias.add_(1.0)
        bumped = m(x, 42)
        m.load_state_dict(other)
        loaded = m(x, 42)
    assert len(m._graphs.by_key) == 1
    assert not torch.equal(before, bumped)
    assert torch.equal(loaded, _eager(m, x, 42))
    assert torch.equal(loaded, _eager(_rollouter(cuda, seed=3), x, 42))


@pytest.mark.cuda
def test_a_replaced_parameter_is_captured_anew(cuda):
    m, x = _rollouter(cuda), _slots(8, cuda)
    with torch.no_grad():
        m(x, 42)
        m.in_proj.weight = nn.Parameter(m.in_proj.weight * 2)
        got = m(x, 42)
    assert len(m._graphs.by_key) == 2
    assert torch.equal(got, _eager(m, x, 42))


@pytest.mark.cuda
def test_batch_sizes_get_their_own_graphs_in_a_bounded_cache(cuda):
    """A partial last batch is a key of its own; past the cache's size the
    least recently used graph goes, and a later call captures it again."""
    m = _rollouter(cuda)
    size = m._graphs.size
    sizes = range(1, size + 3)
    with torch.no_grad():
        for n, B in enumerate(sizes, 1):
            x = _slots(B, cuda, seed=B)
            assert torch.equal(m(x, 10), _eager(m, x, 10))
            assert len(m._graphs.by_key) == min(n, size)
        x = _slots(1, cuda, seed=1)
        assert torch.equal(m(x, 10), _eager(m, x, 10))
    assert len(m._graphs.by_key) == size
    assert [k[0][0] for k in m._graphs.by_key] == [*sizes[-size + 1:], 1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grad", "train", "tp", "capturing"])
def test_the_loop_runs_eagerly_where_a_graph_cannot(cuda, case):
    """With gradients, in training mode, with a tensor-parallel module
    (whose forward may all-reduce) or inside another capture, the loop runs
    eagerly: no graph of the rollouter's own."""
    m, x = _rollouter(cuda), _slots(8, cuda)
    if case == "tp":  # a one-wide model axis: no collective runs
        layer = m.transformer_encoder.layers[0]
        layer.linear1 = ColumnParallelLinear(layer.linear1, Grid())
    if case == "train":
        m.train()
    if case == "capturing":
        outer = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _eager(m, x, 6)
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad(), torch.cuda.graph(outer):
            got = m(x, 6)
        outer.replay()
        torch.cuda.synchronize()
    else:
        with torch.set_grad_enabled(case == "grad"):
            torch.manual_seed(0)
            got = m(x, 6)
    assert len(m._graphs.by_key) == 0
    assert got.requires_grad == (case == "grad")
    if case != "train":
        assert torch.equal(got.detach(), _eager(m, x, 6))


FAILED_CAPTURE = textwrap.dedent("""
    import torch
    from slotformer_tpu_torch.models.slotformer import SlotRollouter

    m = SlotRollouter(num_slots=7, slot_size=128, history_len=6, d_model=256,
                      num_layers=1, num_heads=8, ffn_dim=1024).cuda().eval()
    encode = m.transformer_encoder.forward

    def syncing(*a, **k):  # a host sync: unsupported while capturing
        torch.cuda.synchronize()
        return encode(*a, **k)

    m.transformer_encoder.forward = syncing
    try:
        with torch.no_grad():
            m(torch.randn(2, 6, 7, 128, device="cuda"), 3)
    except RuntimeError as e:
        assert len(m._graphs.by_key) == 0
        print("raised:", str(e).splitlines()[0])
    else:
        print("no error")
""")


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda):
    """A capture that fails raises and keeps no graph; it never falls back
    to the eager loop. In a process of its own: a capture that failed can
    leave the CUDA context unusable."""
    run = subprocess.run([sys.executable, "-c", FAILED_CAPTURE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.startswith("raised:"), run.stdout
