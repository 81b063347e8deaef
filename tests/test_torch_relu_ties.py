"""``chip_smoke._tied_pair``: the second run takes the first run's side at
every ReLU, counts the units it would have put on the other side, and
refuses two runs that make different ReLU calls. CPU only: both runs are
on the CPU here, the first standing for the card's."""

import os
import sys

import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


RELU = F.relu


def _mlp_grads(x, w1, b, w2):
    """Gradients of sum(relu(x @ w1 + b) @ w2) with respect to w1 and w2."""
    w1, w2 = w1.clone().requires_grad_(), w2.clone().requires_grad_()
    (F.relu(x @ w1 + b) @ w2).sum().backward()
    return w1.grad, w2.grad


def _inputs():
    g = torch.Generator().manual_seed(0)
    return (torch.randn(8, 16, generator=g), torch.randn(16, 32, generator=g),
            torch.zeros(32), torch.randn(32, 4, generator=g))


def test_identical_runs_take_the_same_sides():
    x, w1, b, w2 = _inputs()
    first, second, ties = chip_smoke._tied_pair(lambda: _mlp_grads(x, w1, b, w2),
                                                lambda: _mlp_grads(x, w1, b, w2))
    assert ties == dict(relu_calls=1, untied=0, untied_rel_x=0.0)
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    assert F.relu is RELU  # put back


def test_a_unit_on_the_other_side_of_zero_is_tied_and_counted():
    x, w1, b, w2 = _inputs()
    # unit 3 of row 0 just above 0 in the first run, just below in the second
    pre = (x @ w1)[0, 3]
    above, below = b.clone(), b.clone()
    above[3], below[3] = -pre + 1e-5, -pre - 1e-5
    assert (x @ w1 + above)[0, 3] > 0 > (x @ w1 + below)[0, 3]
    first, second, ties = chip_smoke._tied_pair(
        lambda: _mlp_grads(x, w1, above, w2), lambda: _mlp_grads(x, w1, below, w2))
    assert ties["relu_calls"] == 1 and ties["untied"] == 1
    assert 0 < ties["untied_rel_x"] <= chip_smoke.RELU_TIE_RTOL
    # on its own side the second run's w1 gradient loses row 0's share in
    # unit 3; at the first run's side it keeps it
    own = _mlp_grads(x, w1, below, w2)[0]
    assert (own[:, 3] - first[0][:, 3]).abs().max() > 1e-2
    assert torch.allclose(second[0], first[0], atol=1e-5)
    assert torch.allclose(second[1], first[1], atol=1e-4)
    assert F.relu is RELU


def test_runs_with_different_relu_calls_are_refused():
    x, w1, b, w2 = _inputs()
    with pytest.raises(AssertionError, match="different ReLU calls"):
        chip_smoke._tied_pair(lambda: _mlp_grads(x, w1, b, w2),
                              lambda: _mlp_grads(x[:4], w1, b, w2))
    with pytest.raises(AssertionError, match="different ReLU calls"):
        chip_smoke._tied_pair(lambda: _mlp_grads(x, w1, b, w2), lambda: None)
    assert F.relu is RELU
