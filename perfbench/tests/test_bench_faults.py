"""The timed path broken underneath a whole run on the CPU, with the cells'
own limits: each fault a cell can have turns ``correct`` false.  (One card,
so no cell has an exchange between chips to leave out.)"""

import pytest
import torch

from differential_equations_resnet_tpu_torch.train import train_step
from differential_equations_resnet_tpu_torch.utils import serving

from conftest import train_cases

TRAIN_CELLS = ["sb-antisym-64x16.train-resident", "resnet50-224.train-resident",
               "sb-antisym-64x16.train-stream"]
TRAIN_CASES = train_cases(TRAIN_CELLS)


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_sound_training_run_is_correct(run_tiny, name):
    assert run_tiny(name)["correct"]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_a_step_that_leaves_its_state_unchanged_fails(run_tiny, monkeypatch, name):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    result = run_tiny(name)
    assert not result["correct"]
    assert result["checks"]["change"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name,model", TRAIN_CASES)
def test_half_the_batch_left_out_fails(run_tiny, monkeypatch, name, model):
    whole = train_step.cross_entropy_from_logits

    def half(logits, labels):
        n = logits.shape[0] // 2
        return whole(logits[:n], labels[:n])

    monkeypatch.setattr(train_step, "cross_entropy_from_logits", half)
    assert not run_tiny(name, model=model)["correct"]


def test_an_altered_answer_fails(run_tiny, monkeypatch):
    forward = serving._Fp32Program.forward
    calls = {"n": 0}

    def altered(self, x):
        out = forward(self, x)
        calls["n"] += 1
        return out.roll(1, dims=-1) if calls["n"] == 7 else out

    monkeypatch.setattr(serving._Fp32Program, "forward", altered)
    result = run_tiny("sb-antisym-64x16.serve-b1-poisson")
    assert not result["correct"]
    assert result["checks"]["prob_gap"]["value"] > result["checks"]["prob_gap"]["limit"]
