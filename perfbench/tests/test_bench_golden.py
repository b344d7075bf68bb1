"""The reference's readings of the three training cells, bit for bit.

``golden_first_steps.json`` holds `reference.first_steps` of each cell's
configuration at the CPU's size (`conftest.TINY_MODEL`) on two seeds, as
float hex, recorded from the reference as it stood before it took more than
one stage.  The reference of a one-stage model and of ResNet-50 has to give
the same numbers, operation for operation."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import program, reference
from perfbench import weights as seeded

from conftest import tiny_cell

GOLDEN = Path(__file__).with_name("golden_first_steps.json")
TRAIN_CELLS = ["sb-antisym-64x16.train-resident", "resnet50-224.train-resident",
               "sb-antisym-64x16.train-stream"]
SEEDS = [4_000_000_017, 2 ** 31 + 11]


def first_steps(bench, name: str, seed: int) -> dict:
    """The reference's readings of the cell ``name`` at the CPU's size, as a
    run hands it the seed's weights, state and feed."""
    _, config, traffic = tiny_cell(bench, name)
    model_d, recipe = config["model"], config["train"]
    images, labels = seeded.images_and_labels(config["train_images"], model_d["image_shape"],
                                              model_d["num_classes"], seed, "train", "cpu")
    model, shapes = program.build(config, seed, "cpu")
    state = reference.initial_state({n: tuple(b.shape) for n, b in model.named_buffers()}, "cpu")
    feed = bench.kind(traffic["kind"]).batches(traffic, config, images, labels, seed)
    return reference.first_steps(config["family"], model_d,
                                 program.initial_weights(config, shapes, seed, "cpu"), state,
                                 feed, recipe["learning_rate"], recipe["adam_epsilon"])


def as_hex(value):
    """Every float of a reading as ``float.hex``."""
    if isinstance(value, dict):
        return {k: as_hex(v) for k, v in value.items()}
    if isinstance(value, list):
        return [as_hex(v) for v in value]
    return float(value).hex()


@pytest.fixture
def one_thread():
    """One CPU thread, as the readings were recorded: a sum's order then
    does not depend on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_reference_gives_the_recorded_readings(bench, one_thread, name, seed):
    recorded = json.loads(GOLDEN.read_text())[name][str(seed)]
    assert as_hex(first_steps(bench, name, seed)) == recorded
