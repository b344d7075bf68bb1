"""Train-mode batch norm's plain version (`ops.kernels.batch_norm`), the
yardstick of its CUDA kernels, and the route `models.blocks.batch_norm`
takes, on the CPU.

The plain version's forward, closed-form backward and running statistics
are held against autograd of the composite of torch ops
(`blocks.composite_batch_norm`) in float64 (and its fp32 forward against
the composite's bit for bit), at ResNet-50's nine batch-norm shapes cut in
rows and at the single-block family's C = 8 and 16.  The route: only CUDA
fp32 tensors reach the kernels; train mode on the CPU, eval mode, another
dtype and a data group of more than one rank keep the composite.  The kernels' launch plan, their C signatures,
their calls in the record of hand-kernel calls and the benchmark's two
readers of the kernels (``perfbench/metrics/bn_*.train.py``) are checked
here too; the kernels themselves run in
``tests/test_torch_cuda_batch_norm.py``.
"""

import ctypes
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from differential_equations_resnet_tpu_torch.models import blocks
from differential_equations_resnet_tpu_torch.ops.kernels import batch_norm as fbn
from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi
from differential_equations_resnet_tpu_torch.ops.kernels._build import SOURCES
from differential_equations_resnet_tpu_torch.utils.tracing import STACKS, StackEntry, StackRecord

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.program import MetricContext  # noqa: E402
from perfbench.registry import Benchmark  # noqa: E402
from perfbench.trace import Trace  # noqa: E402

# ResNet-50's batch norms at batch 32 and 224x224, as (rows, C), and the
# same with the rows cut about 1024 times: (N, H, W) for each.
RESNET50_SHAPES = [(401_408, 64), (100_352, 64), (100_352, 256), (25_088, 128), (25_088, 512),
                   (6_272, 256), (6_272, 1024), (1_568, 512), (1_568, 2048)]
CUT = [(2, 14, 14), (2, 7, 7), (2, 7, 7), (1, 5, 5), (1, 5, 5), (1, 7, 1), (1, 7, 1), (2, 1, 1),
       (2, 1, 1)]
SHAPES = ([(*cut, c) for cut, (_, c) in zip(CUT, RESNET50_SHAPES)]
          + [(2, 4, 4, 8), (2, 4, 4, 16)])
F64_TOL = dict(rtol=1e-10, atol=1e-10)


def bn_inputs(shape, dtype=torch.float64, seed=0):
    """x (mean about 2, spread 3), scale, offset, running mean and variance."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    arrays = [2.0 + 3.0 * rng.standard_normal(shape), 1.0 + 0.1 * rng.standard_normal(c),
              0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c),
              rng.uniform(0.5, 1.5, c)]
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_plain_version_matches_autograd_of_the_composite(shape):
    """y, the batch mean and inv, the new running statistics and the
    closed-form dx, dscale, doffset against `blocks.composite_batch_norm`
    and autograd through it, in float64."""
    x, scale, offset, mean, var = bn_inputs(shape)
    leaves = [t.clone().requires_grad_() for t in (x, scale, offset)]
    want_y, want_state = blocks.composite_batch_norm(
        leaves[0], blocks.BatchNormParams(*leaves[1:]), blocks.BatchNormState(mean, var), True)
    assert type(want_y.grad_fn).__name__ != "FusedBatchNormBackward"
    dy = torch.cos(want_y.detach())
    want_grads = torch.autograd.grad(want_y, leaves, dy)

    y, stats = fbn.reference_batch_norm(x, scale, offset, mean, var, blocks.BN_EPSILON,
                                        blocks.BN_MOMENTUM)
    torch.testing.assert_close(y, want_y.detach(), **F64_TOL)
    torch.testing.assert_close(stats[2], want_state.mean, **F64_TOL)
    torch.testing.assert_close(stats[3], want_state.var, **F64_TOL)
    rows = x.reshape(-1, shape[-1])
    torch.testing.assert_close(stats[0], rows.mean(0), **F64_TOL)
    torch.testing.assert_close(stats[1], torch.rsqrt(rows.var(0, correction=0) + 1e-3), **F64_TOL)
    got = fbn.reference_batch_norm_bwd(dy, x, stats, scale)
    for name, a, b in zip(("dx", "dscale", "doffset"), got, want_grads):
        torch.testing.assert_close(a, b, **F64_TOL, msg=name)


@pytest.mark.parametrize("shape", SHAPES[:3] + SHAPES[-2:],
                         ids=["x".join(map(str, s)) for s in SHAPES[:3] + SHAPES[-2:]])
def test_fp32_plain_version_is_the_composites_forward(shape):
    """In fp32 the plain version's y and running statistics are the
    composite's bit for bit (its forward is the composite's arithmetic, as
    the kernels' is), and its closed-form dx, dscale and doffset are within
    fp32 rounding of the float64 run's."""
    x64, *rest64 = bn_inputs(shape, seed=1)
    x32, scale, offset, mean, var = (t.float() for t in (x64, *rest64))
    y32, stats32 = fbn.reference_batch_norm(x32, scale, offset, mean, var, blocks.BN_EPSILON,
                                            blocks.BN_MOMENTUM)
    batch_var, batch_mean = torch.var_mean(x32, dim=(0, 1, 2), correction=0)
    inv = torch.rsqrt(batch_var + blocks.BN_EPSILON)
    assert torch.equal(y32, (x32 - batch_mean) * inv * scale + offset)
    assert torch.equal(stats32, torch.stack([batch_mean, inv, 0.99 * mean + 0.01 * batch_mean,
                                             0.99 * var + 0.01 * batch_var]))
    y64, stats64 = fbn.reference_batch_norm(x64, *rest64, blocks.BN_EPSILON, blocks.BN_MOMENTUM)
    dy64 = torch.cos(y64)
    got = fbn.reference_batch_norm_bwd(dy64.float(), x32, stats32, scale)
    want = fbn.reference_batch_norm_bwd(dy64, x64, stats64, rest64[0])
    for name, a, b in zip(("dx", "dscale", "doffset"), got, want):
        scale_ = float(b.abs().max())
        torch.testing.assert_close(a.double(), b, rtol=0, atol=1e-5 * scale_, msg=name)


def test_cpu_train_mode_on_fp32_keeps_the_composite():
    """Train mode on an fp32 CPU tensor takes the composite and autograd's
    backward through it, not `FusedBatchNorm`: y, the new running
    statistics and the gradients of `blocks.composite_batch_norm` bit for
    bit (the plain version's forward too), and no kernel launch."""
    x, scale, offset, mean, var = bn_inputs((2, 3, 5, 8), torch.float32)
    leaves = [t.clone().requires_grad_() for t in (x, scale, offset)]
    before = STACKS.calls("BN"), STACKS.launches("BN")
    y, state = blocks.batch_norm(leaves[0], blocks.BatchNormParams(*leaves[1:]),
                                 blocks.BatchNormState(mean, var), True)
    assert type(y.grad_fn).__name__ != "FusedBatchNormBackward"
    want_leaves = [t.clone().requires_grad_() for t in (x, scale, offset)]
    want_y, want_state = blocks.composite_batch_norm(
        want_leaves[0], blocks.BatchNormParams(*want_leaves[1:]),
        blocks.BatchNormState(mean, var), True)
    assert torch.equal(y, want_y)
    assert torch.equal(state.mean, want_state.mean) and torch.equal(state.var, want_state.var)
    assert not state.mean.requires_grad and not state.var.requires_grad
    plain_y, stats = fbn.reference_batch_norm(x, scale, offset, mean, var, blocks.BN_EPSILON,
                                              blocks.BN_MOMENTUM)
    assert torch.equal(y.detach(), plain_y)
    dy = torch.cos(plain_y)
    for a, b in zip(torch.autograd.grad(y, leaves, dy), torch.autograd.grad(want_y, want_leaves, dy)):
        assert torch.equal(a, b)
    assert (STACKS.calls("BN"), STACKS.launches("BN")) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_kernels_take_only_cuda_fp32_tensors(dtype):
    """`fused_batch_norm` has no CPU route: a CPU tensor is refused before
    anything runs, and nothing is counted."""
    x, scale, offset, mean, var = bn_inputs((2, 3, 5, 8), dtype)
    before = STACKS.calls("BN"), STACKS.launches("BN")
    with pytest.raises(ValueError, match="CUDA"):
        fbn.fused_batch_norm(x, scale, offset, mean, var, blocks.BN_EPSILON, blocks.BN_MOMENTUM)
    assert (STACKS.calls("BN"), STACKS.launches("BN")) == before


def test_a_non_contiguous_fp32_input_is_normalized_as_its_copy():
    x, scale, offset, mean, var = bn_inputs((2, 5, 3, 8), torch.float32)
    params, state = blocks.BatchNormParams(scale, offset), blocks.BatchNormState(mean, var)
    y, _ = blocks.batch_norm(x.transpose(1, 2), params, state, True)
    want, _ = blocks.batch_norm(x.transpose(1, 2).contiguous(), params, state, True)
    assert torch.equal(y, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64])
def test_other_dtypes_keep_the_composite(dtype):
    """Train mode on a tensor that is not fp32 takes the composite of torch
    ops, as before: not `FusedBatchNorm`."""
    x, scale, offset, mean, var = bn_inputs((2, 3, 5, 8), dtype)
    x.requires_grad_()
    y, state = blocks.batch_norm(x, blocks.BatchNormParams(scale, offset),
                                 blocks.BatchNormState(mean.float(), var.float()), True)
    assert y.dtype == dtype and type(y.grad_fn).__name__ != "FusedBatchNormBackward"
    rows = x.detach().double().reshape(-1, 8)
    torch.testing.assert_close(state.mean.double(), 0.99 * mean.double() + 0.01 * rows.mean(0),
                               rtol=1e-2, atol=1e-2)


def test_eval_mode_keeps_the_running_statistics():
    x, scale, offset, mean, var = bn_inputs((2, 3, 5, 8), torch.float32)
    x.requires_grad_()
    state = blocks.BatchNormState(mean, var)
    y, new_state = blocks.batch_norm(x, blocks.BatchNormParams(scale, offset), state, False)
    assert new_state is state and type(y.grad_fn).__name__ != "FusedBatchNormBackward"
    assert torch.equal(y, (x - mean) * torch.rsqrt(var + blocks.BN_EPSILON) * scale + offset)


def test_a_data_group_of_more_than_one_rank_keeps_the_global_moments(monkeypatch):
    """Inside a data group of two ranks train mode takes `_global_moments`
    (stubbed here with the local moments) and not `FusedBatchNorm`."""
    calls = []

    def moments(x, group):
        calls.append(group)
        var, mean = torch.var_mean(x, dim=(0, 1, 2), correction=0)
        return mean, var

    monkeypatch.setattr(blocks, "data_group", lambda: "data")
    monkeypatch.setattr(blocks.dist, "get_world_size", lambda group: 2)
    monkeypatch.setattr(blocks, "_global_moments", moments)
    x, scale, offset, mean, var = bn_inputs((2, 3, 5, 8), torch.float32)
    x.requires_grad_()
    y, _ = blocks.batch_norm(x, blocks.BatchNormParams(scale, offset),
                             blocks.BatchNormState(mean, var), True)
    assert calls == ["data"] and type(y.grad_fn).__name__ != "FusedBatchNormBackward"


@pytest.mark.parametrize("rows,channels", RESNET50_SHAPES + [(12_288, 8), (12_288, 16)],
                         ids=[f"{m}x{c}" for m, c in RESNET50_SHAPES + [(12_288, 8), (12_288, 16)]])
def test_plan_covers_the_tensor(rows, channels):
    """At ResNet-50's shapes (and C = 8, 16): four channels a thread, the
    channel groups cover C, the chunks cover the rows with none empty, each
    thread has a row, and the grid is about four blocks of each of 132
    SMs (at least two where the rows allow)."""
    plan = fbn.bn_plan(rows, channels)
    assert plan["vec"] == 4
    lanes = plan["lanes"]
    assert lanes & (lanes - 1) == 0 and lanes <= 32 and fbn.THREADS % lanes == 0
    assert (plan["groups"] - 1) * lanes * 4 < channels <= plan["groups"] * lanes * 4
    assert (plan["chunks"] - 1) * plan["chunk"] < rows <= plan["chunks"] * plan["chunk"]
    assert plan["chunk"] >= fbn.THREADS // lanes or plan["chunks"] == 1
    blocks_ = plan["chunks"] * plan["groups"]
    assert blocks_ <= fbn.BLOCKS_PER_SM * fbn.SM_COUNT + plan["groups"]
    assert blocks_ >= 2 * fbn.SM_COUNT or plan["chunk"] <= 2 * fbn.THREADS // lanes


@pytest.mark.parametrize("channels,aligned,vec,lanes", [
    (64, True, 4, 16), (64, False, 1, 32), (6, True, 1, 8), (3, True, 1, 4), (1, True, 1, 1),
    (2048, True, 4, 32), (100, True, 4, 32)])
def test_plan_vector_width_and_lanes(channels, aligned, vec, lanes):
    plan = fbn.bn_plan(1000, channels, aligned)
    assert (plan["vec"], plan["lanes"]) == (vec, lanes)


C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "const char*": ctypes.c_char_p}


@pytest.mark.parametrize("function", sorted(fbn._SIGNATURES))
def test_ctypes_signatures_match_the_source(function):
    """Each C entry point's argument and return types, read from
    ``csrc/batch_norm.cu``, are what the binding declares."""
    source = SOURCES["batch_norm"].path.read_text()
    found = re.search(r"^(const char\*|int) " + function + r"\(([^)]*)\)", source, re.MULTILINE)
    assert found, function
    params = [" ".join(p.split()[:-1]) for p in found.group(2).replace("\n", " ").split(",")]
    declared = [ctypes.c_void_p if "*" in p else C_TYPES[p] for p in params]
    argtypes, restype = fbn._SIGNATURES[function]
    assert argtypes == declared
    assert restype == C_TYPES[found.group(1)]


def test_the_kernels_use_no_atomics():
    """The partial sums combine in a fixed order: no atomic in the source,
    so two replays of a step give the same bits."""
    source = SOURCES["batch_norm"].path.read_text()
    assert not re.search(r"\batomic\w*\s*\(|\batom\.|\bred\.", source)
    assert "fused_bn_grad_stats" in source


def test_a_replay_counts_batch_norm_launches_apart(monkeypatch):
    """Batch norm's calls report to the record that B1's and B2's do, as
    kernel "BN" with x's shape and variant "forward" or "backward"; a
    graph that holds B1, B2, a wide B2 and batch norm adds each kernel's
    launches to its own totals at each replay, and its capture adds none."""
    record = StackRecord()
    for module in (fi, fbn):
        monkeypatch.setattr(module, "STACKS", record)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    x, kernels = torch.zeros(32, 8, 8, 16), torch.zeros(64, 3, 3, 16, 16)
    with record.capture("train step") as graph:
        fi._report(fi._stack_entry("B1", x, kernels, "band", 1, 1))
        fbn._report(x, "forward", 1)
        fbn._report(x, "backward", 3)
        fi._report(fi._stack_entry("B2", x, kernels[:2], "wide", 0, 6))
        fi._report(fi._stack_entry("B2", x, kernels, "band", 2, 1))
    assert record.graph("train step")[1:3] == [StackEntry("BN", (32, 8, 8, 16), "forward", 0, 1),
                                               StackEntry("BN", (32, 8, 8, 16), "backward", 0, 3)]
    assert record.launches("BN") == record.launches("B1") == record.launches("B2") == 0
    for _ in range(106):
        record.replay(graph)
    assert (record.calls("BN"), record.launches("BN")) == (212, 424)
    assert (record.launches("BN", "forward"), record.launches("BN", "backward")) == (106, 318)
    assert (record.launches("B1"), record.launches("B2")) == (106, 742)
    assert (record.calls("B2", "wide"), record.launches("B2", "wide")) == (106, 636)


# Two steps' device operations: each step one layer's four batch-norm
# launches (1 us each, their names as the profiler gives them) and a conv.
BN_OPS = ["void (anonymous namespace)::fused_bn_apply<4>(float const*, float const*, ...)",
          "void (anonymous namespace)::fused_bn_grad_stats<1>(float const*, ...)",
          "(anonymous namespace)::fused_bn_grad_finalize(double2 const*, int, ...)",
          "void (anonymous namespace)::fused_bn_grad_apply<4>(float const*, ...)"]
CONV = "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw"


def device_ops(with_bn=True):
    ops = []
    for t0 in (0.0, 100.0):
        ops.append((CONV, t0, t0 + 50.0))
        if with_bn:
            ops += [(name, t0 + 50.0 + i, t0 + 51.0 + i) for i, name in enumerate(BN_OPS)]
    return ops


@pytest.mark.parametrize("name,want", [("bn_device_ms.train", 0.004),
                                       ("bn_launches_per_step.train", 4.0)])
def test_batch_norm_readers(name, want):
    """The readers count the operations that hold the kernels' prefix, over
    the window's steps; a trace without them (the parent), or a serving
    window, reads nothing."""
    reader = Benchmark(ROOT).reader(name)
    read = lambda ops, info: reader.read(MetricContext(Trace(ops, {"window": [(0.0, 200.0)]}, [],
                                                             "window"), {}, {}, info))
    assert read(device_ops(), {"kind": "train", "calls": 2}) == pytest.approx(want, rel=1e-12)
    assert read(device_ops(with_bn=False), {"kind": "train", "calls": 2}) is None
    assert read(device_ops(), {"kind": "serve", "calls": 2}) is None
    entry = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    assert entry[name]["workloads"] == ["resnet50-224.train-resident"]
    assert entry[name]["layer"] == "model, models/blocks.py (batch norm)"
    assert entry[name]["moves"] == "train_images_per_s"
