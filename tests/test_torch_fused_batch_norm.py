"""Train-mode batch norm's plain version (`ops.kernels.batch_norm`), the
yardstick of its CUDA kernels, and the route `models.blocks.batch_norm`
takes, on the CPU.

The plain version's forward, closed-form backward and running statistics
are held against autograd of the composite of torch ops
(`blocks.composite_batch_norm`) in float64 (and its fp32 forward against
the composite's bit for bit), at ResNet-50's nine batch-norm shapes cut in
rows and at the single-block family's C = 8 and 16.  The route: only CUDA
fp32 tensors reach the kernels; train mode on the CPU, eval mode, another
dtype and a data group of more than one rank keep the composite.  The
epilogues (relu, residual add and relu): the plain version with each is the
composite followed by its torch ops bit for bit, at 0, -0.0 and NaN, and
every route that does not reach the kernels applies them the same way; a
ResNet-50 step with the kernels' launches stood in for records 4 plain, 33
relu and 16 add_relu forward calls and 20 plain and 33 relu backward.  The
kernels' launch plan, their C signatures,
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


# The epilogues and how the forward's torch ops spell them.
EPILOGUES = ("none", "relu", "add_relu")


def bits(t):
    """A tensor's bytes, so that NaNs and signed zeros compare exactly."""
    return t.detach().contiguous().view(torch.uint8)


def same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(bits(a), bits(b))


def edge_inputs(dtype=torch.float32, shape=(2, 3, 5, 8), seed=4):
    """x, scale, offset, running mean and variance, a residual and a
    cotangent whose batch norm and epilogue meet 0, -0.0 and NaN: channel 0
    is constant with a negative scale and a -0.0 offset (y is -0.0),
    channel 1 constant with a 0 offset (y is +0.0), channel 2 holds a NaN
    (its statistics and y are NaN); the residual is -y at some places of
    the other channels (y + residual is +0.0), -0.0 and NaN at others."""
    x, scale, offset, mean, var = bn_inputs(shape, torch.float64, seed)
    x[..., 0], x[..., 1] = 1.5, -0.25
    x[0, 1, 2, 2] = float("nan")
    scale[0], offset[0], offset[1] = -1.0, -0.0, 0.0
    x, scale, offset, mean, var = (t.to(dtype) for t in (x, scale, offset, mean, var))
    y, _ = blocks.composite_batch_norm(x, blocks.BatchNormParams(scale, offset),
                                       blocks.BatchNormState(mean, var), True)
    rng = np.random.default_rng(seed + 1)
    residual = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    pick = torch.from_numpy(rng.integers(0, 4, shape))
    residual = torch.where(pick == 0, -y, residual)
    residual = torch.where(pick == 1, torch.full_like(y, -0.0), residual)
    residual[1, 2, 3, 5] = float("nan")
    dy = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    return x, scale, offset, mean, var, residual, dy


def by_hand(y, epilogue, residual):
    """The torch ops that followed a batch norm in the model before the
    epilogues existed."""
    if epilogue == "relu":
        return torch.relu(y)
    return torch.relu(y + residual) if epilogue == "add_relu" else y


def test_the_edge_inputs_meet_zero_negative_zero_and_nan():
    x, scale, offset, mean, var, residual, _ = edge_inputs()
    y, _ = fbn.reference_batch_norm(x, scale, offset, mean, var, blocks.BN_EPSILON,
                                    blocks.BN_MOMENTUM)
    assert torch.equal(torch.signbit(y[..., 0]), torch.ones_like(y[..., 0], dtype=torch.bool))
    assert (y[..., 0] == 0).all() and (y[..., 1] == 0).all()
    assert not torch.signbit(y[..., 1]).any()
    assert torch.isnan(y[..., 2]).all() and not torch.isnan(y[..., 3:]).any()
    total = y + residual
    assert ((total == 0) & ~torch.signbit(total)).sum() > 10 and torch.isnan(total[..., 3:]).any()


@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_plain_version_with_each_epilogue_is_the_composite_then_its_torch_ops(epilogue):
    """`reference_batch_norm` with an epilogue is the composite followed by
    torch.relu (or the add, then relu) bit for bit, at 0, -0.0 and NaN; its
    "relu" backward is its plain backward on threshold_backward's gradient
    bit for bit ("add_relu" masks with threshold_backward before the plain
    backward, as the kernels' caller does)."""
    x, scale, offset, mean, var, residual, dy = edge_inputs()
    residual = residual if epilogue == "add_relu" else None
    y, stats = fbn.reference_batch_norm(x, scale, offset, mean, var, blocks.BN_EPSILON,
                                        blocks.BN_MOMENTUM)
    out, out_stats = fbn.reference_batch_norm(x, scale, offset, mean, var, blocks.BN_EPSILON,
                                              blocks.BN_MOMENTUM, epilogue, residual)
    composite, _ = blocks.composite_batch_norm(x, blocks.BatchNormParams(scale, offset),
                                               blocks.BatchNormState(mean, var), True)
    assert same_bits(out, by_hand(composite, epilogue, residual))
    assert same_bits(out_stats, stats)
    masked = dy if epilogue == "none" else torch.ops.aten.threshold_backward(dy, out, 0)
    want = fbn.reference_batch_norm_bwd(masked, x, stats, scale)
    if epilogue != "add_relu":
        got = fbn.reference_batch_norm_bwd(dy, x, stats, scale,
                                           offset if epilogue == "relu" else None, epilogue)
        for name, a, b in zip(("dx", "dscale", "doffset"), got, want):
            assert same_bits(a, b), name
    assert torch.isnan(want[0][..., 2]).all()


def test_plain_relu_backward_matches_autograd_through_the_composite_and_relu():
    """In float64 the plain "relu" backward is autograd's through the
    composite and torch.relu."""
    x, scale, offset, mean, var = bn_inputs((2, 7, 7, 16), seed=6)
    leaves = [t.clone().requires_grad_() for t in (x, scale, offset)]
    y, _ = blocks.composite_batch_norm(leaves[0], blocks.BatchNormParams(*leaves[1:]),
                                       blocks.BatchNormState(mean, var), True)
    out = torch.relu(y)
    assert 0.2 < float((out == 0).double().mean()) < 0.8
    dy = torch.cos(3 * y.detach())
    want = torch.autograd.grad(out, leaves, dy)
    _, stats = fbn.reference_batch_norm(x, scale, offset, mean, var, blocks.BN_EPSILON,
                                        blocks.BN_MOMENTUM)
    got = fbn.reference_batch_norm_bwd(dy, x, stats, scale, offset, "relu")
    for name, a, b in zip(("dx", "dscale", "doffset"), got, want):
        torch.testing.assert_close(a, b, **F64_TOL, msg=name)


def _two_ranks(monkeypatch):
    monkeypatch.setattr(blocks, "data_group", lambda: "data")
    monkeypatch.setattr(blocks.dist, "get_world_size", lambda group: 2)
    monkeypatch.setattr(blocks, "_global_moments", lambda x, group: tuple(
        reversed(torch.var_mean(x, dim=(0, 1, 2), correction=0))))


ROUTES = [("cpu", torch.float32, True), ("eval", torch.float32, False),
          ("bf16", torch.bfloat16, True), ("fp16", torch.float16, True),
          ("fp64", torch.float64, True), ("two_ranks", torch.float32, True)]


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("route,dtype,train", ROUTES, ids=[r[0] for r in ROUTES])
def test_every_other_route_applies_the_same_epilogue(monkeypatch, route, dtype, train, epilogue):
    """Each route that does not reach the kernels (the CPU, eval mode,
    another dtype, a data group of two ranks) gives `composite_batch_norm`
    followed by the epilogue's torch ops: the output, the new running
    statistics and the gradients of x, scale, offset and the residual bit
    for bit, at 0, -0.0 and NaN."""
    if route == "two_ranks":
        _two_ranks(monkeypatch)
    x, scale, offset, mean, var, residual, dy = edge_inputs(dtype)
    residual = residual if epilogue == "add_relu" else None
    state = blocks.BatchNormState(mean.float(), var.float())

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (x, scale, offset)]
        res = None if residual is None else residual.clone().requires_grad_()
        out, new_state = fn(leaves, res)
        grads = torch.autograd.grad(out, leaves + ([res] if res is not None else []), dy)
        return out, new_state, grads

    got = run(lambda l, r: blocks.batch_norm(l[0], blocks.BatchNormParams(*l[1:]), state, train,
                                             epilogue, r))
    want = run(lambda l, r: (lambda y, s: (by_hand(y, epilogue, r), s))(
        *blocks.composite_batch_norm(l[0], blocks.BatchNormParams(*l[1:]), state, train)))
    assert type(got[0].grad_fn).__name__ != "FusedBatchNormBackward"
    assert same_bits(got[0], want[0])
    assert same_bits(got[1].mean, want[1].mean) and same_bits(got[1].var, want[1].var)
    assert len(got[2]) == (4 if residual is not None else 3)
    for a, b in zip(got[2], want[2]):
        assert same_bits(a, b)


@pytest.mark.parametrize("epilogue,residual", [("gelu", False), ("add_relu", False),
                                               ("relu", True), ("none", True)])
def test_an_epilogue_needs_its_residual_and_only_it(epilogue, residual):
    x, scale, offset, mean, var = bn_inputs((2, 3, 5, 8), torch.float32)
    res = torch.zeros_like(x) if residual else None
    with pytest.raises(ValueError, match="epilogue"):
        blocks.batch_norm(x, blocks.BatchNormParams(scale, offset),
                          blocks.BatchNormState(mean, var), True, epilogue, res)
    with pytest.raises(ValueError, match="epilogue"):
        fbn.reference_batch_norm(x, scale, offset, mean, var, blocks.BN_EPSILON,
                                 blocks.BN_MOMENTUM, epilogue, res)


def test_the_variant_names_the_epilogue():
    assert [fbn.variant(d, e) for d in ("forward", "backward") for e in EPILOGUES] == [
        "forward", "forward+relu", "forward+add_relu",
        "backward", "backward+relu", "backward+add_relu"]


# A captured ResNet-50 step's batch-norm calls by variant: the stem and each
# block's bn1 and bn2 take relu (33), each block's last batch norm its
# residual add and relu (bn3 of the identity blocks, bn_shortcut of the
# conv blocks: 16), the conv blocks' bn3 none (4); the backward runs the
# kernels' relu for the 33, the plain kernels for the 20.
RESNET50_VARIANTS = {"forward": 4, "forward+relu": 33, "forward+add_relu": 16,
                     "backward": 20, "backward+relu": 33}


def test_a_captured_resnet50_step_records_each_epilogue(monkeypatch):
    """A ResNet-50 train step on the CPU with the kernel route forced and
    the kernels' launches stood in for by their plain versions (which
    report as the kernels do), inside a capture: the graph records the
    variants above, 4 launches a layer (212 a step); the logits and the new
    running statistics are the composite route's bit for bit and the
    gradients within fp32 rounding of its autograd's."""
    from differential_equations_resnet_tpu_torch.models import build_resnet, resnet_preset

    def launch(x, scale, offset, mean, var, epsilon, momentum, epilogue="none", residual=None):
        out = fbn.reference_batch_norm(x, scale, offset, mean, var, epsilon, momentum, epilogue,
                                       residual)
        fbn._report(x, fbn.variant("forward", epilogue), 1)
        return out

    def launch_bwd(dy, x, stats, scale, offset=None, epilogue="none"):
        grads = fbn.reference_batch_norm_bwd(dy.contiguous(), x, stats, scale, offset, epilogue)
        fbn._report(x, fbn.variant("backward", epilogue), 3)
        return grads

    config = resnet_preset("resnet50", 10, antisymmetric_mid=True, image_shape=(32, 32, 3))
    rng = np.random.default_rng(11)
    images = torch.from_numpy(rng.uniform(0, 255, (4, 32, 32, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, 4))

    def step():
        model = build_resnet(config, generator=torch.Generator().manual_seed(3), device="cpu")
        logits = model(images, return_logits=True, train=True)
        loss = torch.nn.functional.cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return logits.detach(), [b.clone() for b in model.buffers()], grads

    want = step()
    record = StackRecord()
    monkeypatch.setattr(fbn, "STACKS", record)
    monkeypatch.setattr(fbn, "_launch", launch)
    monkeypatch.setattr(fbn, "_launch_bwd", launch_bwd)
    monkeypatch.setattr(blocks, "_kernel_route", lambda x, train: train)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with record.capture("train step") as graph:
        got = step()
    entries = record.graph("train step")
    counts = {}
    for e in entries:
        assert e.kernel == "BN"
        counts[e.variant] = counts.get(e.variant, 0) + 1
    assert counts == RESNET50_VARIANTS
    assert sum(e.launches for e in entries) == 53 * 4
    record.replay(graph)
    assert (record.calls("BN", "forward+add_relu"), record.launches("BN")) == (16, 212)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    # Against the largest gradient: the conv biases' are zero but for
    # rounding (each conv feeds a batch norm), so no gradient is its own scale.
    scale_ = max(float(b.abs().max()) for b in want[2])
    worst = max(float((a - b).abs().max()) for a, b in zip(got[2], want[2]))
    assert worst <= 1e-5 * scale_, (worst, scale_)
