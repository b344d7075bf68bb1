#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. device: the card's name and power limit, from nvidia-smi;
2. build: every CUDA source of the port, compiled from the checkout into
   build/kernels/ (one nvcc per source, started together), with each
   library's ptxas register and spill report;
3. kernels: each kernel against its plain PyTorch version on the card, TF32
   off, at the main path's shape and at small shapes that reach every
   variant, in fp32 and bf16-operand modes: the forward kernel B1
   (fused_euler_fwd) and the backward kernel B2 (fused_euler_bwd);
4. serve: the 64-layer x 16-filter antisymmetric CIFAR-10 model from a
   seeded init is exported, loaded on the card and asked for batches of 1, 7
   and 32 images; its answers are held against the same export served on
   the CPU, and every request must launch B1 once;
5. train: the same model takes 2 train steps on the card and 2 on the CPU
   (plain path) from the same params and batches, which must agree; every
   step launches B1 once and B2 once; then 20 steps at batch 32 on one
   batch must lower the loss, their grad-norm rows logged to a CSV;
6. time: each kernel and its plain version at batch 32 (CUDA events, median
   of 25) beside its bound, request latency and throughput, and the train
   step's time at batch 32.

The last two lines are a JSON summary of the kernels and the device line.
The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from differential_equations_resnet_tpu_torch.models import (
    build_single_block_resnet,
    cifar10_single_block_config,
)
from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3Params,
    init_antisym_3x3,
    materialize_3x3_stacked,
)
from differential_equations_resnet_tpu_torch.ops.kernels import _build
from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi
from differential_equations_resnet_tpu_torch.train import (
    CsvLogger,
    gradient_metric_names,
    make_adam,
    make_train_step,
)
from differential_equations_resnet_tpu_torch.utils.serving import export_model, load_exported

# H100 SXM fp32 rate outside the tensor cores (NVIDIA data sheet, 700 W) and
# its HBM3 bandwidth: the bound of a kernel is the larger of FLOPs over the
# first and bytes over the second.
FP32_CUDA_CORE_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
FP32_TOL = 1e-4   # rtol = atol; sums are ordered differently than cuDNN's
# Card against CPU in training, per grad norm and per leaf (norm-relative):
# relu-mask flips where |z| is under the fp32 difference of the two
# forwards move g_z elements, and 64 layers carry them (phase_kernels_bwd).
TRAIN_GRAD_TOL = 1e-3
BF16_TOL = 1e-2   # rtol = atol; see phase_kernels
LR = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.device_count()} device(s)")
    log(f"[device] nvidia-smi: {smi}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("matmul TF32 is on; the port's fp32 checks need it off")
    return smi


def phase_build():
    t0 = time.perf_counter()
    seconds = _build.build()
    log(f"[build] {json.dumps({k: round(v, 1) for k, v in seconds.items()})} "
        f"wall {time.perf_counter() - t0:.1f} s")
    for name in seconds:
        ptxas = _build.library_path(name).with_suffix(".so.log").read_text()
        regs = [int(line.split("Used ")[1].split()[0])
                for line in ptxas.splitlines() if "Used " in line and "registers" in line]
        spills = [int(line.split(" bytes spill stores")[0].split(",")[-1])
                  for line in ptxas.splitlines() if "spill stores" in line]
        log(f"[build] {name}: {len(regs)} kernels, max {max(regs, default=0)} registers, "
            f"{sum(spills)} spill-store bytes in all")


def make_case(batch, height, width, channels, layers, seed):
    """Random input, packed antisymmetric kernels materialized to dense,
    nonzero biases and a random cotangent of the output, from a seed, on
    the card."""
    gen = torch.Generator().manual_seed(seed)
    blocks = [init_antisym_3x3(gen, channels) for _ in range(layers)]
    stacked = Antisym3x3Params(*[torch.stack(leaf) for leaf in zip(*blocks)])
    kernels = materialize_3x3_stacked(stacked)
    biases = 0.05 * torch.randn(layers, channels, generator=gen)
    x = torch.randn(batch, height, width, channels, generator=gen)
    g = torch.randn(batch, height, width, channels, generator=gen)
    return [t.cuda() for t in (x, kernels, biases, g)]


def norm_rel(got, want):
    """||got - want|| / ||want||, in float64."""
    return float((got.double() - want.double()).norm() / want.double().norm())


def max_violation(got, want, tol):
    """max |got - want| and whether |got - want| <= tol + tol*|want| holds."""
    err = (got - want).abs()
    return float(err.max()), bool((err <= tol + tol * want.abs()).all())


def phase_kernels():
    """The kernel against its plain version.  fp32: the two sum in different
    orders, so they agree to fp32 rounding carried through L layers.  bf16:
    the plain version rounds the same operands, but an fp32 difference in
    the last bit can move a state element across a bf16 rounding boundary
    at a later layer, which then changes its operand by one bf16 ulp.
    Returns the fp32 error at the serving path's shape."""
    cases = [  # (batch, H, W, C, L, h)
        (32, 32, 32, 16, 64, 0.125),  # the serving path's shape
        (3, 8, 8, 8, 3, 0.125),
        (3, 8, 8, 32, 3, 0.125),
        (2, 64, 64, 8, 3, 0.125),     # > 2048 pixels: staged variant
        (3, 16, 16, 6, 3, 0.25),      # C not a multiple of 4: staged
    ]
    slice_err = 0.0
    for i, (b, hh, ww, c, layers, h) in enumerate(cases):
        x, kernels, biases, _ = make_case(b, hh, ww, c, layers, 100 + i)
        variant = fi.kernel_variant(hh, ww, c)
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            got = fi.fused_euler_dense(x, kernels, biases, h, matmul_dtype=dtype)
            want = fi.reference_euler_dense(x, kernels, biases, h, matmul_dtype=dtype)
            torch.cuda.synchronize()
            err, ok = max_violation(got, want, tol)
            log(f"[kernels] B={b} {hh}x{ww}x{c} L={layers} {variant} "
                f"{str(dtype).split('.')[-1]}: max|kernel-plain| {err:.3e} "
                f"(max|plain| {float(want.abs().max()):.3e}), tol rtol=atol={tol:g}: "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel disagrees with its plain version in case {i}")
            if i == 0 and dtype == torch.float32:
                slice_err = err
    return slice_err


def phase_kernels_bwd():
    """B2 against its plain version (`reference_euler_dense_bwd`) for gx, gk
    and gb.  The two sum in different orders, and the backward takes the
    relu mask 1[z > 0] of a recomputed z: where |z| is below the fp32
    difference of the two recomputes, a mask element flips and moves that
    g_z element by h * g, and L layers carry it on.  So the judge is a
    float64 run of the plain version (operands rounded to bf16 in bf16
    mode): per output, ||B2 - f64|| <= 2 ||plain - f64|| + 1e-5 ||f64||,
    i.e. B2 is as accurate as the plain fp32 version.  At the small shapes
    (no flips at 3-4 layers) that bound is about 1e-5 norm-relative; the
    direct B2 - plain difference is printed beside it.  Returns the max
    |B2 - plain| over gx, gk and gb at the training path's shape, fp32."""
    cases = [  # (batch, H, W, C, L, h)
        (32, 32, 32, 16, 64, 0.125),  # the training path's shape: resident, C=16, 2 pixels a thread
        (3, 8, 8, 8, 3, 0.125),       # resident, C=8, 1 pixel a thread
        (3, 8, 8, 32, 3, 0.125),      # resident, C=32
        (2, 48, 40, 4, 4, 0.125),     # resident, C=4, 4 pixels a thread
        (2, 64, 64, 4, 3, 0.125),     # > 2048 pixels: staged, float4 dK groups
        (3, 16, 16, 6, 3, 0.25),      # C not a multiple of 4: staged, scalar dK groups
    ]
    slice_err = 0.0
    for i, (b, hh, ww, c, layers, h) in enumerate(cases):
        x, kernels, biases, g = make_case(b, hh, ww, c, layers, 200 + i)
        variant = fi.kernel_variant(hh, ww, c, backward=True)
        for dtype in (torch.float32, torch.bfloat16):
            got = fi.fused_euler_dense_bwd(x, kernels, biases, g, h, dtype)
            want = fi.reference_euler_dense_bwd(x, kernels, biases, g, h, dtype)
            judge = fi.reference_euler_dense_bwd(
                *[t.double() for t in (x, kernels, biases, g)], h, dtype)
            torch.cuda.synchronize()
            parts = []
            for name, a, w, j in zip(("gx", "gk", "gb"), got, want, judge):
                kernel_err, plain_err = norm_rel(a, j), norm_rel(w, j)
                ok = kernel_err <= 2 * plain_err + 1e-5
                parts.append(f"{name} {norm_rel(a, w):.2e} (f64: B2 {kernel_err:.2e}, "
                             f"plain {plain_err:.2e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"B2 is less accurate than its plain version: case {i}, {name}")
            log(f"[kernels] B2 B={b} {hh}x{ww}x{c} L={layers} {variant} "
                f"{str(dtype).split('.')[-1]}: norm-rel |B2-plain| " + "; ".join(parts))
            if i == 0 and dtype == torch.float32:
                slice_err = max(float((a - w).abs().max()) for a, w in zip(got, want))
                log(f"[kernels] B2 training shape fp32: max|B2-plain| {slice_err:.3e} "
                    f"(max|plain| gx {float(want[0].abs().max()):.3e}, "
                    f"gk {float(want[1].abs().max()):.3e}, gb {float(want[2].abs().max()):.3e})")
    return slice_err


def phase_serve():
    """Export the headline model, serve it on the card, and hold its answers
    against the same export served on the CPU by the plain path.  Returns
    the kernel's launches during the requests, the card's predict and the
    requests."""
    config = cifar10_single_block_config(num_layers=64, num_filters=16, kernel_type="antisymmetric")
    model = build_single_block_resnet(
        config, generator=torch.Generator().manual_seed(0), device="cuda"
    )
    rng = np.random.default_rng(0)
    requests = [rng.uniform(0, 255, (n, 32, 32, 3)).astype(np.float32) for n in (1, 7, 32)]
    with tempfile.TemporaryDirectory() as tmp:
        export_dir = export_model(model, os.path.join(tmp, "export"), batch_size=32)
        predict, _ = load_exported(export_dir, device="cuda")
        predict_cpu, _ = load_exported(export_dir, device="cpu")
        fi.fused_euler_dense.launches = 0
        answers = [predict(r) for r in requests]
        launches = fi.fused_euler_dense.launches
        if launches != len(requests):
            raise AssertionError(f"{len(requests)} requests launched the kernel {launches} times")
        for images, probs in zip(requests, answers):
            if probs.shape != (len(images), 10) or not np.isfinite(probs).all():
                raise AssertionError(f"bad answer of shape {probs.shape}")
            want = predict_cpu(images)
            err, ok = max_violation(torch.from_numpy(probs), torch.from_numpy(want), FP32_TOL)
            log(f"[serve] batch {len(images)}: max|card-cpu| {err:.3e} over probabilities, "
                f"row sums within {float(np.abs(probs.sum(-1) - 1).max()):.1e} of 1, "
                f"tol rtol=atol={FP32_TOL:g}: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("the card's answer disagrees with the CPU's")
    # The random-init head saturates the softmax, so hold the logits too.
    cpu_model = build_single_block_resnet(config, params=model.params(), device="cpu")
    with torch.inference_mode():
        x = torch.from_numpy(requests[-1])
        got = model(x.cuda(), return_logits=True).cpu()
        want = cpu_model(x, return_logits=True)
    err, ok = max_violation(got, want, FP32_TOL)
    log(f"[serve] batch {len(x)} logits: max|card-cpu| {err:.3e} "
        f"(max|cpu| {float(want.abs().max()):.3e}), tol rtol=atol={FP32_TOL:g}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's logits disagree with the CPU's")
    log(f"[serve] 64L x 16F antisymmetric model: {len(requests)} requests, "
        f"{launches} launches of fused_euler_fwd")
    return launches, predict, requests


def phase_train(smi):
    """Train the headline model (random weights from seed 0) on the card
    through the train step, and hold 2 steps at batch 8 against the CPU's
    plain path from the same params and batches.  Returns the kernels'
    launches during the phase, the card's train step and a batch of 32."""
    config = cifar10_single_block_config(num_layers=64, num_filters=16, kernel_type="antisymmetric")
    rng = np.random.default_rng(1)

    def batch(n):
        return (torch.from_numpy(rng.uniform(0, 255, (n, 32, 32, 3)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, 10, n)))

    card = build_single_block_resnet(
        config, generator=torch.Generator().manual_seed(0), device="cuda")
    cpu = build_single_block_resnet(config, params=card.params(), device="cpu")
    steps = {m: make_train_step(m, make_adam(m.parameters())) for m in (card, cpu)}
    small = [batch(8) for _ in range(2)]
    fi.fused_euler_dense.launches = fi.fused_euler_dense_bwd.launches = 0
    for n, (images, labels) in enumerate(small, 1):
        (m_card, norms_card), (m_cpu, norms_cpu) = [
            steps[m](images.to(m_dev), labels.to(m_dev), LR)
            for m, m_dev in ((card, "cuda"), (cpu, "cpu"))]
        launches = (fi.fused_euler_dense.launches, fi.fused_euler_dense_bwd.launches)
        if launches != (n, n):
            raise AssertionError(f"after {n} train steps B1, B2 launched {launches} times")
        loss_err = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
        norms_err = float(((norms_card.cpu() - norms_cpu).abs() / norms_cpu.abs()).max())
        same_correct = float(m_card["correct"]) == float(m_cpu["correct"])
        ok = loss_err <= 1e-5 and norms_err <= TRAIN_GRAD_TOL and same_correct
        log(f"[train] step {n} batch 8 card vs cpu: loss {float(m_card['loss']):.6f} vs "
            f"{float(m_cpu['loss']):.6f} (rel {loss_err:.2e}, tol 1e-5), correct "
            f"{float(m_card['correct']):g} vs {float(m_cpu['correct']):g}, 65 grad norms max rel "
            f"{norms_err:.2e} (tol {TRAIN_GRAD_TOL:g}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the card's train step disagrees with the CPU's")
        if n == 1:
            grad_errs = {
                name: norm_rel(a.grad.cpu(), b.grad)
                for (name, a), (_, b) in zip(card.named_parameters(), cpu.named_parameters())
            }
            worst = max(grad_errs, key=grad_errs.get)
            log(f"[train] step 1 gradients card vs cpu, norm-rel per leaf: " + ", ".join(
                f"{k} {v:.2e}" for k, v in grad_errs.items()) + f"; worst {worst} "
                f"(tol {TRAIN_GRAD_TOL:g})")
            if grad_errs[worst] > TRAIN_GRAD_TOL:
                raise AssertionError("the card's gradients disagree with the CPU's")
    param_err = max(norm_rel(a.detach().cpu(), b.detach())
                    for a, b in zip(card.parameters(), cpu.parameters()))
    log(f"[train] params after 2 Adam updates, card vs cpu: max norm-rel {param_err:.2e}")

    images, labels = [t.cuda() for t in batch(32)]
    losses = []
    with tempfile.TemporaryDirectory() as tmp:
        names = gradient_metric_names(config)
        logger = CsvLogger(os.path.join(tmp, "gradient_history.csv"), names)
        for _ in range(20):
            metrics, norms = steps[card](images, labels, LR)
            losses.append(float(metrics["loss"]))
            logger.log(norms.tolist())
        logger.close()
        with open(os.path.join(tmp, "gradient_history.csv")) as f:
            header, *rows = f.read().splitlines()
    if header.split(" ") != names or len(names) != 65 or len(rows) != 20:
        raise AssertionError("the grad-norm CSV lacks its 65-name header or its 20 rows")
    launches = (fi.fused_euler_dense.launches, fi.fused_euler_dense_bwd.launches)
    if launches != (22, 22) or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"20 steps at batch 32: launches {launches}, losses {losses}")
    log(f"[train] 20 steps at batch 32 on one batch: loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
        f"CSV header of {len(names)} names, {len(rows)} rows")
    log(f"[train] 64L x 16F antisymmetric model: 22 train steps, {launches[0]} launches of "
        f"fused_euler_fwd, {launches[1]} of fused_euler_bwd ({smi})")
    return launches, steps[card], (images, labels)


def cuda_time_ms(fn, runs=25, warmup=3):
    """Median milliseconds of ``fn`` between two CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_time_kernel():
    b, hh, ww, c, layers, h = 32, 32, 32, 16, 64, 0.125
    x, kernels, biases, _ = make_case(b, hh, ww, c, layers, 7)
    for batch in (1, 7):
        ms = cuda_time_ms(lambda: fi.fused_euler_dense(x[:batch], kernels, biases, h))
        log(f"[time] fused_euler_fwd B={batch} {hh}x{ww}x{c} L={layers}: kernel {ms:.4f} ms")
    kernel_ms = cuda_time_ms(lambda: fi.fused_euler_dense(x, kernels, biases, h))
    plain_ms = cuda_time_ms(lambda: fi.reference_euler_dense(x, kernels, biases, h))
    flops = 2 * layers * b * hh * ww * 9 * c * c
    nbytes = 4 * (2 * x.numel() + kernels.numel() + biases.numel())
    flop_ms = flops / FP32_CUDA_CORE_FLOPS * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_by = "operations" if flop_ms >= byte_ms else "bytes"
    bound_ms = max(flop_ms, byte_ms)
    log(f"[time] fused_euler_fwd B={b} {hh}x{ww}x{c} L={layers}: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (median of 25, CUDA events)")
    log(f"[time] bound: {flops / 1e9:.3f} GFLOP / {FP32_CUDA_CORE_FLOPS / 1e12:g} TFLOP/s "
        f"(H100 SXM fp32 CUDA cores) = {flop_ms:.4f} ms; {nbytes / 1e6:.3f} MB / "
        f"{HBM_BYTES_PER_S / 1e12:g} TB/s = {byte_ms:.5f} ms; bound {bound_ms:.4f} ms "
        f"by {bound_by}; kernel at {bound_ms / kernel_ms:.1%} of it")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def phase_time_bwd():
    b, hh, ww, c, layers, h = 32, 32, 32, 16, 64, 0.125
    x, kernels, biases, g = make_case(b, hh, ww, c, layers, 8)
    kernel_ms = cuda_time_ms(lambda: fi.fused_euler_dense_bwd(x, kernels, biases, g, h))
    plain_ms = cuda_time_ms(lambda: fi.reference_euler_dense_bwd(x, kernels, biases, g, h))
    # The least work from x: forward recompute, dK and the state cotangent,
    # each 2*L*B*H*W*9C^2 (B2 also recomputes z: four).  The least bytes:
    # each input (x, g, kernels, biases) read once, each output (gx, gk, gb)
    # written once.
    flops = 3 * 2 * layers * b * hh * ww * 9 * c * c
    nbytes = 4 * (3 * x.numel() + 2 * kernels.numel() + 2 * biases.numel())
    trajectory_bytes = 4 * (2 * layers * x.numel() + b * kernels.numel() + b * biases.numel())
    flop_ms = flops / FP32_CUDA_CORE_FLOPS * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_by = "operations" if flop_ms >= byte_ms else "bytes"
    bound_ms = max(flop_ms, byte_ms)
    log(f"[time] fused_euler_bwd B={b} {hh}x{ww}x{c} L={layers}: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (median of 25, CUDA events)")
    log(f"[time] bound: 3 x 2*L*B*H*W*9C^2 = {flops / 1e9:.3f} GFLOP / "
        f"{FP32_CUDA_CORE_FLOPS / 1e12:g} TFLOP/s (H100 SXM fp32 CUDA cores) = {flop_ms:.4f} ms; "
        f"{nbytes / 1e6:.3f} MB / {HBM_BYTES_PER_S / 1e12:g} TB/s = {byte_ms:.5f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by}; kernel at {bound_ms / kernel_ms:.1%} of it "
        f"(its trajectory and partials add {trajectory_bytes / 1e6:.1f} MB = "
        f"{trajectory_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms of traffic)")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def phase_time_train(step, batch, runs=25):
    """Train-step time at batch 32 on the host clock around a synchronized
    step, median of ``runs``."""
    images, labels = batch
    times = []
    for i in range(runs + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(images, labels, LR)
        torch.cuda.synchronize()
        if i >= 3:
            times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    log(f"[time] train step batch {len(images)}: {ms:.4f} ms median of {runs}, "
        f"{1e3 / ms:.2f} steps/s, {len(images) * 1e3 / ms:.1f} images/s")


def phase_time_requests(predict, requests, runs=25):
    """Request latency on the host clock, end to end through predict (host
    to device, forward, device to host), median of ``runs``."""
    for images in requests:
        for _ in range(3):
            predict(images)
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            predict(images)
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        log(f"[time] request batch {len(images)}: {ms:.4f} ms median of {runs}, "
            f"{len(images) / ms * 1e3:.1f} images/s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    fwd_err = phase_kernels()
    bwd_err = phase_kernels_bwd()
    serve_launches, predict, requests = phase_serve()
    (train_fwd, train_bwd), step, batch = phase_train(smi)
    fwd_timing = phase_time_kernel()
    bwd_timing = phase_time_bwd()
    phase_time_requests(predict, requests)
    phase_time_train(step, batch)
    source = "differential_equations_resnet_tpu_torch/csrc/"
    replaces = "differential_equations_resnet_tpu/ops/pallas/fused_integrator.py:"
    kernels = [
        {"name": "fused_euler_fwd", "route": "cuda", "source": source + "fused_euler_fwd.cu",
         "replaces": replaces + "146", "launches": serve_launches + train_fwd,
         "max_abs_err": fwd_err, **fwd_timing, "library_ms": None},
        {"name": "fused_euler_bwd", "route": "cuda", "source": source + "fused_euler_bwd.cu",
         "replaces": replaces + "216", "launches": train_bwd,
         "max_abs_err": bwd_err, **bwd_timing, "library_ms": None},
    ]
    log(f"[device] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
