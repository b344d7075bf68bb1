#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. device: the card's name and power limit, from nvidia-smi;
2. build: every CUDA source of the port, compiled from the checkout into
   build/kernels/ (one nvcc per source, started together);
3. kernels: each kernel against its plain PyTorch version on the card, TF32
   off, at the serving path's shape and at small shapes that reach every
   variant, in fp32 and bf16-operand modes;
4. serve: the 64-layer x 16-filter antisymmetric CIFAR-10 model from a
   seeded init is exported, loaded on the card and asked for batches of 1, 7
   and 32 images; its answers are held against the same export served on
   the CPU, and every request must launch the fused kernel once;
5. time: the kernel and its plain version at batch 32 (CUDA events, median
   of 25), the kernel's bound, and request latency and throughput.

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
from differential_equations_resnet_tpu_torch.utils.serving import export_model, load_exported

# H100 SXM fp32 rate outside the tensor cores (NVIDIA data sheet, 700 W) and
# its HBM3 bandwidth: the bound of a kernel is the larger of FLOPs over the
# first and bytes over the second.
FP32_CUDA_CORE_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
FP32_TOL = 1e-4   # rtol = atol; sums are ordered differently than cuDNN's
BF16_TOL = 1e-2   # rtol = atol; see phase_kernels


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
    """Random input, packed antisymmetric kernels materialized to dense, and
    nonzero biases, from a seed, on the card."""
    gen = torch.Generator().manual_seed(seed)
    blocks = [init_antisym_3x3(gen, channels) for _ in range(layers)]
    stacked = Antisym3x3Params(*[torch.stack(leaf) for leaf in zip(*blocks)])
    kernels = materialize_3x3_stacked(stacked)
    biases = 0.05 * torch.randn(layers, channels, generator=gen)
    x = torch.randn(batch, height, width, channels, generator=gen)
    return [t.cuda() for t in (x, kernels, biases)]


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
        x, kernels, biases = make_case(b, hh, ww, c, layers, 100 + i)
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
    x, kernels, biases = make_case(b, hh, ww, c, layers, 7)
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
    max_abs_err = phase_kernels()
    launches, predict, requests = phase_serve()
    timing = phase_time_kernel()
    phase_time_requests(predict, requests)
    kernels = [{
        "name": "fused_euler_fwd",
        "route": "cuda",
        "source": "differential_equations_resnet_tpu_torch/csrc/fused_euler_fwd.cu",
        "replaces": "differential_equations_resnet_tpu/ops/pallas/fused_integrator.py:146",
        "launches": launches,
        "max_abs_err": max_abs_err,
        **timing,
        "library_ms": None,
    }]
    log(f"[device] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
