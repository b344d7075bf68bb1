#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. device: the card's name and power limit, from nvidia-smi;
2. build: every CUDA source of the port, compiled from the checkout into
   build/kernels/ (one nvcc per source, started together: the band B1 and
   B2 and their wide variants, batch norm's kernels), with each library's
   ptxas register and spill report, and each instantiation of the wide and
   batch-norm kernels' registers and spill bytes (none may spill);
3. plan: each kernel's band plan (blocks an image) at the main path's
   shapes and the images the card holds at once for every band count
   (`fi.resident_images`), and the wide variants' launch plans at the
   widths the band variants decline;
4. kernels: each kernel against its plain PyTorch version on the card, TF32
   off, at the main path's shape, at small shapes and at band edges (batch
   1 and 7, uneven and short bands, one band, 64x64x16), in fp32 and
   bf16-operand modes: the forward kernel B1 (fused_euler_fwd) and the
   backward kernel B2 (fused_euler_bwd), whose dK and db must also be
   bit-identical across two calls; then the wide variants
   (fused_euler_wide.cu, `phase_kernels_wide`) at 64 layers at 32x32x72,
   32x32x128, 8x8x128, 64x64x48 (B2) and 64x64x128, both modes, B2 judged
   by float64 and bit-identical across two calls; then the WRN-40-4 cell's
   four calls at its batch of 128 (`phase_kernels_wrn`: the band B1 at
   32x32x64 in 16 bands, the wide B1 at 16x16x128, the wide B2 at both),
   fp32, each call's launches in the record checked, the sha256 of the wide
   B1's output and B2's gx, gk and gb printed, and each wide kernel
   instantiation's device time a step against its bound;
5. serve: the 64-layer x 16-filter antisymmetric CIFAR-10 model from a
   seeded init is exported at batch 32 (config, parameters and the
   compiled forward ``forward.pt2``: `torch.export` of the eval forward,
   B1 a dispatcher op in it), loaded on the card and asked for batches of
   1, 7 and 32 images: batch 32 through the compiled forward (a replayed
   CUDA graph, the predictor's only one), 1 and 7 through the rebuilt
   model (eager); its answers, and the logits they imply, are held
   against the CPU, the compiled path against the rebuilt one at a
   tolerance a TF32 run of the program is measured against, every request
   must launch B1 once, and 4 threads at once get their own answers; then
   (`phase_serve_paths`) an export made on the CPU is served on the card
   (one B1 launch, the card's own export's answer), the request latency
   of the compiled, rebuilt and eager paths at batch 1 and 32, and the
   `use_pallas` 64L x 128F stack served through forward.pt2 (one wide B1
   call a request, against the rebuilt path);
6. train: the same model takes 2 train steps on the card and 2 on the CPU
   (plain path) from the same params and batches, which must agree; every
   step launches B1 once and B2 once; then 20 steps at batch 32 on one
   batch must lower the loss, their grad-norm rows logged to a CSV;
7. time: each kernel and its plain version at batch 32 (CUDA events around
   25 calls back to back, median of 5 such windows) beside its bound, B1 at
   batch 1 and 7 and B2 at batch 1, and each at band counts beside the
   plan's; request latency and throughput, and the train step's time at
   batch 32;
8. profile: one window of train steps at batch 32 under torch.profiler, its
   ten device operations that took the most time and the device's idle
   share; then determinism (`phase_deterministic`): two 64L x 16F models
   from one seed take 2 replayed steps each with cuDNN's ``deterministic``
   flag on, and then off, compared bit for bit, and the replayed step timed
   under each setting in turns;
9. harness: the training harness at the same width and depth on synthetic
   CIFAR-10 of the real size (50,000 + 10,000 uint8 images): a streaming
   epoch of 200 replayed steps through `Training` (CSV and summary rows, the
   loss falls) and a full validation pass; 8 steps replayed from one CUDA
   graph against 8 eager steps; a device-resident epoch of 1562 replayed
   steps with augmentation, whose B1 and B2 launches the profiler counts
   (one each a step, as the record of hand-kernel calls does), timed again
   unprofiled beside the same epoch run with the eager step (seconds, steps/s, model
   TFLOP/s, MFU, and the idle share of a profiled window of each epoch), and
   its device evaluation against the streaming one; a checkpoint round trip
   (bit for bit); and the command line (train, then evaluate, predict and
   analyze) in subprocesses, whose kernels build into a compile cache under
   build/ (`utils.compile_cache`), which a later process finds built
   (`check_compile_cache`: no compiler runs);
10. kernel types: at 64 layers, regular 16F and 8F and centrosymmetric k = 3
   through B1/B2 and centrosymmetric k = 5, midpoint and RK4 on the
   per-layer route, each against the CPU with its launches and route
   asserted; the per-layer steps timed; a captured remat midpoint step
   against an eager one; then the wide phase (`phase_wide`): the widths the
   band kernels decline on the wide variants against the CPU (``use_pallas``
   antisymmetric 64 and 128 filters and regular 64 in training, regular 72
   in a forward), the wide B1 and B2 timed at 32x32x64, 32x32x128 and
   64x64x128 beside their bounds and profiled (the kernels a call launches
   and their device time), and the regular 64L x 64, 96, 112 and 128F
   train steps on the fused and the per-layer route in turns; B1 and B2
   timed at 8 filters;
11. epochs: device-resident epochs of the regular 64L x 16F and 8F models;
12. bf16 (`phase_bf16`): the 64L x 16F model, `imagenet32_config()` (28L x
   64F, 1000 classes) and ResNet-50 at 32x32 in bf16, each against the
   CPU's bf16 (eval logits, a train step, export -> load -> predict), no
   kernel launch, then replayed train steps timed with MFU against the
   bf16 peak;
13. subcommands: reproduce --synthetic, deep-stability, train then export
   --checkpoint then load_exported, benchmark and sweep, in subprocesses;
14. bottleneck and batch norm (`phase_bottleneck`): ResNet-50 at 32x32 and
   at 224x224 x 257 classes against the CPU, trained (2 steps against the
   CPU, 3 captured against 3 eager, replayed steps timed) and served
   (export, load, latency at batch 1 and 32, and at batch 1 the compiled,
   rebuilt and eager paths), ResNet-50 v1.5, ResNet-101
   and ResNet-152 forwards against the CPU, the single-block model with
   batch norm against the CPU, and ``train --model resnet50`` then
   ``export --checkpoint`` in subprocesses; none launches B1 or B2;
   then batch norm's kernels (`phase_batch_norm`): against the plain
   version at ResNet-50's nine shapes at batch 32 and 224x224 and at C = 8,
   16 and 6, bit for bit across two runs, the relu and add_relu epilogues
   against their torch ops bit for bit, each shape timed forward with each
   epilogue and backward beside its byte bound, the separate ops' time and
   the composite's, and 53 x 4 launches (by variant 4 / 33 / 16 forward,
   20 / 33 backward) in one ResNet-50 train step;
15. int8 ops (`phase_int8_ops`): the dynamic-w8a8 conv at the trunk's
   32x32x128 (batch 32) and ResNet-50 stage 3's strided 3x3 and 1x1 convs,
   then the int8 dgrad and wgrad at the trunk shape: int8 operands and
   int32 accumulators equal to the CPU's, outputs within 1e-6, each timed
   beside the fp32 and bf16 cuDNN call;
16. int8 serving (`phase_int8_serve`): the 64L x 128F model and ResNet-50
   at 224x224 x 257 classes exported with ``quantize="int8"``, loaded and
   asked for a batch of 256 (the 64L x 128F model through forward.pt2, the
   weights quantized at export, held against the rebuilt path; ResNet-50,
   whose trace takes tens of seconds, rebuilt), against the CPU's quantized
   forward, and timed beside the fp32 and bf16 forwards (images/s, the int8
   GEMMs' TOPS against the int8 peak);
17. int8 training (`phase_int8_train`): 64L x 128F in 'ste' and 'wgrad'
   and ResNet-50 at 32x32 in 'wgrad', the first step against the CPU, then
   replayed steps at batch 32 (a CUDA graph) whose loss must fall, timed;
18. s2d (`phase_s2d`): midpoint and RK4 64L x 16F packed against direct,
   logits within 1e-5, forwards and replayed train steps timed;
19. records (`phase_records`): the native record codec and loader built
   with g++ into build/native/ (no fallback to Python), 1024 seeded
   224x224x3 images with 257 labels written as records and read back bit
   for bit through the Python reader, the C++ codec and the native loader,
   feed rates (the native loader alone and into the card, the Python chain
   with RandomCrop 256 -> 224 and RandomFlipLeftRight), then ResNet-50 at
   224x224 x 257 classes fed by `create_native_dataset`: its first step
   against the CPU on a loader batch, a timed and a profiled streaming
   epoch of replayed steps (images/s end to end, idle share), an
   evaluation over the records and export -> load -> predict; where Pillow
   imports, ``convert-records`` and ``predict`` on an image directory, card
   against CPU;
20. MNIST (`phase_mnist`): B1 and B2 at 32x28x28x16, L = 8 (uneven bands)
   against their plain versions and timed beside their bounds, the
   `mnist_single_block_config()` model (8L x 16F) against the CPU on
   seeded `synthetic_mnist` data, then an epoch of 1875 replayed steps,
   a device evaluation and predict;
21. examples (`phase_examples`): five of the port's examples (the JAX
   package's `examples/`), each in a subprocess (all started together):
   the gradient-flow experiment at 64L x 16F for one device-resident
   epoch of 2048 seeded images, the kernel-property
   checks, depth doubling, the large-batch A/B with bf16 and int8 arms and
   the int8 NaN probe at cut sizes; each must exit 0 and print its JAX
   original's keys, and their B1/B2 launches join the kernels line;
22. meshes (`phase_mesh`, parallel/): a device-resident epoch of the
   64L x 16F model through a one-rank NCCL ``data`` mesh against the same
   epoch without a mesh (same state and seed: the first 16 steps' rows and
   the parameters within the step bounds), 1562-step epochs of both timed,
   their B1/B2 launches counted; two spawned ranks
   sharing the card over gloo (CUDA tensors) taking
   `make_train_step(mesh=...)` eagerly at global batch 32 (16 images a
   rank: B1/B2 launch on each) against the one-rank step from the same
   state, for the fused 64L x 16F model and for ResNet-50 at 32x32 with
   batch norm (its moments all-reduced); a captured loop over gloo raises
   naming the backend; then TP and PP at axis size 1 on NCCL, each
   model-level forward and step against the meshless model.

A kernel's launches are those on the card: its wrapper counts each launch
outside a CUDA-graph capture, and each replay of a graph counts the
launches the graph holds.  The last two lines are a JSON summary of the
kernels and the device line.  The script imports nothing of JAX and nothing
of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from differential_equations_resnet_tpu_torch.models import (
    build_resnet,
    build_single_block_resnet,
    cifar10_single_block_config,
    resnet_preset,
)
from differential_equations_resnet_tpu_torch.models.blocks import init_conv
from differential_equations_resnet_tpu_torch.models import single_block_resnet as sbr
from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3Params,
    init_antisym_3x3,
    materialize_3x3_stacked,
)
from differential_equations_resnet_tpu_torch.models.quantized import make_quantized_forward
from differential_equations_resnet_tpu_torch.ops import quantize as q
from differential_equations_resnet_tpu_torch.ops.conv import conv2d_same, conv2d_same_vjp
from differential_equations_resnet_tpu_torch.models.blocks import (
    BN_EPSILON,
    BN_MOMENTUM,
    BatchNormParams,
    BatchNormState,
    composite_batch_norm,
)
from differential_equations_resnet_tpu_torch.ops.kernels import _build
from differential_equations_resnet_tpu_torch.ops.kernels import batch_norm as fbn
from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi
from differential_equations_resnet_tpu_torch.data import synthetic_cifar10
from differential_equations_resnet_tpu_torch.experiments import imagenet32_config
from differential_equations_resnet_tpu_torch.data.jit_augment import standard_cifar_augment
from differential_equations_resnet_tpu_torch.train import (
    Checkpointer,
    CsvLogger,
    Training,
    gradient_metric_names,
    make_adam,
    make_device_epoch,
    make_multi_step,
    make_predict_step,
    make_train_step,
)
from differential_equations_resnet_tpu_torch.train.train_step import TrainState, WARMUP_CALLS, pack_row
from differential_equations_resnet_tpu_torch.utils.flops import (
    PEAK_FLOPS,
    mfu,
    peak_of,
    single_block_train_flops,
    train_flops,
)
from differential_equations_resnet_tpu_torch.utils import serving
from differential_equations_resnet_tpu_torch.utils.tracing import STACKS
from differential_equations_resnet_tpu_torch.utils.serving import (
    FORWARD_FILE,
    export_model,
    load_exported,
)

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
# Two serving paths on the card against each other, over logit gaps
# (`logit_gaps`): the same kernels and cuDNN calls, so far under the
# ~1e-3 by which a TF32 convolution errs; rtol = atol.
CARD_PATHS_TOL = 1e-5
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


def ptxas_kernels(ptxas):
    """[(kernel, registers, spill-store bytes, spill-load bytes)] of each entry
    function in a ``ptxas -v`` log, names demangled where c++filt is found."""
    kernels = []
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            kernels.append([line.split("'")[1], 0, 0, 0])
        elif kernels and "spill stores" in line:
            kernels[-1][2] = int(line.split(" bytes spill stores")[0].split(",")[-1])
            kernels[-1][3] = int(line.split(" bytes spill loads")[0].split(",")[-1])
        elif kernels and "Used " in line and "registers" in line:
            kernels[-1][1] = int(line.split("Used ")[1].split()[0])
    if kernels and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(k[0] for k in kernels),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(kernels):
            for k, name in zip(kernels, names):
                name = name.replace("(anonymous namespace)::", "").split("(")[0]
                k[0] = name.removeprefix("void ")
    return [tuple(k) for k in kernels]


def phase_build():
    """Every native library built from the checkout (one compiler each, all
    at once), with each CUDA library's registers and spills; every kernel of
    the wide variants (each instantiation) must spill nothing."""
    t0 = time.perf_counter()
    seconds = _build.build()  # the CUDA kernels and the native record libraries at once
    log(f"[build] {json.dumps({k: round(v, 1) for k, v in seconds.items()})} "
        f"wall {time.perf_counter() - t0:.1f} s")
    for name in seconds:
        if _build.SOURCES[name].compiler != "nvcc":
            continue
        kernels = ptxas_kernels(_build.library_path(name).with_suffix(".so.log").read_text())
        log(f"[build] {name}: {len(kernels)} kernels, max "
            f"{max((k[1] for k in kernels), default=0)} registers, "
            f"{sum(k[2] for k in kernels)} spill-store bytes in all")
        if name in ("fused_euler_wide", "batch_norm"):
            for kernel, regs, stores, loads in kernels:
                log(f"[build]   {kernel}: {regs} registers, {stores} bytes spill stores, "
                    f"{loads} bytes spill loads")
            if not kernels or any(k[2] or k[3] for k in kernels):
                raise AssertionError(f"a kernel of {name} spills registers (or ptxas reported none)")


MAIN = (32, 32, 16)  # H, W, C of the main path's identity stack


def describe_bands(shape, backward=False):
    """'n bands (rows a, b, ...), B*n blocks, s threads a tile' for a batch
    shape on B1 or B2."""
    batch, height = shape[0], shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bands = fi.kernel_bands(shape, backward=backward, sms=sms)
    rows = sorted({stop - start for start, stop in fi.band_plan(batch, height, bands)})
    split = fi.kernel_split(*shape[1:], bands)
    return bands, (f"{bands} bands of {'/'.join(map(str, rows))} rows, {batch * bands} blocks, "
                   f"{split} thread{'s' if split > 1 else ''} a tile")


def phase_plan():
    """The band plan at the main path's shapes and the images the card
    holds at once (every band of an image resident) for each band count."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, backward, batches in (("fused_euler_fwd", False, (1, 7, 32)),
                                    ("fused_euler_bwd", True, (1, 8, 32))):
        smem = fi.bwd_smem_bytes if backward else fi.state_smem_bytes
        occupancy = {n: (fi.resident_images(*MAIN, n, backward), smem(*MAIN, n))
                     for n in (1, 2, 4, 8, 16, 32)
                     if n <= MAIN[0] and smem(*MAIN, n) <= fi.SMEM_LIMIT_BYTES}
        log(f"[plan] {name} {'x'.join(map(str, MAIN))}: images resident at once by band "
            "count: " + ", ".join(f"n={n}: {c} images ({c * n} blocks, {b} B smem a block)"
                                   for n, (c, b) in occupancy.items()))
        for batch in batches:
            bands, text = describe_bands((batch, *MAIN), backward)
            blocks = min(batch, occupancy[bands][0]) * bands  # resident at once
            log(f"[plan] {name} batch {batch}: {text}; SMs in use: {min(blocks, sms)} of {sms} "
                f"({blocks} blocks resident at once)")
    # The shapes the band variants decline run on the wide ones.
    for shape in ((32, 32, 32, 64), (32, 32, 32, 72), (32, 32, 32, 128), (8, 8, 8, 128),
                  (32, 64, 64, 128)):
        for backward in (False, True):
            log(f"[plan] {'fused_euler_bwd' if backward else 'fused_euler_fwd'} "
                f"B={shape[0]} {'x'.join(map(str, shape[1:]))}: "
                f"{json.dumps(fi.launch_plan(shape, backward, sms))}")


def make_case(batch, height, width, channels, layers, seed, unstructured=False):
    """Random input, packed antisymmetric kernels materialized to dense (or,
    with ``unstructured``, He-initialised dense kernels with no structure,
    as the regular kernel type has), nonzero biases and a random cotangent
    of the output, from a seed, on the card."""
    gen = torch.Generator().manual_seed(seed)
    if unstructured:
        kernels = init_conv(gen, (3, 3), channels, layers * channels).kernel
        kernels = kernels.reshape(3, 3, channels, layers, channels).permute(3, 0, 1, 2, 4)
        kernels = kernels.contiguous()
    else:
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


def logit_gaps(probs, ref, ref_probs=False):
    """Each class's logit less its row's top class's (top by ``ref``), from
    served probabilities (log p_i - log p_j = z_i - z_j) and from ``ref``:
    logits, or probabilities where ``ref_probs``.  A served answer so held
    is held at the logit level, which a saturated softmax does not hide.
    Classes whose probability underflowed to 0 in either are left out.
    Returns (got, want, "kept/all classes"), float64."""
    p = torch.as_tensor(np.asarray(probs), dtype=torch.float64)
    z = torch.as_tensor(np.asarray(ref), dtype=torch.float64)
    z = z.log() if ref_probs else z
    top = z.argmax(-1, keepdim=True)
    kept = (p > 0) & torch.isfinite(z)
    got, want = p.log() - p.log().gather(-1, top), z - z.gather(-1, top)
    return got[kept], want[kept], f"{int(kept.sum())}/{kept.numel()}"


def gap_violation(probs, ref, tol, ref_probs=False):
    """`max_violation` over `logit_gaps`: (max error, ok, "kept/all"); not
    ok where a class was left out, whose logit the answer no longer
    shows."""
    got, want, kept = logit_gaps(probs, ref, ref_probs)
    err, ok = max_violation(got, want, tol)
    return err, ok and got.numel() == np.asarray(probs).size, kept


def tf32_control(export_dir, images, ref_probs):
    """The export's forward.pt2 run as `torch.export` loads it, outside
    `load_program`'s fp32 wrapper, with cuDNN's TF32 on (PyTorch's
    default): its `gap_violation` against ``ref_probs`` at CARD_PATHS_TOL,
    which shows whether that tolerance would catch a program run in
    TF32.  Its launches are not the main path's: call it outside a
    counted window."""
    program = torch.export.load(os.path.join(export_dir, FORWARD_FILE)).module()
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            probs = program(torch.from_numpy(images).cuda()).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return gap_violation(probs, ref_probs, CARD_PATHS_TOL, ref_probs=True)


@contextlib.contextmanager
def counted_graphs():
    """Yields the list of every `_Replayed` that `load_exported` makes
    meanwhile, so a check can count the CUDA graphs a predictor holds."""
    made, cls = [], serving._Replayed

    class Counted(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    serving._Replayed = Counted
    try:
        yield made
    finally:
        serving._Replayed = cls


def phase_kernels():
    """The kernel against its plain version.  fp32: the two sum in different
    orders, so they agree to fp32 rounding carried through L layers.  bf16:
    the plain version rounds the same operands, but an fp32 difference in
    the last bit can move a state element across a bf16 rounding boundary
    at a later layer, which then changes its operand by one bf16 ulp.
    Returns the fp32 error at the serving path's shape."""
    cases = [  # (batch, H, W, C, L, h)
        (32, 32, 32, 16, 64, 0.125),  # the serving path's shape: 4 bands
        (1, 32, 32, 16, 64, 0.125),   # a serving request: 32 bands of one row
        (7, 32, 32, 16, 64, 0.125),
        (3, 8, 8, 8, 3, 0.125),
        (3, 8, 8, 32, 3, 0.125),
        (2, 64, 64, 8, 3, 0.125),     # > 2048 pixels
        (3, 16, 16, 6, 3, 0.25),      # C not a multiple of 4
        (2, 13, 9, 8, 3, 0.125),      # H not divisible by the band count
        (1, 3, 5, 4, 3, 0.125),       # fewer rows than the plan's bands
        (70, 8, 8, 8, 3, 0.125),      # one band an image
        (1, 64, 64, 16, 4, 0.125),    # 64x64x16: at least 4 bands to fit
        (1, 32, 32, 56, 3, 0.125),    # C = 56: one kernel buffer, loaded after the barrier
        # Unstructured (regular) kernels at the main path's shapes, 16 and 8 filters.
        (32, 32, 32, 16, 64, 0.125, "regular"),
        (32, 32, 32, 8, 64, 0.125, "regular"),
    ]
    slice_err = 0.0
    for i, (b, hh, ww, c, layers, h, *kind) in enumerate(cases):
        x, kernels, biases, _ = make_case(b, hh, ww, c, layers, 100 + i, unstructured=bool(kind))
        plan = describe_bands(x.shape)[1] + (f", {kind[0]} kernels" if kind else "")
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            got = fi.fused_euler_dense(x, kernels, biases, h, matmul_dtype=dtype)
            want = fi.reference_euler_dense(x, kernels, biases, h, matmul_dtype=dtype)
            torch.cuda.synchronize()
            err, ok = max_violation(got, want, tol)
            log(f"[kernels] B={b} {hh}x{ww}x{c} L={layers} {plan} "
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
        (32, 32, 32, 16, 64, 0.125),  # the training path's shape: 4 bands
        (8, 32, 32, 16, 64, 0.125),   # the card-against-CPU train steps' batch: 16 bands
        (1, 32, 32, 16, 16, 0.125),   # batch 1: 32 bands
        (3, 8, 8, 8, 3, 0.125),
        (3, 8, 8, 32, 3, 0.125),
        (2, 48, 40, 4, 4, 0.125),
        (2, 64, 64, 4, 3, 0.125),     # > 2048 pixels
        (3, 16, 16, 6, 3, 0.25),      # C not a multiple of 4
        (2, 13, 9, 8, 3, 0.125),      # H not divisible by the band count
        (1, 3, 5, 4, 3, 0.125),       # fewer rows than the plan's bands
        (70, 8, 8, 8, 3, 0.125),      # one band an image
        (1, 64, 64, 16, 4, 0.125),    # 64x64x16: at least 8 bands to fit
        (2, 32, 32, 22, 3, 0.125),    # C = 22: declined by one block per image
        (1, 32, 32, 56, 3, 0.125),    # C = 56: one buffer of each, 16 bands
        # Unstructured (regular) kernels at the training path's shapes, 16 and 8 filters.
        (32, 32, 32, 16, 64, 0.125, "regular"),
        (32, 32, 32, 8, 64, 0.125, "regular"),
    ]
    slice_err = 0.0
    for i, (b, hh, ww, c, layers, h, *kind) in enumerate(cases):
        x, kernels, biases, g = make_case(b, hh, ww, c, layers, 200 + i, unstructured=bool(kind))
        plan = describe_bands(x.shape, backward=True)[1] + (f", {kind[0]} kernels" if kind else "")
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
            log(f"[kernels] B2 B={b} {hh}x{ww}x{c} L={layers} {plan} "
                f"{str(dtype).split('.')[-1]}: norm-rel |B2-plain| " + "; ".join(parts))
            if i == 0 and dtype == torch.float32:
                slice_err = max(float((a - w).abs().max()) for a, w in zip(got, want))
                log(f"[kernels] B2 training shape fp32: max|B2-plain| {slice_err:.3e} "
                    f"(max|plain| gx {float(want[0].abs().max()):.3e}, "
                    f"gk {float(want[1].abs().max()):.3e}, gb {float(want[2].abs().max()):.3e})")
                again = fi.fused_euler_dense_bwd(x, kernels, biases, g, h, dtype)
                same = [torch.equal(a, b) for a, b in zip(got, again)]
                log(f"[kernels] B2 training shape, two calls: gx, gk, gb bit-identical {same}")
                if not all(same):
                    raise AssertionError("B2's gradients differ between two calls on the same inputs")
    return slice_err


def warmed(predict, requests):
    """``predict`` after one call at each request's shape: on the card the
    first call of the manifest's shape captures its graph (warm-up launches
    included)."""
    for images in requests:
        predict(images)
    return predict


def threaded_answers(predict, requests, threads=4, rounds=5):
    """Each request served ``rounds`` times from ``threads`` threads at
    once; raises unless every answer equals the one-at-a-time answer."""
    import threading

    want = [predict(r) for r in requests]
    wrong = []

    def serve(i):
        for _ in range(rounds):
            for r, w in zip(requests[i::threads], want[i::threads]):
                if not np.array_equal(predict(r), w):
                    wrong.append(len(r))

    workers = [threading.Thread(target=serve, args=(i,)) for i in range(threads)]
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    return len(wrong)


def phase_serve():
    """Export the headline model at batch 32 (config, parameters and the
    compiled forward ``forward.pt2``), serve it on the card, and hold its
    answers against the same export served on the CPU by the plain path:
    batch 32 through the compiled forward (a replayed CUDA graph, the
    predictor's only one), 1 and 7 through the rebuilt model (eager),
    every request one launch of B1.  Each answer's logit gaps
    (`logit_gaps`) against the CPU model's logits; the compiled path's
    against the rebuilt path's at batch 32, tighter than a TF32 run of the
    program passes (`tf32_control`, with cuDNN's TF32 flag on as PyTorch
    sets it); requests from 4 threads at once.  Returns the kernel's
    launches during the requests, the card's predict and the requests."""
    config = cifar10_single_block_config(num_layers=64, num_filters=16, kernel_type="antisymmetric")
    model = build_single_block_resnet(
        config, generator=torch.Generator().manual_seed(0), device="cuda"
    )
    cpu_model = build_single_block_resnet(config, params=model.params(), device="cpu")
    rng = np.random.default_rng(0)
    requests = [rng.uniform(0, 255, (n, 32, 32, 3)).astype(np.float32) for n in (1, 7, 32)]
    with tempfile.TemporaryDirectory() as tmp, counted_graphs() as graphs:
        export_dir = export_model(model, os.path.join(tmp, "export"), batch_size=32)
        if not os.path.isfile(os.path.join(export_dir, FORWARD_FILE)):
            raise AssertionError(f"export_model wrote no {FORWARD_FILE}")
        predict, _ = load_exported(export_dir, device="cuda")
        predict_cpu, _ = load_exported(export_dir, device="cpu")
        warmed(predict, requests)
        routes = dict(predict.routes)
        STACKS.reset()
        answers = [predict(r) for r in requests]
        launches = STACKS.launches("B1")
        if launches != len(requests):
            raise AssertionError(f"{len(requests)} requests launched the kernel {launches} times")
        served = {k: predict.routes[k] - routes[k] for k in routes}
        if served != {"compiled": 1, "rebuilt": 2}:
            raise AssertionError(f"requests at batch 1, 7, 32 took the paths {served}; expected "
                                 "batch 32 compiled and 1 and 7 rebuilt")
        held = sum(len(r.graphs) for r in graphs)
        log(f"[serve] requests at batch 1, 7 and 32: the predictor holds {held} captured graph "
            f"(the manifest's batch, 32): {'ok' if held == 1 else 'FAIL'}")
        if held != 1:
            raise AssertionError(f"the predictor holds {held} captured graphs, not 1")
        for images, probs in zip(requests, answers):
            if probs.shape != (len(images), 10) or not np.isfinite(probs).all():
                raise AssertionError(f"bad answer of shape {probs.shape}")
            want = predict_cpu(images)
            err, ok = max_violation(torch.from_numpy(probs), torch.from_numpy(want), FP32_TOL)
            with torch.inference_mode():
                logits = cpu_model(torch.from_numpy(images), return_logits=True)
            gap_err, gap_ok, kept = gap_violation(probs, logits, FP32_TOL)
            path = "compiled forward.pt2, replayed" if len(images) == 32 else "rebuilt model, eager"
            log(f"[serve] batch {len(images)} ({path}): max|card-cpu| {err:.3e} over "
                f"probabilities, row sums within {float(np.abs(probs.sum(-1) - 1).max()):.1e} of "
                f"1; logit gaps against the CPU model's {gap_err:.3e} over {kept} classes (max "
                f"|logit| {float(logits.abs().max()):.3e}); tol rtol=atol={FP32_TOL:g}: "
                f"{'ok' if ok and gap_ok else 'FAIL'}")
            if not (ok and gap_ok):
                raise AssertionError("the card's answer disagrees with the CPU's")
        if predict_cpu.routes != {"compiled": 1, "rebuilt": 2}:
            raise AssertionError(f"the CPU's requests took the paths {predict_cpu.routes}")
        rebuilt = load_exported(export_dir, prefer_stablehlo=False, device="cuda")[0](requests[-1])
        err, ok, kept = gap_violation(answers[-1], rebuilt, CARD_PATHS_TOL, ref_probs=True)
        tf32_err, tf32_ok, _ = tf32_control(export_dir, requests[-1], rebuilt)
        log(f"[serve] batch 32 logit gaps, compiled forward.pt2 against the rebuilt model on the "
            f"card: {err:.3e} over {kept} classes, tol rtol=atol={CARD_PATHS_TOL:g}: "
            f"{'ok' if ok else 'FAIL'}; the program run with cuDNN TF32 on: {tf32_err:.3e} "
            f"({'within' if tf32_ok else 'past'} the tol)")
        if not ok:
            raise AssertionError("the compiled forward answers otherwise than the rebuilt model")
        wrong = threaded_answers(predict, requests)
        log(f"[serve] 4 threads at once, 5 rounds of the 3 requests: {wrong} answers differ "
            f"from one-at-a-time serving: {'ok' if not wrong else 'FAIL'}")
        if wrong:
            raise AssertionError("requests from several threads get others' answers")
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
    STACKS.reset()
    for n, (images, labels) in enumerate(small, 1):
        (m_card, norms_card), (m_cpu, norms_cpu) = [
            steps[m](images.to(m_dev), labels.to(m_dev), LR)
            for m, m_dev in ((card, "cuda"), (cpu, "cpu"))]
        launches = launch_counts()
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
    launches = launch_counts()
    if launches != (22, 22) or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"20 steps at batch 32: launches {launches}, losses {losses}")
    log(f"[train] 20 steps at batch 32 on one batch: loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
        f"CSV header of {len(names)} names, {len(rows)} rows")
    log(f"[train] 64L x 16F antisymmetric model: 22 train steps, {launches[0]} launches of "
        f"fused_euler_fwd, {launches[1]} of fused_euler_bwd ({smi})")
    return launches, steps[card], (images, labels)


def cuda_time_ms(fn, runs=25, repeats=5, warmup=3):
    """Milliseconds a call of ``fn`` takes on the card: CUDA events around
    ``runs`` calls issued back to back (so the host's work for the next call
    overlaps this one on the card), divided by ``runs``; the median of
    ``repeats`` such windows."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return statistics.median(times)


def kernel_bounds(b, hh, ww, c, layers, backward=False):
    """The least time B1 (or B2) could take at this shape: FLOPs over the
    fp32 CUDA-core rate against the bytes that each input read once and each
    output written once move over HBM.  B1: 2*L*B*H*W*9C^2 FLOPs, x, K and b
    in, y out.  B2: the forward recompute, dK and the state cotangent, each
    2*L*B*H*W*9C^2 (it reads the relu mask of its recompute instead of
    recomputing z); x, g, K and b in, gx, gK and gb out."""
    passes = 3 if backward else 1
    flops = passes * 2 * layers * b * hh * ww * 9 * c * c
    state, kernels, biases = b * hh * ww * c, layers * 9 * c * c, layers * c
    nbytes = 4 * ((3 * state + 2 * kernels + 2 * biases) if backward
                  else (2 * state + kernels + biases))
    flop_ms, byte_ms = flops / FP32_CUDA_CORE_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return dict(flops=flops, nbytes=nbytes, flop_ms=flop_ms, byte_ms=byte_ms,
                bound_ms=max(flop_ms, byte_ms),
                bound_by="operations" if flop_ms >= byte_ms else "bytes")


def phase_time_kernel():
    b, hh, ww, c, layers, h = 32, 32, 32, 16, 64, 0.125
    x, kernels, biases, _ = make_case(b, hh, ww, c, layers, 7)
    small = {}
    for batch in (1, 7):
        small[batch] = cuda_time_ms(lambda: fi.fused_euler_dense(x[:batch], kernels, biases, h))
        log(f"[time] fused_euler_fwd B={batch} {hh}x{ww}x{c} L={layers} "
            f"({describe_bands(x[:batch].shape)[1]}): kernel {small[batch]:.4f} ms")
    # Band counts beside the plan's: 8 bands at batch 1 and 32 (two blocks
    # an SM), one thread a tile.
    for batch, bands in ((1, 8), (32, 8)):
        ms = cuda_time_ms(lambda: fi._launch(x[:batch], kernels, biases, h, torch.float32, bands))
        log(f"[time] fused_euler_fwd B={batch} in {bands} bands, "
            f"{fi.kernel_split(hh, ww, c, bands)} thread(s) a tile (not the plan): "
            f"kernel {ms:.4f} ms")
    kernel_ms = cuda_time_ms(lambda: fi.fused_euler_dense(x, kernels, biases, h))
    plain_ms = cuda_time_ms(lambda: fi.reference_euler_dense(x, kernels, biases, h))
    bound = kernel_bounds(b, hh, ww, c, layers)
    flops, nbytes, flop_ms, byte_ms, bound_ms, bound_by = bound.values()
    log(f"[time] fused_euler_fwd B={b} {hh}x{ww}x{c} L={layers} ({describe_bands(x.shape)[1]}): "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, 25 calls back to back, median of 5)")
    log(f"[time] bound: {flops / 1e9:.3f} GFLOP / {FP32_CUDA_CORE_FLOPS / 1e12:g} TFLOP/s "
        f"(H100 SXM fp32 CUDA cores) = {flop_ms:.4f} ms; {nbytes / 1e6:.3f} MB / "
        f"{HBM_BYTES_PER_S / 1e12:g} TB/s = {byte_ms:.5f} ms; bound {bound_ms:.4f} ms "
        f"by {bound_by}; kernel at {bound_ms / kernel_ms:.1%} of it")
    for label, ms in (("B=32", kernel_ms), ("B=1", small[1])):
        log(f"[time] fused_euler_fwd {label}: {ms:.4f} ms against the target of <= 0.6 ms: "
            f"{'met' if ms <= 0.6 else 'NOT met'}")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def phase_time_bwd():
    b, hh, ww, c, layers, h = 32, 32, 32, 16, 64, 0.125
    x, kernels, biases, g = make_case(b, hh, ww, c, layers, 8)
    one_ms = cuda_time_ms(lambda: fi.fused_euler_dense_bwd(x[:1], kernels, biases, g[:1], h))
    log(f"[time] fused_euler_bwd B=1 {hh}x{ww}x{c} L={layers} "
        f"({describe_bands(x[:1].shape, backward=True)[1]}): kernel {one_ms:.4f} ms")
    ms8 = cuda_time_ms(lambda: fi._launch_bwd(x, kernels, biases, g, h, torch.float32, 8))
    log(f"[time] fused_euler_bwd B={b} in 8 bands (not the plan): kernel {ms8:.4f} ms")
    kernel_ms = cuda_time_ms(lambda: fi.fused_euler_dense_bwd(x, kernels, biases, g, h))
    plain_ms = cuda_time_ms(lambda: fi.reference_euler_dense_bwd(x, kernels, biases, g, h))
    bound = kernel_bounds(b, hh, ww, c, layers, backward=True)
    flops, nbytes, flop_ms, byte_ms, bound_ms, bound_by = bound.values()
    bands = fi.kernel_bands(x.shape, backward=True)
    padded, _, rows, row = fi._band_geometry(hh, ww, c, bands)
    items = rows * -(-ww // 4) * padded // 4 * fi.kernel_split(hh, ww, c, bands)
    scratch_bytes = (4 * layers * b * (2 * hh + 2 * (bands - 1)) * row  # trajectory out, in with halos
                     + 2 * 2 * layers * b * bands * items             # relu-mask words out and in
                     + 2 * 4 * layers * b * bands * (9 * padded * padded + padded)  # dK partials
                     + 2 * 4 * 2 * layers * b * bands * 2 * row)      # edge rows out and in
    log(f"[time] fused_euler_bwd B={b} {hh}x{ww}x{c} L={layers} "
        f"({describe_bands(x.shape, backward=True)[1]}): kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (CUDA events, 25 calls back to back, median of 5)")
    log(f"[time] bound: 3 x 2*L*B*H*W*9C^2 = {flops / 1e9:.3f} GFLOP / "
        f"{FP32_CUDA_CORE_FLOPS / 1e12:g} TFLOP/s (H100 SXM fp32 CUDA cores) = {flop_ms:.4f} ms; "
        f"{nbytes / 1e6:.3f} MB / {HBM_BYTES_PER_S / 1e12:g} TB/s = {byte_ms:.5f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by}; kernel at {bound_ms / kernel_ms:.1%} of it "
        f"(its trajectory, masks, dK partials and edge rows add {scratch_bytes / 1e6:.1f} MB = "
        f"{scratch_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms of traffic)")
    log(f"[time] fused_euler_bwd B=32: {kernel_ms:.4f} ms against the target of <= 2.5 ms: "
        f"{'met' if kernel_ms <= 2.5 else 'NOT met'}")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def phase_time_narrow(smi):
    """B1 and B2 at 8 filters (the regular 64L x 8F run's identity stack,
    unstructured kernels, batch 32) beside their plain versions and their
    bounds."""
    b, hh, ww, c, layers, h = 32, 32, 32, 8, 64, 0.125
    x, kernels, biases, g = make_case(b, hh, ww, c, layers, 9, unstructured=True)
    for name, backward, run, plain in (
            ("fused_euler_fwd", False, lambda: fi.fused_euler_dense(x, kernels, biases, h),
             lambda: fi.reference_euler_dense(x, kernels, biases, h)),
            ("fused_euler_bwd", True, lambda: fi.fused_euler_dense_bwd(x, kernels, biases, g, h),
             lambda: fi.reference_euler_dense_bwd(x, kernels, biases, g, h))):
        kernel_ms, plain_ms = cuda_time_ms(run), cuda_time_ms(plain)
        bound = kernel_bounds(b, hh, ww, c, layers, backward)
        flops, bound_ms, bound_by = bound["flops"], bound["bound_ms"], bound["bound_by"]
        log(f"[time] {name} B={b} {hh}x{ww}x{c} L={layers} regular kernels "
            f"({describe_bands(x.shape, backward)[1]}): kernel {kernel_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms; bound {flops / 1e9:.3f} GFLOP / 67 TFLOP/s = {bound_ms:.4f} ms by "
            f"{bound_by}; kernel at {bound_ms / kernel_ms:.1%} of it ({smi})")


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
    return ms


def profile_window(run, steps, label="train_step"):
    """torch.profiler (CPU and CUDA) over ``steps`` synchronized calls of
    ``run``: (host ms a step, device-busy ms a step, device operations a
    step, idle share, the device operations' averages).  The idle share is
    1 - the union of the device operations' intervals over the sum of the
    calls' host ranges, each ending in a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            with record_function(label):
                run()
                torch.cuda.synchronize()

    def annotation(e):  # record_function ranges, which Kineto also puts on the device timeline
        return (getattr(e, "name", None) or e.key) == label or getattr(
            e, "is_user_annotation", False)

    events = prof.events()
    windows = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == label and e.device_type == DeviceType.CPU]
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == DeviceType.CUDA and not annotation(e))
    busy, reach = 0.0, float("-inf")
    for start, end in device:  # the union of the device intervals
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    window = sum(end - start for start, end in windows)
    kernels = [a for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA and not annotation(a)]
    return window / 1e3, busy / 1e3, len(device), 1 - busy / window, kernels


def device_us(avg):
    return getattr(avg, "self_device_time_total", None) or getattr(avg, "self_cuda_time_total", 0)


def phase_profile(step, batch, steps=10):
    """torch.profiler over ``steps`` synchronized train steps at batch 32:
    the ten device operations with the most device time, and the device's
    idle share of the window (1 - the union of device-op intervals over the
    sum of the steps' host ranges, each ending in a synchronize)."""
    images, labels = batch
    for _ in range(3):
        step(images, labels, LR)
    torch.cuda.synchronize()
    window, busy, ops, idle, kernels = profile_window(lambda: step(images, labels, LR), steps)
    total = sum(device_us(a) for a in kernels)
    log(f"[profile] {steps} train steps at batch {len(images)} (profiler on): host window "
        f"{window / steps:.4f} ms a step, device busy {busy / steps:.4f} ms a step "
        f"({ops / steps:.1f} device operations a step), idle share {idle:.1%}")
    if total == 0:
        log("[profile] the profiler recorded no device time on this machine")
    for avg in sorted(kernels, key=device_us, reverse=True)[:10]:
        log(f"[profile]   {device_us(avg) / steps / 1e3:8.4f} ms a step "
            f"({device_us(avg) / total:6.1%}), {avg.count / steps:5.1f} a step: {avg.key[:110]}")
    return idle


@contextlib.contextmanager
def cudnn_deterministic(flag=True):
    """``torch.backends.cudnn.deterministic`` set to ``flag`` inside, the
    caller's value restored on exit (the port's convolutions keep it since
    C2's repair: `ops.conv.cudnn_tf32_off`)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = flag
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def phase_deterministic(smi, steps=2, timed=50):
    """cuDNN's determinism flag reaches the port's convolutions (the stem's
    and its weight gradient run on cuDNN; B1 and B2 sum in fixed orders):
    with ``torch.backends.cudnn.deterministic`` True, and then at its
    default (False), two 64L x 16F models built from one seed each take
    ``steps`` replayed steps on one batch, and their losses, grad-norm rows
    and parameters are compared bit for bit; then the replayed step's time
    under each setting, in turns (default, deterministic, deterministic,
    default; ``timed`` replays each).  Raises unless the deterministic
    setting gave bit-identical steps."""
    images, labels = [t.cuda() for t in image_batch(np.random.default_rng(5), HARNESS_BATCH)]
    identical = {}
    for deterministic in (True, False):
        runs = []
        for _ in range(2):
            with cudnn_deterministic(deterministic):
                model = headline_model(seed=0)
                multi = make_multi_step(model, make_adam(model.parameters()))
                metrics, norms = multi(images.expand(steps, *images.shape),
                                       labels.expand(steps, *labels.shape), [LR] * steps)
                torch.cuda.synchronize()
            runs.append([metrics["loss"].clone(), norms.clone()]
                        + [p.detach().clone() for p in model.parameters()])
            del model, multi
        identical[deterministic] = all(torch.equal(a, b) for a, b in zip(*runs))
        worst = max(float((a - b).abs().max()) for a, b in zip(*runs))
        log(f"[deterministic] cudnn.deterministic={deterministic}: two 64L x 16F models "
            f"from one seed, {steps} replayed steps at batch {HARNESS_BATCH} each: losses, "
            f"grad-norm rows and parameters bit-identical {identical[deterministic]} (max "
            f"|difference| {worst:.3e}) ({smi})")
    times = {True: [], False: []}
    for deterministic in (False, True, True, False):
        with cudnn_deterministic(deterministic):
            times[deterministic].append(replayed_steps_ms(headline_model(seed=0), steps=timed))
    log(f"[deterministic] replayed 64L x 16F step at batch {HARNESS_BATCH}, {timed} replays a "
        f"turn: default {' / '.join(f'{t:.4f}' for t in times[False])} ms, deterministic "
        f"{' / '.join(f'{t:.4f}' for t in times[True])} ms ({smi})")
    if not identical[True]:
        raise AssertionError("with cudnn.deterministic on, two steps from one state differ: "
                             "the flag does not reach the port's convolutions")


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


def eager_predict(model):
    """The request path served before the compiled export: the model called
    op by op in inference mode, NumPy in and out."""
    def predict(images):
        with torch.inference_mode():
            return model(torch.as_tensor(images).cuda()).cpu().numpy()

    return predict


def request_ms(predict, images, runs=25):
    """Median request latency on the host clock (NumPy in, NumPy out), after
    3 warm-up requests."""
    for _ in range(3):
        predict(images)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        predict(images)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def served_paths(label, model, export_dir, batch, images, want_logits, smi, runs=25,
                 tf32_shows=False):
    """Request latency at ``batch`` of the export in ``export_dir`` (made
    at that batch) on its three paths: the compiled forward.pt2 replayed,
    the rebuilt model replayed, and the eager model.  Logit gaps
    (`logit_gaps`): the compiled answer against ``want_logits`` (the CPU
    model's) within FP32_TOL, the other two against the compiled one
    within CARD_PATHS_TOL, which a TF32 run of the program is measured
    against (`tf32_control`); with ``tf32_shows``, a model whose convs
    cuDNN runs in TF32 when allowed, that run must miss it.  Returns
    {path: ms}."""
    compiled, _ = load_exported(export_dir, device="cuda")
    rebuilt, _ = load_exported(export_dir, prefer_stablehlo=False, device="cuda")
    paths = {"compiled": compiled, "rebuilt": rebuilt, "eager": eager_predict(model)}
    want = compiled(images)
    err, ok, kept = gap_violation(want, want_logits, FP32_TOL)
    log(f"[serve_paths] {label}, batch {batch}: compiled forward.pt2 logit gaps against the "
        f"CPU model's {err:.3e} over {kept} classes (tol rtol=atol={FP32_TOL:g}): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the compiled path answers otherwise than the CPU")
    times, errs = {}, {}
    for name, predict in paths.items():
        errs[name], ok, _ = gap_violation(predict(images), want, CARD_PATHS_TOL, ref_probs=True)
        if not ok:
            raise AssertionError(f"{label}: the {name} path answers otherwise than the compiled "
                                 f"one ({errs[name]:.3e})")
        times[name] = request_ms(predict, images, runs)
    if compiled.routes["rebuilt"] or rebuilt.routes["compiled"] or not compiled.routes["compiled"]:
        raise AssertionError(f"{label}: requests took the wrong paths: compiled "
                             f"{compiled.routes}, rebuilt {rebuilt.routes}")
    tf32_err, tf32_ok, _ = tf32_control(export_dir, images, want)
    log(f"[serve_paths] {label}, batch {batch}: request latency median of {runs} (host clock, "
        f"NumPy in and out): compiled forward.pt2 replayed {times['compiled']:.4f} ms, rebuilt "
        f"model replayed {times['rebuilt']:.4f} ms, eager model {times['eager']:.4f} ms; logit "
        f"gaps of the rebuilt and eager paths against the compiled one {errs['rebuilt']:.3e} and "
        f"{errs['eager']:.3e} (tol rtol=atol={CARD_PATHS_TOL:g}); the program run with cuDNN "
        f"TF32 on: {tf32_err:.3e} ({'within' if tf32_ok else 'past'} the tol) ({smi})")
    if tf32_shows and tf32_ok:
        raise AssertionError(f"{label}: a TF32 run of the program passes CARD_PATHS_TOL, so the "
                             "check would not see the program run in TF32")
    return times


def phase_serve_paths(tmp, smi):
    """The compiled forward (forward.pt2) beyond the headline requests:

    1. an export of the 64L x 16F model made on the CPU, loaded on the
       card: a request at its batch (32) launches B1 once, and its logit
       gaps (`logit_gaps`) match the card's own export's within
       CARD_PATHS_TOL;
    2. request latency of the compiled, rebuilt and eager paths at batch 1
       and 32, each from an export at that batch (`served_paths`);
    3. the `use_pallas` antisymmetric 64L x 128F stack exported at batch 32
       and served through forward.pt2: one wide B1 call a request, its
       logit gaps against the rebuilt path's on the card within
       CARD_PATHS_TOL.

    Returns the (band B1, wide B1) launches of the requests of 1 and 3."""
    t_phase = time.perf_counter()
    card = headline_model(seed=21)
    cpu = build_single_block_resnet(card.config, params=card.params(), device="cpu")
    rng = np.random.default_rng(21)
    images = {n: rng.uniform(0, 255, (n, 32, 32, 3)).astype(np.float32) for n in (1, 32)}
    from_cpu, _ = load_exported(export_model(cpu, os.path.join(tmp, "from_cpu"), batch_size=32),
                                device="cuda")
    own_dir = export_model(card, os.path.join(tmp, "card_32"), batch_size=32)
    own, _ = load_exported(own_dir, device="cuda")
    want = warmed(own, [images[32]])(images[32])
    warmed(from_cpu, [images[32]])
    reset_counts()
    got = from_cpu(images[32])
    band = STACKS.launches("B1", "band")
    err, ok, kept = gap_violation(got, want, CARD_PATHS_TOL, ref_probs=True)
    ok = ok and band == 1 and from_cpu.routes == {"compiled": 2, "rebuilt": 0}
    log(f"[serve_paths] an export made on the CPU, served on the card at batch 32: {band} B1 "
        f"launch, routes {from_cpu.routes}, logit gaps against the card's own export "
        f"{err:.3e} over {kept} classes (tol rtol=atol={CARD_PATHS_TOL:g}): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the CPU's export does not serve on the card as the card's own does")
    with torch.inference_mode():
        logits = {n: cpu(torch.from_numpy(x), return_logits=True) for n, x in images.items()}
    del cpu, from_cpu, own
    latency = {}
    for batch in (1, 32):
        export_dir = own_dir if batch == 32 else export_model(
            card, os.path.join(tmp, f"card_{batch}"), batch_size=batch)
        latency[batch] = served_paths("64L x 16F antisymmetric", card, export_dir, batch,
                                      images[batch], logits[batch], smi)
    del card
    config = cifar10_single_block_config(num_layers=64, num_filters=128, use_pallas=True)
    wide = build_single_block_resnet(config, generator=torch.Generator().manual_seed(22),
                                     device="cuda")
    wide_dir = export_model(wide, os.path.join(tmp, "wide_128"), batch_size=32)
    compiled, _ = load_exported(wide_dir, device="cuda")
    rebuilt, _ = load_exported(wide_dir, prefer_stablehlo=False, device="cuda")
    want = warmed(rebuilt, [images[32]])(images[32])
    warmed(compiled, [images[32]])
    reset_counts()
    got = compiled(images[32])
    wide_calls, wide = STACKS.calls("B1", "wide"), STACKS.launches("B1", "wide")
    err, ok, kept = gap_violation(got, want, CARD_PATHS_TOL, ref_probs=True)
    ok = (ok and STACKS.calls("B1") == wide_calls == 1 and wide == 64
          and compiled.routes["compiled"] == 2)
    log(f"[serve_paths] use_pallas antisymmetric 64L x 128F exported at batch 32, served "
        f"through forward.pt2: {wide_calls} wide B1 call ({wide} launches) of "
        f"{STACKS.calls('B1')} B1 call a request, "
        f"logit gaps against the rebuilt model's {err:.3e} over {kept} classes (tol "
        f"rtol=atol={CARD_PATHS_TOL:g}) ({smi}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the wide stack's forward.pt2 does not run the wide B1 once a request")
    log(f"[serve_paths] phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    return band, wide


HARNESS_BATCH = 32
STREAM_STEPS = 200
GRAPH_K = 8
WINDOW_STEPS = 60  # steps of an epoch in the profiled idle-share windows


def headline_model(seed=0):
    config = cifar10_single_block_config(num_layers=64, num_filters=16, kernel_type="antisymmetric")
    return build_single_block_resnet(config, generator=torch.Generator().manual_seed(seed),
                                     device="cuda")


def logged_summary_steps(log_dir):
    """The steps of the scalars a `SummaryWriter` wrote: its JSONL file, or
    TensorBoard's event files where the tensorboard package is installed."""
    jsonl = os.path.join(log_dir, "scalars.jsonl")
    if os.path.isfile(jsonl):
        with open(jsonl) as f:
            return sorted({json.loads(line)["step"] for line in f})
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    events = EventAccumulator(log_dir)
    events.Reload()
    return sorted({e.step for tag in events.Tags()["scalars"] for e in events.Scalars(tag)})


def rate_figures(label, seconds, steps, smi, config=None):
    """Seconds, steps/s, model TFLOP/s and MFU against the fp32 peak of a
    run of ``steps`` train steps at batch 32 (of the headline model unless
    ``config`` says otherwise)."""
    config = config or cifar10_single_block_config(num_layers=64, num_filters=16)
    flops_step = single_block_train_flops(config, HARNESS_BATCH)
    rate = steps / seconds
    log(f"[harness] {label}: {seconds:.4f} s for {steps} steps, {rate:.2f} steps/s, "
        f"{flops_step * rate / 1e12:.4f} model TFLOP/s ({flops_step / 1e9:.3f} GFLOP a step), "
        f"MFU {mfu(flops_step, rate):.2%} of the {PEAK_FLOPS['h100_sxm_fp32'] / 1e12:g} TFLOP/s "
        f"fp32 peak ({smi})")
    return rate


def epoch_window(label, run_epoch, steps, epochs=2):
    """The idle share and device operations a step over ``epochs`` profiled
    epochs of ``steps`` steps (``run_epoch(steps)``)."""
    window, busy, ops, idle, _ = profile_window(lambda: run_epoch(steps), epochs, label)
    n = epochs * steps
    log(f"[harness] profiled window of {label}, {epochs} epochs of {steps} steps: host "
        f"{window / n:.4f} ms a step, device busy {busy / n:.4f} ms a step ({ops / n:.1f} device "
        f"operations a step), idle share {idle:.1%}")
    return idle


def eager_device_epoch(step, features, labels, generator, steps, augment):
    """`make_device_epoch`'s epoch with the eager step in place of the
    replayed one: the same shuffle, gather, cast, augmentation and
    telemetry rows on the card.  Returns the rows."""
    perm = torch.randperm(len(features), generator=generator, device=features.device)
    rows = None
    for i in range(steps):
        idx = perm[i * HARNESS_BATCH:(i + 1) * HARNESS_BATCH]
        x = augment(generator, features.index_select(0, idx).to(torch.float32))
        row = pack_row(*step(x, labels.index_select(0, idx), LR))
        if rows is None:
            rows = row.new_empty((steps, row.numel()))
        rows[i].copy_(row)
    return rows


def kernel_counts(kernels):
    """(B1 launches, B2 launches, B1 device ms, B2 device ms) among a
    profiler's device-operation averages, by kernel name."""
    counts = {"euler_fwd<": [0, 0.0], "euler_bwd<": [0, 0.0]}
    for avg in kernels:
        for name, c in counts.items():
            if name in avg.key:
                c[0] += avg.count
                c[1] += device_us(avg) / 1e3
    (n1, t1), (n2, t2) = counts["euler_fwd<"], counts["euler_bwd<"]
    return n1, n2, t1, t2


def phase_harness(smi, arrays):
    """The harness at full width and depth (64L x 16F, batch 32) on
    synthetic CIFAR-10 of the real size (50,000 + 10,000 uint8 images):

    1. streaming: `Training.train` of 200 replayed steps (CSV and summary
       rows at summaries_frequency, the loss falls), then a full 'val' pass
       of 313 replayed batches;
    2. graph against eager: K = 8 steps replayed through `make_multi_step`
       against 8 eager steps from the same state and batches;
    3. device-resident epoch: 1562 steps with `standard_cifar_augment` as
       CUDA-graph replays, once under the profiler (one B1 and one B2 a
       step, as the counters say) and once timed, beside the same epoch
       with the eager step; the idle share of a profiled window of each;
       the device eval against the streaming eval;
    4. checkpoint round trip: save, load into a new trainer (bit for bit),
       and one more step on each;
    5. the CLI in subprocesses: train (device data), then evaluate, predict
       and analyze together.

    Returns the B1 and B2 launches on the card in this process's phase."""
    from torch.profiler import ProfilerActivity, profile

    train_x, train_y, val_x, val_y = arrays
    data = dict(train_features=train_x, train_labels=train_y, val_features=val_x,
                val_labels=val_y, batch_size=HARNESS_BATCH)
    names = gradient_metric_names(cifar10_single_block_config(num_layers=64, num_filters=16))
    STACKS.reset()
    counts = launch_counts

    with tempfile.TemporaryDirectory() as tmp:
        # 1. The streaming path, replayed steps.
        stream = Training(headline_model(), csv_logger_dir=os.path.join(tmp, "csv"),
                          csv_logger_name="stream", summaries_dir=os.path.join(tmp, "sum"),
                          summaries_name="stream", **data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream.train(epochs=1, steps_per_epoch=STREAM_STEPS, learning_rate_schedule=lambda s: LR,
                     eval_frequency=None, summaries_frequency=10, verbose=False)
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
        stream_counts = counts()
        t0 = time.perf_counter()
        stream_eval = stream.evaluate("val")
        eval_s = time.perf_counter() - t0
        eval_b1 = counts()[0] - stream_counts[0]
        stream.close()
        (csv_name,) = [f for f in os.listdir(os.path.join(tmp, "csv")) if f.endswith("_training.csv")]
        with open(os.path.join(tmp, "csv", csv_name)) as f:
            header, *rows = f.read().splitlines()
        rows = [[float(v) for v in r.split(" ")] for r in rows]
        steps_logged = [int(r[0]) for r in rows]
        summary_steps = logged_summary_steps(os.path.join(tmp, "sum", "stream", "train"))
        first, last = rows[0][1], rows[-1][1]
        val_batches = -(-len(val_x) // HARNESS_BATCH)
        ok = (header.split(" ") == ["global_step", "mean_loss", "accuracy"] + names
              and steps_logged == list(range(10, STREAM_STEPS + 1, 10))
              and summary_steps == steps_logged
              and all(np.isfinite(r[1]) for r in rows) and last < first
              and stream_counts == (WARMUP_CALLS + STREAM_STEPS,) * 2
              and eval_b1 == 2 * WARMUP_CALLS + val_batches
              and stream.eval_metrics._count == len(val_x) and np.isfinite(stream_eval["mean_loss"]))
        log(f"[harness] streaming: {STREAM_STEPS} replayed steps in {stream_s:.4f} s, capture "
            f"included ({STREAM_STEPS / stream_s:.2f} steps/s, host staging included; B1 and B2 "
            f"launches {stream_counts}: {WARMUP_CALLS} warm-up + one replay a step); CSV of "
            f"{len(header.split(' '))} columns, rows at steps {steps_logged[0]}..{steps_logged[-1]} "
            f"every 10, summaries at the same steps; running mean loss {first:.4f} -> {last:.4f}; "
            f"val pass of {val_batches} replayed batches ({int(stream.eval_metrics._count)} images, "
            f"{eval_b1} B1 launches: two graphs, batch 32 and the last batch of 16) in {eval_s:.4f} s: "
            f"loss {stream_eval['mean_loss']:.6f} accuracy {stream_eval['accuracy']:.4f}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the streaming epoch's CSV, summaries, loss or evaluation is wrong")

        # 2. K replayed steps against K eager steps.
        graph_model, eager_model = headline_model(), headline_model()
        optimizers = [make_adam(m.parameters()) for m in (graph_model, eager_model)]
        idx = np.arange(GRAPH_K * HARNESS_BATCH).reshape(GRAPH_K, HARNESS_BATCH)
        images = torch.from_numpy(train_x[idx]).cuda()
        labels = torch.from_numpy(train_y[idx]).cuda()
        lrs = [LR * (1 + 0.1 * i) for i in range(GRAPH_K)]
        t0 = time.perf_counter()
        metrics, norms = make_multi_step(graph_model, optimizers[0])(images, labels, lrs)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        eager = make_train_step(eager_model, optimizers[1])
        want = [eager(images[i], labels[i], lrs[i]) for i in range(GRAPH_K)]
        loss_err = max(abs(float(metrics["loss"][i]) - float(m["loss"])) / abs(float(m["loss"]))
                       for i, (m, _) in enumerate(want))
        norm_err = max(norm_rel(norms[i], n) for i, (_, n) in enumerate(want))
        param_err = max(norm_rel(p.detach(), q.detach())
                        for p, q in zip(graph_model.parameters(), eager_model.parameters()))
        ok = max(loss_err, norm_err, param_err) <= TRAIN_GRAD_TOL
        log(f"[harness] graph against eager: {GRAPH_K} replayed steps (capture, {WARMUP_CALLS} warm-up "
            f"calls and the replays in {capture_s:.3f} s) against {GRAPH_K} eager steps: loss rows "
            f"max rel {loss_err:.2e}, grad-norm rows max norm-rel {norm_err:.2e}, parameters max "
            f"norm-rel {param_err:.2e} (tol {TRAIN_GRAD_TOL:g}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the replayed steps disagree with the eager steps")

        # 3. The device-resident epoch, as CUDA-graph replays.
        steps = len(train_x) // HARNESS_BATCH
        trainer = Training(graph_model, optimizer=optimizers[0],
                           jit_augment=standard_cifar_augment(),
                           csv_logger_dir=os.path.join(tmp, "csv_dev"), csv_logger_name="dev", **data)
        host_before = counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.train(epochs=1, steps_per_epoch=steps, learning_rate_schedule=lambda s: LR,
                          device_data=True, eval_frequency=None, verbose=False)
            torch.cuda.synchronize()
        n1, n2, t1, t2 = kernel_counts(prof.key_averages())
        counted = tuple(a - b for a, b in zip(counts(), host_before))
        ok = (n1, n2) == counted == (WARMUP_CALLS + steps,) * 2
        log(f"[harness] device-resident epoch under the profiler: {steps} steps, B1 {n1} and B2 {n2} "
            f"launches on the card = {WARMUP_CALLS} warm-up calls + one replay a step (the record "
            f"of hand-kernel calls: {counted[0]} and {counted[1]}); inside the epoch B1 "
            f"{t1 / max(n1, 1):.4f} ms "
            f"and B2 {t2 / max(n2, 1):.4f} ms a launch ({smi}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the device-resident epoch of {steps} steps launched B1 {n1} and "
                                 f"B2 {n2} times on the card, counted {counted}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = trainer.train(epochs=1, steps_per_epoch=steps, learning_rate_schedule=lambda s: LR,
                                device_data=True, eval_frequency=None, verbose=False)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        device_eval = trainer.evaluate("val", device_data=True)
        device_eval_s = time.perf_counter() - t0
        streaming_eval = trainer.evaluate("val")
        loss_rel = abs(device_eval["mean_loss"] - streaming_eval["mean_loss"]) / abs(
            streaming_eval["mean_loss"])
        acc_err = abs(device_eval["accuracy"] - streaming_eval["accuracy"])
        ok = (loss_rel <= 1e-5 and acc_err <= 1e-3 and np.isfinite(history["train"][-1]["mean_loss"]))
        log(f"[harness] device eval ({val_batches} replayed batches, ragged last "
            f"masked, {device_eval_s:.4f} s) against the streaming eval on the same parameters: loss "
            f"{device_eval['mean_loss']:.6f} vs {streaming_eval['mean_loss']:.6f} (rel {loss_rel:.2e}, "
            f"tol 1e-5), accuracy {device_eval['accuracy']:.4f} vs {streaming_eval['accuracy']:.4f} "
            f"(tol 1e-3); epoch loss {history['train'][-1]['mean_loss']:.4f} accuracy "
            f"{history['train'][-1]['accuracy']:.4f}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the device eval disagrees with the streaming eval")

        # The same epoch with the eager step, from the eager twin's state.
        features, targets = trainer._device_data("train")
        generator = torch.Generator(device="cuda")
        augment = standard_cifar_augment()

        def eager_epoch(n):
            return eager_device_epoch(eager, features, targets, generator, n, augment)

        eager_epoch(WINDOW_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_rows = eager_epoch(steps)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        if not torch.isfinite(eager_rows).all():
            raise AssertionError("the eager epoch's telemetry rows are not finite")
        graph_rate = rate_figures("device-resident epoch, CUDA-graph replays (unprofiled)",
                                  epoch_s, steps, smi)
        eager_rate = rate_figures("device-resident epoch, eager steps (unprofiled)",
                                  eager_s, steps, smi)
        graph_idle = epoch_window(
            "device-resident epochs, replayed steps",
            lambda n: trainer.train(epochs=1, steps_per_epoch=n, learning_rate_schedule=lambda s: LR,
                                    device_data=True, eval_frequency=None, verbose=False),
            WINDOW_STEPS)
        eager_idle = epoch_window("device-resident epochs, eager steps", eager_epoch, WINDOW_STEPS)
        log(f"[harness] graph against eager, measured epochs of {steps} steps: {epoch_s:.4f} vs "
            f"{eager_s:.4f} s, {graph_rate / eager_rate:.3f}x the steps/s; idle {graph_idle:.1%} vs "
            f"{eager_idle:.1%} ({smi})")

        # 4. Checkpoint round trip.
        path = trainer.save(os.path.join(tmp, "ckpt"))
        restored = Training(headline_model(seed=7), **data)
        restored.load_variables(path)
        same_params = all(torch.equal(p, q) for p, q in
                          zip(restored.model.parameters(), trainer.model.parameters()))
        slots = [(restored.optimizer.state[p], trainer.optimizer.state[q]) for p, q in
                 zip(restored.model.parameters(), trainer.model.parameters())]
        same_slots = all(torch.equal(a[k], b[k]) for a, b in slots for k in ("step", "exp_avg", "exp_avg_sq"))
        x, y = images[0], labels[0]
        # Each row is its graph's own output: copied before the next call.
        row_a = restored._train_step(x, y, LR).clone()
        row_b = trainer._train_step(x, y, LR).clone()
        step_err = max(abs(float(row_a[0]) - float(row_b[0])) / abs(float(row_b[0])),
                       norm_rel(row_a[3:], row_b[3:]),
                       max(norm_rel(p.detach(), q.detach()) for p, q in
                           zip(restored.model.parameters(), trainer.model.parameters())))
        ok = same_params and same_slots and restored.global_step == trainer.global_step and \
            step_err <= TRAIN_GRAD_TOL
        log(f"[harness] checkpoint at step {trainer.global_step}: parameters bit for bit {same_params}, "
            f"Adam slots bit for bit {same_slots}; the next step max rel {step_err:.2e} "
            f"(tol {TRAIN_GRAD_TOL:g}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the checkpoint round trip lost state")
        phase_counts = counts()

        # 5. The CLI as a user runs it.
        phase_cli(tmp)
    return phase_counts


ROOT = os.path.dirname(os.path.abspath(__file__))
# The compile cache of the CLI's subprocesses (`utils.compile_cache`): under
# build/, out of the home directory.
CLI_COMPILE_CACHE = os.path.join(ROOT, "build", "compile_cache")


def run_python(*args):
    """``python <args>`` from the checkout, with the CLI's compile cache: a
    started process."""
    env = dict(os.environ, DEQRES_COMPILE_CACHE_DIR=CLI_COMPILE_CACHE, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def run_cli(*args):
    """``python -m differential_equations_resnet_tpu_torch.cli <args>`` from
    the checkout: a started process."""
    return run_python("-m", "differential_equations_resnet_tpu_torch.cli", *args)


def check_compile_cache():
    """The CLI's first subcommand on the card built the kernels into its
    compile cache (`enable_compile_cache`); a later process that enables
    the cache finds them there and starts no compiler (0 s a build)."""
    code = ("import json\n"
            "from differential_equations_resnet_tpu_torch.ops.kernels import _build\n"
            "from differential_equations_resnet_tpu_torch.utils.compile_cache import "
            "enable_compile_cache\n"
            "root = enable_compile_cache()\n"
            "print(json.dumps({'root': root, 'seconds': _build.build(['fused_euler_fwd', "
            "'fused_euler_bwd']), 'paths': [str(_build.library_path(n)) for n in "
            "('fused_euler_fwd', 'fused_euler_bwd')]}))\n")
    out = finish(run_python("-c", code), "compile cache check", timeout=120)
    ok = (out["root"] == os.path.realpath(CLI_COMPILE_CACHE)
          and all(s == 0.0 for s in out["seconds"].values())
          and all(p.startswith(out["root"]) and os.path.isfile(p) for p in out["paths"]))
    log(f"[compile_cache] a new process with DEQRES_COMPILE_CACHE_DIR={CLI_COMPILE_CACHE}: "
        f"root {out['root']}, B1/B2 build seconds {out['seconds']} (0 = found built by the CLI's "
        f"first run, no nvcc): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the compile cache did not keep the CLI's kernel builds")


def finish(proc, name, timeout=300):
    """Wait for a CLI process; its last line of output as JSON, or raise."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"cli {name} exited with {proc.returncode}:\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def phase_cli(tmp):
    model = ["--num-layers", "64", "--num-filters", "16"]
    sizes = ["--synthetic-train-size", "5000", "--synthetic-val-size", "1000"]
    save_dir, csv_dir = os.path.join(tmp, "cli_ckpt"), os.path.join(tmp, "cli_csv")
    t0 = time.perf_counter()
    trained = finish(run_cli("train", *model, "--epochs", "1", "--steps-per-epoch", "100", *sizes,
                             "--device-data", "--save-dir", save_dir, "--csv-dir", csv_dir), "train")
    train_s = time.perf_counter() - t0
    checkpoint = os.path.join(save_dir, Checkpointer(save_dir).latest())
    (csv_name,) = [f for f in os.listdir(csv_dir) if f.endswith("_training.csv")]
    np.save(os.path.join(tmp, "x.npy"),
            np.random.default_rng(0).uniform(0, 255, (40, 32, 32, 3)).astype(np.float32))
    t0 = time.perf_counter()
    procs = {
        "evaluate": run_cli("evaluate", *model, *sizes, "--checkpoint", checkpoint),
        "predict": run_cli("predict", os.path.join(tmp, "x.npy"), *model, "--checkpoint", checkpoint),
        "analyze": run_cli("analyze", os.path.join(csv_dir, csv_name)),
    }
    out = {name: finish(proc, name) for name, proc in procs.items()}
    rest_s = time.perf_counter() - t0
    ok = (np.isfinite(trained["best"]["loss"]) and np.isfinite(out["evaluate"]["mean_loss"])
          and out["predict"]["num_images"] == 40
          and np.isfinite(out["analyze"]["gradient_norm_relative_deviation"]))
    log(f"[harness] cli train (64L x 16F, 100 device-resident steps on 5000 images, then 32 eval "
        f"batches) {train_s:.1f} s: {json.dumps(trained)}")
    log(f"[harness] cli evaluate, predict and analyze together {rest_s:.1f} s: "
        + "; ".join(f"{k} {json.dumps(v)}" for k, v in out.items()) + f": {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a CLI subcommand printed a bad result")


# The reference's comparison at full width and depth (64 layers): the stacks
# that run on B1/B2 besides the antisymmetric one, and those that take the
# per-layer route on cuDNN.
FUSED_CONFIGS = (  # (kernel type, filters, kernel size)
    ("regular", 16, 3),
    ("regular", 8, 3),
    ("centrosymmetric", 16, 3),
)
PER_LAYER_CONFIGS = (  # (kernel type, filters, kernel size, integrator)
    ("centrosymmetric", 16, 5, "euler"),
    ("antisymmetric", 16, 3, "midpoint"),
    ("antisymmetric", 16, 3, "rk4"),
)
TIMED_STEPS = 50


def model_config(kernel_type, filters, kernel_size=3, integrator="euler", remat=False):
    return cifar10_single_block_config(num_layers=64, num_filters=filters, kernel_type=kernel_type,
                                       kernel_size=kernel_size, integrator=integrator, remat=remat)


def describe(config):
    return (f"{config.kernel_type} k={config.kernel_size} {config.integrator} 64L x "
            f"{config.filters_per_block[0]}F" + (" remat" if config.remat else ""))


def launch_counts():
    """B1's and B2's launches, every variant, since the last `reset_counts`
    (the record of hand-kernel calls)."""
    return STACKS.launches("B1"), STACKS.launches("B2")


def card_calls():
    """B1's and B2's calls on the card (band and wide, not the CPU's plain
    version) since the last `reset_counts`."""
    return tuple(STACKS.calls(k, "band") + STACKS.calls(k, "wide") for k in ("B1", "B2"))


def variant_launches():
    """The band B1's and B2's launches, then the wide ones', since the last
    `reset_counts`."""
    return tuple(STACKS.launches(k, v) for v in ("band", "wide") for k in ("B1", "B2"))


def reset_counts():
    """The record's totals and every route's count set to 0."""
    STACKS.reset()
    sbr.route_counts.update(fused=0, per_layer=0)
    sbr.per_layer_counts.update(int8=0, s2d=0, direct=0)


def image_batch(rng, n, size=32, classes=10):
    """``n`` uniform 0-255 images of ``size`` x ``size`` and their labels."""
    return (torch.from_numpy(rng.uniform(0, 255, (n, size, size, 3)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, classes, n)))


# Card against CPU after an Adam step, with batch norm: every parameter
# element within BN_STEP_BOUND of lr (Adam's first two steps move an element
# by at most ~1.2 lr whatever its gradient, so this is a flipped sign at
# worst: an element whose gradient is fp32 roundoff steps either way), and
# each parameter's gradient within the step's gradient tolerance
# (norm-relative), but the conv biases that feed a batch norm, whose true
# gradient is 0.
BN_STEP_BOUND = 2.5
STATE_TOL = 1e-4    # running statistics after a train step, norm-relative
# The bottleneck family in train mode, card against CPU: at 32x32 its last
# stage is 1x1, so batch norm there normalizes each channel over the batch's
# 16 values alone, dividing the convs' fp32 differences by a spread that can
# be small (a first step: loss 1.1e-05, grad norms 6.8e-04 at batch 16,
# 1.3e-03 at batch 8, while the eval-mode logits agree to ~2e-6).
RESNET_LOSS_TOL = 1e-4
RESNET_GRAD_TOL = 5e-3    # the grad-norm row (the 3x3 mid-convs)
# Each parameter's gradient, norm-relative: the antisymmetric mid-convs' d
# (and a, b, c) vectors take differences of two nearly equal correlations (d
# sits at +d and -d), and cuDNN's weight gradients differ from run to run,
# so the worst leaf moves: 2.2e-02 to 2.6e-02 seen in ResNet-50 (the stem
# norm's scale too), up to 7.3e-04 in the single-block model with batch
# norm (its a and d vectors).  A fault in a layer's gradient is O(1).
RESNET_LEAF_TOL = 1e-1
BN_LEAF_TOL = 5e-3


def bn_agreement(card, cpu):
    """(max |card - cpu| over every parameter element in units of lr, the
    worst norm-relative difference of a parameter's gradient and that
    parameter's name, the conv biases that feed a batch norm left out),
    after a step of both."""
    worst, grad_err, leaf = 0.0, 0.0, ""
    for name, a in card.named_parameters():
        b = cpu.get_parameter(name)
        worst = max(worst, float((a.detach().cpu() - b.detach()).abs().max()) / LR)
        if not (name.endswith("__bias") and name != "head__bias"):
            err = norm_rel(a.grad.cpu(), b.grad)
            if err > grad_err:
                grad_err, leaf = err, name
    return worst, grad_err, leaf


def sync_twin(card, cpu, opt_card, opt_cpu):
    """Give the CPU twin the card's parameters, buffers and Adam slots."""
    with torch.no_grad():
        for a, b in zip(card.buffers(), cpu.buffers()):
            b.copy_(a)
        for a, b in zip(card.parameters(), cpu.parameters()):
            b.copy_(a)
            for key, value in opt_card.state[a].items():
                opt_cpu.state[b][key].copy_(value)


def compare_steps(tag, label, card, cpu, steps=2, batch=8, image_size=32, classes=10, seed=2,
                  loss_tol=1e-5, grad_tol=TRAIN_GRAD_TOL, leaf_tol=TRAIN_GRAD_TOL, batches=None):
    """``steps`` train steps of ``card`` and its CPU twin on the same
    batches (``batches``, a list of (images, labels) on the CPU, or drawn
    with `image_batch`), each from the same state: loss (relative, ``loss_tol``),
    correct count, grad-norm row (relative, ``grad_tol``), the parameters
    after Adam (norm-relative TRAIN_GRAD_TOL a leaf; with batch norm
    `bn_agreement`: BN_STEP_BOUND, and ``leaf_tol`` for each parameter's
    gradient) and the running statistics (STATE_TOL); then the twin
    takes the card's state (`sync_twin`), so the next step is compared from
    where the card stands.  (Left to run on, the two would part: Adam steps
    an element by about lr * sign(g), and one whose gradient is fp32
    roundoff steps either way; through batch norm the random-init ResNet
    turns that into a 2-6% difference of the next loss.)  Logs every step,
    then raises where they disagreed."""
    bn = card.config.use_batch_norm
    optimizers = {m: make_adam(m.parameters()) for m in (card, cpu)}
    train = {m: make_train_step(m, optimizers[m]) for m in (card, cpu)}
    rng = np.random.default_rng(seed)
    agree = True
    for n in range(1, steps + 1):
        images, labels = (batches[n - 1] if batches is not None
                          else image_batch(rng, batch, image_size, classes))
        (m_card, norms_card), (m_cpu, norms_cpu) = [
            train[m](images.to(dev), labels.to(dev), LR) for m, dev in ((card, "cuda"), (cpu, "cpu"))]
        loss_err = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
        rel = ((norms_card.cpu() - norms_cpu).abs() / norms_cpu.abs())
        same_correct = float(m_card["correct"]) == float(m_cpu["correct"])
        if bn:
            worst, grad_err, leaf = bn_agreement(card, cpu)
            state_err = max(norm_rel(a.cpu(), b) for a, b in zip(card.buffers(), cpu.buffers()))
            params_ok = (worst <= BN_STEP_BOUND and grad_err <= leaf_tol
                         and state_err <= STATE_TOL)
            params = (f"params max |card-cpu| {worst:.3f} of lr (tol {BN_STEP_BOUND:g}), "
                      f"gradients max norm-rel {grad_err:.2e} a parameter, at {leaf} (tol "
                      f"{leaf_tol:g}), "
                      f"{len(list(card.buffers()))} running statistics max norm-rel "
                      f"{state_err:.2e} (tol {STATE_TOL:g})")
        else:
            param_err = max(norm_rel(a.detach().cpu(), b.detach())
                            for a, b in zip(card.parameters(), cpu.parameters()))
            params_ok = param_err <= TRAIN_GRAD_TOL
            params = f"params max norm-rel {param_err:.2e} (tol {TRAIN_GRAD_TOL:g})"
        ok = (loss_err <= loss_tol and float(rel.max()) <= grad_tol and same_correct
              and params_ok)
        agree = agree and ok
        log(f"[{tag}] {label} step {n} batch {batch} card vs cpu: loss rel {loss_err:.2e} "
            f"(tol {loss_tol:g}), correct {float(m_card['correct']):g} vs {float(m_cpu['correct']):g}, "
            f"{norms_card.numel()} grad norms max rel {float(rel.max()):.2e} at entry "
            f"{int(rel.argmax())}, median {float(rel.median()):.2e} (tol {grad_tol:g}); after "
            f"Adam {params}: {'ok' if ok else 'FAIL'}")
        sync_twin(card, cpu, optimizers[card], optimizers[cpu])
    if not agree:
        raise AssertionError(f"{label}: the card's train steps disagree with the CPU's")


def against_cpu(config, smi, steps=2, batch=8, tag="types"):
    """The model of ``config`` (random weights from seed 0) on the card
    against its twin on the CPU's plain path, from the same parameters and
    batches: the logits of one batch, then ``steps`` train steps at batch 8
    (`compare_steps`, each from the same state).  Asserts the route and its
    calls: a fused stack calls B1 once a forward and B2 once a step, in
    whichever variant, a per-layer stack neither.  Returns the card's model
    and the launches (B1, B2) of the run."""
    card = build_single_block_resnet(config, generator=torch.Generator().manual_seed(0), device="cuda")
    # The route a train step takes, from the shapes alone.
    route = sbr.identity_route(config, torch.zeros(batch, 32, 32, config.filters_per_block[0]),
                               sbr._dense_blocks(card.params()["stages"][0]["blocks"], config))
    cpu = build_single_block_resnet(config, params=card.params(), device="cpu")
    rng = np.random.default_rng(1)
    images, _ = image_batch(rng, batch)
    reset_counts()
    with torch.no_grad():
        got = card(images.cuda(), return_logits=True).cpu()
        want = cpu(images, return_logits=True)
    err, ok = max_violation(got, want, FP32_TOL)
    log(f"[{tag}] {describe(config)}: route {route}; logits at batch {batch} max|card-cpu| "
        f"{err:.3e} (max|cpu| {float(want.abs().max()):.3e}), tol rtol=atol={FP32_TOL:g}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{describe(config)}: the card's logits disagree with the CPU's")
    compare_steps(tag, describe(config), card, cpu, steps, batch)
    calls, launches, routes = card_calls(), launch_counts(), dict(sbr.route_counts)
    want_calls = (1 + steps, steps) if route == "fused" else (0, 0)
    ok = (calls == want_calls
          and routes == {"fused": 0, "per_layer": 0, route: 2 * (1 + steps)})  # card and CPU twin
    log(f"[{tag}] {describe(config)}: a forward and {steps} steps called B1 {calls[0]} and B2 "
        f"{calls[1]} times (want {want_calls}; {launches} launches), routes {routes} ({smi}): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{describe(config)}: calls {calls}, routes {routes}")
    return card, launches


def replayed_steps_ms(model, steps=TIMED_STEPS, batch=HARNESS_BATCH, size=32, classes=10):
    """Milliseconds a train step of ``model`` takes as replays of one
    captured step at ``batch`` (host clock around ``steps`` replays that end
    in a synchronize; the capture before it)."""
    multi = make_multi_step(model, make_adam(model.parameters()))
    images, labels = [t.cuda() for t in image_batch(np.random.default_rng(3), batch, size, classes)]

    def run(n):
        metrics, _ = multi(images.expand(n, *images.shape), labels.expand(n, *labels.shape), [LR] * n)
        return metrics

    run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = run(steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    if not torch.isfinite(metrics["loss"]).all():
        raise AssertionError("replayed steps gave a non-finite loss")
    return ms


@contextlib.contextmanager
def fused_stacks_on(route):
    """Within it, every stack the model would fuse takes ``route`` instead
    ("fused" or "per_layer"; `models.single_block_resnet.identity_route`
    patched), to time the two routes of one stack."""
    identity_route = sbr.identity_route
    sbr.identity_route = lambda *args: (route if identity_route(*args) == "fused"
                                        else identity_route(*args))
    try:
        yield
    finally:
        sbr.identity_route = identity_route


def wide_counts():
    """The wide B1's and B2's calls since the last `reset_counts`."""
    return STACKS.calls("B1", "wide"), STACKS.calls("B2", "wide")


def phase_wide(smi, batch=8):
    """Euler 3x3 stacks at 64 layers within the JAX kernel gate's reach that
    the band kernels decline, on the wide variants, each against the CPU
    (`against_cpu`: logits, 2 train steps at batch 8 from the same state,
    launches and routes):

    - antisymmetric with ``use_pallas`` (as ``train --use-pallas
      --num-filters 64`` builds it), 64 and 128 filters: B1 and B2 both
      wide at 128, the band B1 and the wide B2 at 64;
    - regular 64 filters, the band B1 and the wide B2;
    - regular 72 filters: a forward, on the wide B1.

    Returns the launches (band B1, band B2, wide B1, wide B2) of the
    phase."""
    total = [0, 0, 0, 0]
    for kernel_type, filters, pallas in (("antisymmetric", 64, True),
                                         ("antisymmetric", 128, True), ("regular", 64, False)):
        config = dataclasses.replace(model_config(kernel_type, filters), use_pallas=pallas)
        reset_counts()
        card, launches = against_cpu(config, smi, tag="wide")
        wide = wide_counts()
        want = (1 + 2 if fi.kernel_variant((batch, 32, 32, filters)) == "wide" else 0, 2)
        ok = wide == want
        log(f"[wide] {describe(config)}{' use_pallas' if pallas else ''}: wide-variant calls "
            f"B1 {wide[0]} B2 {wide[1]} (want {want}) of B1/B2 launches {launches}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{describe(config)}: wide calls {wide}")
        total = [a + b for a, b in zip(total, variant_launches())]
        del card
    config = model_config("regular", 72)
    card = build_single_block_resnet(config, generator=torch.Generator().manual_seed(0), device="cuda")
    cpu = build_single_block_resnet(config, params=card.params(), device="cpu")
    images, _ = image_batch(np.random.default_rng(7), batch)
    reset_counts()
    with torch.no_grad():
        got = card(images.cuda(), return_logits=True).cpu()
        want = cpu(images, return_logits=True)
    err, ok = max_violation(got, want, FP32_TOL)
    calls, wide = card_calls(), wide_counts()
    ok = ok and calls == wide == (1, 0)
    log(f"[wide] {describe(config)}: forward on the wide B1, logits at batch {batch} "
        f"max|card-cpu| {err:.3e} (max|cpu| {float(want.abs().max()):.3e}, tol rtol=atol="
        f"{FP32_TOL:g}), B1/B2 calls {calls}, wide {wide}, launches {launch_counts()} ({smi}): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{describe(config)}: logits err {err}, calls {calls}")
    total = [a + b for a, b in zip(total, variant_launches())]
    return tuple(total)


def log_kernels_per_call(label, run, calls=2):
    """torch.profiler over ``calls`` synchronized calls of ``run`` (after one
    unprofiled call), logged: the device operations a call launches in all,
    and each one's launches and device ms a call (the wide B2's recompute,
    dK pass and state-cotangent conv apart).  Returns {name: (launches a
    call, ms a call)}."""
    run()
    torch.cuda.synchronize()
    by_name = {}
    for avg in profile_window(run, calls, label)[4]:
        n, ms = by_name.get(avg.key, (0.0, 0.0))
        by_name[avg.key] = (n + avg.count / calls, ms + device_us(avg) / calls / 1e3)
    total = sum(n for n, _ in by_name.values())
    log(f"[profile] {label}: {total:g} device operations a call, "
        f"{sum(ms for _, ms in by_name.values()):.4f} ms of device time a call (torch.profiler)")
    for key, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        log(f"[profile]   {n:6g} a call, {ms:9.4f} ms a call ({ms / max(n, 1) * 1e3:8.2f} us a "
            f"launch): {key[:100]}")
    return by_name


def phase_time_wide(smi, step_widths=(64, 96, 112, 128)):
    """The wide variants timed at batch 32, 64 layers, beside their bounds
    and their plain versions: B1 and B2 at 32x32x64 (B1's band variant
    too: it takes that width), 32x32x128 and 64x64x128 (fewer calls: a
    call there is tens to hundreds of ms); then the train step of the
    regular 64L x C models at batch 32, C in ``step_widths``, on both
    routes (`fused_stacks_on`) in turns (fused, per layer, per layer,
    fused), replayed.  Each
    wide call is also profiled: the device operations it launches and their
    device time (`log_kernels_per_call`).  Returns the wide B1 and B2
    timings at 32x32x128 (the `kernels` line's)."""
    out = {}
    for hh, c, runs in ((32, 64, 10), (32, 128, 5), (64, 128, 2)):
        x, kernels, biases, g = make_case(32, hh, hh, c, 64, 10 + c, unstructured=True)
        variants = [("fused_euler_fwd_wide", False,
                     lambda: fi._launch_wide(x, kernels, biases, 0.125, torch.float32),
                     lambda: fi.reference_euler_dense(x, kernels, biases, 0.125)),
                    ("fused_euler_bwd_wide", True,
                     lambda: fi._launch_bwd_wide(x, kernels, biases, g, 0.125, torch.float32),
                     lambda: fi.reference_euler_dense_bwd(x, kernels, biases, g, 0.125))]
        if fi.kernel_variant(x.shape) == "band":
            variants.append(("fused_euler_fwd (band)", False,
                             lambda: fi._launch(x, kernels, biases, 0.125, torch.float32), None))
        for name, backward, run, plain in variants:
            ms = cuda_time_ms(run, runs=runs, repeats=3, warmup=1)
            plain_ms = cuda_time_ms(plain, runs=max(1, runs // 2), repeats=3, warmup=1) if plain else None
            bound = kernel_bounds(32, hh, hh, c, 64, backward)
            log(f"[time] {name} B=32 {hh}x{hh}x{c} L=64: kernel {ms:.4f} ms"
                + (f", plain {plain_ms:.4f} ms" if plain else "")
                + f"; bound {bound['flops'] / 1e9:.3f} GFLOP / 67 TFLOP/s = {bound['bound_ms']:.4f} "
                f"ms by {bound['bound_by']}; kernel at {bound['bound_ms'] / ms:.1%} of it ({smi})")
            if plain:
                log_kernels_per_call(f"{name} B=32 {hh}x{hh}x{c} L=64", run,
                                     calls=2 if hh == 32 else 1)
            if hh == 32 and c == 128 and plain:
                out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
                             "bound_by": bound["bound_by"]}
        del x, kernels, biases, g
        torch.cuda.empty_cache()
    for filters in step_widths:
        config = model_config("regular", filters)
        card = build_single_block_resnet(config, generator=torch.Generator().manual_seed(0),
                                         device="cuda")
        flops_step = single_block_train_flops(config, HARNESS_BATCH)
        turns = {"fused": [], "per_layer": []}
        for route in ("fused", "per_layer", "per_layer", "fused"):
            with fused_stacks_on(route):
                reset_counts()
                ms = replayed_steps_ms(card, steps=20)
                launches = launch_counts()
            turns[route].append(ms)
            rate = 1e3 / ms
            log(f"[time] {describe(config)} train step on the {route} route, 20 replayed steps at "
                f"batch {HARNESS_BATCH}: {ms:.4f} ms a step, {flops_step * rate / 1e12:.4f} model "
                f"TFLOP/s ({flops_step / 1e9:.3f} GFLOP a step), MFU {mfu(flops_step, rate):.2%} of "
                f"the fp32 peak; B1/B2 launches {launches}, wide calls {wide_counts()} ({smi})")
        wins = sum(f < p for f in turns["fused"] for p in turns["per_layer"])
        log(f"[time] {describe(config)}: the fused route faster in {wins} of 4 pairings of turns "
            f"(fused {' / '.join(f'{t:.4f}' for t in turns['fused'])} ms, per layer "
            f"{' / '.join(f'{t:.4f}' for t in turns['per_layer'])} ms)")
        del card
        torch.cuda.empty_cache()
    return out


# The wide B2's distance from float64, norm-relative, that a relu-mask flip
# explains: the wide kernels sum each output over the 9C (tap, input)
# products in one fp32 accumulator, in order (1152 of them at C = 128),
# where cuDNN splits its sums, so their z carries a few times the rounding
# of the plain version's and, at 64 layers, flips a few times as many mask
# elements (each moves one g_z element by h * g).  On an NVIDIA H100 80GB
# HBM3 at 700 W, 32x32x128, B = 4: B2 2.4-3.4e-04 from float64, the plain
# version 1.0-2.0e-04.  A fault in an index or a race is O(1e-2)
# or more, and breaks the bit-identity of two calls.
WIDE_F64_TOL = 1e-3


def phase_kernels_wide():
    """The wide variants against their plain versions at 64 layers, fp32 and
    bf16 operands: B1 to FP32_TOL / BF16_TOL as in phase_kernels; B2 judged
    by a float64 run of its plain version as in phase_kernels_bwd (as close
    to it as the plain version is, 2x + 1e-5, or within WIDE_F64_TOL of it),
    its dK and db bit-identical across two calls.  Returns the max |kernel
    - plain| of each at 32x32x128, fp32."""
    errs = {}
    fwd_cases = [(8, 32, 32, 72), (8, 32, 32, 128), (8, 8, 8, 128), (2, 64, 64, 128)]
    bwd_cases = [(4, 32, 32, 72), (4, 32, 32, 128), (8, 8, 8, 128), (2, 64, 64, 48),
                 (2, 64, 64, 128)]
    for i, (b, hh, ww, c) in enumerate(fwd_cases):
        x, kernels, biases, _ = make_case(b, hh, ww, c, 64, 400 + i, unstructured=True)
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            before = STACKS.calls("B1", "wide")
            got = fi.fused_euler_dense(x, kernels, biases, 0.125, matmul_dtype=dtype)
            want = fi.reference_euler_dense(x, kernels, biases, 0.125, matmul_dtype=dtype)
            torch.cuda.synchronize()
            err, ok = max_violation(got, want, tol)
            ok = ok and STACKS.calls("B1", "wide") == before + 1
            log(f"[kernels] wide B1 B={b} {hh}x{ww}x{c} L=64 {str(dtype).split('.')[-1]}: "
                f"max|kernel-plain| {err:.3e} (max|plain| {float(want.abs().max()):.3e}), tol "
                f"rtol=atol={tol:g}: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the wide B1 disagrees with its plain version at {x.shape}")
            if (hh, c) == (32, 128) and dtype == torch.float32:
                errs["fused_euler_fwd_wide"] = err
    for i, (b, hh, ww, c) in enumerate(bwd_cases):
        x, kernels, biases, g = make_case(b, hh, ww, c, 64, 500 + i, unstructured=True)
        for dtype in (torch.float32, torch.bfloat16):
            before = STACKS.calls("B2", "wide")
            got = fi.fused_euler_dense_bwd(x, kernels, biases, g, 0.125, dtype)
            want = fi.reference_euler_dense_bwd(x, kernels, biases, g, 0.125, dtype)
            judge = fi.reference_euler_dense_bwd(
                *[t.double() for t in (x, kernels, biases, g)], 0.125, dtype)
            again = fi.fused_euler_dense_bwd(x, kernels, biases, g, 0.125, dtype)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
            parts, ok = [], same and STACKS.calls("B2", "wide") == before + 2
            for name, a, w, j in zip(("gx", "gk", "gb"), got, want, judge):
                kernel_err, plain_err = norm_rel(a, j), norm_rel(w, j)
                ok = ok and kernel_err <= max(2 * plain_err + 1e-5, WIDE_F64_TOL)
                parts.append(f"{name} {norm_rel(a, w):.2e} (f64: B2 {kernel_err:.2e}, plain "
                             f"{plain_err:.2e})")
            log(f"[kernels] wide B2 B={b} {hh}x{ww}x{c} L=64 {str(dtype).split('.')[-1]}: norm-rel "
                f"|B2-plain| " + "; ".join(parts) + f"; two calls bit-identical {same}: "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the wide B2 is wrong at {x.shape} ({dtype})")
            if (hh, c) == (32, 128) and dtype == torch.float32:
                errs["fused_euler_bwd_wide"] = max(float((a - w).abs().max())
                                                   for a, w in zip(got, want))
        del x, kernels, biases, g, got, want, judge, again
        torch.cuda.empty_cache()
    return errs


WRN_BATCH = 128
# The fused stacks of the WRN-40-4 cell (perfbench/configs/wrn-40-4-antisym-
# cifar10.json) at its batch: (H, W, C, L) and the variants B1 and B2 take.
WRN_STACKS = (((32, 32, 64, 12), "band", "wide"), ((16, 16, 128, 11), "wide", "wide"))


def sha256(t):
    """The sha256 of a tensor's bytes, on the host."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def wide_instantiation(key):
    """A wide kernel's instantiation from its profiler name, or None:
    ``wide_conv<false, 0, 2, ...>`` without the namespace and arguments."""
    name = key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]
    return name if name.startswith(("wide_conv", "wide_dk")) else None


def phase_kernels_wrn():
    """The hand-kernel calls of the WRN-40-4 cell's train step at its batch
    of 128, fp32, antisymmetric kernels, h = 0.125, against their plain
    versions: the band B1 at 32x32x64 (16 bands an image, in launches of
    the images the card holds at once) and the wide B1 at 16x16x128 to
    FP32_TOL as in phase_kernels; the wide B2 at both shapes judged by a
    float64 run of its plain version as in phase_kernels_wide, two calls
    bit-identical.  Each call's launches in the record: the band B1's
    groups, the wide B1's L, the wide B2's 3L.  Then the sha256 of the wide
    B1's output and of B2's gx, gk and gb at these seeds (a change that
    keeps the kernels' sums keeps them), and each wide kernel
    instantiation's device time a step (one wide B1 call and one B2 call
    of each stack, torch.profiler) against its bound: one pass,
    2*L*B*H*W*9C^2 FLOP over 67 TFLOP/s, for each call that launches it."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    digests, device_ms, bound_ms = [], {}, {}
    for i, ((hh, ww, c, layers), fwd_variant, bwd_variant) in enumerate(WRN_STACKS):
        x, kernels, biases, g = make_case(WRN_BATCH, hh, ww, c, layers, 600 + i)
        assert (fi.kernel_variant(x.shape), fi.kernel_variant(x.shape, True)) == (
            fwd_variant, bwd_variant), f"the planner moved the cell's stack {tuple(x.shape)}"
        want_launches = layers
        if fwd_variant == "band":
            bands = fi.kernel_bands(x.shape, sms=sms)
            want_launches = -(-WRN_BATCH // fi.resident_images(hh, ww, c, bands))
        before = STACKS.launches("B1", fwd_variant)
        got = fi.fused_euler_dense(x, kernels, biases, 0.125)
        want = fi.reference_euler_dense(x, kernels, biases, 0.125)
        torch.cuda.synchronize()
        launches = STACKS.launches("B1", fwd_variant) - before
        err, ok = max_violation(got, want, FP32_TOL)
        ok = ok and launches == want_launches
        plan = describe_bands(x.shape)[1] if fwd_variant == "band" else "wide"
        log(f"[kernels] WRN B1 B={WRN_BATCH} {hh}x{ww}x{c} L={layers} {plan}: max|kernel-plain| "
            f"{err:.3e} (max|plain| {float(want.abs().max()):.3e}), tol rtol=atol={FP32_TOL:g}; "
            f"{launches} launches (want {want_launches}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the WRN cell's B1 is wrong at {tuple(x.shape)}")
        before = STACKS.launches("B2", bwd_variant)
        got = fi.fused_euler_dense_bwd(x, kernels, biases, g, 0.125, torch.float32)
        want = fi.reference_euler_dense_bwd(x, kernels, biases, g, 0.125, torch.float32)
        judge = fi.reference_euler_dense_bwd(
            *[t.double() for t in (x, kernels, biases, g)], 0.125, torch.float32)
        again = fi.fused_euler_dense_bwd(x, kernels, biases, g, 0.125, torch.float32)
        torch.cuda.synchronize()
        launches = STACKS.launches("B2", bwd_variant) - before
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        parts, ok = [], same and launches == 2 * 3 * layers
        for name, a, w, j in zip(("gx", "gk", "gb"), got, want, judge):
            kernel_err, plain_err = norm_rel(a, j), norm_rel(w, j)
            ok = ok and kernel_err <= max(2 * plain_err + 1e-5, WIDE_F64_TOL)
            parts.append(f"{name} {norm_rel(a, w):.2e} (f64: B2 {kernel_err:.2e}, plain "
                         f"{plain_err:.2e})")
        log(f"[kernels] WRN B2 B={WRN_BATCH} {hh}x{ww}x{c} L={layers} {bwd_variant}: norm-rel "
            f"|B2-plain| " + "; ".join(parts) + f"; two calls bit-identical {same}; "
            f"{launches} launches (want 2 x {3 * layers}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the WRN cell's B2 is wrong at {tuple(x.shape)}")
        shape = f"{hh}x{ww}x{c} L={layers}"
        pass_ms = kernel_bounds(WRN_BATCH, hh, ww, c, layers)["flop_ms"]
        runs = [("B2", lambda: fi.fused_euler_dense_bwd(x, kernels, biases, g, 0.125,
                                                        torch.float32))]
        if fwd_variant == "wide":
            digests.append((f"B1 {shape}", sha256(fi.fused_euler_dense(x, kernels, biases, 0.125))))
            runs.insert(0, ("B1", lambda: fi.fused_euler_dense(x, kernels, biases, 0.125)))
        digests += [(f"B2 {name} {shape}", sha256(t)) for name, t in zip(("gx", "gk", "gb"), got)]
        for label, run in runs:
            for key, (_, ms) in log_kernels_per_call(f"WRN {label} {shape}", run).items():
                name = wide_instantiation(key)
                if name:
                    device_ms[name] = device_ms.get(name, 0.0) + ms
                    bound_ms[name] = bound_ms.get(name, 0.0) + pass_ms
        del x, kernels, biases, g, got, want, judge, again
        torch.cuda.empty_cache()
    for what, digest in digests:
        log(f"[kernels] WRN sha256 {what}: {digest}")
    for name, ms in sorted(device_ms.items()):
        log(f"[kernels] WRN {name}: {ms:.4f} ms a step against {bound_ms[name]:.4f} ms of bound "
            f"({bound_ms[name] / ms:.1%})")


def phase_kernel_types(smi):
    """Regular and centrosymmetric 3x3 stacks through B1/B2 at 64 layers
    (16 and 8 filters), and the stacks on the per-layer route
    (centrosymmetric k = 5, midpoint, RK4), each against the CPU; widths the
    kernels' band variants decline (`phase_wide`); the per-layer stacks' replayed
    steps at batch 32 timed; a captured remat midpoint step against an
    eager one.  Returns the B1 and B2 launches of the fused configurations'
    runs."""
    total = [0, 0]
    for kernel_type, filters, k in FUSED_CONFIGS:
        _, launches = against_cpu(model_config(kernel_type, filters, k), smi)
        total = [a + b for a, b in zip(total, launches)]
    for kernel_type, filters, k, integrator in PER_LAYER_CONFIGS:
        config = model_config(kernel_type, filters, k, integrator)
        card, _ = against_cpu(config, smi)
        reset_counts()
        ms = replayed_steps_ms(card)
        flops_step = single_block_train_flops(config, HARNESS_BATCH)
        rate = 1e3 / ms
        launches = launch_counts()
        log(f"[types] {describe(config)}: {TIMED_STEPS} replayed steps at batch {HARNESS_BATCH}: "
            f"{ms:.4f} ms a step, {rate:.2f} steps/s, {flops_step * rate / 1e12:.4f} model TFLOP/s "
            f"({flops_step / 1e9:.3f} GFLOP a step), MFU {mfu(flops_step, rate):.2%} of the fp32 peak; "
            f"B1/B2 launches {launches} ({smi})")
        if launches != (0, 0):
            raise AssertionError(f"{describe(config)}: the per-layer route launched {launches}")

    # A captured midpoint step with remat (checkpointed layers recomputed in
    # the backward, inside the graph) against the eager step on a twin.
    config = model_config("antisymmetric", 16, 3, "midpoint", remat=True)
    models = [build_single_block_resnet(config, generator=torch.Generator().manual_seed(0),
                                        device="cuda") for _ in range(2)]
    optimizers = [make_adam(m.parameters()) for m in models]
    images, labels = zip(*[image_batch(np.random.default_rng(4 + i), 8) for i in range(3)])
    images, labels = torch.stack(images).cuda(), torch.stack(labels).cuda()
    metrics, norms = make_multi_step(models[0], optimizers[0])(images, labels, [LR] * 3)
    eager = make_train_step(models[1], optimizers[1])
    want = [eager(images[i], labels[i], LR) for i in range(3)]
    loss_err = max(abs(float(metrics["loss"][i]) - float(m["loss"])) / abs(float(m["loss"]))
                   for i, (m, _) in enumerate(want))
    norm_err = max(norm_rel(norms[i], n) for i, (_, n) in enumerate(want))
    param_err = max(norm_rel(p.detach(), q.detach()) for p, q in zip(*[m.parameters() for m in models]))
    ok = max(loss_err, norm_err, param_err) <= TRAIN_GRAD_TOL
    log(f"[types] {describe(config)}: 3 captured and replayed steps against 3 eager steps: loss max "
        f"rel {loss_err:.2e}, grad-norm rows max norm-rel {norm_err:.2e}, parameters max norm-rel "
        f"{param_err:.2e} (tol {TRAIN_GRAD_TOL:g}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the captured remat midpoint step disagrees with the eager step")
    return tuple(total)


def phase_epochs(smi, arrays):
    """A device-resident epoch of 1562 replayed steps with augmentation for
    the regular 64L x 16F and 64L x 8F models (the reference's other two
    published runs), beside the antisymmetric one of phase_harness:
    seconds, steps/s, MFU, the idle share of two profiled epochs of 60
    steps, and one B1 and one B2 launch a replayed step.  Returns the
    launches."""
    train_x, train_y, val_x, val_y = arrays
    steps = len(train_x) // HARNESS_BATCH
    total = [0, 0]
    for kernel_type, filters in (("regular", 16), ("regular", 8)):
        config = model_config(kernel_type, filters)
        trainer = Training(
            build_single_block_resnet(config, generator=torch.Generator().manual_seed(0), device="cuda"),
            train_features=train_x, train_labels=train_y, val_features=val_x, val_labels=val_y,
            batch_size=HARNESS_BATCH, jit_augment=standard_cifar_augment(), record_summaries=False)

        def epoch(n):
            return trainer.train(epochs=1, steps_per_epoch=n, learning_rate_schedule=lambda s: LR,
                                 device_data=True, eval_frequency=None, verbose=False)

        reset_counts()
        epoch(WINDOW_STEPS)  # the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = epoch(steps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rate_figures(f"{describe(config)}, device-resident epoch, CUDA-graph replays",
                     seconds, steps, smi, config)
        idle = epoch_window(f"{describe(config)} device-resident epochs", epoch, WINDOW_STEPS)
        launches = launch_counts()
        want = (WARMUP_CALLS + WINDOW_STEPS + steps + 2 * WINDOW_STEPS,) * 2
        loss = history["train"][-1]["mean_loss"]
        ok = launches == want and np.isfinite(loss)
        log(f"[epochs] {describe(config)}: launches B1 {launches[0]} B2 {launches[1]} (want {want}: "
            f"{WARMUP_CALLS} warm-up calls + one replay a step), epoch loss {loss:.4f}, idle "
            f"{idle:.1%}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{describe(config)}: the device-resident epoch is wrong")
        total = [a + b for a, b in zip(total, launches)]
        trainer.close()
    return tuple(total)


def phase_subcommands(tmp, smi):
    """The research subcommands as a user runs them, in subprocesses on the
    card: reproduce --synthetic (the three published runs, each with its
    measured gradient-flow diagnostics), deep-stability at its defaults,
    train then export --checkpoint of a regular model (load_exported must
    predict what the checkpoint's model predicts), then, one at a time so
    that their timings do not share the card, benchmark (antisymmetric,
    regular and RK4, 64L x 16F) and sweep on a 2 x 2 grid."""
    save_dir, csv_dir = os.path.join(tmp, "sub_ckpt"), os.path.join(tmp, "sub_csv")
    model = ["--num-layers", "64", "--num-filters", "16"]
    t0 = time.perf_counter()
    procs = {
        "reproduce": run_cli("reproduce", "--synthetic", "--device-data", "--epochs", "1",
                             "--steps-per-epoch", "200", "--csv-dir", os.path.join(tmp, "repro_csv")),
        "deep-stability": run_cli("deep-stability"),
        "train": run_cli("train", *model, "--kernel-type", "regular", "--epochs", "1",
                         "--steps-per-epoch", "100", "--synthetic-train-size", "5000",
                         "--synthetic-val-size", "1000", "--device-data", "--save-dir", save_dir,
                         "--csv-dir", csv_dir),
    }
    out = {name: finish(proc, name, timeout=600) for name, proc in procs.items()}
    together_s = time.perf_counter() - t0
    runs = out["reproduce"]["runs"]
    measured = [r["gradient_flow"]["measured"] for r in runs]
    spectrum = out["deep-stability"]["spectrum"]
    sweep = out["deep-stability"]["gamma_sweep"]
    ok = (len(runs) == 3 and all(m is not None and all(np.isfinite(list(m.values()))) for m in measured)
          and all(np.isfinite(r["best_val_loss"]) for r in runs)
          and len(sweep) == 3 and all(np.isfinite(list(v.values())).all() for v in sweep.values())
          and spectrum["real_part_error"] < 1e-6 and spectrum["antisymmetry_defect"] < 1e-6)
    for r in runs:
        log(f"[cli] reproduce {r['run']}: best val accuracy {r['best_val_accuracy']:.4f} loss "
            f"{r['best_val_loss']:.4f} ({r['data']} data), gradient flow measured "
            f"{json.dumps(r['gradient_flow']['measured'])} (published "
            f"{json.dumps(r['gradient_flow']['baseline'])})")
    log(f"[cli] deep-stability (100L x 8F, gammas 0.0/0.05/0.2, 60 steps each): "
        f"{json.dumps(out['deep-stability'])}")
    log(f"[cli] reproduce, deep-stability and a regular train together {together_s:.1f} s "
        f"({smi}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("reproduce or deep-stability printed a bad result")

    checkpoint = os.path.join(save_dir, Checkpointer(save_dir).latest())
    export_dir = os.path.join(tmp, "sub_export")
    exported = finish(run_cli("export", export_dir, *model, "--kernel-type", "regular",
                              "--checkpoint", checkpoint), "export")
    predict, manifest = load_exported(exported["export_dir"], device="cuda")
    config = model_config("regular", 16)
    trained = build_single_block_resnet(config, generator=torch.Generator().manual_seed(5), device="cuda")
    Checkpointer(save_dir).restore(TrainState(trained, make_adam(trained.parameters())), checkpoint)
    images = np.random.default_rng(6).uniform(0, 255, (16, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want = trained(torch.from_numpy(images).cuda()).cpu()
    err, ok = max_violation(torch.from_numpy(predict(images)), want, FP32_TOL)
    ok = ok and manifest["config"]["kernel_type"] == "regular"
    log(f"[cli] export --checkpoint of the trained regular 64L x 16F model, then load_exported: "
        f"predictions max|export-model| {err:.3e} over 16 images (tol rtol=atol={FP32_TOL:g}): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the exported regular model predicts otherwise than its checkpoint")

    bench_keys = {"train_steps_per_sec", "train_img_per_sec", "inference_latency_batch1_ms",
                  "inference_fps_batch1", "device", "model_flops_per_step", "model_tflops",
                  "mfu_vs_fp32_peak"}
    for flags in (["--kernel-type", "antisymmetric"], ["--kernel-type", "regular"],
                  ["--integrator", "rk4"]):
        t0 = time.perf_counter()
        result = finish(run_cli("benchmark", *model, *flags), "benchmark")
        ok = set(result) == bench_keys and result["train_steps_per_sec"] > 0
        log(f"[cli] benchmark {' '.join(flags)} 64L x 16F batch 32 ({time.perf_counter() - t0:.1f} s): "
            f"{json.dumps(result)} ({smi}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("benchmark printed a bad result")
    t0 = time.perf_counter()
    result = finish(run_cli("sweep", "--widths", "16,32", "--depths", "16,32"), "sweep")
    ok = set(result) == {"16x16", "16x32", "32x16", "32x32"} and all(
        np.isfinite(v["steps_per_sec"]) and set(v) == {
            "steps_per_sec", "images_per_sec", "step_ms", "model_tflops", "mfu_vs_fp32_peak"}
        for v in result.values())
    log(f"[cli] sweep widths 16,32 x depths 16,32, batch 128, 30 steps "
        f"({time.perf_counter() - t0:.1f} s): {json.dumps(result)} ({smi}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("sweep printed a bad result")



RESNET_LOGITS_TOL = 1e-4  # eval-mode logits card against CPU, norm-relative
PREDICT_TOL = 1e-5        # a served export against the model it came from, norm-relative
RESNET_PRESETS = {(3, 4, 6, 3): "ResNet-50", (3, 4, 23, 3): "ResNet-101", (3, 8, 36, 3): "ResNet-152"}


def describe_resnet(config):
    size = config.image_shape[0]
    return (f"{RESNET_PRESETS[config.blocks_per_stage]} v{config.version:g} {config.kernel_type} "
            f"mid {size}x{size} {config.num_classes} classes")


def resnet_pair(preset, size, classes, antisymmetric_mid=True, version=1, seed=0):
    """A bottleneck preset (random weights from ``seed``) on the card and
    its twin on the CPU, with the same parameters and running statistics."""
    config = resnet_preset(preset, classes, antisymmetric_mid=antisymmetric_mid,
                           image_shape=(size, size, 3), version=version)
    card = build_resnet(config, generator=torch.Generator().manual_seed(seed), device="cuda")
    cpu = build_resnet(config, params=card.params(), state=card.state(), device="cpu")
    return card, cpu


def resnet_eval_against_cpu(card, cpu, batch, smi, seed=11):
    """Eval-mode logits of ``batch`` images, card against CPU."""
    config = card.config
    images, _ = image_batch(np.random.default_rng(seed), batch, config.image_shape[0],
                            config.num_classes)
    with torch.no_grad():
        got = card(images.cuda(), return_logits=True).cpu()
        want = cpu(images, return_logits=True)
    err = norm_rel(got, want)
    ok = err <= RESNET_LOGITS_TOL and tuple(got.shape) == (batch, config.num_classes)
    log(f"[resnet] {describe_resnet(config)}: eval-mode logits at batch {batch}, card vs cpu "
        f"norm-rel {err:.2e} (tol {RESNET_LOGITS_TOL:g}) ({smi}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{describe_resnet(config)}: the card's logits disagree with the CPU's")


def calm_head(card, cpu, images, spread=20.0):
    """Scale the head kernel of both twins so that the CPU's logits of
    ``images`` span about ``spread`` a row, and return those logits.  A
    random-init ResNet-50's logits span thousands, so its softmax is 0 in
    all classes but one and its probabilities would hide its logits
    (`logit_gaps`); the scaled head leaves every class visible."""
    x = torch.from_numpy(images)
    with torch.inference_mode():
        logits = cpu(x, return_logits=True)
    scale = spread / float((logits.max(-1).values - logits.min(-1).values).max())
    with torch.no_grad():
        for model in (card, cpu):
            model.params()["head"].kernel.mul_(scale)
    with torch.inference_mode():
        return cpu(x, return_logits=True)


def resnet_replayed(card, steps, smi, batch=HARNESS_BATCH):
    """``steps`` replayed train steps at ``batch`` on synthetic images of
    the model's shape: ms a step, images/s, model TFLOP/s and MFU."""
    config = card.config
    ms = replayed_steps_ms(card, steps, batch, config.image_shape[0], config.num_classes)
    flops_step = train_flops(config, batch)
    rate = 1e3 / ms
    log(f"[resnet] {describe_resnet(config)}: {steps} replayed train steps at batch {batch}: "
        f"{ms:.4f} ms a step, {batch * rate:.1f} images/s, {flops_step * rate / 1e12:.4f} model "
        f"TFLOP/s ({flops_step / 1e9:.3f} GFLOP a step), MFU {mfu(flops_step, rate):.2%} of the "
        f"fp32 peak ({smi})")
    return ms


def captured_against_eager(preset, size, classes, smi, steps=3, batch=8):
    """A bottleneck train step captured after its warm-up calls and
    replayed ``steps`` times against ``steps`` eager steps on a twin drawn
    from the same seed, at learning rate 0: the parameters stay put, so the
    running statistics after each step depend on the batches alone, and a
    warm-up that did not give the batch-norm buffers back as it found them
    shows as 3 momentum updates too many (~2% of the statistics' change).
    (At a learning rate of 1e-3 the random-init ResNet is chaotic: Adam
    steps each element by about lr * sign(g), and an element whose gradient
    is fp32 roundoff steps either way, so two runs part after 2 steps.)"""
    config = resnet_preset(preset, classes, antisymmetric_mid=True, image_shape=(size, size, 3))
    models = [build_resnet(config, generator=torch.Generator().manual_seed(0), device="cuda")
              for _ in range(2)]
    rng = np.random.default_rng(12)
    images, labels = zip(*[image_batch(rng, batch, size, classes) for _ in range(steps)])
    images, labels = torch.stack(images).cuda(), torch.stack(labels).cuda()
    metrics, _ = make_multi_step(models[0], make_adam(models[0].parameters()))(
        images, labels, [0.0] * steps)
    eager = make_train_step(models[1], make_adam(models[1].parameters()))
    want = [eager(images[i], labels[i], 0.0)[0] for i in range(steps)]
    loss_err = max(abs(float(metrics["loss"][i]) - float(m["loss"])) / abs(float(m["loss"]))
                   for i, m in enumerate(want))
    state_err = max(norm_rel(a, b) for a, b in zip(models[0].buffers(), models[1].buffers()))
    moved = all(torch.equal(p, q) for p, q in zip(models[0].parameters(), models[1].parameters()))
    ok = loss_err <= 1e-5 and state_err <= 1e-5 and moved
    log(f"[resnet] {describe_resnet(config)}: {steps} captured and replayed steps at batch {batch} "
        f"and lr 0 against {steps} eager steps: loss max rel {loss_err:.2e} (tol 1e-5), "
        f"{len(list(models[0].buffers()))} running statistics max norm-rel {state_err:.2e} (tol "
        f"1e-5), parameters equal: {moved} ({smi}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the captured bottleneck step leaves other running statistics")


def time_served(predict, batch, size, runs, smi):
    """Request latency of a served model on the host clock (host to device,
    forward, device to host), median of ``runs``; returns (ms, images/s)."""
    images = np.random.default_rng(13).uniform(0, 255, (batch, size, size, 3)).astype(np.float32)
    for _ in range(3):
        predict(images)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        predict(images)
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    log(f"[resnet] served request at batch {batch}, {size}x{size}: {ms:.4f} ms median of {runs}, "
        f"{batch / ms * 1e3:.1f} images/s ({smi})")
    return ms


def phase_bottleneck(tmp, smi):
    """The bottleneck family and batch norm on the card, none of which runs
    B1 or B2 (the JAX package runs them on XLA's convolutions); train-mode
    batch norm runs its own kernels (`phase_batch_norm`):

    1. ResNet-50, antisymmetric mid-convs, 32x32, 10 classes (the JAX
       bench's CIFAR-scale row, full widths): eval-mode logits at batch 8
       and 2 train steps at batch 16 against the CPU (`compare_steps`: loss,
       correct, the 17 grad norms, parameters and running statistics after
       Adam), 3 captured steps against 3 eager ones at learning rate 0 (the
       warm-up leaves the running statistics alone), then 50 replayed steps
       at batch 32 timed;
    2. the same at 224x224 and 257 classes (the v6 notebook's Caltech-256
       shape, on seeded images): eval-mode logits at batch 2 against the
       CPU, then its head scaled so that no probability underflows
       (`calm_head`), `export_model` -> `load_exported` -> predict at
       batch 1 and 32 (latency, images/s), the three serving paths at
       batch 1 against the CPU's logits (`served_paths`), 20 replayed
       train steps at batch 32 timed;
    3. ResNet-50 v1.5 with regular mid-convs, ResNet-101 and ResNet-152:
       eval-mode logits at 32x32, batch 4, against the CPU;
    4. the single-block model with batch norm, 64L x 16F: 2 train steps at
       batch 8 against the CPU on the per-layer route, no launch;
    5. ``cli train --model resnet50`` for 20 device-resident steps, then
       ``export --checkpoint`` and `load_exported`, in subprocesses.

    B1's and B2's launch counts must stay 0 throughout."""
    t_phase = time.perf_counter()
    reset_counts()
    card, cpu = resnet_pair("resnet50", 32, 10)
    resnet_eval_against_cpu(card, cpu, 8, smi)
    compare_steps("resnet", describe_resnet(card.config), card, cpu, steps=2, batch=16,
                  seed=14, loss_tol=RESNET_LOSS_TOL, grad_tol=RESNET_GRAD_TOL,
                  leaf_tol=RESNET_LEAF_TOL)
    captured_against_eager("resnet50", 32, 10, smi)
    resnet_replayed(card, TIMED_STEPS, smi)
    del card, cpu

    card, cpu = resnet_pair("resnet50", 224, 257)
    resnet_eval_against_cpu(card, cpu, 2, smi)
    images = np.random.default_rng(15).uniform(0, 255, (4, 224, 224, 3)).astype(np.float32)
    cpu_logits = calm_head(card, cpu, images[:1])
    del cpu
    predict, manifest = load_exported(export_model(card, os.path.join(tmp, "resnet50_224")),
                                      device="cuda")
    with torch.no_grad():
        want = card(torch.from_numpy(images).cuda()).cpu()
    err = norm_rel(torch.from_numpy(predict(images)), want)
    ok = manifest["family"] == "bottleneck" and err <= PREDICT_TOL
    log(f"[resnet] {describe_resnet(card.config)}: export_model -> load_exported -> predict at "
        f"batch 4 against the model, norm-rel {err:.2e} (tol {PREDICT_TOL:g}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the served ResNet-50 predicts otherwise than the model")
    for batch, runs in ((1, 25), (32, 10)):
        time_served(predict, batch, 224, runs, smi)
    del predict
    # The three serving paths at batch 1 (an export at batch 1 is served
    # compiled there): forward.pt2, the rebuilt model, the eager model.
    served_paths("ResNet-50 224x224 x 257 classes", card, os.path.join(tmp, "resnet50_224"), 1,
                 images[:1], cpu_logits, smi, tf32_shows=True)
    resnet_replayed(card, 20, smi)
    del card
    torch.cuda.empty_cache()

    for preset, version, antisymmetric_mid in (("resnet50", 1.5, False), ("resnet101", 1, True),
                                               ("resnet152", 1, True)):
        card, cpu = resnet_pair(preset, 32, 10, antisymmetric_mid, version)
        resnet_eval_against_cpu(card, cpu, 4, smi)
    del card, cpu

    config = dataclasses.replace(model_config("antisymmetric", 16), use_batch_norm=True)
    card = build_single_block_resnet(config, generator=torch.Generator().manual_seed(0), device="cuda")
    cpu = build_single_block_resnet(config, params=card.params(), device="cpu")
    reset_counts()
    compare_steps("bn", describe(config) + " batch norm", card, cpu, steps=2, batch=8,
                  leaf_tol=BN_LEAF_TOL)
    routes = dict(sbr.route_counts)
    ok = launch_counts() == (0, 0) and routes == {"fused": 0, "per_layer": 4}
    log(f"[bn] {describe(config)} batch norm: 2 train steps on card and CPU launched B1/B2 "
        f"{launch_counts()} (want (0, 0)), routes {routes} (want 4 per-layer) ({smi}): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the single-block model with batch norm left the per-layer route")
    del card, cpu

    save_dir, csv_dir = os.path.join(tmp, "resnet_ckpt"), os.path.join(tmp, "resnet_csv")
    model = ["--model", "resnet50"]
    t0 = time.perf_counter()
    trained = finish(run_cli("train", *model, "--epochs", "1", "--steps-per-epoch", "20",
                             "--synthetic-train-size", "1000", "--synthetic-val-size", "200",
                             "--device-data", "--save-dir", save_dir, "--csv-dir", csv_dir), "train")
    train_s = time.perf_counter() - t0
    checkpoint = os.path.join(save_dir, Checkpointer(save_dir).latest())
    # --no-stablehlo: tracing ResNet-50 takes tens of seconds here, and the
    # compiled forward is held in the serving phases.
    exported = finish(run_cli("export", os.path.join(tmp, "resnet_export"), *model,
                              "--checkpoint", checkpoint, "--no-stablehlo"), "export")
    cli_s = time.perf_counter() - t0
    predict, manifest = load_exported(exported["export_dir"], device="cuda")
    restored = build_resnet(resnet_preset("resnet50", 10, antisymmetric_mid=True,
                                          image_shape=(32, 32, 3)),
                            generator=torch.Generator().manual_seed(5), device="cuda")
    Checkpointer(save_dir).restore(TrainState(restored, make_adam(restored.parameters())), checkpoint)
    images = np.random.default_rng(16).uniform(0, 255, (8, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want = restored(torch.from_numpy(images).cuda()).cpu()
    err = norm_rel(torch.from_numpy(predict(images)), want)
    ok = (np.isfinite(trained["best"]["loss"]) and manifest["family"] == "bottleneck"
          and err <= PREDICT_TOL and launch_counts() == (0, 0))
    log(f"[resnet] cli train --model resnet50 (20 device-resident steps at batch 32, then 7 eval "
        f"batches) {train_s:.1f} s: {json.dumps(trained)}; export --checkpoint then load_exported "
        f"{cli_s - train_s:.1f} s: predictions against the checkpoint's model norm-rel {err:.2e} "
        f"(tol {PREDICT_TOL:g}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the CLI's ResNet-50 train, export or load went wrong")
    log(f"[resnet] bottleneck and batch-norm phase {time.perf_counter() - t_phase:.1f} s, "
        f"B1/B2 launches {launch_counts()} ({smi})")


# bf16 on the card against bf16 on the CPU: the two round to bf16 after
# every layer but sum in fp32 in other orders (cuDNN's against oneDNN's), so
# a last-bit difference before a rounding moves a value by one bf16 ulp and
# later layers carry it on; and batch norm in train mode divides by the
# spread of the batch's 16 values at ResNet-50's 1x1 last stage (its fp32
# comparison takes batch 16 too; BF16_BN_TRAIN_TOL).  So each quantity
# (eval logits, loss, grad-norm row) must be within its tolerance of the
# CPU's bf16 (norm-relative) or, failing that, as close to the CPU's fp32
# run of the same parameters as the CPU's bf16 run is (2x its distance +
# BF16_TOL).  Measurements: NVIDIA H100 80GB HBM3 at 700 W.
BF16_TOL = 2e-2
# ResNet-50's train-mode loss and grad-norm row, card bf16 against CPU bf16:
# batch norm over 16 values at the 1x1 stage in bf16 moves them 5-16% from
# fp32 on the card and 1-10% on the CPU (NVIDIA H100 80GB HBM3 at 700 W:
# loss 4.8e-02 and grad norms 6.8e-02 apart; 1.3e-01 and 2.7e-01 at batch
# 4), while its eval logits agree to 6.2e-03.  A fault in a cast or a
# layer's gradient is O(1).
BF16_BN_TRAIN_TOL = 0.15
BF16_PREDICT_TOL = 1e-3  # a served bf16 export against its model on the card, norm-relative


def bf16_against_cpu(label, card, classes, size, smi, batch=8, seed=30, train_tol=BF16_TOL):
    """A bf16 model on the card against its twins on the CPU (bf16, and
    fp32 as the judge), from the same parameters and state: eval logits,
    then one train step (loss, grad-norm row, the parameters after Adam
    within BN_STEP_BOUND lr), the loss and grad-norm row to ``train_tol``.
    No B1/B2 launch and no fused stack.  Then
    `export_model` -> `load_exported` -> predict at batch 32 against the
    model.  Returns the checks' worst norm-relative distance to the CPU's
    bf16."""
    build = build_resnet if hasattr(card.config, "version") else build_single_block_resnet
    cpu = build(card.config, params=card.params(), state=card.state(), device="cpu")
    exact = build(dataclasses.replace(card.config, compute_dtype=torch.float32),
                  params=card.params(), state=card.state(), device="cpu")
    rng = np.random.default_rng(seed)
    images, labels = image_batch(rng, batch, size, classes)
    logits, out = [], []
    reset_counts()
    # The bf16 twins first: the fp32 judge's stack takes the plain B1/B2 path.
    for m, d in ((card, "cuda"), (cpu, "cpu"), (exact, "cpu")):
        if m is exact:
            routes = dict(sbr.route_counts)
        with torch.no_grad():
            logits.append(m(images.to(d), return_logits=True).cpu())
        out.append(make_train_step(m, make_adam(m.parameters()))(images.to(d), labels.to(d), LR))
    results = {"logits": tuple(logits)}
    results["loss"] = tuple(m["loss"].cpu().reshape(1) for m, _ in out)
    results["grad norms"] = tuple(n.cpu() for _, n in out)
    ok, parts, worst = True, [], 0.0
    for name, (a, b, j) in results.items():
        d, d_card, d_cpu = norm_rel(a, b), norm_rel(a, j), norm_rel(b, j)
        this = d <= (BF16_TOL if name == "logits" else train_tol) or d_card <= 2 * d_cpu + BF16_TOL
        ok, worst = ok and this, max(worst, d)
        parts.append(f"{name} {d:.2e} (to fp32: card {d_card:.2e}, cpu {d_cpu:.2e})")
    step_lr = max(float((a.detach().cpu() - b.detach()).abs().max()) / LR
                  for a, b in zip(card.parameters(), cpu.parameters()))
    dtypes = {p.dtype for p in card.parameters()}
    ok = (ok and step_lr <= BN_STEP_BOUND and dtypes == {torch.float32}
          and launch_counts() == (0, 0) and routes["fused"] == 0)
    log(f"[bf16] {label}: card bf16 against CPU bf16, norm-rel " + "; ".join(parts)
        + f" (tol {BF16_TOL:g}, {train_tol:g} for the loss and grad norms, or 2x the CPU's "
        f"distance to fp32 + {BF16_TOL:g}); params after Adam max "
        f"|card-cpu| {step_lr:.3f} lr (tol {BN_STEP_BOUND:g}), parameters {sorted(map(str, dtypes))}; "
        f"B1/B2 launches {launch_counts()}, bf16 routes {routes} ({smi}): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: bf16 on the card disagrees with bf16 on the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        # The rebuilt path (the compiled one is held in the serving phases).
        predict, manifest = load_exported(
            export_model(card, os.path.join(tmp, "bf16"), stablehlo=False), device="cuda")
        images = np.random.default_rng(seed + 1).uniform(0, 255, (32, size, size, 3)).astype(
            np.float32)
        with torch.no_grad():
            want = card(torch.from_numpy(images).cuda()).cpu()
        t0 = time.perf_counter()
        served = predict(images)
        served_ms = (time.perf_counter() - t0) * 1e3
        err = norm_rel(torch.from_numpy(served), want)
    ok = manifest["config"]["compute_dtype"] == "bfloat16" and err <= BF16_PREDICT_TOL
    log(f"[bf16] {label}: export_model -> load_exported -> predict at batch 32 ({served_ms:.1f} "
        f"ms, eager) against the model, norm-rel {err:.2e} (tol {BF16_PREDICT_TOL:g}), manifest "
        f"compute_dtype {manifest['config']['compute_dtype']}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the served bf16 export predicts otherwise than its model")
    return worst


def phase_bf16(smi):
    """bf16 compute on the card, which runs every layer on cuDNN (the JAX
    kernel gate takes fp32 only): the 64L x 16F antisymmetric CIFAR-10
    model, `imagenet32_config()` (28L x 64F, 1000 classes, bf16 by
    default) and ResNet-50 at 32x32, each against the CPU
    (`bf16_against_cpu`: eval logits, a train step, export -> load ->
    predict), then 50 replayed train steps at batch 32 timed, model
    TFLOP/s and MFU against the bf16 peak.  No B1/B2 launch."""
    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    models = (
        ("64L x 16F antisymmetric", cifar10_single_block_config(
            num_layers=64, num_filters=16, compute_dtype=bf16), 10, 8),
        ("imagenet32_config() 28L x 64F", imagenet32_config(), 1000, 8),
        ("ResNet-50 32x32", resnet_preset("resnet50", 10, antisymmetric_mid=True,
                                          image_shape=(32, 32, 3), compute_dtype=bf16), 10, 16),
    )
    peak_name, peak = peak_of(bf16)
    for label, config, classes, batch in models:
        if config.compute_dtype != bf16:
            raise AssertionError(f"{label}: compute dtype {config.compute_dtype}, not bf16")
        build = build_resnet if hasattr(config, "version") else build_single_block_resnet
        card = build(config, generator=torch.Generator().manual_seed(0), device="cuda")
        bf16_against_cpu(label, card, classes, 32, smi, batch=batch,
                         train_tol=BF16_BN_TRAIN_TOL if hasattr(config, "version") else BF16_TOL)
        reset_counts()
        ms = replayed_steps_ms(card, steps=TIMED_STEPS, classes=classes)
        flops_step = train_flops(config, HARNESS_BATCH)
        rate = 1e3 / ms
        log(f"[bf16] {label}: {TIMED_STEPS} replayed train steps at batch {HARNESS_BATCH}: "
            f"{ms:.4f} ms a step, {rate:.2f} steps/s, {flops_step * rate / 1e12:.4f} model TFLOP/s "
            f"({flops_step / 1e9:.3f} GFLOP a step), MFU {mfu(flops_step, rate, peak):.2%} of the "
            f"{peak / 1e12:g} TFLOP/s {peak_name} peak; B1/B2 launches {launch_counts()} ({smi})")
        if launch_counts() != (0, 0):
            raise AssertionError(f"{label}: a bf16 stack launched B1/B2")
        del card
        torch.cuda.empty_cache()
    log(f"[bf16] phase {time.perf_counter() - t_phase:.1f} s ({smi})")


# --- int8 (ROADMAP A13) and space-to-depth (A10) ----------------------------
#
# No hand-written kernel runs here: the JAX package runs int8 and s2d on
# XLA's ops, and the port on torch._int_mm (cuBLASLt's int8 GEMM) and cuDNN.

INT8_OUT_TOL = 1e-6     # a rescaled int8 conv output, card against CPU, norm-relative
# Quantized logits, card against CPU, norm-relative: the fp32 stem (and
# batch norm) differ in the last bit between cuDNN and the CPU, which can
# move an activation across a rounding boundary, one int8 step.
INT8_SERVE_TOL = 1e-2
INT8_LOSS_TOL = 1e-3    # the first int8 train step, card against CPU, relative
INT8_GRAD_TOL = 1e-2    # its grad-norm row, relative
S2D_TOL = 1e-5          # s2d logits against the direct stack's, norm-relative
INT8_BATCH = 256        # the serving batch of the JAX package's int8 measurements
INT8_OP_SHAPES = (  # (label, batch, H, W, C_in, C_out, k, stride)
    ("64L x 128F trunk 3x3", 32, 32, 32, 128, 128, 3, 1),
    ("ResNet-50 stage 3 3x3 stride 2 (v1.5)", 32, 28, 28, 256, 256, 3, 2),
    ("ResNet-50 stage 3 1x1 (identity conv1)", 32, 14, 14, 1024, 256, 1, 1),
    ("ResNet-50 stage 3 1x1 stride 2 (v1 conv1)", 32, 28, 28, 512, 256, 1, 2),
)


def per_layer_counts():
    return dict(sbr.per_layer_counts)


def int8_rate(ops, ms):
    """'x TOPS, y% of the int8 peak' for ``ops`` integer operations in
    ``ms``."""
    peak = PEAK_FLOPS["h100_sxm_int8"]
    return f"{ops / ms / 1e9:.2f} TOPS, {ops / ms * 1e3 / peak:.2%} of the {peak / 1e12:g} TOPS int8 peak"


def card_equals_cpu(pairs):
    """Whether every (card tensor, CPU tensor) pair is equal bit for bit."""
    return all(torch.equal(a.cpu(), b) for a, b in pairs)


def phase_int8_ops(smi):
    """The dynamic-w8a8 conv (`ops.quantize`) at the trunk's 32x32x128
    shape at batch 32 and at ResNet-50 stage 3's strided 3x3 and 1x1 convs
    (224x224 input): the int8 operands (weights per c_out, activations per
    tensor) and the int32 accumulator equal to the CPU's, the rescaled
    output within INT8_OUT_TOL; then the int8 data-gradient conv and the
    weight-gradient correlation at the trunk shape (per-tensor weights), the
    same way.  Each is timed (CUDA events) beside the fp32 (TF32 off) and
    bf16 cuDNN call of the same shape."""
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(40)
    with torch.no_grad():
        for label, b, hh, ww, cin, cout, k, s in INT8_OP_SHAPES:
            strides = (s, s)
            x = torch.randn(b, hh, ww, cin, generator=gen)
            kern = torch.randn(k, k, cin, cout, generator=gen) * (2.0 / (k * k * cin)) ** 0.5
            bias = 0.05 * torch.randn(cout, generator=gen)
            xc, kc, bc = x.cuda(), kern.cuda(), bias.cuda()
            qp, qp_card = q.quantize_kernel_per_cout(kern, bias), q.quantize_kernel_per_cout(kc, bc)
            z, yq, s_y = q._dynamic_int8_conv_parts(x, qp, strides)
            z_card, yq_card, s_card = q._dynamic_int8_conv_parts(xc, qp_card, strides)
            acc_card = q.int8_conv_same(yq_card, qp_card.kernel_q, strides)
            operands = card_equals_cpu(((qp_card.kernel_q, qp.kernel_q), (qp_card.scale, qp.scale),
                                        (yq_card, yq), (s_card, s_y)))
            accumulators = card_equals_cpu(((acc_card, q.int8_conv_same(yq, qp.kernel_q, strides)),))
            err = norm_rel(z_card.cpu(), z)
            ok = operands and accumulators and err <= INT8_OUT_TOL
            rows = acc_card.shape[0] * acc_card.shape[1] * acc_card.shape[2]
            ops = 2 * rows * k * k * cin * cout
            xbf, kbf, bbf = xc.bfloat16(), kc.bfloat16(), bc.bfloat16()
            patches = q._patches(yq_card, k, k, strides)
            b_t = qp_card.kernel_q.reshape(k * k * cin, cout).t().contiguous()
            # The GEMM's least time: each operand read once and the int32
            # result written once over HBM, or its operations at the int8 peak.
            gemm_bound = max((patches.numel() + b_t.numel() + 4 * rows * cout) / HBM_BYTES_PER_S,
                             ops / PEAK_FLOPS["h100_sxm_int8"]) * 1e3
            times = {
                "int8 (quantize, im2col, GEMM, rescale)":
                    cuda_time_ms(lambda: q.dynamic_int8_conv_same(xc, qp_card, strides)),
                "int8 GEMM part (im2col + torch._int_mm)":
                    cuda_time_ms(lambda: q.int8_conv_same(yq_card, qp_card.kernel_q, strides)),
                "torch._int_mm alone": cuda_time_ms(lambda: q.int8_matmul(patches, b_t)),
                "fp32 cuDNN": cuda_time_ms(lambda: conv2d_same(xc, kc, strides, bc)),
                "bf16 cuDNN": cuda_time_ms(lambda: conv2d_same(xbf, kbf, strides, bbf)),
            }
            log(f"[int8_ops] {label}, x {b}x{hh}x{ww}x{cin}, kernel {k}x{k}x{cin}x{cout}, stride "
                f"{s}: card vs cpu int8 operands equal {operands}, int32 accumulators equal "
                f"{accumulators}, output norm-rel {err:.2e} (tol {INT8_OUT_TOL:g}): "
                f"{'ok' if ok else 'FAIL'}; times "
                + ", ".join(f"{name} {ms:.4f} ms" for name, ms in times.items())
                + f"; the whole int8 conv {int8_rate(ops, times[next(iter(times))])} "
                f"({ops / 1e9:.3f} GOP); torch._int_mm alone against its bound "
                f"{gemm_bound:.4f} ms ({smi})")
            if not ok:
                raise AssertionError(f"int8 conv {label}: the card disagrees with the CPU")
        # The backward's int8 convs at the trunk shape, per-tensor weights.
        label, b, hh, ww, cin, cout, k, _ = INT8_OP_SHAPES[0]
        y = torch.randn(b, hh, ww, cin, generator=gen)
        g = torch.randn(b, hh, ww, cout, generator=gen)
        kern = torch.randn(k, k, cin, cout, generator=gen) * (2.0 / (k * k * cin)) ** 0.5
        yc, gc, kc = y.cuda(), g.cuda(), kern.cuda()
        qt, qt_card = q.quantize_kernel_per_tensor(kern), q.quantize_kernel_per_tensor(kc)
        yq, s_y = q.quantize_activations_per_tensor(y)
        yq_card, _ = q.quantize_activations_per_tensor(yc)
        dy, g_q, s_g = q._int8_dgrad(g, qt.kernel_q, qt.scale[..., 0], torch.float32)
        dy_card, g_q_card, s_g_card = q._int8_dgrad(gc, qt_card.kernel_q, qt_card.scale[..., 0],
                                                     torch.float32)
        k_t, k_t_card = q.transpose_int8_kernel(qt.kernel_q), q.transpose_int8_kernel(qt_card.kernel_q)
        dgrad_equal = card_equals_cpu(((g_q_card, g_q), (s_g_card, s_g), (
            q.int8_conv_same(g_q_card, k_t_card), q.int8_conv_same(g_q, k_t))))
        dgrad_err = norm_rel(dy_card.cpu(), dy)
        wgrad_card = q._int8_wgrad(yq_card, g_q_card, (k, k))
        wgrad_equal = card_equals_cpu(((yq_card, yq), (wgrad_card, q._int8_wgrad(yq, g_q, (k, k)))))
        ok = dgrad_equal and wgrad_equal and dgrad_err <= INT8_OUT_TOL
        ops = 2 * b * hh * ww * k * k * cin * cout
        ybf, gbf, kbf = yc.bfloat16(), gc.bfloat16(), kc.bfloat16()
        times = {
            "int8 dgrad": cuda_time_ms(lambda: q._int8_dgrad(gc, qt_card.kernel_q,
                                                             qt_card.scale[..., 0], torch.float32)),
            "fp32 cuDNN dgrad": cuda_time_ms(lambda: conv2d_same_vjp(yc, kc, gc, need=(True, False))),
            "bf16 cuDNN dgrad": cuda_time_ms(lambda: conv2d_same_vjp(ybf, kbf, gbf,
                                                                     need=(True, False))),
            "int8 wgrad (9 tap GEMMs)": cuda_time_ms(lambda: q._int8_wgrad(yq_card, g_q_card, (k, k))),
            "fp32 cuDNN wgrad": cuda_time_ms(lambda: conv2d_same_vjp(yc, kc, gc, need=(False, True))),
            "bf16 cuDNN wgrad": cuda_time_ms(lambda: conv2d_same_vjp(ybf, kbf, gbf,
                                                                     need=(False, True))),
        }
    log(f"[int8_ops] {label} backward: int8 dgrad operands and accumulators equal {dgrad_equal}, "
        f"dy norm-rel {dgrad_err:.2e} (tol {INT8_OUT_TOL:g}), int8 wgrad accumulators equal "
        f"{wgrad_equal}: {'ok' if ok else 'FAIL'}; times "
        + ", ".join(f"{name} {ms:.4f} ms" for name, ms in times.items())
        + f"; int8 dgrad {int8_rate(ops, times['int8 dgrad'])}, int8 wgrad "
        f"{int8_rate(ops, times['int8 wgrad (9 tap GEMMs)'])} ({smi})")
    if not ok:
        raise AssertionError("the int8 backward convs: the card disagrees with the CPU")
    log(f"[int8_ops] phase {time.perf_counter() - t_phase:.1f} s ({smi})")


def counted_int8_ops(fn, x):
    """``fn(x)`` once, and the integer operations (2 M K N a GEMM, before
    padding) of the int8 GEMMs it ran."""
    total, real = [0], q.int8_matmul

    def counting(a, b_t):
        total[0] += 2 * a.shape[0] * a.shape[1] * b_t.shape[0]
        return real(a, b_t)

    q.int8_matmul = counting
    try:
        out = fn(x)
    finally:
        q.int8_matmul = real
    return out, total[0]


def phase_int8_serve(tmp, smi):
    """int8 serving at full width: the 64L x 128F single-block model at
    32x32 and ResNet-50 at 224x224 x 257 classes (stages of mid width >=
    256 quantized), random weights from a seed.  Each is exported with
    ``quantize="int8"``, loaded on the card (`load_exported`) and asked for
    a batch of 256: the served probabilities against the softmax of the
    card's `make_quantized_forward` logits and, for forward.pt2, its logit
    gaps against the rebuilt path's (`logit_gaps`); the card's quantized logits of
    the first few images, a batch of their own (the activation scales span
    the batch), against the CPU's quantized forward of them; the int8
    forward timed at batch 256 beside the fp32 and the bf16 forward
    (CUDA events), with images/s and the int8 trunk's TOPS."""
    t_phase = time.perf_counter()
    cases = (  # (label, config, build, CPU batch, served through forward.pt2)
        ("single-block 64L x 128F 32x32", cifar10_single_block_config(
            num_layers=64, num_filters=128), build_single_block_resnet, 4, True),
        ("ResNet-50 224x224 x 257 classes", resnet_preset(
            "resnet50", 257, antisymmetric_mid=True, image_shape=(224, 224, 3)), build_resnet, 2,
         False),
    )
    for i, (label, config, build, cpu_batch, compiled) in enumerate(cases):
        size, classes = config.image_shape[0], config.num_classes
        card = build(config, generator=torch.Generator().manual_seed(50), device="cuda")
        export_dir = export_model(card, os.path.join(tmp, f"int8_{i}"), batch_size=INT8_BATCH,
                                  stablehlo=compiled, quantize="int8")
        predict, manifest = load_exported(export_dir, device="cuda")
        images = np.random.default_rng(51).uniform(0, 255, (INT8_BATCH, size, size, 3)).astype(
            np.float32)
        x = torch.from_numpy(images).cuda()
        forward = make_quantized_forward(card, return_logits=True)
        logits, trunk_ops = counted_int8_ops(forward, x)
        served = predict(images)
        served_err = norm_rel(torch.from_numpy(served), torch.softmax(logits, -1).cpu())
        # forward.pt2 (the weights quantized at export) against the rebuilt
        # path (quantized at load) at the same batch.
        rebuilt = (load_exported(export_dir, prefer_stablehlo=False, device="cuda")[0](images)
                   if compiled else served)
        pt2_err = norm_rel(torch.from_numpy(served), torch.from_numpy(rebuilt))
        # Its logit gaps too, where forward.pt2 serves (the model's softmax
        # keeps every class).
        gap_err, gap_ok, kept = (gap_violation(served, rebuilt, CARD_PATHS_TOL, ref_probs=True)
                                 if compiled else (0.0, True, "no"))
        path = "compiled" if compiled else "rebuilt"
        # The activation scales are per tensor, over the batch: compare like batches.
        cpu = build(config, params=card.params(), state=card.state(), device="cpu")
        want = make_quantized_forward(cpu, return_logits=True)(torch.from_numpy(images[:cpu_batch]))
        got = forward(x[:cpu_batch]).cpu()
        err = norm_rel(got, want)
        with torch.inference_mode():
            fp32_logits = card(x[:cpu_batch], return_logits=True).cpu()
        ok = (manifest["quantize"] == "int8" and served.shape == (INT8_BATCH, classes)
              and bool(np.isfinite(served).all()) and served_err <= PREDICT_TOL
              and err <= INT8_SERVE_TOL and pt2_err <= INT8_SERVE_TOL and gap_ok
              and predict.routes[path] == 1)
        log(f"[int8_serve] {label}: export -> load_exported -> predict at batch {INT8_BATCH} "
            f"({predict.routes}) against softmax of make_quantized_forward "
            f"norm-rel {served_err:.2e} (tol {PREDICT_TOL:g}), against the rebuilt path norm-rel "
            f"{pt2_err:.2e} (tol {INT8_SERVE_TOL:g}), its logit gaps {gap_err:.2e} over {kept} "
            f"classes (tol rtol=atol={CARD_PATHS_TOL:g}); card int8 logits vs CPU int8 logits on "
            f"{cpu_batch} images norm-rel "
            f"{err:.2e} (tol {INT8_SERVE_TOL:g}); int8 against fp32 logits norm-rel "
            f"{norm_rel(got, fp32_logits):.2e} (quantization error, no "
            f"tolerance) ({smi}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"int8 serving {label}: the card disagrees")
        del cpu
        bf16_card = build(dataclasses.replace(config, compute_dtype=torch.bfloat16),
                          params=card.params(), state=card.state(), device="cuda")
        with torch.inference_mode():
            times = {
                "int8": cuda_time_ms(lambda: forward(x), runs=3, repeats=3, warmup=1),
                "fp32": cuda_time_ms(lambda: card(x), runs=3, repeats=3, warmup=1),
                "bf16": cuda_time_ms(lambda: bf16_card(x), runs=3, repeats=3, warmup=1),
            }
        t0 = time.perf_counter()
        predict(images)
        served_ms = (time.perf_counter() - t0) * 1e3
        log(f"[int8_serve] {label}: forward at batch {INT8_BATCH} "
            + ", ".join(f"{name} {ms:.3f} ms ({INT8_BATCH / ms * 1e3:.1f} images/s)"
                        for name, ms in times.items())
            + f"; int8 over bf16 {times['bf16'] / times['int8']:.3f}x, over fp32 "
            f"{times['fp32'] / times['int8']:.3f}x; int8 GEMMs {trunk_ops / 1e12:.4f} TOP a "
            f"forward, {int8_rate(trunk_ops, times['int8'])} over the whole int8 forward; one "
            f"served request (host to device, forward, device to host) {served_ms:.1f} ms; "
            f"B1/B2 launches {launch_counts()} ({smi})")
        del card, bf16_card, x, logits
        torch.cuda.empty_cache()
    log(f"[int8_serve] phase {time.perf_counter() - t_phase:.1f} s ({smi})")


def int8_bn_step_against_cpu(label, card, batch, size, classes, smi, seed=63):
    """An int8 model with batch norm on the card against its CPU twins from
    the same state: eval-mode logits within INT8_SERVE_TOL, then one train
    step.  A rounding that flips one int8 step (the card's and the CPU's
    fp32 convs differ in the last bit) moves an element by 1/127 of its
    tensor's absmax, and train-mode batch norm over a small batch (1x1
    spatial in ResNet-50's last stage at 32x32) divides that by a spread
    that can be small.  So the step is judged as the bf16 phase judges
    bf16: the loss (INT8_LOSS_TOL), the grad-norm row and the running
    statistics (INT8_GRAD_TOL) as the CPU's int8 step, or no farther from
    the CPU's fp32 step (the exact judge) than twice the CPU's int8 step is
    plus that tolerance; the parameters after Adam within BN_STEP_BOUND
    lr."""
    config = card.config
    cpu = build_resnet(config, params=card.params(), state=card.state(), device="cpu")
    exact = build_resnet(dataclasses.replace(config, int8_forward=False, int8_backward="ste"),
                         params=card.params(), state=card.state(), device="cpu")
    images, labels = image_batch(np.random.default_rng(seed), batch, size, classes)
    with torch.no_grad():
        err = norm_rel(card(images.cuda(), return_logits=True).cpu(),
                       cpu(images, return_logits=True))
    twins = ((card, "cuda"), (cpu, "cpu"), (exact, "cpu"))
    out = [make_train_step(m, make_adam(m.parameters()))(images.to(d), labels.to(d), LR)
           for m, d in twins]
    stats = [torch.cat([b.flatten().cpu() for b in m.buffers()]) for m, _ in twins]
    results = {"loss": ([m["loss"].cpu().reshape(1) for m, _ in out], INT8_LOSS_TOL),
               "grad norms": ([n.cpu() for _, n in out], INT8_GRAD_TOL),
               "running statistics": (stats, INT8_GRAD_TOL)}
    ok, parts = err <= INT8_SERVE_TOL, [f"eval logits {err:.2e} (tol {INT8_SERVE_TOL:g})"]
    for name, ((a, b, j), tol) in results.items():
        d, d_card, d_cpu = norm_rel(a, b), norm_rel(a, j), norm_rel(b, j)
        ok = ok and (d <= tol or d_card <= 2 * d_cpu + tol)
        parts.append(f"{name} {d:.2e} (to fp32: card {d_card:.2e}, cpu {d_cpu:.2e}; tol {tol:g})")
    step_lr = max(float((a.detach().cpu() - b.detach()).abs().max()) / LR
                  for a, b in zip(card.parameters(), cpu.parameters()))
    ok = ok and step_lr <= BN_STEP_BOUND
    log(f"[int8_train] {label} batch {batch}, card int8 against CPU int8, norm-rel "
        + "; ".join(parts) + f"; params after Adam max |card-cpu| {step_lr:.3f} lr (tol "
        f"{BN_STEP_BOUND:g}) ({smi}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the card's int8 step disagrees with the CPU's")


def phase_int8_train(smi, steps=10):
    """int8-forward training on the card: 64L x 128F single-block in 'ste'
    and 'wgrad' and ResNet-50 at 32x32 in 'wgrad' (stages of mid width >=
    256 int8), random weights from a seed.  The first step against the
    CPU's from the same state (`compare_steps`, a small batch: the CPU
    runs the same int8 ops; with batch norm `int8_bn_step_against_cpu`),
    then ``steps`` steps at batch 32 on one batch,
    each a replay of one captured step (CUDA graph), whose loss must fall,
    timed on the host clock."""
    t_phase = time.perf_counter()
    single = dict(num_layers=64, num_filters=128, int8_forward=True)
    cases = (
        ("64L x 128F int8 ste", cifar10_single_block_config(**single, int8_backward="ste"),
         build_single_block_resnet, 4),
        ("64L x 128F int8 wgrad", cifar10_single_block_config(**single, int8_backward="wgrad"),
         build_single_block_resnet, 4),
        ("ResNet-50 32x32 int8 wgrad", resnet_preset(
            "resnet50", 10, antisymmetric_mid=True, image_shape=(32, 32, 3), int8_forward=True,
            int8_backward="wgrad"), build_resnet, 8),
    )
    for label, config, build, cpu_batch in cases:
        card = build(config, generator=torch.Generator().manual_seed(60), device="cuda")
        reset_counts()
        bn = config.use_batch_norm
        if bn:
            int8_bn_step_against_cpu(label, card, cpu_batch, 32, 10, smi)
        else:
            cpu = build(config, params=card.params(), state=card.state(), device="cpu")
            compare_steps("int8_train", label, card, cpu, steps=1, batch=cpu_batch,
                          loss_tol=INT8_LOSS_TOL, grad_tol=INT8_GRAD_TOL)
            del cpu
        with torch.no_grad():
            _, ops = counted_int8_ops(lambda v: card(v, return_logits=True),
                                      image_batch(np.random.default_rng(62), 2)[0].cuda())
        multi = make_multi_step(card, make_adam(card.parameters()))
        images, labels = [t.cuda() for t in image_batch(np.random.default_rng(61), HARNESS_BATCH)]
        stack = lambda n: (images.expand(n, *images.shape), labels.expand(n, *labels.shape))
        multi(*stack(1), [LR])  # the warm-up calls and the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, _ = multi(*stack(steps), [LR] * steps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        losses = metrics["loss"].cpu()
        ok = bool(torch.isfinite(losses).all()) and float(losses[-1]) < float(losses[0])
        log(f"[int8_train] {label}: {steps} replayed steps at batch {HARNESS_BATCH} on one batch, "
            f"loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f} (must fall), {ms:.3f} ms a "
            f"step, {HARNESS_BATCH / ms * 1e3:.1f} images/s; int8 GEMMs of a forward at batch 2 "
            f"{ops / 1e9:.3f} GOP, per-layer stacks by form {per_layer_counts()}, B1/B2 launches "
            f"{launch_counts()} ({smi}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: the replayed int8 steps did not lower the loss")
        if ops == 0 or launch_counts() != (0, 0) or (not bn and per_layer_counts()["int8"] == 0):
            raise AssertionError(f"{label}: the model did not run its int8 convs")
        del card, multi
        torch.cuda.empty_cache()
    log(f"[int8_train] phase {time.perf_counter() - t_phase:.1f} s ({smi})")


def phase_s2d(smi, steps=20):
    """Space-to-depth on the card: the midpoint and RK4 64L x 16F stacks
    with ``s2d_force`` against the same parameters without, logits at
    batch 32 within S2D_TOL, each form asserted; the forward, replayed
    from a captured CUDA graph (`make_predict_step`), timed at batch 8, 32
    and 128 (8192, 32768 and 131072 input rows) and ``steps``
    replayed train steps at batch 32, the two forms in turns (direct,
    s2d, s2d, direct).  The card's own answer to whether an s2d row gate
    should turn on: nothing is packed by default."""
    t_phase = time.perf_counter()
    for integrator in ("midpoint", "rk4"):
        base = cifar10_single_block_config(num_layers=64, num_filters=16, integrator=integrator,
                                           s2d_block=2)
        direct = build_single_block_resnet(base, generator=torch.Generator().manual_seed(70),
                                           device="cuda")
        packed = build_single_block_resnet(dataclasses.replace(base, s2d_force=True),
                                           params=direct.params(), device="cuda")
        images, _ = image_batch(np.random.default_rng(71), 128)
        x = images.cuda()
        reset_counts()
        with torch.inference_mode():
            err = norm_rel(packed(x[:32], return_logits=True), direct(x[:32], return_logits=True))
        forms = per_layer_counts()
        predict = {"direct": make_predict_step(direct), "s2d": make_predict_step(packed)}
        fwd = {(name, n): cuda_time_ms(lambda: predict[name](x[:n]), runs=10, repeats=3)
               for n in (8, 32, 128) for name in ("direct", "s2d")}
        ok = err <= S2D_TOL and forms == {"int8": 0, "s2d": 1, "direct": 1}
        train = {"direct": [], "s2d": []}
        for name, model in (("direct", direct), ("s2d", packed), ("s2d", packed),
                            ("direct", direct)):
            train[name].append(replayed_steps_ms(model, steps=steps))
        log(f"[s2d] {integrator} 64L x 16F: s2d logits vs direct at batch 32 norm-rel {err:.2e} "
            f"(tol {S2D_TOL:g}), per-layer forms {forms}: {'ok' if ok else 'FAIL'}; forward "
            f"(a replayed CUDA graph a batch) "
            + ", ".join(f"batch {n} direct {fwd[('direct', n)]:.3f} ms s2d {fwd[('s2d', n)]:.3f} ms "
                        f"({fwd[('direct', n)] / fwd[('s2d', n)]:.3f}x)" for n in (8, 32, 128))
            + f"; {steps} replayed train steps at batch 32, in turns: direct "
            f"{'/'.join(f'{ms:.3f}' for ms in train['direct'])} ms, s2d "
            f"{'/'.join(f'{ms:.3f}' for ms in train['s2d'])} ms a step; B1/B2 launches "
            f"{launch_counts()} ({smi})")
        if not ok:
            raise AssertionError(f"s2d {integrator}: the packed stack disagrees with the direct one")
        del direct, packed
        torch.cuda.empty_cache()
    log(f"[s2d] phase {time.perf_counter() - t_phase:.1f} s ({smi})")


RECORDS_IMAGES = 1024      # seeded 224x224x3 images written as records (154 MB)
RECORDS_SIZE = 224         # their side, the v6 notebook's
RECORDS_CHAIN_SIZE = 256   # the side of the Python chain's shards, cropped to RECORDS_SIZE
RECORDS_SHARD = 128        # records a shard
RECORDS_CLASSES = 257      # the v6 notebook's Caltech-256 head
RECORDS_STEPS = 20         # timed replayed steps of the records-fed epoch
RECORDS_PROFILED = 8       # steps of its profiled window


def records_signature(images, labels):
    """Sorted (label, crc32 of the image) of a set of records: equal sets of
    records, whatever their order."""
    return sorted(zip(np.asarray(labels).tolist(),
                      (zlib.crc32(np.ascontiguousarray(im).data) for im in images)))


def feed_rate(batches, count):
    """Images a second over the first ``count`` images of ``batches`` (an
    iterator of (images, labels) batches), copies to the card that are still
    in flight included."""
    t0 = time.perf_counter()
    seen = 0
    for images, _ in batches:
        seen += len(images)
        if seen >= count:
            break
    torch.cuda.synchronize()
    return seen / (time.perf_counter() - t0)


def phase_records(tmp, smi):
    """The v6 notebook's records workflow on the card:

    1. both native libraries (the DERT codec and the threaded loader) built
       with g++ from the checkout into build/native/; a failed build fails
       the run, and neither may fall back to Python;
    2. 1024 seeded 224x224x3 uint8 images with 257 labels written as 8
       record shards by `RecordGenerator.write_arrays` (the C++ writer), then
       read back bit for bit through the Python reader, the C++ codec and the
       native loader (in order at one thread; as a set at four);
    3. feed rates in images/s: the native loader alone (into NumPy buffers,
       and into pinned ones), the same with each batch copied to the card,
       and the Python chain alone (`RecordDatasetCreator.create_dataset`
       with `RandomCrop` 256 -> 224 and `RandomFlipLeftRight` over a
       256x256 shard set);
    4. ResNet-50 (antisymmetric mid-convs, 224x224, 257 classes, full
       width, random weights from seed 0) fed by `create_native_dataset`:
       its first train step at batch 32 on a loader batch, card against
       CPU from the same state (loss 1e-5, grad-norm row 5e-3, parameters
       as `compare_steps` holds batch norm), then `Training`'s streaming
       epoch of replayed steps, timed (images/s end to end) and profiled
       (device idle share against the step's own device time), then an
       evaluation over the records and `export_model` -> `load_exported`
       -> predict against the model;
    5. where Pillow imports, ``convert-records`` on a PNG tree and
       ``predict`` on the image directory, card against CPU.

    The bottleneck family launches no hand-written kernel: B1/B2 stay at 0.
    Returns the launches of the main path (4), which must be (0, 0)."""
    from differential_equations_resnet_tpu_torch import cli
    from differential_equations_resnet_tpu_torch.data import (
        NumpyDataset,
        RandomCrop,
        RandomFlipLeftRight,
        RecordDatasetCreator,
        RecordGenerator,
        UnpackImagesLabels,
    )
    from differential_equations_resnet_tpu_torch.data.records import read_record_file
    from differential_equations_resnet_tpu_torch.native import (
        NativeRecordLoader,
        native_codec_available,
        native_loader_available,
        read_raw_shard,
    )

    t_phase = time.perf_counter()
    native = [name for name, source in _build.SOURCES.items() if source.compiler == "g++"]
    seconds = _build.build(native)  # built by phase_build: 0.0 s here
    for name in native:
        log(f"[records] g++ {name}: {_build.library_path(name).relative_to(_build.BUILD_ROOT)} "
            f"({seconds[name]:.1f} s)")
    if not (native_codec_available() and native_loader_available()):
        raise AssertionError("a native record library did not load")

    size = RECORDS_SIZE
    shape = (size, size, 3)
    rng = np.random.default_rng(40)
    images = rng.integers(0, 256, (RECORDS_IMAGES, *shape), dtype=np.uint8)
    labels = rng.integers(0, RECORDS_CLASSES, RECORDS_IMAGES).astype(np.int64)
    root = os.path.join(tmp, "records")
    t0 = time.perf_counter()
    paths = RecordGenerator().write_arrays(images, labels, root,
                                           num_files_per_record=RECORDS_SHARD)
    written = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(p) for p in paths)
    log(f"[records] write_arrays: {RECORDS_IMAGES} images {size}x{size}x3, {len(paths)} shards, "
        f"{nbytes} bytes in {written:.3f} s ({nbytes / written / 1e6:.1f} MB/s)")

    t0 = time.perf_counter()
    python = [r for p in paths for r in read_record_file(p)]
    python_s = time.perf_counter() - t0
    ok = (np.array_equal(np.stack([r["image"] for r in python]), images)
          and [r["label"] for r in python] == labels.tolist())
    t0 = time.perf_counter()
    shards = [read_raw_shard(p, shape) for p in paths]
    codec_s = time.perf_counter() - t0
    ok = ok and all(r is not None for r in shards)
    ok = ok and (np.array_equal(np.concatenate([r[0] for r in shards]), images)
                 and np.array_equal(np.concatenate([r[1] for r in shards]), labels))
    in_order = NativeRecordLoader(paths, shape, batch_size=HARNESS_BATCH, repeat=False,
                                  shuffle_files=False, num_threads=1)
    t0 = time.perf_counter()
    batches = list(in_order)
    loader_s = time.perf_counter() - t0
    in_order.close()
    ok = ok and (np.array_equal(np.concatenate([b[0] for b in batches]), images)
                 and np.array_equal(np.concatenate([b[1] for b in batches]), labels))
    threaded = NativeRecordLoader(paths, shape, batch_size=HARNESS_BATCH, repeat=False,
                                  shuffle_files=True, shuffle_buffer_size=256, num_threads=4,
                                  seed=1)
    shuffled = list(threaded)
    threaded.close()
    same_set = (records_signature([im for b in shuffled for im in b[0]],
                                  np.concatenate([b[1] for b in shuffled]))
                == records_signature(images, labels))
    log(f"[records] read back bit for bit: Python reader {python_s:.3f} s, C++ codec "
        f"{codec_s:.3f} s, native loader (1 thread, in order) {loader_s:.3f} s: "
        f"{'ok' if ok else 'FAIL'}; native loader (4 threads, shuffled) the same set of "
        f"records: {same_set}")
    if not (ok and same_set):
        raise AssertionError("records read back otherwise than they were written")
    del python, shards, batches, shuffled

    # Feed rates: the native loader at 4 threads with both shuffles (the
    # training configuration), alone and with each batch copied to the card.
    def to_card(loader, pinned):
        """The loader's batches copied to the card as `Training` stages them:
        into page-locked memory first, unless the loader filled it there."""
        for x, y in loader:
            staged = torch.from_numpy(x)
            yield (staged if pinned else staged.pin_memory()).cuda(non_blocking=True), y

    rates, pinned_seen = {}, None
    for pinned in (False, True):
        for copied in (False, True):
            loader = NativeRecordLoader(paths, shape, batch_size=HARNESS_BATCH, repeat=True,
                                        shuffle_files=True, shuffle_buffer_size=256,
                                        num_threads=4, seed=2)
            loader._pinned = pinned  # the loader pins on a CUDA machine; NumPy buffers to compare
            feed = to_card(loader, pinned) if copied else loader
            first = next(feed)  # the first batch waits for the workers' first shards
            if pinned and not copied:
                pinned_seen = torch.from_numpy(first[0]).is_pinned()
            rates[pinned, copied] = feed_rate(feed, 2 * RECORDS_IMAGES)
            loader.close()
    need = HARNESS_BATCH * 1e3 / 77.5  # a replayed 224x224 step, H100 80GB HBM3 at 700 W (PERF.md §5)
    log(f"[records] native loader, 4 threads, shuffled, {2 * RECORDS_IMAGES} images: alone "
        f"{rates[False, False]:.1f} images/s into NumPy buffers, {rates[True, False]:.1f} into "
        f"pinned ones; with each batch copied to the card {rates[False, True]:.1f} "
        f"(pin_memory() then copy) and {rates[True, True]:.1f} (pinned, copied directly; "
        f"torch sees the buffer as pinned: {pinned_seen}); a 77.5 ms step needs "
        f"{need:.1f} images/s ({smi})")

    side = RECORDS_CHAIN_SIZE
    big = rng.integers(0, 256, (256, side, side, 3), dtype=np.uint8)
    big_paths = RecordGenerator().write_arrays(big, labels[:256], os.path.join(tmp, "records256"),
                                               num_files_per_record=64)
    chain = RecordDatasetCreator(
        big_paths, batch_size=HARNESS_BATCH, repeat=True, num_epochs=2, shuffle=True,
        shuffle_buffer_size=256, seed=3,
        preprocessors=[UnpackImagesLabels(), RandomCrop(scale=size / side, seed=4),
                       RandomFlipLeftRight(seed=5)]).create_dataset()
    chain_iter = iter(chain)
    first, _ = next(chain_iter)
    chain_rate = feed_rate(chain_iter, 2 * 256 - HARNESS_BATCH)
    log(f"[records] Python chain (UnpackImagesLabels, RandomCrop {side} -> {first.shape[1]}, "
        f"RandomFlipLeftRight, shuffle buffer 256) over 4 shards of {side}x{side}x3: "
        f"{chain_rate:.1f} images/s, batches {tuple(first.shape)} {first.dtype} ({smi})")
    if first.shape != (HARNESS_BATCH, size, size, 3):
        raise AssertionError(f"the Python chain gave batches of {first.shape}")
    del big, chain, chain_iter

    config = resnet_preset("resnet50", RECORDS_CLASSES, antisymmetric_mid=True, image_shape=shape)
    card = build_resnet(config, generator=torch.Generator().manual_seed(0), device="cuda")
    cpu = build_resnet(config, params=card.params(), state=card.state(), device="cpu")
    creator = RecordDatasetCreator(paths, batch_size=HARNESS_BATCH, repeat=True, shuffle=True,
                                   shuffle_buffer_size=256, seed=6)
    fed = [0]

    def counted():  # pinned buffers, as the loader fills them on a CUDA machine
        for batch in creator.create_native_dataset(shape, num_threads=4):
            if not torch.from_numpy(batch[0]).is_pinned():
                raise AssertionError("the native loader's batch is not in pinned memory")
            fed[0] += 1
            yield batch

    reset_counts()
    stream = counted()
    x, y = next(stream)
    t0 = time.perf_counter()
    compare_steps("records", describe_resnet(config) + ", a loader batch", card, cpu, steps=1,
                  batch=len(x), loss_tol=1e-5, grad_tol=RESNET_GRAD_TOL,
                  leaf_tol=RESNET_LEAF_TOL,
                  batches=[(torch.from_numpy(x.astype(np.float32)), torch.from_numpy(y))])
    log(f"[records] the first step, card and CPU, {time.perf_counter() - t0:.1f} s")
    del cpu

    val = RecordDatasetCreator(paths, batch_size=HARNESS_BATCH, repeat=True, shuffle=False)
    trainer = Training(card, train_dataset=NumpyDataset.from_generator(lambda: stream),
                       val_dataset=val.create_native_dataset(shape, num_threads=1),
                       batch_size=HARNESS_BATCH, record_summaries=False)

    def epoch(steps):
        return trainer.train(epochs=1, steps_per_epoch=steps, learning_rate_schedule=lambda s: LR,
                             eval_frequency=None, verbose=False)

    epoch(2)  # the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = epoch(RECORDS_STEPS)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    window, busy, ops, idle, _ = profile_window(lambda: epoch(RECORDS_PROFILED), 1,
                                                "records_epoch")
    loss = history["train"][-1]["mean_loss"]
    rate = RECORDS_STEPS * HARNESS_BATCH / epoch_s
    log(f"[records] {describe_resnet(config)} fed by create_native_dataset (4 threads, pinned): "
        f"{RECORDS_STEPS} replayed steps at batch {HARNESS_BATCH} (after 1 compared and 2 "
        f"warm-up) in {epoch_s:.4f} s: {epoch_s / RECORDS_STEPS * 1e3:.4f} ms a step, "
        f"{rate:.1f} images/s end to end, mean loss {loss:.4f}; profiled epoch of "
        f"{RECORDS_PROFILED} steps: host {window / RECORDS_PROFILED:.4f} ms a step, device busy "
        f"{busy / RECORDS_PROFILED:.4f} ms a step ({ops / RECORDS_PROFILED:.1f} device "
        f"operations), idle share {idle:.1%} ({smi})")
    if not np.isfinite(loss):
        raise AssertionError("the records-fed ResNet-50's loss is not finite")

    metrics = trainer.evaluate("val", num_steps=RECORDS_IMAGES // HARNESS_BATCH)
    exported = export_model(card, os.path.join(tmp, "records_resnet50"), stablehlo=False)
    predict, manifest = load_exported(exported, device="cuda")
    sample = images[:HARNESS_BATCH].astype(np.float32)
    with torch.no_grad():
        want = card(torch.from_numpy(sample).cuda()).cpu()
    err = norm_rel(torch.from_numpy(predict(sample)), want)
    launches = launch_counts()
    ok = (np.isfinite(metrics["mean_loss"]) and manifest["family"] == "bottleneck"
          and err <= PREDICT_TOL and launches == (0, 0) and fed[0] >= 1 + 2 + RECORDS_STEPS
          + RECORDS_PROFILED)
    log(f"[records] evaluation over the {RECORDS_IMAGES} records ({RECORDS_IMAGES // HARNESS_BATCH}"
        f" replayed batches through the native loader): {json.dumps(metrics)}; export_model -> "
        f"load_exported -> predict at batch {HARNESS_BATCH} against the model norm-rel "
        f"{err:.2e} (tol {PREDICT_TOL:g}); {fed[0]} training batches came from the native "
        f"loader; B1/B2 launches {launches} (want (0, 0)): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the records-fed ResNet-50 went wrong")
    stream.close()
    del trainer, predict, card
    torch.cuda.empty_cache()

    try:
        from PIL import Image
    except ImportError:
        log("[records] Pillow leg: not run (Pillow is not installed here); convert-records and "
            "predict on an image directory are held against the JAX package's CLI by the CPU tests")
    else:
        tree = os.path.join(tmp, "png_tree")
        os.makedirs(tree)
        pngs = rng.integers(0, 256, (8, 40, 48, 3), dtype=np.uint8)
        for i, png in enumerate(pngs):
            Image.fromarray(png).save(os.path.join(tree, f"{i % 3}_{i}.png"))
        cli.main(["convert-records", tree, os.path.join(tmp, "png_records"), "--shard-size", "4"])
        converted = [r for p in sorted(os.listdir(os.path.join(tmp, "png_records")))
                     for r in read_record_file(os.path.join(tmp, "png_records", p))]
        probs = {}
        for device in ("cuda", "cpu"):
            out = os.path.join(tmp, f"png_{device}.npy")
            finish(run_cli("predict", tree, "--device", device, "--batch-size", "8",
                           "--output", out), f"predict {device}")
            probs[device] = np.load(out)
        err = float(np.abs(probs["cuda"] - probs["cpu"]).max())
        ok = len(converted) == 8 and probs["cuda"].shape == (8, 10) and err <= 1e-4
        log(f"[records] Pillow leg ran: convert-records wrote {len(converted)} records; predict "
            f"on the image directory (64L x 16F, 8 PNGs resized 40x48 -> 32x32) card vs cpu "
            f"max|diff| {err:.2e} (tol 1e-4): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("convert-records or predict on an image directory went wrong")
    log(f"[records] phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


MNIST_SHAPE = (32, 28, 28, 16)  # batch, H, W, C of the MNIST model's identity stack
MNIST_LAYERS = 8
MNIST_SIZES = (60000, 10000)    # synthetic_mnist's train and test images, MNIST's own


def phase_mnist(smi):
    """The MNIST smoke workflow (`mnist_single_block_config()`: 8L x 16F at
    28x28, full width) on the card:

    1. B1 and B2 at its stack's shape, 32x28x28x16, L = 8 (28 rows make
       uneven bands), against their plain versions (B2 judged by a float64
       run, as `phase_kernels_bwd`), then timed beside their bounds;
    2. the model from seed 0 against its CPU twin on seeded
       `synthetic_mnist` data: logits at batch 32, then 2 train steps at
       batch 32 each from the same state (`compare_steps`);
    3. an epoch's worth of replayed steps (60,000 images, 1875 steps at
       batch 32, device-resident) through `Training`, a device evaluation
       of the 10,000 test images, and `predict`.

    Returns the B1 and B2 launches of steps 2-3 (the main path)."""
    from differential_equations_resnet_tpu_torch.data.mnist import (
        mnist_single_block_config,
        synthetic_mnist,
    )

    t_phase = time.perf_counter()
    b, hh, ww, c = MNIST_SHAPE
    h = 1.0 / MNIST_LAYERS
    x, kernels, biases, g = make_case(b, hh, ww, c, MNIST_LAYERS, 300)
    got = fi.fused_euler_dense(x, kernels, biases, h)
    want = fi.reference_euler_dense(x, kernels, biases, h)
    fwd_err, fwd_ok = max_violation(got, want, FP32_TOL)
    grads = fi.fused_euler_dense_bwd(x, kernels, biases, g, h)
    plain = fi.reference_euler_dense_bwd(x, kernels, biases, g, h)
    judge = fi.reference_euler_dense_bwd(*[t.double() for t in (x, kernels, biases, g)], h)
    bwd_err = max(float((a - w).abs().max()) for a, w in zip(grads, plain))
    bwd_ok = all(norm_rel(a, j) <= 2 * norm_rel(w, j) + 1e-5 for a, w, j in zip(grads, plain, judge))
    log(f"[mnist] B1 {'x'.join(map(str, MNIST_SHAPE))} L={MNIST_LAYERS} "
        f"({describe_bands(x.shape)[1]}, {fi.kernel_variant(x.shape)} variant): max|kernel-plain| "
        f"{fwd_err:.3e} (tol rtol=atol={FP32_TOL:g}); B2 ({describe_bands(x.shape, True)[1]}, "
        f"{fi.kernel_variant(x.shape, True)} variant): max|B2-plain| {bwd_err:.3e}, as close to "
        f"float64 as the plain version: {'ok' if fwd_ok and bwd_ok else 'FAIL'}")
    if not (fwd_ok and bwd_ok):
        raise AssertionError("B1 or B2 disagrees with its plain version at 28x28x16")
    times = {}
    for name, fn, backward in (
            ("B1", lambda: fi.fused_euler_dense(x, kernels, biases, h), False),
            ("B1 plain", lambda: fi.reference_euler_dense(x, kernels, biases, h), False),
            ("B2", lambda: fi.fused_euler_dense_bwd(x, kernels, biases, g, h), True),
            ("B2 plain", lambda: fi.reference_euler_dense_bwd(x, kernels, biases, g, h), True)):
        times[name] = cuda_time_ms(fn)
        if " " not in name:
            bound = kernel_bounds(b, hh, ww, c, MNIST_LAYERS, backward)
            log(f"[mnist] {name} at {'x'.join(map(str, MNIST_SHAPE))} L={MNIST_LAYERS}: "
                f"{times[name]:.4f} ms, bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
                f"({bound['flops'] / 1e9:.3f} GFLOP, {bound['nbytes']} bytes), "
                f"{bound['bound_ms'] / times[name]:.1%} of bound ({smi})")
    log(f"[mnist] plain versions: B1 {times['B1 plain']:.4f} ms, B2 {times['B2 plain']:.4f} ms")

    config = mnist_single_block_config()
    tr_x, tr_y, te_x, te_y, _ = synthetic_mnist(*MNIST_SIZES, seed=0)
    card = build_single_block_resnet(config, generator=torch.Generator().manual_seed(0),
                                     device="cuda")
    cpu = build_single_block_resnet(config, params=card.params(), device="cpu")
    route = sbr.identity_route(config, torch.zeros(HARNESS_BATCH, hh, ww, c),
                               sbr._dense_blocks(card.params()["stages"][0]["blocks"], config))
    reset_counts()
    images = torch.from_numpy(te_x[:HARNESS_BATCH].astype(np.float32))
    with torch.no_grad():
        got = card(images.cuda(), return_logits=True).cpu()
        want = cpu(images, return_logits=True)
    err, ok = max_violation(got, want, FP32_TOL)
    log(f"[mnist] {MNIST_LAYERS}L x {c}F at 28x28x1 (route {route}): logits at batch "
        f"{HARNESS_BATCH} max|card-cpu| {err:.3e} (max|cpu| {float(want.abs().max()):.3e}), tol "
        f"rtol=atol={FP32_TOL:g}: {'ok' if ok else 'FAIL'}")
    if not ok or route != "fused":
        raise AssertionError("the MNIST model's logits disagree with the CPU's or left B1/B2")
    batches = [(torch.from_numpy(tr_x[i * HARNESS_BATCH:(i + 1) * HARNESS_BATCH].astype(np.float32)),
                torch.from_numpy(tr_y[i * HARNESS_BATCH:(i + 1) * HARNESS_BATCH])) for i in range(2)]
    compare_steps("mnist", f"{MNIST_LAYERS}L x {c}F MNIST", card, cpu, steps=2,
                  batch=HARNESS_BATCH, batches=batches)
    del cpu

    trainer = Training(card, train_features=tr_x, train_labels=tr_y, val_features=te_x,
                       val_labels=te_y, batch_size=HARNESS_BATCH, record_summaries=False)
    steps = len(tr_x) // HARNESS_BATCH
    t0 = time.perf_counter()
    history = trainer.train(epochs=1, steps_per_epoch=steps, learning_rate_schedule=lambda s: LR,
                            device_data=True, verbose=False)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    probs = trainer.predict(te_x[:100].astype(np.float32))
    launches = launch_counts()
    wide = wide_counts()
    train, evaluated = history["train"][-1], history["eval"][-1]
    ok = (np.isfinite(train["mean_loss"]) and evaluated["accuracy"] > 0.15  # above chance
          and probs.shape == (100, 10) and np.allclose(probs.sum(-1), 1, atol=1e-5)
          and launches[0] > steps and launches[1] > steps and wide == (0, 0))
    log(f"[mnist] a device-resident epoch of {steps} replayed steps at batch {HARNESS_BATCH} "
        f"and a device evaluation of {len(te_x)} images (with capture) {epoch_s:.3f} s: train "
        f"loss {train['mean_loss']:.4f} acc {train['accuracy']:.4f}, eval loss "
        f"{evaluated['mean_loss']:.4f} acc {evaluated['accuracy']:.4f}; predict 100 images: "
        f"probabilities {probs.shape}, argmax of the first 8 {probs[:8].argmax(-1).tolist()}; "
        f"B1/B2 launches {launches} (wide {wide}) ({smi}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the MNIST workflow went wrong on the card")
    del trainer, card
    torch.cuda.empty_cache()
    log(f"[mnist] phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# A step over a mesh against the same step without one (PERF.md §2): the
# loss relative, the grad-norm row relative, each parameter absolute.
EXAMPLES = "differential_equations_resnet_tpu_torch.examples"
# Each example with its arguments on the card: the gradient-flow experiment
# at its full 64L x 16F on the fused route for one device-resident epoch of
# a small seeded synthetic set, the others at their own defaults or cut
# sizes (large_batch_training with its bf16 and int8 arms).
EXAMPLE_RUNS = (
    ("cifar10_gradient_flow_experiment",
     ("--num-layers", "64", "--num-filters", "16", "--epochs", "1", "--device-data",
      "--synthetic-train-size", "2048", "--synthetic-val-size", "512")),
    ("antisymmetric_kernel_properties", ()),
    ("depth_doubling_continuation",
     ("--synthetic-train-size", "1024", "--synthetic-val-size", "256")),
    ("large_batch_training",
     ("--epochs", "1", "--train-size", "2048", "--val-size", "256", "--compare-bf16",
      "--compare-int8", "--int8-backward", "wgrad")),
    ("int8_full_nan_repro", ("--num-layers", "16", "--batch", "32", "--steps", "3")),
)


def example_json(name, body):
    """The JSON an example printed (the last of its output before the
    launches line; indented or on one line)."""
    lines = body.splitlines()
    start = max(i for i, line in enumerate(lines) if line in ("{", "[") or line.startswith("{\""))
    return json.loads("\n".join(lines[start:]))


def example_ok(name, body):
    """Whether an example's output has what its JAX original prints."""
    if name == "antisymmetric_kernel_properties":
        return "after training" in body and body.count("skew-consistent") == 3
    out = example_json(name, body)
    if name == "cifar10_gradient_flow_experiment":
        keys = {"best_val_accuracy", "best_val_mean_loss", "grad_norm_relative_deviation",
                "grad_norm_std_over_layers", "grad_norm_last_first_ratio", "training_csv"}
        return set(out) == {"antisymmetric", "regular"} and all(
            set(row) == keys and np.isfinite(row["best_val_mean_loss"]) for row in out.values())
    if name == "depth_doubling_continuation":
        return ([row["layers"] for row in out] == [8, 16, 32]
                and all(np.isfinite(row["mean_loss"]) for row in out))
    if name == "large_batch_training":
        return (len(out["runs"]) == 8 and len(out["convergence_delta_vs_base"]) == 7
                and all(np.isfinite(r["final_train_loss"]) for r in out["runs"]))
    return out["verdict"] == "clean" and out["residual_stack_bytes"] > 0


def phase_examples(tmp, smi):
    """The five examples of this slice, each in a subprocess (all started
    together) through its ``main(argv)``, which then prints the B1/B2
    launches it made: each must exit 0 and print its JAX original's keys.
    Returns the launches of the band and wide B1 and B2, summed."""
    t_phase = time.perf_counter()
    procs = {}
    for name, args in EXAMPLE_RUNS:
        if name == "cifar10_gradient_flow_experiment":
            args = args + ("--out-dir", os.path.join(tmp, "gradient_flow"))
        code = ("import json, sys\n"
                f"from {EXAMPLES} import {name}\n"
                "from differential_equations_resnet_tpu_torch.utils.tracing import STACKS\n"
                f"rc = {name}.main({list(args)!r})\n"
                "print(json.dumps([STACKS.launches(k, v) for v in ('band', 'wide')\n"
                "                  for k in ('B1', 'B2')]))\n"
                "sys.exit(rc)\n")
        procs[name] = run_python("-c", code)
    launches = np.zeros(4, dtype=np.int64)
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
                p.communicate()
            raise
        if proc.returncode != 0:
            raise AssertionError(f"example {name} exited with {proc.returncode}:\n{err[-4000:]}")
        body, counts = out.strip().rsplit("\n", 1)
        counts = json.loads(counts)
        ok = example_ok(name, body)
        log(f"[examples] {name}: exit 0, band B1/B2, wide B1/B2 launches {counts}, "
            f"last output line {body.splitlines()[-1][:300]}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"example {name} printed a bad result:\n{body[-4000:]}")
        launches += counts
    if launches[0] == 0 or launches[1] == 0:
        raise AssertionError("the examples launched no B1 or no B2")
    log(f"[examples] five examples {time.perf_counter() - t_phase:.1f} s, launches "
        f"{launches.tolist()} ({smi})")
    return [int(n) for n in launches]


MESH_LOSS_TOL = 1e-5
MESH_ROW_TOL = 1e-3
MESH_PARAM_TOL = 1e-3
MESH_RANKS = 2
MESH_RANK_TIMEOUT = 300
# Steps of the device-resident epochs compared row by row.  cuDNN's weight
# gradients (the stem's) differ from run to run in the last bits, and a
# random-label epoch of 64 layers under Adam amplifies that over its 1562
# steps as it would between two meshless epochs, so the whole epoch is
# timed and its loss reported, and its first steps are held to the bounds.
MESH_COMPARED_STEPS = 16


def mesh_step_rows(model, mesh, batches, device):
    """Eager `make_train_step(mesh=...)` steps over global ``batches``:
    their telemetry rows and the parameters and buffers after, on the
    host."""
    step = make_train_step(model, make_adam(model.parameters()), mesh=mesh)
    rows = [pack_row(*step(x.to(device), y.to(device), LR)).cpu() for x, y in batches]
    return (torch.stack(rows), [p.detach().cpu() for p in model.parameters()],
            [b.detach().cpu() for b in model.buffers()])


def mesh_cases(device):
    """The two models the gloo ranks step (seeded): the fused 64L x 16F
    model for 2 steps and ResNet-50 at 32x32 with batch norm for one (a
    random-init ResNet's next steps part under Adam, compare_steps), each at
    global batch 32."""
    rng = np.random.default_rng(40)
    batches = [image_batch(rng, MESH_RANKS * 16) for _ in range(2)]
    return [
        ("64L x 16F", lambda: build_single_block_resnet(
            cifar10_single_block_config(num_layers=64, num_filters=16),
            generator=torch.Generator().manual_seed(41), device=device), batches),
        ("ResNet-50 32x32", lambda: build_resnet(
            resnet_preset("resnet50", 10, image_shape=(32, 32, 3)),
            generator=torch.Generator().manual_seed(42), device=device), batches[:1]),
    ]


def mesh_rank(rank, store, out, device):
    """One of the gloo ranks that share the card (a spawned process): every
    case's eager mesh steps, this rank's B1/B2 launches, and what a captured
    loop over gloo raises."""
    import pickle

    import torch.distributed as dist

    from differential_equations_resnet_tpu_torch.parallel import create_mesh

    result = {}
    try:
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=MESH_RANKS)
        mesh = create_mesh((MESH_RANKS,), ("data",), device_type=device)
        STACKS.reset()
        for label, build, batches in mesh_cases(device):
            result[label] = mesh_step_rows(build(), mesh, batches, device)
        result["launches"] = launch_counts()
        if device == "cuda":
            model = mesh_cases(device)[0][1]()
            multi = make_multi_step(model, make_adam(model.parameters()), mesh=mesh)
            x, y = mesh_cases(device)[0][2][0]
            try:
                multi(x[None].cuda(), y[None].cuda(), [LR])
                result["captured"] = "no error"
            except RuntimeError as e:
                result["captured"] = str(e)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 - reported by the parent
        import traceback

        result = {"error": f"rank {rank}: {e!r}\n{traceback.format_exc()}"}
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_mesh_ranks(tmp, device):
    """Spawn the gloo ranks (`mesh_rank`) and return their results; every
    rank is stopped by the end, at the latest after MESH_RANK_TIMEOUT s."""
    import multiprocessing
    import pickle

    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(tmp, "store")
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(MESH_RANKS)]
    procs = [ctx.Process(target=mesh_rank, args=(r, store, outs[r], device))
             for r in range(MESH_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_RANK_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r, out in enumerate(outs):
        if not os.path.exists(out):
            raise AssertionError(f"gloo rank {r} left no result (exit code {procs[r].exitcode})")
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    errors = [r["error"] for r in results if "error" in r]
    if errors:
        raise AssertionError("\n".join(errors))
    return results


def rows_agree(got, want, loss_tol=MESH_LOSS_TOL, row_tol=MESH_ROW_TOL):
    """(loss rel, row rel, ok) of telemetry rows [loss, correct, count, *norms]."""
    loss_err = float(((got[:, 0] - want[:, 0]).abs() / want[:, 0].abs()).max())
    row_err = float(((got[:, 3:] - want[:, 3:]).abs() / want[:, 3:].abs()).max())
    same = torch.equal(got[:, 1:3], want[:, 1:3])
    return loss_err, row_err, loss_err <= loss_tol and row_err <= row_tol and same


def mesh_epoch_run(model, mesh, features, labels, steps, device):
    """A device-resident epoch of MESH_COMPARED_STEPS replayed steps of
    ``model`` (the first, which captures the step), then one of ``steps``
    timed: (rows of the first, parameters after it, rows of the second,
    seconds of the second)."""
    epoch = make_device_epoch(model, make_adam(model.parameters()), HARNESS_BATCH, mesh=mesh,
                              augment=standard_cifar_augment())
    out = []
    for seed, n in ((1, MESH_COMPARED_STEPS), (2, steps)):
        generator = torch.Generator(device=device).manual_seed(seed)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, norms = epoch(features, labels, generator, [LR] * n)
        rows = torch.cat([torch.stack([metrics[k] for k in ("loss", "correct", "count")], 1),
                          norms], 1).cpu()
        if device == "cuda":
            torch.cuda.synchronize()
        out.append((rows, [p.detach().cpu() for p in model.parameters()],
                    time.perf_counter() - t0))
    (rows, params, _), (timed_rows, _, seconds) = out
    return rows, params, timed_rows, seconds


def phase_mesh(smi, arrays, device="cuda", epoch_steps=None):
    """Meshes on the card (parallel/, ROADMAP A15).  One card: the NCCL
    collectives run on a world of one rank, and two gloo ranks share it;
    nothing here measures a multi-GPU speed.

    1. The 64L x 16F model's device-resident epoch through a one-rank NCCL
       ``data`` mesh against the same epoch without a mesh, from the same
       state and seeds: MESH_COMPARED_STEPS replayed steps compared row by
       row (the all-reduce of one rank adds nothing; bit for bit is
       reported, the bounds are held), then an epoch of 1562 steps of each
       timed (the collective's cost on one card), B1/B2 launches of the
       mesh epochs counted.
    2. Two spawned gloo ranks on the card (`mesh_rank`): eager
       `make_train_step(mesh=...)` at global batch 32 against the one-rank
       step from the same state, for the fused model (B1/B2 on each rank's
       16 images) and for ResNet-50 at 32x32 with batch norm (loss
       RESNET_LOSS_TOL, row RESNET_GRAD_TOL, parameters BN_STEP_BOUND lr,
       running statistics STATE_TOL); a captured loop over gloo raises
       naming the backend.
    3. TP, PP and tp x pp at axis size 1 on NCCL: an 8L x 16F model's
       eval-mode logits and one eager step against the meshless model.

    Returns the B1 and B2 launches of parts 1 and 2 (the mesh path)."""
    import torch.distributed as dist

    from differential_equations_resnet_tpu_torch.parallel import create_mesh

    t_phase = time.perf_counter()
    train_x, train_y = arrays[:2]
    steps = epoch_steps or len(train_x) // HARNESS_BATCH
    features = torch.from_numpy(train_x).to(device)
    labels = torch.from_numpy(train_y).to(device)
    mesh = create_mesh((1,), ("data",), device_type=device)
    backend = dist.get_backend(mesh.get_group(0))
    runs = {}
    for label, m in (("meshless", None), ("mesh", mesh)):
        model = headline_model() if device == "cuda" else build_single_block_resnet(
            cifar10_single_block_config(num_layers=64, num_filters=16),
            generator=torch.Generator().manual_seed(0), device=device)
        reset_counts()
        runs[label] = mesh_epoch_run(model, m, features, labels, steps, device) + (launch_counts(),)
    rows_m, params_m, timed_m, sec_m, launches = runs["mesh"]
    rows_0, params_0, timed_0, sec_0, _ = runs["meshless"]
    bitwise = torch.equal(rows_m, rows_0) and all(torch.equal(a, b) for a, b in zip(params_m, params_0))
    loss_err, row_err, rows_ok = rows_agree(rows_m, rows_0)
    param_err = max(float((a - b).abs().max()) for a, b in zip(params_m, params_0))
    # The kernels launch on the card (on the CPU the plain versions run,
    # which launch nothing).
    want = (WARMUP_CALLS + MESH_COMPARED_STEPS + steps,) * 2 if device == "cuda" else (0, 0)
    finite = bool(torch.isfinite(timed_m).all() and torch.isfinite(timed_0).all())
    ok = rows_ok and param_err <= MESH_PARAM_TOL and launches == want and finite
    log(f"[mesh] one-rank {backend} data mesh, 64L x 16F device-resident epochs of {steps} "
        f"replayed steps at batch {HARNESS_BATCH} (augmented): mesh {sec_m:.4f} s "
        f"({steps / sec_m:.2f} steps/s) vs meshless {sec_0:.4f} s ({steps / sec_0:.2f} steps/s), "
        f"collective cost {(sec_m - sec_0) / steps * 1e3:+.4f} ms a step; epoch mean loss "
        f"{float(timed_m[:, 0].mean()):.4f} vs {float(timed_0[:, 0].mean()):.4f} ({smi})")
    log(f"[mesh] mesh vs meshless, the first {MESH_COMPARED_STEPS} replayed steps from the same "
        f"state and seed: bit for bit {bitwise}; loss rel {loss_err:.2e} (tol "
        f"{MESH_LOSS_TOL:g}), rows rel {row_err:.2e} (tol {MESH_ROW_TOL:g}), params max abs "
        f"{param_err:.2e} (tol {MESH_PARAM_TOL:g}); launches B1 {launches[0]} B2 {launches[1]} "
        f"(want {want}: {WARMUP_CALLS} warm-up calls + one replay a step): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the device-resident epoch over a one-rank mesh differs")
    total = list(launches)

    # 2. two gloo ranks sharing the card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_mesh_ranks(tmp, device)
    rank_seconds = time.perf_counter() - t0
    agree = True
    for label, build, batches in mesh_cases(device):
        want_rows, want_params, want_buffers = mesh_step_rows(build(), None, batches, device)
        bn = "ResNet" in label
        for r, got in enumerate(ranks):
            rows, params, buffers = got[label]
            loss_err, row_err, rows_ok = rows_agree(
                rows, want_rows, *((RESNET_LOSS_TOL, RESNET_GRAD_TOL) if bn else ()))
            worst = max(float((a - b).abs().max()) for a, b in zip(params, want_params))
            state_err = max((norm_rel(a, b) for a, b in zip(buffers, want_buffers)), default=0.0)
            if bn:
                ok = rows_ok and worst / LR <= BN_STEP_BOUND and state_err <= STATE_TOL
                bounds = (f"params max |diff| {worst / LR:.3f} of lr (tol {BN_STEP_BOUND:g}), "
                          f"running statistics norm-rel {state_err:.2e} (tol {STATE_TOL:g})")
            else:
                ok = rows_ok and worst <= MESH_PARAM_TOL
                bounds = f"params max abs {worst:.2e} (tol {MESH_PARAM_TOL:g})"
            agree = agree and ok
            log(f"[mesh] gloo rank {r} of {MESH_RANKS} on one card, {label}, {len(batches)} "
                f"eager mesh step(s) at global batch {len(batches[0][0])} vs the one-rank step: "
                f"loss rel {loss_err:.2e}, rows rel {row_err:.2e}, {bounds}: "
                f"{'ok' if ok else 'FAIL'}")
    for r, got in enumerate(ranks):
        fwd, bwd = got["launches"]
        # The fused model's two steps on this rank's 16 images.
        ok = fwd == bwd == (2 if device == "cuda" else 0)
        captured = got.get("captured", "not run off the card")
        raises = device != "cuda" or "gloo" in captured
        agree = agree and ok and raises
        log(f"[mesh] gloo rank {r}: B1 {fwd} B2 {bwd} launches (want 2 each), a captured loop "
            f"over gloo: {captured!r}: {'ok' if ok and raises else 'FAIL'}")
        total = [total[0] + fwd, total[1] + bwd]
    log(f"[mesh] {MESH_RANKS} gloo ranks: {rank_seconds:.1f} s from spawn to exit ({smi})")
    if not agree:
        raise AssertionError("the gloo ranks' mesh steps differ from the one-rank step")

    # 3. TP and PP at axis size 1 on NCCL
    grid = create_mesh((1, 1), ("pipe", "model"), device_type=device)
    base = cifar10_single_block_config(num_layers=8, num_filters=16)
    rng = np.random.default_rng(43)
    batches = [image_batch(rng, 8)]
    want_model = build_single_block_resnet(base, generator=torch.Generator().manual_seed(44),
                                           device=device)
    with torch.no_grad():
        want_logits = want_model(batches[0][0].to(device), return_logits=True).cpu()
    want_rows, want_params, _ = mesh_step_rows(want_model, None, batches, device)
    agree = True
    for label, fields in (("tp_mesh", dict(tp_mesh=grid)), ("pp_mesh", dict(pp_mesh=grid)),
                          ("tp x pp", dict(tp_mesh=grid, pp_mesh=grid))):
        model = build_single_block_resnet(dataclasses.replace(base, **fields),
                                          generator=torch.Generator().manual_seed(44), device=device)
        with torch.no_grad():
            logits = model(batches[0][0].to(device), return_logits=True).cpu()
        logits_err = float((logits - want_logits).abs().max())
        rows, params, _ = mesh_step_rows(model, grid, batches, device)
        loss_err, row_err, rows_ok = rows_agree(rows, want_rows)
        worst = max(float((a - b).abs().max()) for a, b in zip(params, want_params))
        ok = logits_err <= FP32_TOL * (1 + float(want_logits.abs().max())) and rows_ok and (
            worst <= MESH_PARAM_TOL)
        agree = agree and ok
        log(f"[mesh] {label} of one rank ({backend}), 8L x 16F at batch 8 vs the meshless model: "
            f"eval logits max abs {logits_err:.2e}, step loss rel {loss_err:.2e}, rows rel "
            f"{row_err:.2e}, params max abs {worst:.2e}: {'ok' if ok else 'FAIL'}")
    if not agree:
        raise AssertionError("TP or PP of axis size 1 differs from the meshless model")
    dist.destroy_process_group()
    log(f"[mesh] phase took {time.perf_counter() - t_phase:.1f} s ({smi})")
    return tuple(total)


# ResNet-50 v1's batch norms at batch 32 and 224x224: (N, H, W, C) and the
# layers of that shape by the epilogue each takes in the model (stem; bn1 and
# bn2 of stage 1's 3 blocks; bn3 of those and the shortcut; ... 53 in all):
# relu after the stem, bn1 and bn2; the residual add and relu after each
# block's last batch norm (bn_shortcut in a conv block, bn3 in an identity
# block); none after a conv block's bn3.
BN_RESNET50 = (((32, 112, 112, 64), {"relu": 1}), ((32, 56, 56, 64), {"relu": 6}),
               ((32, 56, 56, 256), {"none": 1, "add_relu": 3}), ((32, 28, 28, 128), {"relu": 8}),
               ((32, 28, 28, 512), {"none": 1, "add_relu": 4}), ((32, 14, 14, 256), {"relu": 12}),
               ((32, 14, 14, 1024), {"none": 1, "add_relu": 6}), ((32, 7, 7, 512), {"relu": 6}),
               ((32, 7, 7, 2048), {"none": 1, "add_relu": 3}))
BN_LAUNCHES_A_LAYER = 4  # the forward's apply (after torch.var_mean); sums, finalize, apply
# A ResNet-50 step's batch-norm calls by the record's variant.
BN_RESNET50_VARIANTS = {"forward": 4, "forward+relu": 33, "forward+add_relu": 16,
                        "backward": 20, "backward+relu": 33}
BN_TOL = 1e-6  # norm-relative, the backward against the plain version: both take fp64 sums


def bn_case(shape, seed=0):
    """x (mean about 2, spread 3), scale, offset, running mean and variance,
    and a cotangent, fp32 on the card."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    arrays = [2.0 + 3.0 * rng.standard_normal(shape), 1.0 + 0.1 * rng.standard_normal(c),
              0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c),
              rng.uniform(0.5, 1.5, c), rng.standard_normal(shape)]
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays]


def graph_ms(fn, calls=20, repeats=5):
    """Milliseconds a call of ``fn`` takes on the card inside a CUDA graph
    of ``calls`` calls, as a replayed train step runs it (no host time
    between launches): CUDA events around a replay, over ``calls``, the
    median of ``repeats`` replays, after 3 warm-up calls on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def bn_bytes(shape, passes):
    """The least bytes ``passes`` passes over a tensor of ``shape`` move: the
    forward's statistics read x once, the apply reads x (and an add_relu
    layer's residual) and writes out; the backward reads dy and x twice each
    (sums, apply) and writes dx; the per-channel vectors left out."""
    return passes * 4 * math.prod(shape)


# Passes of the apply alone by epilogue, and of the backward's three kernels.
BN_APPLY_PASSES = {"none": 2, "relu": 2, "add_relu": 3}
BN_BWD_PASSES = 5


def bits_equal(a, b):
    """Equal bytes: NaNs and signed zeros compare exactly."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def bn_epilogues_ok(x, scale, offset, mean, var, dy, y, stats):
    """The epilogues at one shape against the torch ops they stand for, bit
    for bit: relu and add_relu forward (a residual that is -y at a quarter
    of the places and -0.0 at another), and the relu backward against the
    plain kernels on threshold_backward's gradient."""
    bn = (BN_EPSILON, BN_MOMENTUM)
    gen = torch.Generator(device="cuda").manual_seed(5)
    pick = torch.randint(0, 4, x.shape, device="cuda", generator=gen)
    residual = torch.where(pick == 0, -y, torch.where(
        pick == 1, torch.full_like(y, -0.0), torch.randn(x.shape, device="cuda", generator=gen)))
    relu, relu_stats = fbn._launch(x, scale, offset, mean, var, *bn, "relu")
    add, add_stats = fbn._launch(x, scale, offset, mean, var, *bn, "add_relu", residual)
    ok = (bits_equal(relu, torch.relu(y)) and bits_equal(add, torch.relu(y + residual))
          and bits_equal(relu_stats, stats) and bits_equal(add_stats, stats))
    got = fbn._launch_bwd(dy, x, stats, scale, offset, "relu")
    want = fbn._launch_bwd(torch.ops.aten.threshold_backward(dy, relu, 0), x, stats, scale)
    return ok and all(bits_equal(a, b) for a, b in zip(got, want)), residual


def phase_batch_norm(smi):
    """Train-mode batch norm's kernels (`csrc/batch_norm.cu`):

    1. against the plain version at ResNet-50's nine shapes at batch 32 and
       224x224, at C = 8 and 16 (the single-block family) and at C = 6 (one
       channel a thread): y and the statistics bit for bit (the composite's
       forward), dx, dscale and doffset within BN_TOL, one launch forward
       and three backward, a second run bit for bit; the epilogues bit for
       bit against their torch ops (`bn_epilogues_ok`);
    2. each ResNet-50 shape timed, forward (`torch.var_mean` and the apply;
       the reduction also alone) with each epilogue and backward with and
       without relu's mask, beside their byte bounds and beside the same
       work with the epilogue as separate torch ops (what the model ran
       before the epilogues), the composite's time
       (`blocks.composite_batch_norm`, which every call but a CUDA fp32 one
       in train mode on one rank takes, with autograd's backward) and the
       plain version's, and summed over the step's 53 layers with the
       epilogue each takes in the model;
    3. one eager ResNet-50 train step at 224x224 x 257 classes, batch 32,
       its launches counted from 0 (`reset_counts`): 53 x 4, the count the
       kernels line reports, and the calls by variant (4 plain, 33 relu and
       16 add_relu forward; 20 plain and 33 relu backward).

    Returns the kernels line's entry."""
    t_phase = time.perf_counter()
    bn = (BN_EPSILON, BN_MOMENTUM)
    worst = 0.0
    step = dict(kernel=0.0, separate=0.0, moments=0.0, composite=0.0, plain=0.0, bound=0.0)
    shapes = [s for s, _ in BN_RESNET50] + [(32, 32, 32, 8), (32, 32, 32, 16), (3, 5, 7, 6)]
    layers = dict(BN_RESNET50)
    for shape in shapes:
        x, scale, offset, mean, var, dy = bn_case(shape)
        before = STACKS.launches("BN")
        y, stats = fbn._launch(x, scale, offset, mean, var, *bn)
        grads = fbn._launch_bwd(dy, x, stats, scale)
        torch.cuda.synchronize()
        launches = STACKS.launches("BN") - before
        want_y, want_stats = fbn.reference_batch_norm(x, scale, offset, mean, var, *bn)
        want = fbn.reference_batch_norm_bwd(dy, x, stats, scale)
        forward_equal = torch.equal(y, want_y) and torch.equal(stats, want_stats)
        errs = [norm_rel(a, b) for a, b in zip(grads, want)]
        again = (*fbn._launch(x, scale, offset, mean, var, *bn), *fbn._launch_bwd(dy, x, stats, scale))
        same = all(torch.equal(a, b) for a, b in zip((y, stats, *grads), again))
        epilogues_equal, residual = bn_epilogues_ok(x, scale, offset, mean, var, dy, y, stats)
        worst = max(worst, *(float((a - b).abs().max()) for a, b in zip(grads, want)))
        ok = (forward_equal and max(errs) <= BN_TOL and launches == BN_LAUNCHES_A_LAYER and same
              and epilogues_equal)
        plan = fbn._plan(x)
        log(f"[bn] {'x'.join(map(str, shape))} (vec {plan['vec']}, lanes {plan['lanes']}, "
            f"{plan['chunks']} x {plan['groups']} blocks): y and stats equal to the plain "
            f"version's: {forward_equal}; dx, dscale, doffset norm-rel "
            f"{', '.join(f'{e:.1e}' for e in errs)} (tol {BN_TOL:g}), {launches} launches (want "
            f"{BN_LAUNCHES_A_LAYER}), two runs equal: {same}; relu and add_relu forward and "
            f"relu backward equal to their torch ops': {epilogues_equal}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"batch-norm kernels at {shape} differ from the plain version")
        if shape not in layers:
            continue
        moments_ms = graph_ms(lambda: fbn._moments(x))
        res = {"none": None, "relu": None, "add_relu": residual}
        relu_out = torch.relu(y)
        fwd, fwd_sep = {}, {}
        for e in fbn.EPILOGUES:
            fwd[e] = graph_ms(lambda: fbn._launch(x, scale, offset, mean, var, *bn, e, res[e]))
            fwd_sep[e] = graph_ms(lambda: fbn.epilogue_of(
                fbn._launch(x, scale, offset, mean, var, *bn)[0], e, res[e]))
        bwd = {"none": graph_ms(lambda: fbn._launch_bwd(dy, x, stats, scale)),
               "relu": graph_ms(lambda: fbn._launch_bwd(dy, x, stats, scale, offset, "relu"))}
        bwd_sep = {"relu": graph_ms(lambda: fbn._launch_bwd(
            torch.ops.aten.threshold_backward(dy, relu_out, 0), x, stats, scale))}
        bwd_sep["none"] = bwd["none"]
        # add_relu's backward: one threshold_backward, then the plain kernels.
        bwd["add_relu"] = bwd_sep["add_relu"] = graph_ms(lambda: fbn._launch_bwd(
            torch.ops.aten.threshold_backward(dy, relu_out, 0), x, stats, scale))
        plain_ms = graph_ms(lambda: fbn.reference_batch_norm_bwd(
            dy, x, fbn.reference_batch_norm(x, scale, offset, mean, var, *bn)[1], scale), calls=2)
        leaves = [t.clone().requires_grad_() for t in (x, scale, offset)]
        state = BatchNormState(mean, var)
        comp_fwd_ms = graph_ms(lambda: composite_batch_norm(
            x, BatchNormParams(scale, offset), state, True))
        comp_ms = graph_ms(lambda: torch.autograd.grad(composite_batch_norm(
            leaves[0], BatchNormParams(*leaves[1:]), state, True)[0], leaves, dy))
        ms = lambda passes: bn_bytes(shape, passes) / HBM_BYTES_PER_S * 1e3
        count = sum(layers[shape].values())
        for e, n in layers[shape].items():
            step["kernel"] += n * (fwd[e] + bwd[e])
            step["separate"] += n * (fwd_sep[e] + bwd_sep[e])
            step["bound"] += n * ms(1 + BN_APPLY_PASSES[e] + BN_BWD_PASSES)
        step["moments"] += count * moments_ms
        step["composite"] += count * comp_ms
        step["plain"] += count * plain_ms
        model_layers = ", ".join(f"{n} {e}" for e, n in layers[shape].items())
        log(f"[time] batch norm {'x'.join(map(str, shape))} ({model_layers} of ResNet-50's "
            f"layers): torch.var_mean {moments_ms:.4f} ms (bound {ms(1):.4f}); "
            + "; ".join(
                f"forward {e} {fwd[e]:.4f} ms, the apply {fwd[e] - moments_ms:.4f} (bound "
                f"{ms(BN_APPLY_PASSES[e]):.4f}, {BN_APPLY_PASSES[e]} passes, "
                f"{ms(BN_APPLY_PASSES[e]) / (fwd[e] - moments_ms):.1%}), as separate ops "
                f"{fwd_sep[e]:.4f}" for e in fbn.EPILOGUES)
            + f"; backward {bwd['none']:.4f} ms (bound {ms(BN_BWD_PASSES):.4f}, "
            f"{ms(BN_BWD_PASSES) / bwd['none']:.1%}), with relu's mask {bwd['relu']:.4f} "
            f"({ms(BN_BWD_PASSES) / bwd['relu']:.1%}; threshold_backward then the plain "
            f"kernels {bwd_sep['relu']:.4f}); composite forward {comp_fwd_ms:.4f}, forward "
            f"and autograd backward {comp_ms:.4f} ms, the plain version's {plain_ms:.4f} "
            f"(CUDA events around replayed graphs of calls) ({smi})")
        del x, y, dy, grads, want, want_y, again, leaves, residual, relu_out, res
        torch.cuda.empty_cache()
    log(f"[time] batch norm over ResNet-50's 53 layers at batch 32 with their epilogues, "
        f"forward and backward: {step['kernel']:.4f} ms a step (bound {step['bound']:.4f} ms by "
        f"bytes, {step['bound'] / step['kernel']:.1%}; of it torch.var_mean "
        f"{step['moments']:.4f} ms, the kernels and add_relu's threshold_backward "
        f"{step['kernel'] - step['moments']:.4f} ms); the epilogues as separate torch ops "
        f"{step['separate']:.4f} ms (saved {step['separate'] - step['kernel']:.4f}); composite "
        f"{step['composite']:.4f} ms, plain {step['plain']:.4f} ms ({smi})")

    config = resnet_preset("resnet50", 257, antisymmetric_mid=True, image_shape=(224, 224, 3))
    model = build_resnet(config, generator=torch.Generator().manual_seed(0), device="cuda")
    images, labels = image_batch(np.random.default_rng(17), 32, 224, 257)
    train = make_train_step(model, make_adam(model.parameters()))
    reset_counts()
    metrics, _ = train(images.cuda(), labels.cuda(), LR)
    torch.cuda.synchronize()
    launches = STACKS.launches("BN")
    variants = {v: STACKS.calls("BN", v) for v in BN_RESNET50_VARIANTS}
    ok = (launches == 53 * BN_LAUNCHES_A_LAYER and variants == BN_RESNET50_VARIANTS
          and math.isfinite(float(metrics["loss"])))
    log(f"[bn] {describe_resnet(config)}: one eager train step at batch 32 launched {launches} "
        f"batch-norm kernels (want 53 x {BN_LAUNCHES_A_LAYER}), calls by variant {variants} "
        f"(want {BN_RESNET50_VARIANTS}), loss {float(metrics['loss']):.4f}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ResNet-50's train step did not take the batch-norm kernels with "
                             "their epilogues")
    del model, train
    torch.cuda.empty_cache()
    log(f"[bn] batch-norm phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    return {"name": "batch_norm", "route": "cuda",
            "source": "differential_equations_resnet_tpu_torch/csrc/batch_norm.cu",
            "replaces": None, "max_abs_err": worst, "ms": step["kernel"],
            "plain_ms": step["plain"], "bound_ms": step["bound"], "bound_by": "bytes",
            "composite_ms": step["composite"], "library_ms": None, "launches": launches}


def cifar_arrays():
    """Synthetic CIFAR-10 of the real size and dtype: (train images,
    train labels, val images, val labels)."""
    t0 = time.perf_counter()
    train_x, train_y, val_x, val_y, _ = synthetic_cifar10(50000, 10000, seed=0)
    log(f"[harness] synthetic_cifar10(50000, 10000, seed=0): {train_x.nbytes + val_x.nbytes} bytes "
        f"of uint8 images, made in {time.perf_counter() - t0:.1f} s")
    return train_x, train_y, val_x, val_y


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def elapsed(after):
        log(f"[time] {time.perf_counter() - t_start:.1f} s since the start, after {after}")

    smi = phase_device()
    phase_build()
    phase_plan()
    fwd_err = phase_kernels()
    bwd_err = phase_kernels_bwd()
    wide_errs = phase_kernels_wide()
    phase_kernels_wrn()
    serve_launches, predict, requests = phase_serve()
    with tempfile.TemporaryDirectory() as tmp:
        paths_fwd, paths_wide_fwd = phase_serve_paths(tmp, smi)
    (train_fwd, train_bwd), step, batch = phase_train(smi)
    fwd_timing = phase_time_kernel()
    bwd_timing = phase_time_bwd()
    phase_time_requests(predict, requests)
    phase_time_train(step, batch)
    phase_profile(step, batch)
    phase_deterministic(smi)
    elapsed('the kernels, serving, training and their timing')
    arrays = cifar_arrays()
    harness_fwd, harness_bwd = phase_harness(smi, arrays)
    check_compile_cache()
    elapsed('the harness')
    types_fwd, types_bwd = phase_kernel_types(smi)
    wide_band_fwd, wide_band_bwd, wide_only_fwd, wide_only_bwd = phase_wide(smi)
    wide_timing = phase_time_wide(smi)
    phase_time_narrow(smi)
    epochs_fwd, epochs_bwd = phase_epochs(smi, arrays)
    elapsed('the kernel types, the wide phase and the epochs')
    phase_bf16(smi)
    elapsed('bf16')
    with tempfile.TemporaryDirectory() as tmp:
        phase_subcommands(tmp, smi)
        phase_bottleneck(tmp, smi)
        bn_kernel = phase_batch_norm(smi)
        phase_int8_ops(smi)
        phase_int8_serve(tmp, smi)
        elapsed('the subcommands, the bottleneck family, batch norm, int8 ops and serving')
    phase_int8_train(smi)
    phase_s2d(smi)
    elapsed('int8 training and s2d')
    with tempfile.TemporaryDirectory() as tmp:
        records_launches = phase_records(tmp, smi)
    mnist_fwd, mnist_bwd = phase_mnist(smi)
    elapsed('records and MNIST')
    with tempfile.TemporaryDirectory() as tmp:
        ex_fwd, ex_bwd, ex_wide_fwd, ex_wide_bwd = phase_examples(tmp, smi)
        elapsed('the examples')
    mesh_fwd, mesh_bwd = phase_mesh(smi, arrays)
    elapsed('the meshes')
    source = "differential_equations_resnet_tpu_torch/csrc/"
    replaces = "differential_equations_resnet_tpu/ops/pallas/fused_integrator.py:"
    kernels = [
        {"name": "fused_euler_fwd", "route": "cuda", "source": source + "fused_euler_fwd.cu",
         "replaces": replaces + "146",
         "launches": (serve_launches + paths_fwd + train_fwd + harness_fwd + types_fwd
                      + epochs_fwd + wide_band_fwd + records_launches[0] + mnist_fwd + ex_fwd
                      + mesh_fwd),
         "max_abs_err": fwd_err, **fwd_timing, "library_ms": None},
        {"name": "fused_euler_bwd", "route": "cuda", "source": source + "fused_euler_bwd.cu",
         "replaces": replaces + "216",
         "launches": (train_bwd + harness_bwd + types_bwd + epochs_bwd + wide_band_bwd
                      + records_launches[1] + mnist_bwd + ex_bwd + mesh_bwd),
         "max_abs_err": bwd_err, **bwd_timing, "library_ms": None},
        {"name": "fused_euler_fwd_wide", "route": "cuda", "source": source + "fused_euler_wide.cu",
         "replaces": replaces + "146", "launches": wide_only_fwd + paths_wide_fwd + ex_wide_fwd,
         "max_abs_err": wide_errs["fused_euler_fwd_wide"],
         **wide_timing["fused_euler_fwd_wide"], "library_ms": None},
        {"name": "fused_euler_bwd_wide", "route": "cuda", "source": source + "fused_euler_wide.cu",
         "replaces": replaces + "216", "launches": wide_only_bwd + ex_wide_bwd,
         "max_abs_err": wide_errs["fused_euler_bwd_wide"],
         **wide_timing["fused_euler_bwd_wide"], "library_ms": None},
        bn_kernel,
    ]
    log(f"[device] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
