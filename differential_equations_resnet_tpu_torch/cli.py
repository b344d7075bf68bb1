"""Command-line interface of the port.

Port of `differential_equations_resnet_tpu/cli.py`, with the same flags and
defaults:

    train            headline CIFAR-10 single-block runs (v7 notebook cells 1-8)
    evaluate         restore a checkpoint and evaluate
    predict          batch inference from a .npy array or an image directory
    benchmark        train steps/s + batch-1 inference latency (v7 cells 19-25)
    analyze          TrainingHistory gradient-flow diagnostics (v7 cell 27)
    deep-stability   100-step gamma sweep + conv-matrix eigenvalue check
    sweep            width x depth train-throughput grid
    reproduce        the reference's three published 64-layer runs
    export           serving export (config + params) of a model or checkpoint
    convert-records  image directory tree -> sharded binary records
    fetch-cifar10    download, sha256-verify and extract CIFAR-10

    python -m differential_equations_resnet_tpu_torch.cli train --num-layers 64 --epochs 1

``--device {cuda,cpu}`` (default cuda) picks where the model runs, as
``JAX_PLATFORMS`` does for the JAX package.  Both model families run:
``--model single_block`` with every kernel type, kernel size and
integrator, and ``--model resnet50|resnet101|resnet152`` (with
``--resnet-version``, ``--image-size``, ``--num-classes`` and ``--gamma``;
``--kernel-type antisymmetric`` gives the antisymmetric mid-convs), in every
subcommand that builds a model, in fp32 or, with ``--bf16``, in bf16
compute, and with ``--int8-forward`` (``--int8-backward
ste|dgrad|wgrad|full``) with int8 forward convs; ``export --int8`` writes an
export that `utils.serving.load_exported` serves with int8 convs.
``predict`` on an image directory decodes
each image (Pillow) and resizes it to the model's input as the JAX CLI does.
The MFU that ``benchmark`` and ``sweep`` print is against the card's peak
for the compute dtype (``mfu_vs_fp32_peak``, or ``mfu_vs_bf16_peak`` with
``--bf16``), where the JAX package prints it against a TPU's bf16 peak.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--model",
        choices=["single_block", "resnet50", "resnet101", "resnet152"],
        default="single_block",
        help="single-block ODE-ResNet (v7 notebook) or a bottleneck preset (v6 notebook's "
             "Caltech-256 ResNet-50 workflow)",
    )
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--resnet-version", type=float, default=1, choices=[1, 1.5],
                   help="bottleneck striding variant")
    p.add_argument("--num-layers", type=int, default=64)
    p.add_argument("--num-filters", type=int, default=16)
    p.add_argument("--final-time", type=float, default=8.0)
    p.add_argument("--gamma", type=float, default=0.0)
    p.add_argument("--kernel-type", choices=["antisymmetric", "regular", "centrosymmetric"],
                   default="antisymmetric",
                   help="centrosymmetric = the reference general layer's antisymmetric=False "
                        "mode (trainable center, any odd --kernel-size)")
    p.add_argument("--kernel-size", type=int, default=3,
                   help="spatial kernel size (centrosymmetric/regular only; the antisymmetric "
                        "path is 3x3-specialized)")
    p.add_argument("--integrator", choices=["euler", "midpoint", "rk4"], default="euler")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--use-pallas", action="store_true",
                   help="every fp32 antisymmetric Euler 3x3 stack within the JAX kernel gate's "
                        "reach (C <= 128, H*W <= 4096) runs on the hand-written kernels B1/B2, "
                        "as the JAX package runs it on its Pallas kernel")
    p.add_argument("--s2d-block", type=int, default=2,
                   help="space-to-depth block of the per-layer route; it packs only with the "
                        "config's s2d_force or s2d_max_rows, which no flag sets, so it stays off")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (every layer on cuDNN; parameters stay fp32)")
    p.add_argument("--int8-forward", action="store_true",
                   help="dynamic-w8a8 int8 forward convs in the trunk (single-block identity "
                        "stacks; bottleneck blocks of mid width >= 256)")
    p.add_argument("--int8-backward", choices=["ste", "dgrad", "wgrad", "full"], default="ste",
                   help="with --int8-forward: 'ste' fp backward; 'wgrad' the weight gradient "
                        "in int8 from int8 saved activations; 'dgrad'/'full' also quantize the "
                        "residual-stream cotangent (diverged in training in the JAX package's "
                        "measurements)")
    _add_device_arg(p)


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs (default cuda)")


def _build_model(args):
    """The model of the flags, drawn from seed 0 on ``--device``."""
    import torch

    from differential_equations_resnet_tpu_torch.models import (
        build_resnet,
        build_single_block_resnet,
        cifar10_single_block_config,
        resnet_preset,
    )

    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    generator = torch.Generator().manual_seed(0)
    if args.model != "single_block":
        config = resnet_preset(
            args.model,
            num_classes=args.num_classes,
            antisymmetric_mid=args.kernel_type == "antisymmetric",
            image_shape=(args.image_size, args.image_size, 3),
            version=args.resnet_version,
            gamma=args.gamma,
            compute_dtype=compute_dtype,
            int8_forward=args.int8_forward,
            int8_backward=args.int8_backward,
        )
        return build_resnet(config, generator=generator, device=args.device)
    config = cifar10_single_block_config(
        num_layers=args.num_layers,
        final_time=args.final_time,
        num_filters=args.num_filters,
        kernel_type=args.kernel_type,
        kernel_size=args.kernel_size,
        gamma=args.gamma,
        integrator=args.integrator,
        remat=args.remat,
        use_pallas=args.use_pallas,
        s2d_block=args.s2d_block,
        compute_dtype=compute_dtype,
        int8_forward=args.int8_forward,
        int8_backward=args.int8_backward,
    )
    return build_single_block_resnet(config, generator=generator, device=args.device)


def _load_data(args):
    from differential_equations_resnet_tpu_torch.data.cifar10 import (
        build_cifar10_dataset,
        find_cifar10_directory,
        synthetic_cifar10,
    )

    cifar_dir = getattr(args, "cifar10_dir", None) or find_cifar10_directory()
    if cifar_dir:
        print(f"# loading CIFAR-10 from {cifar_dir}", file=sys.stderr)
        return build_cifar10_dataset(cifar_dir)
    print("# CIFAR-10 not found on disk; using synthetic data", file=sys.stderr)
    return synthetic_cifar10(
        num_train=getattr(args, "synthetic_train_size", None) or 50000,
        num_test=getattr(args, "synthetic_val_size", None) or 10000,
    )


def cmd_train(args) -> int:
    from differential_equations_resnet_tpu_torch.train import (
        Checkpointer,
        Training,
        linear_warmup_schedule,
    )

    model = _build_model(args)
    train_x, train_y, test_x, test_y, _ = _load_data(args)
    trainer = Training(
        model,
        train_features=train_x,
        train_labels=train_y,
        val_features=test_x,
        val_labels=test_y,
        batch_size=args.batch_size,
        csv_logger_dir=args.csv_dir,
        csv_logger_name=f"single_block_{args.kernel_type}_{args.num_layers}-layers_{args.num_filters}-filters",
        summaries_dir=args.summaries_dir,
        accum_steps=args.accum_steps,
    )
    if args.resume:
        if not args.save_dir:
            raise SystemExit("--resume requires --save-dir")
        checkpointer = Checkpointer(args.save_dir)
        latest = checkpointer.latest()
        if latest is not None:
            ckpt_path = os.path.join(args.save_dir, latest)
            trainer.load_variables(ckpt_path)
            # Restore the best-metric watermark, from the sidecar or, for a
            # checkpoint without one, from the metric-encoded name.
            meta = checkpointer.read_meta(ckpt_path)
            if meta and meta.get("metrics"):
                metrics = meta["metrics"]
                if "loss" in metrics:
                    trainer.best_metrics["loss"] = float(metrics["loss"])
                if "accuracy" in metrics:
                    trainer.best_metrics["accuracy"] = float(metrics["accuracy"])
            else:
                m = re.search(r"loss-([0-9.eE+-]+)_accuracy-([0-9.eE+-]+)", latest)
                if m:
                    trainer.best_metrics["loss"] = float(m.group(1))
                    trainer.best_metrics["accuracy"] = float(m.group(2))
            print(f"# resumed from {latest} at step {trainer.global_step}", file=sys.stderr)
        else:
            print("# --resume: no checkpoint found, starting fresh", file=sys.stderr)
    steps_per_epoch = args.steps_per_epoch or ((len(train_x) + args.batch_size - 1) // args.batch_size)
    if args.device_data:
        # A device-resident epoch draws without replacement: at most the dataset.
        steps_per_epoch = min(steps_per_epoch, len(train_x) // args.batch_size)
    trainer.train(
        epochs=args.epochs,
        steps_per_epoch=steps_per_epoch,
        learning_rate_schedule=linear_warmup_schedule(args.learning_rate, args.warmup_steps),
        eval_dataset=args.eval_dataset,
        eval_steps=args.eval_steps,
        save_during_training=args.save_dir is not None,
        save_dir=args.save_dir,
        monitor=args.monitor,
        summaries_frequency=args.summaries_frequency,
        scan_steps=args.scan_steps,
        device_data=args.device_data,
        save_frequency=args.save_frequency,
    )
    print(json.dumps({"best": trainer.best_metrics}))
    trainer.close()
    return 0


def cmd_evaluate(args) -> int:
    from differential_equations_resnet_tpu_torch.train import Training

    model = _build_model(args)
    _, _, test_x, test_y, _ = _load_data(args)
    trainer = Training(model, val_features=test_x, val_labels=test_y,
                       batch_size=args.batch_size, record_summaries=False)
    if args.checkpoint:
        trainer.load_variables(args.checkpoint)
    if args.device_data:
        print(json.dumps(trainer.evaluate("val", device_data=True)))
        return 0
    steps = (len(test_x) + args.batch_size - 1) // args.batch_size
    print(json.dumps(trainer.evaluate("val", num_steps=steps)))
    return 0


def cmd_predict(args) -> int:
    """Batch inference: images (a .npy array, or a directory of JPEG/PNG
    images decoded and resized bilinearly to the model's input) -> class
    probabilities."""
    import numpy as np

    from differential_equations_resnet_tpu_torch.train import Training

    model = _build_model(args)
    trainer = Training(model, batch_size=args.batch_size, record_summaries=False)
    if args.checkpoint:
        trainer.load_variables(args.checkpoint)
    if args.input.endswith(".npy"):
        images = np.load(args.input)
    else:
        from differential_equations_resnet_tpu_torch.data.preprocessors import (
            _decode_image_bytes,
            resize_bilinear,
        )
        from differential_equations_resnet_tpu_torch.data.records import get_image_paths

        size = model.config.image_shape[:2]
        images = []
        for path in get_image_paths([args.input]):
            with open(path, "rb") as f:
                images.append(resize_bilinear(_decode_image_bytes(f.read(), 3), size))
        images = np.stack(images)
    if images.ndim == 3:
        images = images[None]
    probs = trainer.predict(images.astype(np.float32))
    if args.output:
        np.save(args.output, probs)
        print(f"# wrote {probs.shape} -> {args.output}", file=sys.stderr)
    print(json.dumps({
        "num_images": int(len(probs)),
        "predictions": np.argmax(probs, axis=-1)[:32].tolist(),
        "max_prob_mean": float(np.max(probs, axis=-1).mean()),
    }))
    return 0


def cmd_benchmark(args) -> int:
    """Train steps/s and batch-1 inference latency (the reference's
    wall-clock and FPS micro-benchmarks), with model TFLOP/s and MFU against
    the card's peak for the compute dtype (fp32, or bf16 with ``--bf16``).  Every train step and every batch-1 forward is a
    replay of one captured CUDA graph on the card; each timed region ends in
    a read of a value of its last call.  ``--scan-steps`` is accepted and
    changes nothing.  ``--profile-dir`` writes a `torch.profiler` chrome
    trace of the timed train steps."""
    import numpy as np
    import torch

    from differential_equations_resnet_tpu_torch.train import (
        make_adam,
        make_multi_step,
        make_predict_step,
    )
    from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
        compute_dtype_of,
    )
    from differential_equations_resnet_tpu_torch.utils.flops import mfu, peak_of, train_flops

    model = _build_model(args)
    device = next(model.parameters()).device
    multi = make_multi_step(model, make_adam(model.parameters()))
    rng = np.random.default_rng(0)
    image_shape = tuple(model.config.image_shape)
    x = torch.from_numpy(
        rng.uniform(0, 255, (args.batch_size,) + image_shape).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, model.config.num_classes, (args.batch_size,))).to(device)

    def train(n):
        metrics, _ = multi(x.expand(n, *x.shape), y.expand(n, *y.shape), [1e-3] * n)
        return float(metrics["loss"][-1])  # waits for the last step

    train(5)
    profiling = contextlib.nullcontext()
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        profiling = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
    with profiling as profiler:
        t0 = time.perf_counter()
        train(args.steps)
        train_sps = args.steps / (time.perf_counter() - t0)
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile_dir, "benchmark.trace.json"))

    predict = make_predict_step(model)
    x1 = x[:1]
    float(predict(x1)[0, 0])
    t0 = time.perf_counter()
    for _ in range(100):
        out = predict(x1)
    float(out[0, 0])  # waits for the last forward
    latency_ms = (time.perf_counter() - t0) / 100 * 1e3

    flops_step = train_flops(model.config, args.batch_size)
    peak_name, peak = peak_of(compute_dtype_of(model.config))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({
        "train_steps_per_sec": round(train_sps, 3),
        "train_img_per_sec": round(train_sps * args.batch_size, 1),
        "inference_latency_batch1_ms": round(latency_ms, 4),
        "inference_fps_batch1": round(1e3 / latency_ms, 1),
        "device": f"{device}: {name}",
        "model_flops_per_step": flops_step,
        "model_tflops": round(flops_step * train_sps / 1e12, 2),
        f"mfu_vs_{peak_name}_peak": round(mfu(flops_step, train_sps, peak), 4),
    }))
    return 0


def cmd_deep_stability(args) -> int:
    """The deep-stability configuration (BASELINE.md): a gamma sweep on the
    100-Euler-step model and the conv-matrix eigenvalue check."""
    import torch

    from differential_equations_resnet_tpu_torch.experiments import (
        conv_matrix_spectrum,
        gamma_sweep,
    )
    from differential_equations_resnet_tpu_torch.ops.antisymmetric import init_antisym_3x3

    gammas = [float(g) for g in args.gammas.split(",")]
    sweep = gamma_sweep(gammas=gammas, num_layers=args.num_layers, num_filters=args.num_filters,
                        train_steps=args.steps, device=args.device)
    spectrum = conv_matrix_spectrum(
        init_antisym_3x3(torch.Generator().manual_seed(0), args.num_filters),
        gamma=gammas[-1], height=args.grid, width=args.grid,
    )
    print(json.dumps({
        "gamma_sweep": {str(k): v for k, v in sweep.items()},
        "spectrum": {
            "gamma": gammas[-1],
            "real_part_error": float(spectrum["real_part_error"]),
            "antisymmetry_defect": float(spectrum["antisymmetry_defect"]),
        },
    }))
    return 0


def cmd_sweep(args) -> int:
    """Width x depth train-throughput sweep."""
    import torch

    from differential_equations_resnet_tpu_torch.experiments import width_depth_sweep

    results = width_depth_sweep(
        widths=[int(w) for w in args.widths.split(",")],
        depths=[int(d) for d in args.depths.split(",")],
        batch_size=args.batch_size,
        num_classes=args.num_classes,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        steps=args.steps,
        kernel_type=args.kernel_type,
        remat=args.remat,
        device=args.device,
    )
    print(json.dumps({f"{w}x{d}": v for (w, d), v in results.items()}))
    return 0


# The three published reference configs with their best-val-accuracy baselines
# (BASELINE.md rows 1-3) and the gradient-flow diagnostic baselines
# (BASELINE.md rows 6-8; v7 notebook cells 30/34/38).  A copy of the JAX
# package's table.
REFERENCE_RUNS = (
    ("antisymmetric", 16, 0.5526,
     {"relative_deviation": 1.1399, "standard_deviation": 1.25e-4,
      "last_first_ratio": 2.742}),
    ("regular", 16, 0.6047,
     {"relative_deviation": 1.0606, "standard_deviation": 2.4e-5,
      "last_first_ratio": 1.243}),
    ("regular", 8, 0.4954,
     {"relative_deviation": 1.1016, "standard_deviation": 1.51e-4,
      "last_first_ratio": 1.428}),
)


def _gradient_flow_vs_baseline(csv_dir, run_name, grad_baseline):
    """The three gradient-flow diagnostics of the run's newest training CSV
    beside the reference's published values; ``measured`` is None where the
    CSV has no telemetry row.  Comparable only for real-data, full-length
    runs."""
    import glob

    from differential_equations_resnet_tpu_torch.train import TrainingHistory

    csvs = sorted(glob.glob(os.path.join(csv_dir, f"{run_name}*training*.csv")),
                  key=os.path.getmtime)
    measured = None
    if csvs:
        try:
            measured = _gradient_flow_diagnostics(
                TrainingHistory(training_history_filepath=csvs[-1]))
        except ValueError:  # no telemetry rows (a run shorter than summaries_frequency)
            pass
    return {"measured": measured, "baseline": grad_baseline}


def cmd_reproduce(args) -> int:
    """The reference's three 21-epoch CIFAR-10 runs (64 layers, h = 8/64,
    batch 32, Adam lr 1e-3, no augmentation) through `Training`, each
    reported beside its published best val accuracy (the +-0.5% criterion)
    and gradient-flow diagnostics.  It never downloads CIFAR-10: without it
    on disk it exits unless ``--synthetic`` asks for a pipeline smoke run."""
    import torch

    from differential_equations_resnet_tpu_torch.data.cifar10 import (
        build_cifar10_dataset,
        find_cifar10_directory,
        synthetic_cifar10,
    )
    from differential_equations_resnet_tpu_torch.models import (
        build_single_block_resnet,
        cifar10_single_block_config,
    )
    from differential_equations_resnet_tpu_torch.train import Training

    cifar_dir = args.cifar10_dir or find_cifar10_directory()
    if cifar_dir is None and not args.synthetic:
        raise SystemExit(
            "CIFAR-10 was not found on disk (pass --cifar10-dir); the port does not download "
            "it.\nReal CIFAR-10 is required for a reproduction run; pass --synthetic only for "
            "pipeline smoke-testing."
        )
    if cifar_dir:
        print(f"# loading CIFAR-10 from {cifar_dir}", file=sys.stderr)
        train_x, train_y, test_x, test_y, _ = build_cifar10_dataset(cifar_dir)
        data_kind = "real"
    else:
        print("# SYNTHETIC data: results will NOT match the baselines", file=sys.stderr)
        train_x, train_y, test_x, test_y, _ = synthetic_cifar10(
            num_train=args.synthetic_train_size or 50000,
            num_test=args.synthetic_val_size or 10000,
        )
        data_kind = "synthetic"

    batch = 32
    steps_per_epoch = args.steps_per_epoch or (len(train_x) + batch - 1) // batch
    if args.device_data:
        steps_per_epoch = min(steps_per_epoch, len(train_x) // batch)
    eval_steps = (len(test_x) + batch - 1) // batch
    os.makedirs(args.csv_dir, exist_ok=True)

    results = []
    runs = [r for r in REFERENCE_RUNS if args.only is None or f"{r[0]}_{r[1]}" == args.only]
    for kernel_type, num_filters, baseline, grad_baseline in runs:
        name = f"single_block_{kernel_type}_64-layers_{num_filters}-filters"
        print(f"# === {name} (baseline best val acc {baseline}) ===", file=sys.stderr)
        config = cifar10_single_block_config(
            num_layers=64, final_time=8.0, num_filters=num_filters, kernel_type=kernel_type)
        model = build_single_block_resnet(
            config, generator=torch.Generator().manual_seed(0), device=args.device)
        trainer = Training(
            model,
            train_features=train_x, train_labels=train_y,
            val_features=test_x, val_labels=test_y,
            batch_size=batch,
            csv_logger_dir=args.csv_dir,
            csv_logger_name=name,
        )
        trainer.train(
            epochs=args.epochs,
            steps_per_epoch=steps_per_epoch,
            learning_rate_schedule=lambda step: 1e-3,
            eval_steps=eval_steps,
            summaries_frequency=args.summaries_frequency,
            scan_steps=args.scan_steps,
            device_data=args.device_data,
            save_during_training=args.save_dir is not None,
            save_dir=os.path.join(args.save_dir, name) if args.save_dir else None,
            monitor="loss",
        )
        best_acc = trainer.best_metrics["accuracy"]
        delta = best_acc - baseline
        results.append({
            "run": name,
            "data": data_kind,
            "best_val_accuracy": best_acc,
            "best_val_loss": trainer.best_metrics["loss"],
            "baseline_accuracy": baseline,
            "delta": delta,
            "within_half_percent": bool(abs(delta) <= 0.005 or delta > 0),
            "gradient_flow": _gradient_flow_vs_baseline(args.csv_dir, name, grad_baseline),
        })
        trainer.close()
        print(json.dumps(results[-1]), file=sys.stderr)
    print(json.dumps({"data": data_kind, "runs": results}))
    return 0


def cmd_export(args) -> int:
    """Serving export: the model's config and parameters (from
    ``--checkpoint`` when given, else its seeded init) and, unless
    ``--no-stablehlo``, ``forward.pt2``: the eval forward at
    ``--batch-size`` traced by `torch.export` (the counterpart of the JAX
    package's StableHLO artifact; `utils.serving`).  ``--int8`` exports
    for int8 serving."""
    from differential_equations_resnet_tpu_torch.utils.serving import export_model

    model = _build_model(args)
    path = export_model(model, args.output, checkpoint=args.checkpoint,
                        batch_size=args.batch_size, stablehlo=not args.no_stablehlo,
                        quantize="int8" if args.int8 else None)
    print(json.dumps({"export_dir": path}))
    return 0


def cmd_convert_records(args) -> int:
    from differential_equations_resnet_tpu_torch.data.records import RecordGenerator

    RecordGenerator().convert(
        input_directory=args.input,
        output_directory=args.output,
        prefix=args.prefix,
        num_files_per_record=args.shard_size,
        train_val_split=args.val_split,
        store_raw_arrays=args.raw,
    )
    return 0


def cmd_fetch_cifar10(args) -> int:
    from differential_equations_resnet_tpu_torch.data.cifar10 import fetch_cifar10

    path = fetch_cifar10(args.dest, verify=not args.no_verify)
    print(json.dumps({"cifar10_dir": path}))
    return 0


def _gradient_flow_diagnostics(th):
    """The reference's three gradient-flow diagnostics (v7 notebook cells
    30/34/38) from a TrainingHistory."""
    return {
        "relative_deviation": float(th.gradient_norm_relative_deviation()),
        "standard_deviation": float(th.gradient_norm_standard_deviation()),
        "last_first_ratio": float(th.gradient_norm_relative_comparison()),
    }


def cmd_analyze(args) -> int:
    from differential_equations_resnet_tpu_torch.train import TrainingHistory

    th = TrainingHistory(training_history_filepath=args.training_csv,
                         evaluation_history_filepath=args.evaluation_csv)
    out = {f"gradient_norm_{k}": v for k, v in _gradient_flow_diagnostics(th).items()}
    if args.evaluation_csv:
        out["best_val_accuracy"] = float(th.evaluation_accuracy.max())
        out["best_val_mean_loss"] = float(th.evaluation_mean_loss.min())
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="deqres-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train")
    _add_model_args(p)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--eval-steps", type=int, default=None,
                   help="evaluation batches per eval (default: one full pass)")
    p.add_argument("--eval-dataset", choices=["train", "val"], default="val")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--accum-steps", type=int, default=1,
                   help="split each batch into this many microbatches and apply one "
                        "averaged update (the monolithic step's numerics)")
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear lr warmup over this many steps (0 = off)")
    p.add_argument("--cifar10-dir", default=None)
    p.add_argument("--synthetic-train-size", type=int, default=None,
                   help="synthetic-fallback dataset size (default 50000)")
    p.add_argument("--synthetic-val-size", type=int, default=None)
    p.add_argument("--csv-dir", default="./local/csv_logger")
    p.add_argument("--summaries-dir", default=None)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--monitor", choices=["loss", "accuracy"], default="loss")
    p.add_argument("--summaries-frequency", type=int, default=10)
    p.add_argument("--scan-steps", type=int, default=0,
                   help="accepted as in the JAX package; changes nothing here, where "
                        "every step is already one CUDA-graph replay")
    p.add_argument("--device-data", action="store_true",
                   help="device-resident mode: upload the dataset once and run each "
                        "epoch on the device (shuffle, gather, CUDA-graph replays)")
    p.add_argument("--save-frequency", type=int, default=1,
                   help="checkpoint every N epochs (when --save-dir is set)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint in --save-dir (Adam slots "
                        "included) before training")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate")
    _add_model_args(p)
    p.add_argument("--device-data", action="store_true",
                   help="full-pass device-resident evaluation")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--cifar10-dir", default=None)
    p.add_argument("--synthetic-train-size", type=int, default=None)
    p.add_argument("--synthetic-val-size", type=int, default=None)
    p.add_argument("--checkpoint", default=None)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("predict")
    _add_model_args(p)
    p.add_argument("input", help=".npy image array (N,H,W,3) or a directory of images")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--output", default=None, help="write probabilities .npy")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("benchmark")
    _add_model_args(p)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--scan-steps", type=int, default=0,
                   help="accepted as in the JAX package; changes nothing here, where "
                        "every step is already one CUDA-graph replay")
    p.add_argument("--profile-dir", default=None)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("analyze")
    p.add_argument("training_csv")
    p.add_argument("--evaluation-csv", default=None)
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("deep-stability")
    p.add_argument("--gammas", default="0.0,0.05,0.2")
    p.add_argument("--num-layers", type=int, default=100)
    p.add_argument("--num-filters", type=int, default=8)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--grid", type=int, default=6)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_deep_stability)

    p = sub.add_parser("sweep")
    p.add_argument("--widths", default="16,32,64")
    p.add_argument("--depths", default="16,32,64")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (MFU against the bf16 peak)")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--kernel-type", choices=["antisymmetric", "regular"], default="antisymmetric")
    remat_group = p.add_mutually_exclusive_group()
    remat_group.add_argument("--remat", action="store_true", default=None, dest="remat",
                             help="rematerialize every cell's per-layer stack")
    remat_group.add_argument("--no-remat", action="store_false", dest="remat",
                             help="rematerialization off (the default)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("convert-records")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--prefix", default="")
    p.add_argument("--shard-size", type=int, default=1000)
    p.add_argument("--val-split", type=float, default=None)
    p.add_argument("--raw", action="store_true")
    p.set_defaults(fn=cmd_convert_records)

    p = sub.add_parser("fetch-cifar10",
                       help="download + sha256-verify + extract the official CIFAR-10 release "
                            "(needs network access; see fetch_cifar10 for the manual fallback)")
    p.add_argument("--dest", default="data")
    p.add_argument("--no-verify", action="store_true")
    p.set_defaults(fn=cmd_fetch_cifar10)

    p = sub.add_parser("reproduce",
                       help="run the reference's three 21-epoch CIFAR-10 configs and compare "
                            "best val accuracy to the published baselines")
    p.add_argument("--cifar10-dir", default=None)
    p.add_argument("--epochs", type=int, default=21)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--scan-steps", type=int, default=50,
                   help="accepted as in the JAX package; changes nothing here")
    p.add_argument("--device-data", action="store_true",
                   help="device-resident epochs (floor(N/batch) steps per epoch)")
    p.add_argument("--csv-dir", default="./numerical_results/csv")
    p.add_argument("--summaries-frequency", type=int, default=10,
                   help="telemetry CSV row every N steps (the reference logged every 10)")
    p.add_argument("--save-dir", default=None)
    p.add_argument("--only", default=None, choices=[f"{k}_{f}" for k, f, *_ in REFERENCE_RUNS],
                   help="run a single config, e.g. antisymmetric_16")
    p.add_argument("--synthetic", action="store_true",
                   help="allow synthetic data (pipeline smoke only)")
    p.add_argument("--synthetic-train-size", type=int, default=None,
                   help="synthetic dataset size for smoke runs")
    p.add_argument("--synthetic-val-size", type=int, default=None)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_reproduce)

    p = sub.add_parser("export", help="serving export: config + params")
    _add_model_args(p)
    p.add_argument("output", help="export directory to create")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--no-stablehlo", action="store_true",
                   help="write no forward.pt2 (the torch.export program of the forward)")
    p.add_argument("--int8", action="store_true",
                   help="serve with dynamic-w8a8 int8 convs (single-block trunks >= 128 wide, "
                        "bottleneck stages of mid width >= 256)")
    p.set_defaults(fn=cmd_export)

    args = parser.parse_args(argv)
    if getattr(args, "device", None) == "cuda":
        # The kernels' builds go to the compile cache's directory: a repeat
        # run loads them and starts no compiler.  Host-only subcommands and
        # --help never get here; DEQRES_COMPILE_CACHE=0 opts out
        # (utils/compile_cache.py).
        from differential_equations_resnet_tpu_torch.utils.compile_cache import (
            enable_compile_cache,
        )

        enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
