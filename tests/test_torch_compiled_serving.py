"""The compiled serving forward: the port's ``forward.pt2`` (`torch.export`
of the eval forward, B1 a dispatcher op in it) served on the CPU against the
JAX package's StableHLO ``forward.hlo`` on the same weights, in both
families, for every kernel type, with batch norm, midpoint, RK4 and int8;
the rebuilt path at the exported batch and at another one; the JAX
keywords of `export_model` / `load_exported` and the errors."""

import dataclasses
import gc
import json
import os
import threading
import weakref

import numpy as np
import pytest
import torch

from differential_equations_resnet_tpu.models import (
    build_single_block_resnet as jax_build,
    cifar10_single_block_config as jax_cifar10_config,
)
from differential_equations_resnet_tpu.models import bottleneck_resnet as jax_bottleneck
from differential_equations_resnet_tpu.models.single_block_resnet import (
    SingleBlockResNetConfig as JaxConfig,
)
from differential_equations_resnet_tpu.utils import serving as jax_serving
from differential_equations_resnet_tpu_torch.models import (
    build_single_block_resnet,
    cifar10_single_block_config,
)
from differential_equations_resnet_tpu_torch.utils.serving import (
    FORWARD_FILE,
    export_model,
    load_exported,
)
from torch_parity import (
    drawn_bottleneck_trees,
    jax_params_with_biases,
    narrow_bottleneck_config,
    norm_rel,
    port_model,
    with_batch_norms,
)

TOL = dict(rtol=5e-5, atol=5e-5)  # fp32 probabilities, test_torch_serving.py's bound
INT8_TOL = 1e-2  # int8 probabilities, norm-relative (test_torch_quantized_model.py's)
EXPORT_BATCH = 2


def _small(kernel_type="antisymmetric", kernel_size=3, **fields):
    """A 2-layer, 4-filter CIFAR-10 config of the JAX package."""
    return jax_cifar10_config(num_layers=2, final_time=0.25, num_filters=4,
                              kernel_type=kernel_type, kernel_size=kernel_size, s2d_block=0,
                              **fields)


def _wide_int8():
    """A single-block trunk across the 128-filter int8 gate, at 8x8."""
    return JaxConfig(image_shape=(8, 8, 3), h=0.25, num_stages=2, blocks_per_stage=(2,),
                     filters_per_block=(128,), strides=((1, 1),), num_classes=10,
                     subtract_mean=127.5, divide_by_stddev=127.5)


# (id, JAX config, quantize)
CASES = [
    ("antisymmetric", lambda: _small(), None),
    ("regular", lambda: _small("regular"), None),
    ("centrosymmetric-k3", lambda: _small("centrosymmetric"), None),
    ("centrosymmetric-k5", lambda: _small("centrosymmetric", 5), None),
    ("batch-norm", lambda: dataclasses.replace(_small(), use_batch_norm=True), None),
    ("midpoint", lambda: _small(integrator="midpoint"), None),
    ("rk4-remat", lambda: _small(integrator="rk4", remat=True), None),
    ("int8", _wide_int8, "int8"),
    ("bottleneck-v1", lambda: narrow_bottleneck_config(1, True), None),
    ("bottleneck-v1.5-regular", lambda: narrow_bottleneck_config(1.5, False), None),
]


def images(batch, size, seed):
    return np.random.default_rng(seed).uniform(0, 255, (batch, size, size, 3)).astype(np.float32)


def jax_trees(config, seed):
    if hasattr(config, "version"):
        return drawn_bottleneck_trees(config, seed)
    params, state = jax_params_with_biases(jax_build(config), seed)
    return (with_batch_norms(params, state, seed) if config.use_batch_norm
            else (params, state))


def close(got, want, quantize):
    if quantize == "int8":
        assert norm_rel(got, want) <= INT8_TOL
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name,make_config,quantize", CASES, ids=[c[0] for c in CASES])
def test_compiled_forward_matches_jax_stablehlo(tmp_path, name, make_config, quantize):
    """The same weights exported by both packages at batch 2: the port's
    forward.pt2 served on the CPU against JAX `load_exported` on its
    forward.hlo; the rebuilt path (``prefer_stablehlo=False``) against JAX's
    at batch 2 and at batch 3."""
    config = make_config()
    params, state = jax_trees(config, 61)
    build = jax_bottleneck.build_resnet if hasattr(config, "version") else jax_build
    jax_dir = jax_serving.export_model(build(config), str(tmp_path / "jax"), params=params,
                                       model_state=state, batch_size=EXPORT_BATCH,
                                       quantize=quantize)
    assert os.path.isfile(os.path.join(jax_dir, "forward.hlo"))
    model = port_model(config, params, state)
    port_dir = export_model(model, str(tmp_path / "port"), batch_size=EXPORT_BATCH,
                            quantize=quantize)
    assert os.path.isfile(os.path.join(port_dir, FORWARD_FILE))
    size = config.image_shape[0]
    x, other = images(EXPORT_BATCH, size, 62), images(3, size, 63)

    want = np.asarray(jax_serving.load_exported(jax_dir)[0](x))
    compiled, manifest = load_exported(port_dir, device="cpu")
    close(compiled(x), want, quantize)
    assert compiled.routes == {"compiled": 1, "rebuilt": 0}
    assert manifest["quantize"] == quantize

    jax_rebuilt = jax_serving.load_exported(jax_dir, prefer_stablehlo=False)[0]
    rebuilt, _ = load_exported(port_dir, prefer_stablehlo=False, device="cpu")
    close(rebuilt(x), want, quantize)
    close(rebuilt(other), np.asarray(jax_rebuilt(other)), quantize)
    assert rebuilt.routes == {"compiled": 0, "rebuilt": 2}
    # Another batch size from the compiled export takes the rebuilt path.
    close(compiled(other), np.asarray(jax_rebuilt(other)), quantize)
    assert compiled.routes == {"compiled": 1, "rebuilt": 1}


def test_fused_program_calls_b1_and_is_exact(tmp_path):
    """A fused-route stack's forward.pt2 holds one call of B1's op, and on
    the CPU it answers bit for bit as the model does."""
    model = build_single_block_resnet(cifar10_single_block_config(num_layers=3, num_filters=8),
                                      generator=torch.Generator().manual_seed(5), device="cpu")
    export_dir = export_model(model, str(tmp_path / "e"), batch_size=4)
    program = torch.export.load(os.path.join(export_dir, FORWARD_FILE))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("deqres_torch.fused_euler_fwd.default") == 1
    x = images(4, 32, 6)
    predict, _ = load_exported(export_dir, device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(predict(x), model(torch.from_numpy(x)).numpy())


def test_export_takes_the_jax_keywords(tmp_path):
    """``params`` / ``model_state`` are loaded into the model and win over a
    checkpoint; ``seed`` is accepted and changes nothing; ``stablehlo=False``
    writes no forward.pt2."""
    config = cifar10_single_block_config(num_layers=2, num_filters=4)
    model = build_single_block_resnet(config, generator=torch.Generator().manual_seed(0),
                                      device="cpu")
    other = build_single_block_resnet(config, generator=torch.Generator().manual_seed(1),
                                      device="cpu")
    out = export_model(model, str(tmp_path / "a"), checkpoint=str(tmp_path / "missing"),
                       params=other.params(), model_state=other.state(), batch_size=2,
                       stablehlo=False, seed=123)
    assert not os.path.exists(os.path.join(out, FORWARD_FILE))
    x = images(2, 32, 7)
    with torch.no_grad():
        want = other(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(load_exported(out, device="cpu")[0](x), want)
    seeded = export_model(other, str(tmp_path / "b"), batch_size=2, seed=7)
    np.testing.assert_array_equal(load_exported(seeded, device="cpu")[0](x), want)


def test_corrupt_program_raises(tmp_path):
    """A forward.pt2 that is there and preferred but does not load raises;
    nothing falls back.  ``prefer_stablehlo=False`` serves the rebuilt
    model from the same directory."""
    model = build_single_block_resnet(cifar10_single_block_config(num_layers=2, num_filters=4),
                                      generator=torch.Generator().manual_seed(3), device="cpu")
    export_dir = export_model(model, str(tmp_path / "e"), batch_size=2)
    with open(os.path.join(export_dir, FORWARD_FILE), "wb") as f:
        f.write(b"not a program")
    with pytest.raises(RuntimeError, match="does not load"):
        load_exported(export_dir, device="cpu")
    predict, _ = load_exported(export_dir, prefer_stablehlo=False, device="cpu")
    assert predict(images(2, 32, 4)).shape == (2, 10)


def test_program_exported_on_the_cpu_moves_to_the_requested_device(tmp_path, monkeypatch):
    """`load_program` moves the loaded program to the device asked for (an
    export made on the CPU serves on the card): on the CPU, the meta device
    stands in for the card, and every tensor of the moved program lies
    there."""
    from differential_equations_resnet_tpu_torch.utils import serving

    model = build_single_block_resnet(cifar10_single_block_config(num_layers=2, num_filters=4),
                                      generator=torch.Generator().manual_seed(8), device="cpu")
    export_dir = export_model(model, str(tmp_path / "e"), batch_size=2)
    moved = serving.load_program(os.path.join(export_dir, FORWARD_FILE), torch.device("meta"))
    tensors = list(moved.parameters()) + list(moved.buffers())
    assert tensors and {t.device.type for t in tensors} == {"meta"}
    out = moved(torch.zeros(2, 32, 32, 3, device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (2, 10)


def test_cli_export_no_stablehlo(tmp_path, capsys):
    """``export`` writes forward.pt2 unless ``--no-stablehlo``."""
    from differential_equations_resnet_tpu_torch import cli

    flags = ["--num-layers", "2", "--num-filters", "4", "--device", "cpu", "--batch-size", "2"]
    assert cli.main(["export", str(tmp_path / "with"), *flags]) == 0
    assert cli.main(["export", str(tmp_path / "without"), *flags, "--no-stablehlo"]) == 0
    assert os.path.isfile(tmp_path / "with" / FORWARD_FILE)
    assert not os.path.exists(tmp_path / "without" / FORWARD_FILE)
    with open(tmp_path / "without" / "config.json") as f:
        assert json.load(f)["batch_size"] == 2


def test_a_dropped_predictor_is_freed_at_once(tmp_path):
    """``predict`` holds no reference cycle: dropped, it is freed with its
    paths (on the card, their captured graphs) at once, not by a later
    garbage collection that could run inside another graph's capture."""
    model = build_single_block_resnet(cifar10_single_block_config(num_layers=2, num_filters=4),
                                      generator=torch.Generator().manual_seed(2), device="cpu")
    predict, _ = load_exported(export_model(model, str(tmp_path / "e"), batch_size=2),
                               device="cpu")
    predict(images(2, 32, 1))
    gc.disable()
    try:
        dropped = weakref.ref(predict)
        del predict
        assert dropped() is None
    finally:
        gc.enable()


def test_the_program_runs_with_tf32_off(tmp_path):
    """`load_program`'s module runs the program with cuDNN's TF32 off and
    restores the caller's flag: ``torch.export`` does not record the flag,
    so without this the program's fp32 convolutions would run in TF32."""
    from differential_equations_resnet_tpu_torch.utils import serving

    model = build_single_block_resnet(cifar10_single_block_config(num_layers=2, num_filters=4),
                                      generator=torch.Generator().manual_seed(4), device="cpu")
    export_dir = export_model(model, str(tmp_path / "e"), batch_size=2)
    loaded = serving.load_program(os.path.join(export_dir, FORWARD_FILE), torch.device("cpu"))
    x = torch.from_numpy(images(2, 32, 4))
    want = loaded(x)
    seen = []

    class Recorded(torch.nn.Module):
        def __init__(self, program):
            super().__init__()
            self.inner = program

        def forward(self, t):
            seen.append(torch.backends.cudnn.allow_tf32)
            return self.inner(t)

    loaded.program = Recorded(loaded.program)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        torch.testing.assert_close(loaded(x), want, rtol=0, atol=0)
        assert seen == [False] and torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_the_rebuilt_model_is_built_only_when_a_batch_needs_it(tmp_path, monkeypatch):
    """With forward.pt2 the model is rebuilt only at the first request of
    another batch size, once; without the program it is built at load."""
    from differential_equations_resnet_tpu_torch.utils import serving

    built = []
    rebuilt_forward = serving._rebuilt_forward
    monkeypatch.setattr(serving, "_rebuilt_forward",
                        lambda *a: built.append(1) or rebuilt_forward(*a))
    model = build_single_block_resnet(cifar10_single_block_config(num_layers=2, num_filters=4),
                                      generator=torch.Generator().manual_seed(5), device="cpu")
    export_dir = export_model(model, str(tmp_path / "e"), batch_size=2)
    predict, _ = load_exported(export_dir, device="cpu")
    predict(images(2, 32, 1))
    assert not built and predict.routes == {"compiled": 1, "rebuilt": 0}
    for n in (3, 1, 3):
        predict(images(n, 32, n))
    assert len(built) == 1 and predict.routes == {"compiled": 1, "rebuilt": 3}
    load_exported(export_dir, prefer_stablehlo=False, device="cpu")
    assert len(built) == 2


def test_predict_serves_several_threads(tmp_path):
    """Requests from several threads at once each get their own answer,
    on both paths, as when they come one at a time."""
    model = build_single_block_resnet(cifar10_single_block_config(num_layers=2, num_filters=4),
                                      generator=torch.Generator().manual_seed(6), device="cpu")
    predict, _ = load_exported(export_model(model, str(tmp_path / "e"), batch_size=2),
                               device="cpu")
    requests = [images(2 + i % 2, 32, 10 + i) for i in range(8)]
    want = [predict(r) for r in requests]
    got = [None] * len(requests)

    def serve(i):
        for _ in range(3):
            got[i] = predict(requests[i])

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert predict.routes == {"compiled": 16, "rebuilt": 16}
