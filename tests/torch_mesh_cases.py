"""What each gloo rank runs in the port's mesh tests (tests/torch_dist.py
spawns the ranks).  This module imports neither JAX nor the JAX package:
the ranks get their inputs (port configs, parameter trees of torch
tensors, NumPy batches) from the pytest process, which computes the JAX
references.  Every case returns NumPy values; `run` runs a list of cases
and keeps each one's error instead of its result, so one failing case
fails only its own test.  A case raises on every rank alike (a check, a
comparison) or hangs, which the harness's timeout ends."""

from __future__ import annotations

import dataclasses
import traceback

import numpy as np
import torch
import torch.distributed as dist

from differential_equations_resnet_tpu_torch.data import jit_augment
from differential_equations_resnet_tpu_torch.models import build_resnet, build_single_block_resnet
from differential_equations_resnet_tpu_torch.models import single_block_resnet as sbr
from differential_equations_resnet_tpu_torch.ops.kernels.fused_integrator import reference_euler_dense
from differential_equations_resnet_tpu_torch.parallel import (
    batch_sharding,
    create_mesh,
    local_batch_slice,
    make_shard_map_train_step,
    pipeline_blocks_apply,
    replicated_sharding,
    shard_batch,
    shard_params,
)
from differential_equations_resnet_tpu_torch.train import (
    make_adam,
    make_device_epoch,
    make_device_eval,
    make_eval_step,
    make_multi_eval_step,
    make_multi_step,
    make_predict_step,
    make_train_step,
)
from differential_equations_resnet_tpu_torch.utils.weight_utils import params_to_jax


def run(cases):
    """``cases``: [(name, function name, kwargs)]; {name: result or
    {"error": traceback}}."""
    results = {}
    for name, fn, kwargs in cases:
        try:
            results[name] = globals()[fn](**kwargs)
        except Exception:  # noqa: BLE001 - reported by the case's test
            results[name] = {"error": traceback.format_exc()}
    return results


def mesh(shape, names, devices=None):
    return create_mesh(shape, names, devices=devices, device_type="cpu")


def build(config, params, state=None):
    family = build_resnet if hasattr(config, "version") else build_single_block_resnet
    return family(config, params=params, state=state, device="cpu")


def tree(model):
    """The model's parameters as NumPy leaves in the JAX tree's order."""
    return params_to_jax(model.params())


def buffers(model):
    """The batch-norm running statistics in the JAX state tree's order."""
    return params_to_jax(model.state())


def rows_of(metrics, norms):
    return np.concatenate([[float(metrics[k]) for k in ("loss", "correct", "count")],
                           norms.detach().numpy().reshape(-1)])


# -- the mesh module ----------------------------------------------------------


def mesh_layout():
    """create_mesh shapes and error, the placements, shard_batch's rows,
    shard_params and local_batch_slice on this rank."""
    out = {}
    default = create_mesh(device_type="cpu")
    out["default"] = (tuple(default.shape), default.mesh_dim_names, tuple(default.get_coordinate()))
    two = mesh((2, 2), ("data", "model"))
    out["two"] = (tuple(two.shape), tuple(two.get_coordinate()))
    sub = mesh((2,), ("pipe",))
    out["sub"] = None if sub.get_coordinate() is None else tuple(sub.get_coordinate())
    try:
        mesh((3, 2), ("data", "model"))
    except ValueError as e:
        out["mesh_error"] = str(e)
    out["placements"] = (repr(batch_sharding(two)), repr(replicated_sharding(two)))
    batch = np.arange(16).reshape(8, 2)
    out["rows"] = shard_batch(two, {"x": batch, "y": (torch.arange(8),)})
    out["rows"] = (out["rows"]["x"], out["rows"]["y"][0].numpy())
    values = {"w": torch.full((3,), float(dist.get_rank())), "b": [torch.ones(2) * dist.get_rank()]}
    shard_params(two, values)
    out["params"] = (values["w"].numpy(), values["b"][0].numpy())
    out["local"] = local_batch_slice(8)
    return out


# -- data parallelism ---------------------------------------------------------


def train(config, params, batches, lr, state=None, mesh_shape=None, mesh_names=("data",),
          accum_steps=1, shard_map=False, tp=False, pp=False):
    """Train steps over ``batches`` [(images, labels)] (global) on a mesh
    of ``mesh_shape`` (None: no mesh); with ``tp``/``pp`` the model's
    tp_mesh/pp_mesh is that mesh.  Returns the rows, the parameters and
    the buffers after, and the eval-mode logits of the first batch."""
    m = None if mesh_shape is None else mesh(mesh_shape, mesh_names)
    if m is not None and m.get_coordinate() is None:
        return None
    if m is not None and (tp or pp):
        config = dataclasses.replace(config, tp_mesh=m if tp else None, pp_mesh=m if pp else None)
    model = build(config, params, state)
    optimizer = make_adam(model.parameters())
    if shard_map:
        step = make_shard_map_train_step(model, optimizer, m, accum_steps=accum_steps)
    else:
        step = make_train_step(model, optimizer, accum_steps=accum_steps, mesh=m)
    rows = []
    for images, labels in batches:
        rows.append(rows_of(*step(torch.from_numpy(images), torch.from_numpy(labels), lr)))
    logits = eval_logits(model, batches[0][0])
    return {"rows": np.stack(rows), "params": tree(model), "buffers": buffers(model),
            "logits": logits}


def eval_logits(model, images):
    """Eval-mode logits of the whole batch on this rank (a TP or PP model's
    collectives run on every rank alike)."""
    with torch.no_grad():
        return model(torch.from_numpy(images), return_logits=True).numpy()


def device_epochs(config, params, features, labels, batch_size, steps, lr, mesh_shape,
                  mesh_names=("data",), augment=False, tp=False, accum_steps=1):
    """The device-resident epoch on the mesh and without one, from the same
    parameters and generator seed: (rows, parameters) of each."""
    out = {}
    for key, shape in (("meshless", None), ("mesh", mesh_shape)):
        m = None if shape is None else mesh(shape, mesh_names)
        cfg = dataclasses.replace(config, tp_mesh=m) if (tp and m is not None) else config
        model = build(cfg, params)
        epoch = make_device_epoch(
            model, make_adam(model.parameters()), batch_size, mesh=m, accum_steps=accum_steps,
            augment=jit_augment.standard_cifar_augment(brightness_delta=0.2) if augment else None)
        generator = torch.Generator().manual_seed(7)
        metrics, norms = epoch(torch.from_numpy(features), torch.from_numpy(labels), generator,
                               [lr] * steps)
        rows = torch.cat([torch.stack([metrics[k] for k in ("loss", "correct", "count")], 1),
                          norms], 1)
        out[key] = {"rows": rows.numpy(), "params": tree(model)}
    return out


def evaluation(config, params, images, labels, batch_size, mesh_shape, state=None):
    """eval step, K-batch eval, device eval (ragged) and predict, on the mesh
    and without one."""
    out = {}
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    for key, shape in (("meshless", None), ("mesh", mesh_shape)):
        m = None if shape is None else mesh(shape, ("data",))
        model = build(config, params, state)
        step = make_eval_step(model, mesh=m)(x[:batch_size], y[:batch_size])
        k = len(x) // batch_size
        multi = make_multi_eval_step(model, mesh=m)(
            x[:k * batch_size].reshape(k, batch_size, *x.shape[1:]),
            y[:k * batch_size].reshape(k, batch_size))
        device = make_device_eval(model, batch_size, mesh=m)(x, y)
        predict = make_predict_step(model, mesh=m)(x[:batch_size])
        out[key] = {
            "step": np.asarray([float(step[k]) for k in ("loss", "correct", "count")]),
            "multi": np.stack([multi[k].numpy() for k in ("loss", "correct", "count")]),
            "device": np.stack([device[k].numpy() for k in ("loss", "correct", "count")]),
            "predict": predict.numpy(),
        }
    return out


def shard_map_rejects_batch_norm(config, params, state):
    model = build(config, params, state)
    try:
        make_shard_map_train_step(model, make_adam(model.parameters()), mesh((4,), ("data",)))
    except ValueError as e:
        return str(e)
    return "no error"


# -- the pipeline ---------------------------------------------------------------


def pipeline(kernels, biases, x, h, mesh_shape, mesh_names, num_microbatches,
             batch_axis=None, tp_axis=None):
    """pipeline_blocks_apply's value sum(y^2) and its gradients in kernels,
    biases and x on a mesh of ``mesh_shape`` (None on a rank outside it)."""
    m = mesh(mesh_shape, mesh_names)
    if m.get_coordinate() is None:
        return None
    k, b, xx = (torch.from_numpy(a).requires_grad_() for a in (kernels, biases, x))
    y = pipeline_blocks_apply(k, b, xx, h, m, num_microbatches=num_microbatches,
                              batch_spec=(batch_axis,), tp_axis=tp_axis)
    value = (y * y).sum()
    value.backward()
    return {"y": y.detach().numpy(), "value": float(value), "grads": (
        k.grad.numpy(), b.grad.numpy(), xx.grad.numpy())}


def pipeline_errors(kernels, biases, x, h):
    """The ValueErrors of pipeline_blocks_apply (raised before any
    collective)."""
    k, b, xx = (torch.from_numpy(a) for a in (kernels, biases, x))
    messages = []
    pipe = mesh((4,), ("pipe",))
    two = mesh((2, 2), ("pipe", "model"))
    for call in (lambda: pipeline_blocks_apply(k[:6], b[:6], xx, h, pipe),
                 lambda: pipeline_blocks_apply(k, b, xx, h, pipe, num_microbatches=3),
                 lambda: pipeline_blocks_apply(k[..., :3, :3], b[:, :3], xx[..., :3], h, two,
                                               tp_axis="model")):
        try:
            call()
            messages.append("no error")
        except ValueError as e:
            messages.append(str(e))
    return messages


def model_forward_and_grads(config, params, images, labels, mesh_shape, mesh_names,
                            tp=False, pp=False, pp_microbatches=0):
    """The model's logits and the gradient of its mean cross-entropy in
    every parameter (JAX tree order) with tp_mesh/pp_mesh on the mesh."""
    m = mesh(mesh_shape, mesh_names)
    if m.get_coordinate() is None:
        return None
    config = dataclasses.replace(config, tp_mesh=m if tp else None, pp_mesh=m if pp else None,
                                 pp_microbatches=pp_microbatches)
    model = build(config, params)
    logits = model(torch.from_numpy(images), return_logits=True)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels).long())
    loss.backward()
    grads = params_to_jax(sbr.map_leaves(lambda p: p.grad, model.params()))
    return {"logits": logits.detach().numpy(), "grads": grads,
            "routes": dict(sbr.mesh_route_counts)}


def reference_scan(kernels, biases, x, h):
    """The port's own plain stack, for a sanity check beside the JAX one."""
    with torch.no_grad():
        return reference_euler_dense(torch.from_numpy(x), torch.from_numpy(kernels),
                                     torch.from_numpy(biases), h).numpy()


def multi_step(config, params, images, labels, lr, k, mesh_shape):
    """make_multi_step over K copies of a batch on a data mesh."""
    m = mesh(mesh_shape, ("data",))
    model = build(config, params)
    multi = make_multi_step(model, make_adam(model.parameters()), mesh=m)
    x = torch.from_numpy(images).expand(k, *images.shape)
    y = torch.from_numpy(labels).expand(k, *labels.shape)
    metrics, norms = multi(x, y, [lr] * k)
    return {"loss": metrics["loss"].numpy(), "norms": norms.numpy(), "params": tree(model)}


def routes_of(config, params, images, mesh_shape, mesh_names):
    """The route counters of one forward with tp_mesh on the mesh, and its
    logits beside the meshless model's."""
    m = mesh(mesh_shape, mesh_names)
    meshless = build(config, params)
    model = build(dataclasses.replace(config, tp_mesh=m), params)
    for counts in (sbr.route_counts, sbr.mesh_route_counts):
        for key in counts:
            counts[key] = 0
    with torch.no_grad():
        logits = model(torch.from_numpy(images), return_logits=True).numpy()
        routes = {**sbr.route_counts, **sbr.mesh_route_counts}
        want = meshless(torch.from_numpy(images), return_logits=True).numpy()
    return {"logits": logits, "meshless": want, "routes": routes}


def training(config, params, features, labels, val_features, val_labels, directory):
    """`Training` on a data mesh over every rank against `Training` without
    one (each rank its own directory): two streaming epochs with a
    checkpoint after each, a device-resident epoch, `save`, then a fresh
    trainer on the mesh restoring it (`load_variables`)."""
    import os

    from differential_equations_resnet_tpu_torch.train import Training, constant_schedule

    rank = dist.get_rank()
    out = {}
    for key, m in (("meshless", None), ("mesh", mesh((dist.get_world_size(),), ("data",)))):
        where = os.path.join(directory, key if m is not None else f"{key}{rank}")
        arrays = dict(train_features=features, train_labels=labels, val_features=val_features,
                      val_labels=val_labels, batch_size=8, mesh=m)
        trainer = Training(build(config, params), csv_logger_dir=where, **arrays)
        history = trainer.train(2, 3, constant_schedule(1e-3), save_during_training=True,
                                save_dir=os.path.join(where, "ckpt"), save_frequency=1,
                                save_best_only=False, verbose=False)
        history = trainer.train(1, 2, constant_schedule(1e-3), device_data=True, verbose=False)
        path = trainer.save(os.path.join(where, "final"))
        restored = Training(build(config, params), mesh=m, **{
            k: v for k, v in arrays.items() if k != "mesh"})
        restored.load_variables(path)
        out[key] = {
            "history": [(h["epoch"], h["step"], h["mean_loss"], h["accuracy"])
                        for kind in ("train", "eval") for h in history[kind]],
            "params": tree(trainer.model), "restored": tree(restored.model),
            "restored_step": restored.global_step,
            "files": sorted(os.listdir(os.path.join(where, "ckpt"))) if os.path.isdir(
                os.path.join(where, "ckpt")) else [],
            "csvs": len([f for f in os.listdir(where) if f.endswith(".csv")])
            if os.path.isdir(where) else 0,
            "predict": trainer.predict(val_features[:12]),
        }
        trainer.close()
    return out


def sweep(config, batch_size):
    """measure_train_throughput over a data mesh of every rank."""
    from differential_equations_resnet_tpu_torch.experiments import measure_train_throughput

    m = mesh((dist.get_world_size(),), ("data",))
    return {"row": measure_train_throughput(config, batch_size, mesh=m, steps=2, warmup=1,
                                            device="cpu"), "size": m.size()}


def multihost(rank, world_size, address):
    """initialize_multihost over TCP (no harness group), then a sum over the
    world and each process's slice of a global batch."""
    from differential_equations_resnet_tpu_torch.parallel import initialize_multihost

    initialize_multihost(address, world_size, rank)
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    return {"sum": float(t), "slice": local_batch_slice(8), "world": dist.get_world_size()}
