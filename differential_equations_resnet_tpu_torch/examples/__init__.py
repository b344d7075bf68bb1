"""Examples of the port, run as
``python -m differential_equations_resnet_tpu_torch.examples.<name>``, each
the port of the JAX package's ``examples/<name>.py``: `mnist_smoke`,
`bottleneck_resnet_records`, `antisymmetric_kernel_properties`,
`cifar10_gradient_flow_experiment`, `depth_doubling_continuation`,
`large_batch_training` and `int8_full_nan_repro`.  Each runs on the card
unless ``--device cpu`` is given."""
