"""Examples of the port, run as
``python -m differential_equations_resnet_tpu_torch.examples.<name>``: the
MNIST smoke workflow and the records-fed bottleneck ResNet (the JAX
package's ``examples/mnist_smoke.py`` and
``examples/bottleneck_resnet_records.py``).  Each runs on the card unless
``--device cpu`` is given."""
