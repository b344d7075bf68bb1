"""Parameter conversion between the JAX package and the port, weight
surgery, serving export/load and the compile cache.  The JAX package's
weight-surgery names are imported on first use."""

from differential_equations_resnet_tpu_torch import lazy_names

_LAZY = {
    "double_load_weights": "weight_utils",
    "double_model_depth": "weight_utils",
    "export_reference_weights": "weight_utils",
    "import_reference_weights": "weight_utils",
    "load_pickled_weights": "weight_utils",
    "pickle_model_weights": "weight_utils",
}

__getattr__ = lazy_names(__name__, _LAZY)
