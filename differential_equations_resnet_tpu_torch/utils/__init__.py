"""Parameter conversion between the JAX package and the port, and serving
export/load."""
