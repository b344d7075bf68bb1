"""Operators of the port: packed antisymmetric kernels, convolutions and the
hand-written kernels under `ops.kernels`."""
