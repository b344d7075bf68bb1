"""The benchmark of `differential_equations_resnet_tpu_torch` on an NVIDIA H100.

One run is one cell of ``BENCHMARK.json`` (a model configuration under a
traffic mix) on one seed:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the configuration in
``configs/<config>.json``, the traffic mix in ``traffic/<traffic>.json``,
the cell's correctness limits in ``cells/<cell>.json``, the runner of the
traffic's kind in ``kinds/<kind>.py`` and each per-layer metric's reader in
``metrics/<metric>.py``.  ``pending/`` holds the ``BENCHMARK.json`` entries
of cells that are defined and tested but not yet in it.  The yardstick
(weights and data from the seed, the plain reference, the FLOP and bound
arithmetic, the profiler arithmetic) lives here and imports nothing of the
port; the runners take only the system under test from it.  Nothing here imports JAX or the JAX
package.
"""
