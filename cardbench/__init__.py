"""The benchmark of parallel_convolution_tpu_torch on NVIDIA cards.

One run of one cell:

    python3 -m cardbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the root of the checkout; each configuration, traffic
mix and per-layer metric is a file of its own here (``configs/``,
``traffic/``, ``metrics/``), found by that name.  The yardstick lives here
too: the seeded inputs (:mod:`cardbench.inputs`), the plain reference
(:mod:`cardbench.reference`), the peaks and the fewest-operations count
(:mod:`cardbench.roofline`) and the reading of the device trace
(:mod:`cardbench.trace`).  Nothing here imports JAX or the JAX package.
"""
