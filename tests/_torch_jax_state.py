"""The JAX package's process-global state that a port test must restore
after driving it with a fault plan or ``fallback=True``.

JAX's step builders are ``lru_cache``d, and its ``backend_compile`` fault
site fires only on a cache miss; a runner a test left in the cache (a walk
that degraded, say) makes a later test's injected fault never fire when
``--dist loadfile`` puts both files on one worker.  So a test that drives
JAX that way clears the build caches, the degrade probe's verdicts and the
fault plan after itself (:func:`reset_jax_state`).
"""


def reset_jax_state() -> None:
    from parallel_convolution_tpu.parallel import step as jstep
    from parallel_convolution_tpu.resilience import degrade as jdegrade
    from parallel_convolution_tpu.resilience import faults as jfaults

    for build in (jstep._build_iterate, jstep._build_converge,
                  jstep._build_converge_chunk):
        build.cache_clear()
    jdegrade.clear_probe_cache()
    jfaults.uninstall_plan()
