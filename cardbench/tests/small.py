"""Small sizes of every cell, for the CPU: the plain backend in place of
the CUDA kernels, the cell's shapes and mechanisms kept (its grid, its
processes, its traffic kind), its extents cut."""

SMALL = {
    "c4_rgb65536_resident": (
        {"backend": "shifted", "fuse": 4, "iterations": 6},
        {"height": 48, "width": 64, "window": 8, "windows_drawn": 5}),
    "c2_rgb2520_batch8": (
        {"backend": "shifted", "fuse": 4, "iterations": 6},
        {"height": 40, "width": 52, "batch": 4, "pool": 6, "kept_calls": 3}),
    "c5_field32768_vcycle": (
        {"backend": "shifted"}, {"height": 70, "width": 94, "pool": 2}),
    "c4_rgb65536_4cards": (
        {"backend": "shifted", "fuse": 4, "iterations": 6},
        {"height": 48, "width": 64, "window": 8, "windows_drawn": 3}),
}

SEED = 2 ** 33 + 17


def run_small(name: str, seed: int = SEED, trace: int = 0, child=None,
              seconds: float = 0.3) -> dict:
    """One run of cell ``name`` at its small size on the CPU."""
    from cardbench import run

    config_over, traffic_over = SMALL[name]
    return run.run(["--workload", name, "--seed", str(seed), "--seconds",
                    str(seconds), "--trace", str(trace)], device="cpu",
                   config_over=config_over, traffic_over=traffic_over,
                   child=child)
