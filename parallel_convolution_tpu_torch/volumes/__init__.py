"""Rank-3 volumes on the block grid (the JAX package's ``volumes/``).

(F, D, H, W) float32 states, F interleaved field pairs: the grid splits
(H, W) into blocks as rank 2 does, and the depth axis D lies whole in
every block.  The modules:

* ``halo3``   — the 6-face ghost exchange: a local pad of the two D faces,
  then rank 2's two-phase exchange (``parallel/halo.py``) with the
  depth-padded fields folded into its channel axis;
* ``forms``   — the rank-3 kernel forms, registered under ``(3, name,
  boundary)``: the 7-point and the 25-point (8th-order) FD Jacobi
  relaxations, each with a ``_stack`` twin, the wave leapfrog and
  Gray–Scott reaction–diffusion;
* ``driver``  — ``prepare_volume``, ``volume_iterate``, the converge
  chunk and ``volume_converge(_stream)``;
* ``oracle3`` — the port's own copy of the independent numpy oracle
  (global ``np.pad`` ghosts, float64 sums).

The JAX package writes these forms as ``jnp`` shifted-view sums, with no
Pallas kernel; the port's are plain PyTorch, on the card or the CPU.
"""
