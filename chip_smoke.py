#!/usr/bin/env python3
"""On-card proof of parallel_convolution_tpu_torch: build, check, drive, time.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

On a machine with several cards ``python3 chip_smoke.py --cards [4jg]
[4l] [4h] [4i]`` runs only what runs across them (4j (g), 4l's
supervised leg on the real cards, 4h and 4i's ``all`` layouts; all four
when none is named), with the phases whose references they read.

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``parallel_convolution_tpu_torch/csrc`` with
   nvcc (every part of every library at once) and the g++ baseline of
   ``native/`` (so that every file read of the run goes through the native
   reader, whatever an earlier run left built), and print the build seconds,
   and ptxas's registers for every template instance of K1 and of the level
   loop (K2, K3, K4, 5c r3); a spill fails;
3. every kernel against its plain PyTorch version on the card: filters
   blur3 / gaussian5 / edge5 / sharpen3, storage f32 / bf16 / u8, quantize
   on and off, separable on and off, T in {1, 2, 8, 32}, zero and periodic
   boundaries, odd shapes with a ragged last tile, and the main path's own
   shapes; every K1 instance the wrapper reaches (k = 1, 3, 5, 7, 9, every
   input dtype against every output dtype, quantize on and off, both
   orders) on a view whose data_ptr() is not 16-byte aligned; K3 / K4 on
   grids 1x1, 2x2, 1x4 (periodic self-wrap) and 4x1,
   T in {1, 3} and a 32-level chunk split into level groups.  Quantize mode
   must be byte-equal; float mode within ``stencil.float_tolerance`` (the
   kernels round once per tap as an FMA, the plain versions twice);
4. the main paths at full size, 100 iterations each, through the user
   entry points, with the launch counters set to 0 just before each run
   and read just after: ``ConvolutionModel`` (cuda_sep / bf16 / fuse 32,
   and cuda / f32 / fuse 1) on a 1920x2520 RGB image, the ``run`` CLI with
   ``--fast`` on 1920x2520 grey blur3 and 8192x8192 grey edge5, and the
   ``cuda_rdma`` backend: ``ConvolutionModel`` on the RGB image at a 2x2
   grid (bf16, fuse 32; beside it ``cuda`` at the same grid), the CLI
   ``--backend cuda_rdma --mesh 4x4 --fast`` on the 8192x8192 edge5 image,
   and ``ConvolutionModel`` on the grey 1920x2520 image at a 16x16 grid
   (u8, fuse 8).  Each must be byte-equal to the plain ``shifted`` path run
   on the card, and a 3-iteration run must equal the NumPy oracle; the
   ``cuda_rdma`` paths must never call the halo exchange;
4f. K2's interior split (``interior_split=True``, the 9-patch launch),
   counted into the kernels line: ``ConvolutionModel`` on the RGB
   1920x2520 image (blur3 ``cuda_sep`` bf16 fuse 32) at 1x1 and 2x2 and
   on the 8192x8192 grey edge5 image (``cuda`` fuse 8) at 4x4, each with
   and without the split: the two byte-equal and equal to ``shifted``,
   K2's launches as the plan says (more than the single launch's, at
   most 9 a level group and block), both runs' resident seconds;
4g. rank-3 volumes (plain PyTorch: the JAX package's forms have no Pallas
   kernel): fd25 at 512^3 (two fields, 1.07 GB), zero boundary, 40 sweeps
   at fuse 4 through ``run --rank 3 --depth 512`` from a seeded raw file
   under ``build/``, at 1x1 and 2x2, the outputs byte-equal (the peak
   reckoned first and measured); fd7, wave and grayscott at 512^3 x 50
   sweeps, 1x1 against 2x2 bitwise; the fd7 / fd25 ``_stack`` twins and
   fuse 1 against fuse 4 bitwise; every form at 64^3 x 3 sweeps on 2x2,
   zero and periodic, within 2e-5 of the port's ``oracle3``;
   ``volume_converge`` with fd7 on the periodic manufactured problem of
   ``scripts/volume_smoke.py`` at N = 64 to tol 1e-5 (cap 5000), its
   iterations, readbacks and stop, the chunks byte-equal to the fixed
   count; one sweep of every form at 512^3 timed with CUDA events, beside
   the byte bound (``costmodel.volume_bytes_per_cell_iter`` over this
   run's ``hbm_gbps``), the least bytes over the data sheet's rate, the
   cost model's prediction and the peak device memory;
4b. run to convergence (``sharded_converge``), counted into the kernels
   line: BASELINE config 5 (``JacobiSolver``: jacobi3, tol 1e-3, f32,
   ``cuda`` fuse 9, check every 10) on a seeded normal 32768x32768 field,
   capped at 100 iterations, against the plain ``shifted`` converge on the
   card: the same iteration count, and through ``sharded_converge_stream``
   every chunk's diff (the stop quantity, since the cap stops both runs),
   field and diffs bit-equal (jacobi3's taps are dyadic); with the
   peak device memory, K2 / K1 / the diff timed at that size; ``run
   --converge 0.5 --check-every 10`` on the grey 1920x2520 image with
   ``--fast`` and with ``--backend cuda_rdma --mesh 16x16 --storage u8
   --fuse 8`` (K3), each converged, byte-equal to ``shifted`` and with its
   iteration count; ``sharded_converge_stream`` there, one yield and one
   readback a chunk, its last image ``sharded_converge``'s bytes;
4h. blocks on separate devices (ROADMAP item 10), after phase 4b,
   counted into the kernels line: the number of cards and a slot map
   printed first; BASELINE config 2 (RGB 1920x2520 blur3, 2x2 on 4 slots
   of one card) through ``ConvolutionModel`` with ``cuda_rdma`` bf16 fuse
   32 (``col_mode`` packed and strided: one K4 launch per slot a chunk,
   K2 per slot for the later level groups, a pack per slot when packed),
   ``cuda_sep`` bf16 fuse 32 and ``cuda`` f32 fuse 1; the 256-rank split
   (grey 1920x2520, 16x16 on 256 slots, u8 fuse 8: K3 per slot) with both
   transports; BASELINE config 3 (8192x8192 edge5, 4x4 on 16 slots)
   through ``run --device <16 slots>`` with ``cuda_rdma`` (both
   transports) and ``cuda``; ``run --converge 0.5 --check-every 10`` on
   config 1's image at 2x2 slots with ``cuda_rdma`` and ``cuda`` (2730
   iterations) -- each byte-equal to the one-card form and to ``shifted``,
   its resident seconds beside the one-card form's; a 1 ms spin queued on
   one slot's stream before every chunk of config 2's ``cuda_rdma`` run
   leaving its bytes unchanged (the barrier); the per-slot K3 / K4 and the
   pack at those shapes against their plain versions, timed over the
   grid; the pack alone at each of the three shapes (one slot's launches
   queued ahead on its stream, beside an empty kernel's there, its vector
   width and byte bound, and the parent's time where it was measured);
   the column-transport probe (the per-slot launches reading the
   staging against reading in place, the pack, a barrier wait on the
   host) that ``costmodel.pick_col_mode`` reads.  With two cards or more
   the paths run again round-robin over the cards (``--device all``),
   peer access on;
4i. the overlapped pipeline (ROADMAP item 10b), after phase 4h, counted
   into the kernels line: BASELINE config 2 (2x2 on 4 slots, bf16 fuse
   32) and the 256-rank split (16x16 on 256 slots, u8 fuse 8: K3) through
   ``ConvolutionModel(overlap=True)``, BASELINE config 3 (4x4 on 16
   slots) through ``run --overlap on --device <16 slots>``, and ``run
   --converge 0.5 --overlap on`` on config 1's image at 2x2 slots, each
   with both column transports and in three schedules: overlapped and
   partitioned (each slot's K3 / K4 region by region, the interior with
   no wait; the launches as ``rdma.overlap_regions`` counts them),
   overlapped in the JAX phase order (``partitioned=False``) and
   serialized; each byte-equal to the serialized per-slot run, the
   one-card form and ``shifted``, the resident seconds of each schedule
   printed; the skew check (a 10 ms spin on slot 0 before every chunk of
   config 2) with overlap on, both schedules and transports; the region
   launches of K3 and K4 at the paths' first level groups, assembled and
   held against the plain first group, timed beside the same group as
   one launch a slot.  With two cards or more the paths run again
   round-robin over the cards;
4k. obs (ROADMAP item 9), after phase 4i, counted into the kernels
   line, with ``metrics.set_enabled(True)`` and an ``EventLog`` in the
   phase's directory: BASELINE config 2 (RGB 1920x2520 blur3 x 100, seed
   1) through ``ConvolutionModel`` with ``cuda_sep`` bf16 fuse 32 at 1x1,
   ``cuda`` f32 fuse 1 at 2x2 and ``cuda_rdma`` bf16 fuse 32 at 2x2, each
   equal to ``shifted``, every event valid (``validate_event``), the
   ``exchange`` event's per-direction bytes ``halo_bytes_total``'s and
   ``pctpu_iterations_total`` up by 100; the resident seconds with obs on
   over off, six turns each way, on ``cuda`` f32 fuse 1 at 2x2 and the
   256-slot ``cuda_rdma`` u8 fuse 8 split (the least on over the least
   off at most 1.25x: a synchronize or a per-launch hook would show; the
   medians' ratio printed beside it); each run's predicted exchange share, and
   for the fuse-1 run a measured one (100 rounds x ``bench_halo_p50`` at
   its block over its resident seconds); ``run --converge 0.5
   --check-every 10`` on config 1's image with ``cuda_rdma`` at 2x2: one
   ``device`` span whose ``iters`` is the count the run printed, its
   ``exchange`` / ``compute`` children in ``obs.trace_report``'s tree, the
   bytes of ``shifted``; a checkpoint of config 3's image (8192² u8) saved
   on 2x2 and loaded there and onto 4x4, the ``checkpoint_save`` /
   ``_load`` / ``_reshard`` events carrying the shard files' bytes on disk;
   the ``cuda_sep`` and the fuse-1 runs under
   ``utils.tracing.device_trace``, the Chrome JSON holding
   ``fused_iterate_kernel`` and ``stencil_step_kernel`` events as many as
   the counters gave; ``obs.report`` clean on the phase's log, and
   ``render_text`` parsed back by ``parse_text``;
4l. elastic grids, the supervisor, the warm engine and the micro-batcher
   (ROADMAP items 13 and 8a-i), after phase 4k, counted into the kernels
   line: (a) ``serving.WarmEngine`` at BASELINE config 2's width (RGB
   1920x2520 blur3 x 100) with keys ``cuda_sep`` bf16 fuse 32 at 1x1,
   ``cuda`` f32 fuse 1 and ``cuda_rdma`` bf16 fuse 32 (strided, and one
   packed) at 2x2 slots, every batch size 1-8 warmed, then two waves of
   eight concurrent requests (distinct seeds) through a ``MicroBatcher`` at
   the JAX package's defaults for each key: every output the bytes of the
   plain ``shifted`` run of its image, the second wave with no ``compile``
   event (no nvcc build, no launch plan); K2's launches of a batch of 8 the
   launches of one run over 24 planes; request latency p50 / p99 at batch
   1 and at batch 8; (b) ``reshape`` of the 2x2-slot engine onto 1x1: the
   old keys re-warmed, the next wave byte-equal, an old key raises; before
   it, ``run_converge`` on config 1's image (tol 0.5, check every 10,
   ``cuda_rdma`` u8 fuse 8, 2x2 slots), every row the port's own
   ``sharded_converge_stream``'s, its last image phase 4b's; a volume key
   (fd7 at 512³, 5 sweeps) within 2e-5 of ``volumes.driver``; (c) the
   port's CLI on config 3 (8192² edge5 x 100, ``cuda_rdma``, ``--device
   all``, ``--checkpoint`` every 25) under ``python -m
   parallel_convolution_tpu_torch.resilience.supervisor`` with the ladder
   ["4x4", "2x2", "1x1"]: the 4x4 attempt dies of an injected fault in its
   second snapshot (the leg's device-loss pattern), ``PCTPU_SIM_DEVICES=4``
   makes the probe skip to 2x2, the resumed leg reshards the snapshot and
   writes config 3's bytes; the ledger says ``mesh: "2x2"``, one reshape;
   (d) ``ConvolutionModel.set_grid`` on config 3 (``cuda_rdma`` bf16 fuse
   32) from 4x4 slots to "2x2" to the one-device 2x2 grid, and
   ``JacobiSolver.set_grid`` on config 1's image, every run byte-equal to
   the one before the swap;
4m. one replica's service over HTTP (ROADMAP item 8a-ii), after phase 4l,
   counted into the kernels line: ``serving.make_http_server`` on
   127.0.0.1, port 0, over a ``ConvolutionService`` (``cache=True``,
   max_batch 8, 5 ms, max_queue 64) on each of two grids, warmed through
   ``POST /v1/warm`` with BASELINE config 2 (RGB 1920x2520 blur3 x 100)
   at ``cuda_sep`` bf16 fuse 32 on 1x1 and ``cuda_rdma`` bf16 fuse 32
   strided on 2x2 slots (batch sizes 2-8 built in process); for each key
   4 requests on each wire (JSON with base64, binary frames) at
   concurrency 1 and then 8 at 8 from a pool of ``urllib`` threads in a client
   process of its own (phase 4l's eight distinct images; the cache
   emptied after each round so every request runs), every
   image the plain ``shifted`` bytes of its image and the two wires'
   bodies byte-equal, p50 / p99 and each request split into the client's
   encode and decode, the server's decode, the service's phases (queue,
   compile, copy_in, device, copy_out), the server's encode and the rest
   (the host steps inside it timed apart on one request); the launches
   of each round the plan's (K2 7 a batch for ``cuda_sep``; per-slot K4
   and K2 for ``cuda_rdma``); one
   duplicate body ``cache: "hit"`` with no engine batch; ``backend:
   "pallas"`` a 400 naming ``cuda``, a malformed frame a 400;
   ``POST /v1/converge`` on config 1's image (``cuda_rdma`` u8 fuse 8 on
   2x2 slots, tol 0.5, check every 130: 21 rows) framed and as NDJSON
   from the
   client process, the final row phase 4b's (2730 iterations), a token
   from the middle row resumed to the same final bytes, each stream's
   per-slot launches the plan's; one fd7
   256³ x 5 volume on frames within 2e-5 of the engine's own run of that
   key; ``/readyz`` 200 and ``/metrics`` parsed by ``obs.metrics.
   parse_text`` with ``pctpu_request_phase_seconds``;
4n. the fleet's front tier (ROADMAP item 8b-i), after phase 4m, counted
   into the kernels line: a ``ReplicaRouter`` (tenant quotas armed,
   load factor 4, its health poll on) over three replicas on the card,
   each a ``ConvolutionService`` (max_batch 8, 5 ms, max_queue 64, no
   fallback) reporting the card: two in process (``InProcessReplica``)
   and one behind ``make_http_server`` (``HTTPReplica``), their names
   picked so that the ring homes BASELINE config 2's ``cuda_sep`` bf16
   fuse 32 key (on a 1x1 replica) and its ``cuda_rdma`` bf16 fuse 32
   strided key (on 2x2 slots, with config 1's converge key) apart, each
   replica's peak reckoned and printed; each key warmed (batch sizes
   1-8) on its home only, its warm footprint measured;
   ``make_router_http_server`` on port 0 (a backlog of 128).  (1) 4
   requests a key on frames at concurrency 1, 8 at 8, from a client process,
   through the router and straight at the home's own HTTP server, every
   answer ``shifted``'s bytes, each stamped with its home, the launches
   the plan's, p50 / p99 and the router hop (router p50 minus direct
   p50) printed, each key resident on its home only; (2) the ``cuda_sep``
   home killed after three requests of a round: every request completes
   or is shed typed retryable, a failover stamped, the key re-homed on
   one replica; the revive (a fresh engine from the factory, warmed)
   builds no nvcc library and holds at most one warm footprint more
   device memory than before the kill; (3) a greedy tenant shed
   ``tenant_quota`` (retryable, ``retry_after_s``), a polite one never;
   (4) ``ChaosTransport`` on the ``cuda_rdma`` home from seeded
   ``PCTPU_FAULTS`` plans: a ``transport_recv`` drop (a one-replica
   router: typed retryable, the retry served from the replica's dedup
   ledger, its engine one batch), a hedge past a slow send, a
   ``transport_stream`` disconnect at the fifth row of a converge (budget
   200) resumed on the next candidate to the plain run's bytes, corrupt
   bodies opening the breaker (fail over, then spill); (5) a router with
   a write-ahead log streams config 1's converge on the frames arm
   (``cuda_rdma`` u8 fuse 8, tol 0.5), crashes after 40 rows (the stream
   abandoned unclosed); a new router over the same WAL takes over (the
   epoch bumped, the job restored), the zombie is refused
   ``stale_epoch`` (409), and the client's retry over the new router's
   HTTP server resumes from the newest durable token to phase 4b's bytes
   (2730 iterations), one final row in all; the WAL's appends, fsyncs and
   their seconds printed; (6) ``python -m ...serving.loadgen --target
   <router> --wire frames --n 8 --concurrency 4`` at the ``cuda_sep``
   key exits 0 with p50 / p99 and ``failovers_observed``, ``python -m
   ...serving.route --help`` exits 0 and ``--shards 2`` exits 2 with the
   JAX script's refusal (no ``--state-dir``); K2 and per-slot K4 launched
   in the phase;
4o. the rest of the fleet (ROADMAP item 8b-ii), after phase 4n, counted
   into the kernels line: (a) ``soak.main`` with ``--n 32`` and
   ``--converge --n 8`` (seed 0) on the card, every sampled configuration
   (backend, storage, boundary, a grid of slots, filter, fuse, tile,
   interior split, 24-180 px) the oracle's bytes, a float-mode converge
   ``shifted``'s bits where every tap is a power of two and within the
   kernels' FMA tolerance elsewhere; every failing row printed whole; (b)
   three ``ShardRouter`` s (``sA`` / ``sB`` / ``sC``, ``InProcessPeer``
   links synced every 0.25 s, suspect after 3 misses; a 25.8 MB token
   outweighs a 4 MB WAL segment, so every append rotates)
   each owning one shard of a state dir, over three replicas laid out as
   4n's (one on 1x1, two on 2x2 slots): four ``ShardClient`` threads send
   config 2 (``cuda_sep`` bf16 fuse 32, ``iters`` scanned from 100 until
   every shard has a key) on frames to the two shards that survive, every
   answer ``shifted``'s bytes; config 1's converge (``cuda_rdma`` u8 fuse
   8 on 2x2 slots, tol 0.5, check every 130) on the third shard, its owner
   ``hard_stop``-ped after 5 rows; one fenced takeover by the successor
   (the epoch bumped), the client's map refreshed and the job resumed to
   phase 4b's bytes and 2730 iterations with one final, the zombie refused
   ``stale_epoch``, no non-rejected failure on the surviving shards and
   their p99 through the takeover at most 5x their pre-kill p99 + 25 ms;
   (d) a ``ReplicaRouter`` over one 1x1 replica (max_batch 1, queue 16)
   with ``AutoScaler`` (min 1, max 3, ticks of 0.25 s, cooldown 1 s): 8
   closed-loop config-2 clients over six keys until the pool grows, the
   grown replica's pre-warmed keys then served by it with no new runner
   and no ``compile`` event, the clients idle until it shrinks back to 1,
   every answer ``shifted``'s bytes, the device memory after the shrink
   within one replica's warm footprint of before the growth, and ``route
   --autoscale-max 2`` booted with the scaler on its boot line; (c) three
   ``python -m ...serving.route --shards 3`` processes on the card (booted
   at the start of the phase, each warmed with one request during (d)),
   ``serving.loadgen --shardmap`` sending 16 config-2 requests at
   concurrency 4 with ``--check-against`` ``shifted``'s answer, the owner
   of their shard SIGKILLed after it served 2: no non-rejected failure,
   every answer the bytes, the map refreshed past the kill; (e) the soak's
   drills at the JAX script's sizes on the card: ``--shard-kill 1``,
   ``--autoscale 1``, ``--router-kill 1``, ``--chaos 1``,
   ``--router-restart 1``, ``--chaos-matrix 1`` in process and ``--faults
   1``, ``--serve --faults 1`` as children from the start of the phase;
   each step's seconds printed;
4j. the rest on a grid of slots and a grid over two processes (ROADMAP
   item 10c), after phase 4d, counted into the kernels line: BASELINE
   config 5 under the V-cycle (32768², jacobi3, tol 1e-3, 100 work units)
   on 2x2 slots with ``cuda`` (K1 per slot) and ``cuda_rdma`` (K3 / K4 per
   slot), each bit-equal to the one-card 2x2 run of its backend (freed
   before the slot run), the same cycles, work units and level grids, the
   peak reckoned and measured; fd25 at 512³ x 40 sweeps fuse 4 through
   ``run --rank 3`` on 2x2 slots, the bytes of phase 4g's 1x1 run; the
   checkpoint kill
   and resume on config 3's image at 4x4 slots, resharded onto 2x2 slots
   and onto one device, each byte-equal to ``shifted``; two spawned
   processes sharing the card (2 slots each of a 2x2 grid, gloo) running
   the JAX package's two-process job (``utils/multihost_job.py``) at
   config 2's size with ``cuda`` f32 fuse 1 and ``cuda_sep`` bf16 fuse 32
   (the second in (e)'s spawn), byte-equal to the same job in one
   process, the f32 resume bit-identical,
   ``broadcast_scalar`` agreed; then (e, ROADMAP item 10d-i) one more
   spawn of two ranks for ``cuda_rdma`` over processes (a neighbour on the
   other rank read in place through CUDA IPC behind the step counters):
   config 2 bf16 fuse 32 on 2x2 strided and packed, the skew check (rank
   1 50 ms late before each chunk), ``auto`` and ``fallback=True`` (one
   resolution, one rung), the engine with config 2's key and a batch of
   two of 4l's images, config 3 through ``run --device all --mesh 4x4``,
   config 5's V-cycle on 2x2 and fd25 512³ through ``run --rank 3
   --device all``, each against its one-process form and ``shifted``;
   the per-slot K3 / K4 and the pack over the two ranks timed (the
   kernels line's ``... over 2 ranks`` rows: a fork to a join with the
   counter waits, one launch alone, the barrier's own cost a chunk; the
   staging each pack wrote against ``rdma_pack_plain``); then (f, ROADMAP
   item 10d-ii-a) in the same spawn, each rank reporting a host of its
   own so that it reads the other's slots from mirrors gloo fills once a
   chunk: config 2 strided and packed (first and resident) and
   overlapped, config 1's image on the 256-rank split, config 3 through
   ``run --device all --mesh 4x4`` and config 1's converge (``cuda_rdma``
   u8 fuse 8, 2x2), each byte-equal to ``shifted`` and its one-host run,
   the far round's copy out, host wait, gloo and copy in printed a chunk,
   and the per-slot kernels timed again (the ``... between hosts``
   rows); (d), (e) and (f) see the first card alone (their ranks share
   it, over gloo); then (g, ROADMAP item 10d-ii-b) one card a process:
   with two cards or more, four (or two) ranks in one NCCL group, each on
   its own card, run the job's config 2 ``cuda`` f32 fuse 1 and
   ``cuda_sep`` bf16 fuse 32, config 2 ``cuda_rdma`` bf16 fuse 32 on 2x2
   strided / packed / overlapped, config 5's V-cycle, config 1's converge
   and the per-slot kernels between cards (the ``... between cards``
   rows), then with the ranks on two reported hosts config 2 and config
   3 with the mirrors NCCL fills (the round's copy out, NCCL and copy in
   a chunk; the ``... between hosts over NCCL`` rows), and through
   ``torchrun --nproc-per-node N`` config 3 on 4x4 and its checkpoint
   killed and resumed, each byte-equal to ``shifted``, with the card
   topology and every card's name and power limit; with one card it
   prints that it needs two (NCCL refuses two ranks on one card);
   each run's first and resident seconds beside its one-card (or
   one-process) form;
4d. multigrid (``--solver multigrid``), counted into the kernels line:
   BASELINE config 5's field (32768x32768, jacobi3, tol 1e-3, f32) under
   the Jacobi run's budget of 100 fine-grid work units, through
   ``JacobiSolver(solver="multigrid")`` with ``cuda`` at 1x1 (K1 on every
   level) from a host array and resident on the card, at 2x2 (bitwise the
   1x1 field), with ``cuda_rdma`` at 4x4 (K4 on the fine levels, K3 at
   T = 1 on the small blocks, the coarsest level on a 2x2 sub-grid) and
   the plain ``shifted`` run: the same residual every cycle and the same
   field bit for bit (jacobi3's taps and the transfers' weights are
   dyadic), max |field| printed; each run's launches equal to its
   schedule's per-cycle launches times its cycles, one readback a cycle;
   cycles, work units, the residual of every cycle, the level grids and
   shapes, seconds first and resident, the predicted against the measured
   seconds a cycle and the peak device memory printed, beside the Jacobi
   run's work units at the same cap; ``run --converge 0.5 --solver
   multigrid`` on the grey 1920x2520 image with ``cuda`` and with
   ``cuda_rdma`` at 16x16 (coarse levels on 8x8, 4x4 and 2x2 sub-grids),
   each saying the ``shifted`` CLI run's cycles and work units, its bytes
   equal to its;
4e. the host tools, after phase 4c:
   ``serial --impl native`` on BASELINE config 1 (grey 1920x2520 blur3,
   100 iterations) byte-equal to the NumPy oracle, with the host CPU's
   model and OpenMP threads, and the one-thread baseline
   (``bench_oracle_proxy``); ``bench`` on RGB 1920x2520 ``cuda_sep``
   bf16 fuse 32 (one JSON row with the card's name and power limit);
   ``bench_halo_p50`` at BASELINE config 2's block (960x1260 RGB on 2x2,
   r = 1) and config 3's (2048x2048 grey on 4x4, r = 2); ``convert`` and
   ``info`` once each;
4c. the huge-image workflow, after phase 7, each run counted into the
   kernels line: BASELINE config 4 (3x3 blur, 65536x65536 RGB, 100
   iterations) from a seeded file under ``build/`` (the disk and RAM found
   are printed; a disk too small for the input and one output shrinks the
   image, printed as a cut) through ``run --sharded-io --storage u8 --fuse
   32`` at 1x1 ``cuda_sep`` (7 K2 launches) and at 4x4 ``cuda_rdma`` (K4
   and K2), its bands read through the native reader, each with its
   first-run seconds and Gpx/s, the host's read + copy in and copy out +
   write, the kernels' time, the peak device memory and the host's
   resident-set growth (under 1 GB: bands, never a block);
   nine 256x256 output windows (corners, centre, far edges, the 4x4 seams)
   read back from the written file must equal the NumPy oracle on input
   crops reaching 100 pixels beyond them, and the two outputs must be
   CRC32-equal band by band; K2 and K4 timed at those shapes beside their
   bounds.  On BASELINE config 3's image (8192x8192 edge5): ``run
   --checkpoint --checkpoint-every 25 --backend cuda_rdma --mesh 4x4`` in
   a child process that dies with an injected fault in its second
   snapshot, resumed here from iteration 25 (75 K4 launches), byte-equal to
   an uninterrupted ``--sharded-io`` run and to ``shifted``, and a second
   torn run resumed on ``--mesh 2x2`` (the reshard warning, the same
   bytes), ``save_state`` / ``load_state`` timed; ``--fallback`` without a
   fault keeping ``cuda_rdma`` and ``cuda_sep`` (the probe's launches
   counted), with ``PCTPU_FAULTS=backend_compile:1`` degrading
   ``cuda_rdma`` to ``cuda`` (warned, named in the summary line, the same
   bytes), with every tier refused stopping at ``cuda`` and raising (no
   plain run, no launch), and 5b's refused launch named by the runtime and
   classified transient, a canary launch after it passing;
5. times with CUDA events after a warm-up: each kernel at the main path's
   shapes (``ms``: K1 as back-to-back wrapper calls, K3 / K4 as the launch
   alone, its arguments bound once, and as the whole wrapper call;
   ``device_ms``: the same launches queued ahead of the card, its own
   time), its plain version, ``F.conv2d`` (TF32 off) as the one-call
   yardstick of K1 and of K3 / K4 at T = 1, each kernel's bound and its
   fraction of it, the level loop's launch shape (strip height V, tile,
   threads, blocks per SM from the occupancy calculator), K1 at f32, bf16
   and u8 storage, separable, and on the 8192x8192 edge5 block, each with
   its launch shape (tile, stages, persistent grid) and a plain device copy
   of the same bytes as its ceiling, and
   end-to-end Gpx/s of each path's counted first run, of a second (warm)
   run, and of the model on an image already on the card (the host's share
   of the time is the difference);
6. the probes (TPU kernel 5, ``csrc/probes.cu``), after the kernel checks:
   5a ``op_chain`` prices ten op chains (every row printed; the f32 FMA
   rate at most 105% of the data sheet's), 5b ``smem_probe`` steps across
   the shared-memory limits (each step within a limit ``ok``, each above it
   a ``clean_refusal``) and is timed beside ``torch.add`` both per call and
   queued ahead (the device's time), 5c ``rdma_ladder`` takes K4 apart construct by
   construct (every rung equal to its plain version, r3 byte-equal to K4);
   launches counted by the probes themselves;
7. ``backend="auto"``: ``ConvolutionModel(backend="auto", fuse=None)`` on
   the RGB image at 1x1 and 2x2 (bf16), the CLI ``run --backend auto
   --mesh 4x4 --fast`` on 8192x8192 edge5, and auto on the grey image at
   16x16 (u8), each byte-equal to ``shifted`` and to the oracle over 3
   iterations, its ``Resolution`` printed beside its Gpx/s and the
   explicit path at the same grid; a measured ``tune`` (4 candidates, 32
   iterations each, no error row) at each of those grids, the model's pick
   beside the measured winner; then the RGB 2x2 tune with
   ``--emit-plans --verify-auto``, whose plan file ``auto`` must resolve
   with ``source == "measured"`` (byte-equal to shifted, timed first,
   warm and resident);
8. the hardware-model constants of ``tuning.costmodel.H100`` as this run
   measures them, beside the committed ones;
9. the ``kernels`` JSON line (twelve kernels: K1-K4, the per-slot K3 /
   K4, the pack, their region launches, the three probes), then the last
   line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate
# and FP32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
ITERS = 100
RGB_HW = (1920, 2520)      # BASELINE configs 1-2
BIG_HW = (8192, 8192)      # BASELINE config 3
ORACLE_CROP = 1024         # the oracle's 3-iteration check crops above this
GREY_GRID = (16, 16)       # the reference program's split at 256 ranks
CONVERGE_HW = (32768, 32768)  # BASELINE config 5
# Config 5's one cut: an iteration cap.  jacobi3 on a normal field leaves
# the modes near the checkerboard, whose factor is close to -1, alternating,
# so the diff decays slowly and tol 1e-3 is not reached within it.
CONVERGE_MAX_ITERS = 100
CONVERGE_CLI_MAX = 5000    # the CLI's converges (about 2730 iterations)
MG_RDMA_GRID = (4, 4)      # config 5's cuda_rdma multigrid run
CONFIG4_SIDE = 65536       # BASELINE config 4: 65536x65536 RGB, 12.9 GB
WINDOW = 256               # config 4's oracle windows
HOST_GROWTH_LIMIT = 1 << 30  # config 4: at most 16 bands of host memory
CKPT_EVERY = 25            # the checkpoint phase's snapshots
CKPT_KILL = 20             # shard write 20: in the second snapshot at 4x4
VOLUME_N = 512             # the volume phase's cube: 2 fields, 1.07 GB
VOLUME_SWEEPS = 50         # fd7 / wave / grayscott, 1x1 against 2x2
VOLUME_FD25_SWEEPS = 40    # fd25 through run --rank 3, fuse 4
VOLUME_TOL = 1e-5          # fd7 on the N = 64 manufactured problem
VOLUME_CAP = 5000
VOLUME_CHECK = 50
ENGINE_WAVE = 8            # 4l: concurrent requests a wave (max_batch)
ENGINE_SINGLES = 8         # 4l: lone requests for the batch-1 latency
ENGINE_WAVES = 2           # 4l: waves for the batch-8 latency
ENGINE_VOLUME_SWEEPS = 5   # 4l: the fd7 512^3 volume key
SERVICE_REQUESTS = 8       # 4m: requests a key, wire and concurrency 8
SERVICE_LONE = 4           # 4m: ... at concurrency 1
SERVICE_CONCURRENCY = (1, 8)
SERVICE_VOLUME_N = 256     # 4m: the fd7 volume request (2 x 256^3 f32)
# 4m's converge streams check every 130 iterations (21 rows; 273 at 10):
# phase 4b's 2730 is a multiple, and a u8 carry that changed at 2720
# changed at every earlier iteration, so they stop at 2730 with its bytes.
SERVICE_CONVERGE_CHECK = 130
SUPERVISOR_LADDER = ["4x4", "2x2", "1x1"]
REPLACES = {
    "stencil_step": "parallel_convolution_tpu/ops/pallas_stencil.py:405",
    "fused_iterate": "parallel_convolution_tpu/ops/pallas_stencil.py:736",
    "rdma_block": "parallel_convolution_tpu/ops/pallas_rdma.py:1226",
    "rdma_tiled": "parallel_convolution_tpu/ops/pallas_rdma.py:1316,1330",
    "rdma_block_slot": "parallel_convolution_tpu/ops/pallas_rdma.py:1226",
    "rdma_tiled_slot": "parallel_convolution_tpu/ops/pallas_rdma.py:1316,1330",
    "rdma_pack": "parallel_convolution_tpu/ops/pallas_rdma.py:743",
    "rdma_block_region": "parallel_convolution_tpu/ops/pallas_rdma.py:303,486",
    "rdma_tiled_region": "parallel_convolution_tpu/ops/pallas_rdma.py:619,884",
    "op_chain": "scripts/vpu_op_probe.py:102",
    "smem_probe": "scripts/helper_crash_probe.py:100",
    "rdma_ladder": "scripts/tiled_repro_probe.py:101",
}
# The pack and 5b of the parent commit of their redesign, measured by
# parallel_convolution_tpu_torch/probes/pack_ab.py on an H100 80GB HBM3 at
# 700 W beside the redesigned kernels (the means of its parent turns):
# device_ms queued ahead, host_ms back to back, slot_launch_ms every slot
# between a fork and a join.
PACK_PARENT_MS = {
    "config 2": {"device_ms": 0.004974848031997681,
                 "host_ms": 0.013226848125457763,
                 "slot_launch_ms": 0.10507519721984863},
    "config 3": {"device_ms": 0.006008319854736328,
                 "host_ms": 0.012163551807403564,
                 "slot_launch_ms": 0.45226079940795905},
    "grey 16x16": {"device_ms": 0.003482143998146057,
                   "host_ms": 0.013566751956939698,
                   "slot_launch_ms": 7.150134887695312},
}
SMEM_PARENT_MS = {"ms": 0.028789119720458986,
                  "device_ms": 0.002914799898862839}
# The one-card kernels, then the per-slot forms of K3 / K4 and the pack
# (a grid of slots, phase 4h), then their region launches (the overlapped
# pipeline, phase 4i).
ONE_CARD_KERNELS = ("stencil_step", "fused_iterate", "rdma_block",
                    "rdma_tiled")
KERNELS = ONE_CARD_KERNELS + ("rdma_block_slot", "rdma_tiled_slot",
                              "rdma_pack", "rdma_block_region",
                              "rdma_tiled_region")
PROBE_SOURCE = "parallel_convolution_tpu_torch/csrc/probes.cu"
# K1's typed instances: 3 input dtypes x k in (1, 3, 5, 7, 9) x 2 orders x
# 11 (output dtype, store-back) pairs (no u8 output in float mode, no rintf
# without the clip).
K1_INSTANCES = 3 * 5 * 2 * 11
SOURCES = {
    "stencil_step": "parallel_convolution_tpu_torch/csrc/step.cu",
    "fused_iterate": "parallel_convolution_tpu_torch/csrc/stencil.cu",
    "rdma_block": "parallel_convolution_tpu_torch/csrc/rdma.cu",
    "rdma_tiled": "parallel_convolution_tpu_torch/csrc/rdma.cu",
    "rdma_block_slot": "parallel_convolution_tpu_torch/csrc/rdma.cu",
    "rdma_tiled_slot": "parallel_convolution_tpu_torch/csrc/rdma.cu",
    "rdma_pack": "parallel_convolution_tpu_torch/csrc/rdma.cu",
    "rdma_block_region": "parallel_convolution_tpu_torch/csrc/rdma.cu",
    "rdma_tiled_region": "parallel_convolution_tpu_torch/csrc/rdma.cu",
    "op_chain": PROBE_SOURCE,
    "smem_probe": PROBE_SOURCE,
    "rdma_ladder": PROBE_SOURCE,
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip() != "",
          f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2, queue_ahead: bool = False) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events; with
    ``queue_ahead`` the calls are enqueued before the card starts them, so
    the host's time between calls is not counted (the device's time)."""
    from parallel_convolution_tpu_torch.utils.bench import cuda_ms as ms

    return ms(fn, reps, warmup, queue_ahead)


def max_abs_err(a, b) -> float:
    import torch

    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def agree(got, want, filt, levels, quantize) -> tuple[bool, float]:
    """Quantize mode: byte-equal.  Float mode: within float_tolerance."""
    import torch

    from parallel_convolution_tpu_torch.ops import stencil

    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    err = max_abs_err(got, want)
    if quantize:
        return bool(torch.equal(got, want)), err
    rtol, atol = stencil.float_tolerance(filt, levels, got.dtype)
    return bool(torch.allclose(got.to(torch.float32), want.to(torch.float32),
                               rtol=rtol, atol=atol)), err


# K1 and the kernels that run the level loop
# (csrc/stencil_common.cuh:run_levels), by library, and the names of their
# template parameters.
PTXAS_KERNELS = {
    "stencil": {"stencil_step_kernel": ("IN", "OUT", "K", "EPI", "SEP"),
                "fused_iterate_kernel": ("K", "EPI", "SEP")},
    "rdma": {"rdma_block_kernel": ("K", "EPI"),
             "rdma_tiled_kernel": ("K", "EPI")},
    "probes": {"rdma_ladder_kernel": ("RUNG", "K", "EPI")},
}


def print_ptxas() -> None:
    """ptxas's registers and spills for every template instance of K1 and
    the level loop, one line per kernel (K1's registers by k and order);
    fails on a spill."""
    import re

    from parallel_convolution_tpu_torch.ops import _build

    for lib, kernels in PTXAS_KERNELS.items():
        usage = _build.ptxas_usage(lib)
        for kernel, params in kernels.items():
            inst = {}
            for sym, u in usage.items():
                m = re.search(kernel + r"I((?:L[ib]\d+E)+)E", sym)
                if not m:
                    continue
                vals = re.findall(r"L[ib](\d+)E", m.group(1))
                if kernel == "rdma_ladder_kernel" and vals[0] != "3":
                    continue  # r0-r2 run no levels
                key = " ".join(f"{p}={v}" for p, v in zip(params, vals))
                inst[key] = [u.get("registers"), u.get("spill_stores", 0),
                             u.get("spill_loads", 0)]
            check(inst != {}, f"ptxas: no instance of {kernel} in lib{lib}")
            regs = [v[0] for v in inst.values()]
            spills = {k: v for k, v in inst.items() if v[1] or v[2]}
            if kernel == "stencil_step_kernel":  # 330 instances: by k, order
                check(len(inst) == K1_INSTANCES,
                      f"ptxas: {len(inst)} K1 instances, expected "
                      f"{K1_INSTANCES}")
                by = {}
                for key, v in inst.items():
                    p = dict(kv.split("=") for kv in key.split())
                    by.setdefault(f"K={p['K']} SEP={p['SEP']}", []).append(v[0])
                shown = {k: [min(v), max(v)] for k, v in sorted(by.items())}
            else:
                shown = {k: v[0] for k, v in inst.items()}
            print(f"ptxas {kernel}: {len(inst)} instances, registers "
                  f"{min(regs)}-{max(regs)}, spilling {len(spills)}; "
                  + json.dumps(shown))
            check(not spills, f"ptxas: {kernel} spills in {spills}")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(dev) -> dict:
    import torch

    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "u8": torch.uint8}
    modes = [("f32", True), ("bf16", True), ("u8", True), ("f32", False),
             ("bf16", False)]
    gen = torch.Generator(device="cpu").manual_seed(1234)

    def data(shape, storage):
        x = torch.randint(0, 256, shape, generator=gen).to(torch.float32)
        return x.to(device=dev, dtype=dtypes[storage])

    n, worst = 0, {"stencil_step": 0.0, "fused_iterate": 0.0}
    for name in ("blur3", "gaussian5", "edge5", "sharpen3"):
        f = get_filter(name)
        r = f.radius
        for storage, quantize in modes:
            for sep in (False, True):
                # K1 on an odd shape: 67 x 301 ragged against the 32 x 128 tile.
                x = data((3, 67 + 2 * r, 301 + 2 * r), storage)
                kw = dict(quantize=quantize, out_dtype=dtypes[storage],
                          separable=sep)
                got = stencil.stencil_step(x, f, **kw)
                want = stencil.stencil_step_plain(x, f, **kw)
                ok, err = agree(got, want, f, 1, quantize)
                check(ok, f"K1 {name} {storage} q={quantize} sep={sep}: "
                          f"max abs err {err}")
                worst["stencil_step"] = max(worst["stencil_step"], err)
                n += 1
                for T, boundary in ((1, "zero"), (2, "periodic"), (8, "zero"),
                                    (32, "zero")):
                    if not quantize and not f.convex and T > 2:
                        continue  # float mode grows by L1(taps) per level
                    d = r * T
                    x = data((2, 77 + 2 * d, 139 + 2 * d), storage)
                    valid = None if boundary == "periodic" else (90, 150)
                    got = stencil.fused_iterate(x, (3, 5), f, T, valid, **kw)
                    want = stencil.fused_iterate_plain(x, (3, 5), f, T, valid,
                                                       **kw)
                    ok, err = agree(got, want, f, T, quantize)
                    check(ok, f"K2 {name} {storage} q={quantize} sep={sep} "
                              f"T={T} {boundary}: max abs err {err}")
                    worst["fused_iterate"] = max(worst["fused_iterate"], err)
                    n += 1
    worst["stencil_step"] = max(worst["stencil_step"], check_step_instances(
        dev, data))
    n += 6 * 15 * 2
    torch.cuda.synchronize()
    print(f"kernel checks: {n} cases agree (quantize mode byte-equal; float "
          f"mode within stencil.float_tolerance, max abs err "
          f"K1 {worst['stencil_step']:.3g}, K2 {worst['fused_iterate']:.3g})")
    return worst


def check_step_instances(dev, data) -> float:
    """Every K1 instance the wrapper reaches against its plain version:
    k = 1, 3, 5, 7, 9, each input dtype against each output dtype (u8 out
    only with the store-back), quantize on and off, both orders, on a view
    one element past a 16-byte boundary with odd rows; max abs err."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter, make_filter

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "u8": torch.uint8}
    filters = [make_filter("identity1", [[1.0]]), get_filter("blur3"),
               get_filter("edge5"),
               make_filter("binomial7",
                           np.outer(*[[1, 6, 15, 20, 15, 6, 1]] * 2), 4096),
               make_filter("binomial9",
                           np.outer(*[[1, 8, 28, 56, 70, 56, 28, 8, 1]] * 2),
                           65536),
               get_filter("gaussian5")]
    worst = 0.0
    for f in filters:
        shape = (2, 45 + f.size - 1, 77 + f.size - 1)
        n = shape[0] * shape[1] * shape[2]
        for src in dtypes:
            x = data((n + 1,), src)[1:].view(shape)
            for dst in dtypes:
                for quantize in (True, False):
                    if dst == "u8" and not quantize:
                        continue
                    for sep in (False, True):
                        kw = dict(quantize=quantize, out_dtype=dtypes[dst],
                                  separable=sep)
                        got = stencil.stencil_step(x, f, **kw)
                        want = stencil.stencil_step_plain(x, f, **kw)
                        ok, err = agree(got, want, f, 1, quantize)
                        check(ok, f"K1 {f.name} {src}->{dst} q={quantize} "
                                  f"sep={sep}: max abs err {err}")
                        worst = max(worst, err)
    return worst


def check_rdma_kernels(dev) -> dict:
    """K3 and K4 (one launch each) against the plain version (halo exchange
    plus K2's plain levels), and a 32-level chunk through
    ``fused_rdma_step``: K3 whole at r = 1, K4 then K2 in level groups at
    r = 2."""
    import torch

    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "u8": torch.uint8}
    modes = [("f32", True), ("bf16", True), ("u8", True), ("f32", False),
             ("bf16", False)]
    gen = torch.Generator(device="cpu").manual_seed(4321)

    def blocks_of(grid_shape, bhw, storage, channels=2):
        R, Cg = grid_shape
        x = torch.randint(0, 256, (channels, R * bhw[0], Cg * bhw[1]),
                          generator=gen).to(torch.float32)
        return mesh.split_blocks(x.to(device=dev, dtype=dtypes[storage]),
                                 mesh.Grid(R, Cg, dev))

    n, worst = 0, {"rdma_block": 0.0, "rdma_tiled": 0.0}
    bhw = (23, 37)
    for grid_shape, boundary in (((1, 1), "zero"), ((2, 2), "zero"),
                                 ((1, 4), "periodic"), ((4, 1), "zero"),
                                 ((2, 2), "periodic")):
        R, Cg = grid_shape
        # Zero boundary: an image a little smaller than the padded grid, so
        # the pad-to-multiple rim is masked too.
        valids = ([None] if boundary == "periodic"
                  else [(R * bhw[0] - 2, Cg * bhw[1] - 3), None])
        for name in ("blur3", "gaussian5", "edge5"):
            f = get_filter(name)
            for storage, quantize in modes:
                blocks = blocks_of(grid_shape, bhw, storage)
                kw = dict(quantize=quantize, out_dtype=dtypes[storage])
                for T in (1, 3):
                    if not quantize and not f.convex and T > 2:
                        continue  # float mode grows by L1(taps) per level
                    for valid in valids if T == 1 else valids[:1]:
                        want = mesh.join_blocks(rdma.fused_rdma_step_plain(
                            blocks, f, grid_shape, boundary, fuse=T,
                            valid_hw=valid, **kw))
                        for kind, launch, extra in (
                                ("rdma_block", rdma.rdma_block, {}),
                                ("rdma_tiled", rdma.rdma_tiled,
                                 {"tile": (8, 16)})):
                            got = mesh.join_blocks(rdma.unstack_blocks(launch(
                                rdma.stack_blocks(blocks, grid_shape), f,
                                grid_shape, boundary, T, valid, **kw, **extra),
                                grid_shape))
                            ok, err = agree(got, want, f, T, quantize)
                            check(ok, f"{kind} {name} {storage} q={quantize} "
                                      f"grid {grid_shape} {boundary} T={T} "
                                      f"valid {valid}: max abs err {err}")
                            worst[kind] = max(worst[kind], err)
                            n += 1
    # 32 levels in one chunk: K3 whole (r = 1, 100 x 100 blocks fit), and
    # K4 for 8 levels then K2 for 3 x 8 (r = 2, 130 x 136 blocks do not).
    for name, bhw, groups in (("blur3", (100, 100), 1),
                              ("edge5", (130, 136), 4),
                              ("gaussian5", (130, 136), 4)):
        f = get_filter(name)
        for storage in ("bf16", "u8"):
            blocks = blocks_of((2, 2), bhw, storage, channels=1)
            valid = (2 * bhw[0] - 1, 2 * bhw[1] - 5)
            plan = rdma.rdma_plan(f.radius, 32, bhw)
            check(len(plan.groups) == groups, f"rdma_plan {name}: {plan}")
            stencil_counts = _counts()
            got = mesh.join_blocks(rdma.fused_rdma_step(
                blocks, f, (2, 2), "zero", fuse=32, valid_hw=valid))
            delta = {k: v - stencil_counts[k] for k, v in _counts().items()}
            want_counts = {k: 0 for k in KERNELS}
            want_counts.update({"rdma_block": int(plan.kernel == "block"),
                                "rdma_tiled": int(plan.kernel == "tiled"),
                                "fused_iterate": 4 * (groups - 1)})
            check(delta == want_counts,
                  f"fused_rdma_step {name} T=32 launched {delta}, expected "
                  f"{want_counts}")
            want = mesh.join_blocks(rdma.fused_rdma_step_plain(
                blocks, f, (2, 2), "zero", fuse=32, valid_hw=valid))
            ok, err = agree(got, want, f, 32, True)
            check(ok, f"fused_rdma_step {name} {storage} T=32 ({plan}): max "
                      f"abs err {err}")
            n += 1
    torch.cuda.synchronize()
    print(f"rdma kernel checks: {n} cases agree (quantize mode byte-equal; "
          f"float mode within stencil.float_tolerance, max abs err "
          f"K3 {worst['rdma_block']:.3g}, K4 {worst['rdma_tiled']:.3g})")
    return worst


def _counts() -> dict:
    from parallel_convolution_tpu_torch.ops import stencil

    return stencil.launch_counts()


# ---------------------------------------------------------------------------
# Main-path shapes: inputs, checks, times and bounds
# ---------------------------------------------------------------------------


def padded_block(img, storage, depth, dev):
    """The block K1/K2 get on the main path: the image as planar storage,
    zero-padded by the halo depth (the 1x1 grid's exchange)."""
    import torch

    from parallel_convolution_tpu_torch.parallel import halo
    from parallel_convolution_tpu_torch.parallel.step import STORAGE_DTYPES
    from parallel_convolution_tpu_torch.utils import imageio

    x = torch.from_numpy(imageio.interleaved_to_planar(img).copy()).to(
        device=dev, dtype=STORAGE_DTYPES[storage])
    return halo.halo_exchange([[x]], depth, (1, 1), "zero")[0][0]


def level_ops(filt, sep: bool, h: int, w: int, quantize: bool,
              masks: bool) -> float:
    """FP32 operations of one level producing (h, w): an FMA counts 2."""
    k, r = filt.size, filt.radius
    if sep:
        fma = (h + 2 * r) * w * k + h * w * k
    else:
        fma = h * w * k * k
    per_px = (1 + (0 if filt.convex else 2)) if quantize else 0
    per_px += 2 if masks else 0
    return 2.0 * fma + per_px * h * w


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def launch_shape(blocks_per_sm: int) -> dict:
    """The level loop's launch shape: strip height V (as built), threads
    per block, and the blocks one SM holds (the occupancy calculator)."""
    from parallel_convolution_tpu_torch.ops import _build, stencil

    return {"V": _build.load_library("stencil").pc_strip_height(),
            "threads": stencil.FUSED_THREADS, "blocks_per_sm": blocks_per_sm}


def time_step(img, filt, storage, dev, separable: bool = False) -> dict:
    """K1 as ConvolutionModel(backend='cuda', fuse=1) calls it, beside its
    plain version, ``F.conv2d`` (TF32 off) and a plain device copy of the
    same bytes (the output's window of the input, out.copy_(p[:, r:-r,
    r:-r])): the ceiling a kernel that reads and writes these bytes once
    reaches through PyTorch's own copy."""
    import torch
    import torch.nn.functional as F

    from parallel_convolution_tpu_torch.ops import stencil

    r = filt.radius
    p = padded_block(img, storage, r, dev)
    kw = dict(quantize=True, out_dtype=p.dtype, separable=separable)
    got = stencil.stencil_step(p, filt, **kw)
    want = stencil.stencil_step_plain(p, filt, **kw)
    ok, err = agree(got, want, filt, 1, True)
    check(ok, f"K1 at the main path's shape {tuple(p.shape)} {storage} "
              f"sep={separable}: err {err}")
    shape = stencil.step_launch_shape(p, filt, **kw)
    # ms: back-to-back wrapper calls, as the fuse-1 path makes them (where
    # the host's time per call is the longer, it shows); device_ms: the same
    # launches queued ahead of the card, the kernel's own time.
    ms = cuda_ms(lambda: stencil.stencil_step(p, filt, **kw), reps=200,
                 warmup=20)
    device_ms = cuda_ms(lambda: stencil.stencil_step(p, filt, **kw),
                        reps=200, warmup=20, queue_ahead=True)
    plain_ms = cuda_ms(lambda: stencil.stencil_step_plain(p, filt, **kw),
                       reps=10)
    # The one-call yardstick: F.conv2d in full FP32 (cuDNN's TF32 off),
    # timed here only; the port never calls it for K1's work.
    torch.backends.cudnn.allow_tf32 = False
    taps = torch.as_tensor(filt.taps, device=dev)[None, None]
    pf = p.to(torch.float32)
    lib_ms = cuda_ms(lambda: F.conv2d(pf[:, None], taps), reps=50, warmup=5)
    out = torch.empty_like(got)
    window = p[:, r:p.shape[1] - r, r:p.shape[2] - r]
    copy_ms = cuda_ms(lambda: out.copy_(window), reps=200, warmup=20,
                      queue_ahead=True)
    C, H, W = got.shape
    use_sep = separable and filt.separable() is not None
    nbytes = p.numel() * p.element_size() + got.numel() * got.element_size()
    b_ms, b_by = bound(nbytes, C * level_ops(filt, use_sep, H, W, True,
                                             False))
    plan = shape["plan"]
    return dict(shape=list(p.shape), dtype=str(p.dtype), separable=separable,
                tile=list(plan.tile), extent=list(plan.extent),
                stages=plan.stages, threads=plan.threads, smem=plan.smem,
                blocks_per_sm=shape["blocks_per_sm"], grid=shape["grid"],
                max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, library_ms=lib_ms, copy_ms=copy_ms,
                bound_ms=b_ms, bound_by=b_by, fraction_of_bound=b_ms / ms,
                device_fraction_of_bound=b_ms / device_ms,
                copy_fraction_of_bound=b_ms / copy_ms, bytes=nbytes,
                achieved_gbps=nbytes / (ms / 1e3) / 1e9,
                device_gbps=nbytes / (device_ms / 1e3) / 1e9)


def time_fused(img, filt, storage, T, sep, dev) -> dict:
    """K2 as the fused chunk of a fuse=T run on a 1x1 grid calls it, and
    as its interior split (``split_ms``)."""
    import torch

    from parallel_convolution_tpu_torch.ops import stencil

    r = filt.radius
    p = padded_block(img, storage, r * T, dev)
    C, Hp, Wp = p.shape
    h, w = Hp - 2 * r * T, Wp - 2 * r * T
    kw = dict(quantize=True, out_dtype=p.dtype, separable=sep)
    args = (p, (0, 0), filt, T, (h, w))
    before = stencil.fused_iterate.launches
    got = stencil.fused_iterate(*args, **kw)
    per_call = stencil.fused_iterate.launches - before
    want = stencil.fused_iterate_plain(*args, **kw)
    ok, err = agree(got, want, filt, T, True)
    check(ok, f"K2 at the main path's shape {tuple(p.shape)}: err {err}")
    ms = cuda_ms(lambda: stencil.fused_iterate(*args, **kw), reps=10)
    # The same call as the interior split's 9-patch launches (a 1x1
    # grid's block: offset (0, 0)): the same bits, its own time.
    split = dict(kw, interior_split=True, block_off=(0, 0))
    before = stencil.fused_iterate.launches
    check(torch.equal(stencil.fused_iterate(*args, **split), got),
          f"K2's interior split at {tuple(p.shape)} differs from one launch")
    split_launches = stencil.fused_iterate.launches - before
    split_ms = cuda_ms(lambda: stencil.fused_iterate(*args, **split), reps=10)
    plain_ms = cuda_ms(lambda: stencil.fused_iterate_plain(*args, **kw),
                       reps=2, warmup=1)
    use_sep = sep and filt.separable() is not None
    ops = sum(C * level_ops(filt, use_sep, h + 2 * r * (T - s),
                            w + 2 * r * (T - s), True, True)
              for s in range(1, T + 1))
    nbytes = p.numel() * p.element_size() + got.numel() * got.element_size()
    b_ms, b_by = bound(nbytes, ops)
    th, tw, groups = stencil.fused_plan(r, T, (h, w))
    return dict(shape=list(p.shape), dtype=str(p.dtype), T=T, tile=[th, tw],
                groups=groups, launches_per_call=per_call,
                split_launches_per_call=split_launches, split_ms=split_ms,
                rim_tax=[stencil.rim_tax(r, g, (th, tw)) for g in groups],
                **launch_shape(stencil.fused_blocks_per_sm(
                    p, filt, T, (h, w), separable=sep)),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by, fraction_of_bound=b_ms / ms)


def time_rdma(kind, img, filt, storage, grid_shape, T, dev) -> dict:
    """K3 (``kind`` rdma_block) or K4 (rdma_tiled) as a fuse=T chunk of the
    ``cuda_rdma`` backend calls it on the image's blocks, one launch for
    the grid.  At T = 1 its one-call yardstick is ``F.conv2d`` (TF32 off)
    on the joined f32 image with zero padding; deeper chunks have none."""
    import torch
    import torch.nn.functional as F

    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.ops import rdma, stencil
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio

    planar = imageio.interleaved_to_planar(img)
    blocks = convert.blocks_from_numpy(planar, mesh.make_grid(grid_shape, dev),
                                       storage)
    valid = planar.shape[1:]
    x = rdma.stack_blocks(blocks, grid_shape)
    launch = rdma.rdma_block if kind == "rdma_block" else rdma.rdma_tiled
    call = lambda: launch(x, filt, grid_shape, "zero", T, valid)
    plain = lambda: rdma.fused_rdma_step_plain(blocks, filt, grid_shape,
                                               "zero", fuse=T, valid_hw=valid)
    got = mesh.join_blocks(rdma.unstack_blocks(call(), grid_shape))
    want = mesh.join_blocks(plain())
    ok, err = agree(got, want, filt, T, True)
    check(ok, f"{kind} at the main path's blocks {grid_shape} x "
              f"{tuple(blocks[0][0].shape)} T={T}: err {err}")
    # ms: the launch alone, its arguments bound once; device_ms: the same
    # launches queued ahead of the card (the kernel's own time); call_ms:
    # the whole wrapper call as the path makes it, with its checks, pointer
    # table and output allocation.
    tile = stencil.FUSED_TILE if kind == "rdma_tiled" else None
    fire, _ = rdma._bind(kind == "rdma_tiled", x, filt, grid_shape, "zero",
                         T, valid, True, None, 0, tile)
    shape = launch_shape(fire(occupancy=True))
    ms = cuda_ms(fire, reps=50 if T == 1 else 20)
    device_ms = cuda_ms(fire, reps=50 if T == 1 else 20, queue_ahead=True)
    call_ms = cuda_ms(call, reps=20 if T == 1 else 10)
    plain_ms = cuda_ms(plain, reps=2, warmup=1)
    lib_ms = None
    r = filt.radius
    if T == 1:
        torch.backends.cudnn.allow_tf32 = False
        taps = torch.as_tensor(filt.taps, device=dev)[None, None]
        full = mesh.join_blocks(blocks).to(torch.float32)[:, None]
        lib_ms = cuda_ms(lambda: F.conv2d(full, taps, padding=r), reps=20)
    nb, C, h, w = x.shape
    # The function needs T levels over every block and nothing more: the
    # ghost ring is its neighbours' own pixels, so the rim the kernels
    # recompute and their masks are not counted.
    ops = nb * C * T * level_ops(filt, False, h, w, True, False)
    nbytes = 2 * got.numel() * got.element_size()  # each block in once, out once
    b_ms, b_by = bound(nbytes, ops)
    return dict(grid=list(grid_shape), block=[C, h, w], dtype=str(got.dtype),
                T=T, tile=list(tile) if tile else [h, w], **shape,
                max_abs_err=err, ms=ms, device_ms=device_ms, call_ms=call_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, fraction_of_bound=b_ms / ms)


def time_rdma_chunk(img, filt, storage, grid_shape, T, dev) -> dict:
    """One whole ``cuda_rdma`` chunk (``fused_rdma_step``) where its levels
    split into groups: K3 / K4 for the first, then K2 per block."""
    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio

    planar = imageio.interleaved_to_planar(img)
    blocks = convert.blocks_from_numpy(planar, mesh.make_grid(grid_shape, dev),
                                       storage)
    x = rdma.stack_blocks(blocks, grid_shape)
    kw = dict(fuse=T, valid_hw=planar.shape[1:])
    chunk = lambda: rdma.fused_rdma_stacked(x, filt, grid_shape, "zero", **kw)
    before = _counts()
    got = mesh.join_blocks(rdma.unstack_blocks(chunk(), grid_shape))
    per_call = {k: v - before[k] for k, v in _counts().items()}
    want = mesh.join_blocks(rdma.fused_rdma_step_plain(
        blocks, filt, grid_shape, "zero", **kw))
    ok, err = agree(got, want, filt, T, True)
    check(ok, f"fused_rdma_step at {grid_shape} x {tuple(blocks[0][0].shape)}"
              f" T={T}: err {err}")
    return dict(grid=list(grid_shape), block=list(blocks[0][0].shape), T=T,
                plan=rdma.rdma_plan(filt.radius, T,
                                    tuple(blocks[0][0].shape[1:]))._asdict(),
                launches_per_call=per_call, max_abs_err=err,
                ms=cuda_ms(chunk, reps=5),
                plain_ms=cuda_ms(lambda: rdma.fused_rdma_step_plain(
                    blocks, filt, grid_shape, "zero", **kw), reps=1, warmup=1))


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def host_seconds(fn) -> tuple[object, float]:
    """``fn()`` and its host-clock seconds, the card synchronised on both
    sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive(label, fn, expect: dict, pixels: int,
          no_halo: bool = False) -> tuple[object, dict, float]:
    """Run one main-path entry point with the counters zeroed just before
    and read just after; check the expected launch counts and, with
    ``no_halo``, that the halo exchange was never called."""
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.parallel import halo

    stencil.reset_launch_counts()
    halo.halo_exchange.calls = 0
    out, secs = host_seconds(fn)
    counts = stencil.launch_counts()
    calls = halo.halo_exchange.calls
    for name, want in expect.items():
        check(counts[name] == want,
              f"{label}: {name} launched {counts[name]} times, expected {want}")
    check(any(counts.values()), f"{label}: no kernel launched")
    check(not no_halo or calls == 0,
          f"{label}: the halo exchange was called {calls} times")
    print(f"main path {label}: launches {counts}, {secs:.4f} s, "
          f"{pixels * ITERS / secs / 1e9:.3f} Gpx/s end to end")
    return out, counts, secs


def expected_launches(filt, fuse: int, hw, tile=None) -> dict:
    """Launches of one ``ITERS``-iteration run on a 1x1 grid: K2 per
    fused chunk (one per level group), K1 per single-level step."""
    from parallel_convolution_tpu_torch.ops import stencil

    none = {"rdma_block": 0, "rdma_tiled": 0}
    if fuse == 1:
        return {"stencil_step": ITERS, "fused_iterate": 0, **none}
    n_chunks, rem = divmod(ITERS, fuse)
    per = lambda T: len(stencil.fused_plan(filt.radius, T, hw, tile)[2])
    return {"stencil_step": 1 if rem == 1 else 0,
            "fused_iterate": n_chunks * per(fuse) + (per(rem) if rem > 1 else 0),
            **none}


def expected_rdma_launches(filt, fuse: int, grid_shape, block_hw,
                           tile=None) -> dict:
    """Launches of one ``ITERS``-iteration ``cuda_rdma`` run: one K3 or K4
    launch per chunk, and K2 once per block for each later level group."""
    from parallel_convolution_tpu_torch.ops import rdma

    counts = {k: 0 for k in KERNELS}
    n_chunks, rem = divmod(ITERS, fuse)
    for T, n in ((fuse, n_chunks), (rem, 1 if rem else 0)):
        if n == 0:
            continue
        plan = rdma.rdma_plan(filt.radius, T, block_hw, tile)
        counts["rdma_" + plan.kernel] += n
        counts["fused_iterate"] += (n * grid_shape[0] * grid_shape[1]
                                    * (len(plan.groups) - 1))
    return counts


def main_paths(dev, tmp: Path) -> tuple[dict, list]:
    import numpy as np

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import oracle
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils import imageio

    import torch

    totals = {k: 0 for k in KERNELS}
    rows = []

    def add(label, counts, pixels, first, warm, resident=None):
        """Record one path: the counted first run, a second (warm) run of
        the same call, and, for the model, ``run_planar`` on an image
        already on the card (no host conversions or copies)."""
        for k, v in counts.items():
            totals[k] += v
        row = dict(path=label, launches=counts, seconds_first=first,
                   seconds_warm=warm, seconds_resident=resident)
        for key in ("first", "warm", "resident"):
            s = row[f"seconds_{key}"]
            row[f"gpx_per_s_{key}"] = None if s is None else pixels * ITERS / s / 1e9
        rows.append(row)

    def plain(filt, img, iters):
        return ConvolutionModel(filt, backend="shifted", device=dev).run_image(
            img, iters)

    blur3 = get_filter("blur3")
    rgb = imageio.generate_test_image(*RGB_HW, "rgb", seed=1)
    hw = "x".join(map(str, RGB_HW))
    px = RGB_HW[0] * RGB_HW[1] * 3
    ref = plain("blur3", rgb, ITERS)
    for label, kw in (
            (f"rgb {hw} blur3 cuda_sep bf16 fuse 32",
             dict(backend="cuda_sep", storage="bf16", fuse=32)),
            (f"rgb {hw} blur3 cuda f32 fuse 1",
             dict(backend="cuda", storage="f32", fuse=1))):
        model = ConvolutionModel("blur3", device=dev, **kw)
        expect = expected_launches(blur3, kw["fuse"], RGB_HW)
        out, counts, secs = drive(label, lambda: model.run_image(rgb, ITERS),
                                  expect, px)
        check(np.array_equal(out, ref), f"{label}: differs from shifted")
        check(np.array_equal(model.run_image(rgb, 3),
                             oracle.run_serial_u8(rgb, blur3, 3)),
              f"{label}: 3 iterations differ from the NumPy oracle")
        _, warm = host_seconds(lambda: model.run_image(rgb, ITERS))
        planar = torch.from_numpy(imageio.interleaved_to_planar(rgb).copy()).to(
            device=dev, dtype=torch.float32)
        _, resident = host_seconds(lambda: model.run_planar(planar, ITERS))
        add(label, counts, px, secs, warm, resident)

    greys, grey_refs = {}, {}
    for (rows_, cols_), name in ((RGB_HW, "blur3"), (BIG_HW, "edge5")):
        filt = get_filter(name)
        # --fast on the card: cuda_sep / bf16 / fuse min(32, block // r).
        expect = expected_launches(
            filt, max(1, min(32, min(rows_, cols_) // filt.radius)),
            (rows_, cols_))
        img = imageio.generate_test_image(rows_, cols_, "grey", seed=2)
        src, dst = tmp / f"{name}.raw", tmp / f"{name}.out.raw"
        imageio.write_raw(src, img)
        label = f"cli run grey {rows_}x{cols_} {name} --fast"
        argv = ["run", str(src), str(rows_), str(cols_), str(ITERS), "grey",
                "-o", str(dst), "--filter", name, "--fast"]
        def run_cli():
            rc = cli_main(argv)
            check(rc == 0, f"{label}: the CLI exited {rc}")

        _, counts, secs = drive(label, run_cli, expect, rows_ * cols_)
        out = imageio.read_raw(dst, rows_, cols_, "grey")
        greys[name], grey_refs[name] = img, plain(name, img, ITERS)
        check(np.array_equal(out, grey_refs[name]),
              f"{label}: differs from shifted")
        crop = img[:ORACLE_CROP, :ORACLE_CROP]
        fast = ConvolutionModel(name, backend="cuda_sep", storage="bf16",
                                fuse=32, device=dev)
        check(np.array_equal(fast.run_image(crop, 3),
                             oracle.run_serial_u8(crop, filt, 3)),
              f"{label}: 3 iterations on {crop.shape} differ from the oracle")
        _, warm = host_seconds(run_cli)
        add(label, counts, rows_ * cols_, secs, warm)

    # The cuda_rdma backend: every block of the grid on the one card, the
    # exchange inside K3 / K4.  Any grid gives the 1x1 grid's bytes, so the
    # shifted references above stand.  Beside it, cuda at the same grid:
    # the halo exchange and one K2 launch per block that it replaces.
    grid2 = make_grid((2, 2), dev)
    block_rgb = tuple(-(-n // 2) for n in RGB_HW)
    per_block = expected_launches(blur3, 32, block_rgb)
    for label, kw, expect in (
            (f"rgb {hw} blur3 cuda_rdma bf16 fuse 32 grid 2x2",
             dict(backend="cuda_rdma", storage="bf16", fuse=32),
             expected_rdma_launches(blur3, 32, (2, 2), block_rgb)),
            (f"rgb {hw} blur3 cuda bf16 fuse 32 grid 2x2",
             dict(backend="cuda", storage="bf16", fuse=32),
             {k: 4 * v for k, v in per_block.items()})):
        model = ConvolutionModel("blur3", grid=grid2, **kw)
        rdma_path = kw["backend"] == "cuda_rdma"
        out, counts, secs = drive(label, lambda: model.run_image(rgb, ITERS),
                                  expect, px, no_halo=rdma_path)
        check(np.array_equal(out, ref), f"{label}: differs from shifted")
        if rdma_path:
            check(np.array_equal(model.run_image(rgb, 3),
                                 oracle.run_serial_u8(rgb, blur3, 3)),
                  f"{label}: 3 iterations differ from the NumPy oracle")
        _, warm = host_seconds(lambda: model.run_image(rgb, ITERS))
        planar = torch.from_numpy(imageio.interleaved_to_planar(rgb).copy()).to(
            device=dev, dtype=torch.float32)
        _, resident = host_seconds(lambda: model.run_planar(planar, ITERS))
        add(label, counts, px, secs, warm, resident)

    edge5 = get_filter("edge5")
    src, dst = tmp / "edge5.raw", tmp / "edge5.rdma.raw"
    label = f"cli run grey {BIG_HW[0]}x{BIG_HW[1]} edge5 --backend cuda_rdma --mesh 4x4 --fast"
    argv = ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]), str(ITERS),
            "grey", "-o", str(dst), "--filter", "edge5", "--backend",
            "cuda_rdma", "--mesh", "4x4", "--fast"]

    def run_rdma_cli():
        rc = cli_main(argv)
        check(rc == 0, f"{label}: the CLI exited {rc}")

    expect = expected_rdma_launches(edge5, 32, (4, 4),
                                    tuple(n // 4 for n in BIG_HW))
    _, counts, secs = drive(label, run_rdma_cli, expect,
                            BIG_HW[0] * BIG_HW[1], no_halo=True)
    check(np.array_equal(imageio.read_raw(dst, *BIG_HW, "grey"),
                         grey_refs["edge5"]), f"{label}: differs from shifted")
    crop = greys["edge5"][:ORACLE_CROP, :ORACLE_CROP]
    small = ConvolutionModel("edge5", grid=make_grid((4, 4), dev),
                             backend="cuda_rdma", storage="bf16", fuse=32)
    check(np.array_equal(small.run_image(crop, 3),
                         oracle.run_serial_u8(crop, edge5, 3)),
          f"{label}: 3 iterations on {crop.shape} differ from the oracle")
    _, warm = host_seconds(run_rdma_cli)
    add(label, counts, BIG_HW[0] * BIG_HW[1], secs, warm)

    grey = greys["blur3"]
    label = (f"grey {hw} blur3 cuda_rdma u8 fuse 8 grid "
             f"{GREY_GRID[0]}x{GREY_GRID[1]}")
    model = ConvolutionModel("blur3", grid=make_grid(GREY_GRID, dev),
                             backend="cuda_rdma", storage="u8", fuse=8)
    block_grey = tuple(-(-n // g) for n, g in zip(RGB_HW, GREY_GRID))
    expect = expected_rdma_launches(blur3, 8, GREY_GRID, block_grey)
    out, counts, secs = drive(label, lambda: model.run_image(grey, ITERS),
                              expect, RGB_HW[0] * RGB_HW[1], no_halo=True)
    check(np.array_equal(out, grey_refs["blur3"]),
          f"{label}: differs from shifted")
    check(np.array_equal(model.run_image(grey, 3),
                         oracle.run_serial_u8(grey, blur3, 3)),
          f"{label}: 3 iterations differ from the NumPy oracle")
    _, warm = host_seconds(lambda: model.run_image(grey, ITERS))
    planar = torch.from_numpy(grey[None].copy()).to(device=dev,
                                                    dtype=torch.float32)
    _, resident = host_seconds(lambda: model.run_planar(planar, ITERS))
    add(label, counts, RGB_HW[0] * RGB_HW[1], secs, warm, resident)

    check(all(totals[k] for k in ONE_CARD_KERNELS),
          f"a kernel never ran on the main path: {totals}")
    refs = {"rgb": rgb, "rgb_ref": ref, "greys": greys, "grey_refs": grey_refs}
    return totals, rows, refs


def expected_for(res, filt, grid_shape, shape) -> dict:
    """Launches of one ``ITERS``-iteration run at a resolution: a plain
    backend none, ``cuda`` / ``cuda_sep`` its 1x1 counts on every block,
    ``cuda_rdma`` one K3 / K4 per chunk plus K2 per later level group."""
    block = tuple(-(-n // g) for n, g in zip(shape[1:], grid_shape))
    if res.backend == "cuda_rdma":
        return expected_rdma_launches(filt, res.fuse, grid_shape, block,
                                      res.tile)
    if res.backend in ("cuda", "cuda_sep"):
        nb = grid_shape[0] * grid_shape[1]
        return {k: nb * v for k, v in expected_launches(
            filt, res.fuse, block, res.tile).items()}
    return {k: 0 for k in KERNELS}


# ---------------------------------------------------------------------------
# Phase 4f: K2's interior split (ROADMAP item 2)
# ---------------------------------------------------------------------------


def split_launches(filt, fuse: int, grid_shape, valid_hw,
                   tile=None) -> dict:
    """Launches of one ``ITERS``-iteration ``cuda`` / ``cuda_sep`` run with
    the interior split: for every block, every fused step's level groups,
    each the patches of its offset class's plan (``stencil.
    launch_patches``), and K1 once a block for a 1-level tail."""
    from parallel_convolution_tpu_torch.ops import stencil

    R, C = grid_shape
    bh, bw = (-(-n // g) for n, g in zip(valid_hw, grid_shape))
    r = filt.radius
    classes = (stencil.axis_offset_classes(R, bh),
               stencil.axis_offset_classes(C, bw))

    def per_step(T):
        th, tw, groups = stencil.fused_plan(r, T, (bh, bw), tile)
        n = 0
        for i in range(R):
            for j in range(C):
                off = (classes[0][stencil.axis_class_index(i, R)],
                       classes[1][stencil.axis_class_index(j, C)])
                left = T
                for g in groups:
                    left -= g
                    oh, ow = bh + 2 * r * left, bw + 2 * r * left
                    n += len(stencil.launch_patches(
                        valid_hw, (min(th, oh), min(tw, ow)), r * g,
                        (oh, ow), off, r * left))
        return n

    n_chunks, rem = divmod(ITERS, fuse)
    return {"stencil_step": R * C if rem == 1 else 0,
            "fused_iterate": n_chunks * per_step(fuse)
            + (per_step(rem) if rem > 1 else 0),
            "rdma_block": 0, "rdma_tiled": 0}


def interior_split_phase(dev, refs: dict, totals: dict) -> list:
    """The main path with and without ``interior_split``: RGB 1920x2520
    blur3 ``cuda_sep`` bf16 fuse 32 at 1x1 and 2x2, and the 8192x8192 grey
    edge5 image ``cuda`` fuse 8 at 4x4.  Each pair byte-equal and equal to
    ``shifted``; K2's launches as the plan says (at most 9 a level group
    and block, more than the single launch's); both runs' resident
    seconds.  The launches count into ``totals``."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils import imageio

    rows = []
    cases = (
        ("rgb 1920x2520 blur3 cuda_sep bf16 fuse 32", refs["rgb"],
         refs["rgb_ref"], "blur3", (1, 1),
         dict(backend="cuda_sep", storage="bf16", fuse=32)),
        ("rgb 1920x2520 blur3 cuda_sep bf16 fuse 32", refs["rgb"],
         refs["rgb_ref"], "blur3", (2, 2),
         dict(backend="cuda_sep", storage="bf16", fuse=32)),
        ("grey 8192x8192 edge5 cuda f32 fuse 8", refs["greys"]["edge5"],
         refs["grey_refs"]["edge5"], "edge5", (4, 4),
         dict(backend="cuda", storage="f32", fuse=8)))
    for label, img, ref, name, gshape, kw in cases:
        filt = get_filter(name)
        grid = make_grid(gshape, dev)
        hw = img.shape[:2]
        px = hw[0] * hw[1] * (img.shape[2] if img.ndim == 3 else 1)
        label = f"{label} grid {gshape[0]}x{gshape[1]}"
        planar = torch.from_numpy(
            imageio.interleaved_to_planar(img).copy()).to(
            device=dev, dtype=torch.float32)
        block = tuple(-(-n // g) for n, g in zip(hw, gshape))
        plain = {k: v * gshape[0] * gshape[1] for k, v in
                 expected_launches(filt, kw["fuse"], block).items()}
        split = split_launches(filt, kw["fuse"], gshape, hw)
        check(plain["fused_iterate"] < split["fused_iterate"]
              <= 9 * plain["fused_iterate"],
              f"{label}: {split['fused_iterate']} split launches against "
              f"{plain['fused_iterate']} single ones")
        row = {"path": label, "card": card_line()}
        outs = {}
        for key, on, expect in (("unsplit", False, plain),
                                ("split", True, split)):
            model = ConvolutionModel(name, grid=grid, interior_split=on,
                                     **kw)
            out, counts, secs = drive(f"{label} interior_split={on}",
                                      lambda: model.run_image(img, ITERS),
                                      expect, px)
            for k, v in counts.items():
                totals[k] += v
            outs[key] = out
            resident = [host_seconds(lambda: model.run_planar(
                planar, ITERS))[1] for _ in range(2)]
            row[key] = {"launches": counts, "seconds_first": secs,
                        "seconds_resident": resident,
                        "gpx_per_s_resident": px * ITERS / min(resident)
                        / 1e9}
        check(np.array_equal(outs["split"], outs["unsplit"]),
              f"{label}: the split run differs from the single launch")
        check(np.array_equal(outs["split"], ref),
              f"{label}: the split run differs from shifted")
        row["split_over_unsplit_resident"] = (
            min(row["split"]["seconds_resident"])
            / min(row["unsplit"]["seconds_resident"]))
        print("interior split: " + json.dumps(row))
        rows.append(row)
        del planar
    return rows


# ---------------------------------------------------------------------------
# Phase 4g: rank-3 volumes (ROADMAP item 6)
# ---------------------------------------------------------------------------


def volume_state(name: str, shape, seed: int):
    """The seeded (2, D, H, W) f32 start of a form: [0, 1) noise, or for
    Gray-Scott the classic bounded start (U = 1, V = 0, a perturbed blob;
    raw noise leaves the reaction's stable basin at dt = 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if name != "grayscott":
        return rng.random((2, *shape), dtype=np.float32)
    vol = 0.01 * rng.random((2, *shape), dtype=np.float32)
    vol[0] += 1.0
    D, H, W = shape
    blob = (slice(None), slice(H // 2 - H // 8, H // 2 + H // 8),
            slice(W // 2 - W // 8, W // 2 + W // 8))
    vol[0][blob] -= 0.5
    vol[1][blob] += 0.25
    return vol


def reckon_volume_peak(shape, r: int, fuse: int, grid_shape,
                       terms: int) -> int:
    """The peak device bytes reckoned for one fused volume step on the
    stacked grid: the state, its padded exchange, ``terms`` one-field
    temporaries of the padded extent (the sum, the scratch product, the
    damped update's; every term for a _stack twin) and the merged
    output."""
    D, H, W = shape
    R, C = grid_shape
    d = r * fuse
    field = 4 * D * H * W
    padded = 4 * (D + 2 * d) * (H + 2 * d * R) * (W + 2 * d * C)
    return 2 * field + 2 * padded + terms * padded + 2 * padded


def volume_phase(dev, work: Path) -> dict:
    """Rank-3 volumes on the card (all plain PyTorch: the JAX package's
    forms have no Pallas kernel).  fd25 at 512^3 (two fields, 1.07 GB),
    zero boundary, 40 sweeps at fuse 4 through ``run --rank 3 --depth
    512`` from a raw file under ``build/``, at 1x1 and 2x2, the outputs
    byte-equal; fd7, wave and grayscott at 512^3 x 50 sweeps, 1x1 against
    2x2 bitwise; the fd7 / fd25 _stack twins and fuse 1 against fuse 4
    bitwise; every form at 64^3 x 3 sweeps on 2x2, zero and periodic,
    against the port's ``oracle3`` at atol 2e-5; ``volume_converge`` with
    fd7 on the periodic manufactured problem at N = 64 (tol 1e-5, cap
    5000), its chunks byte-equal to the fixed count; a sweep of each form
    timed with CUDA events, with its peak device memory."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils.config import (
        VOLUME_FORMS, VOLUME_RADII,
    )
    from parallel_convolution_tpu_torch.volumes import driver, oracle3

    out = {"card": card_line(), "forms": {}}
    g1, g2 = make_grid((1, 1), dev), make_grid((2, 2), dev)
    n = VOLUME_N
    shape = (n, n, n)

    # fd25 through the CLI, 1x1 and 2x2, from a raw file.
    work.mkdir(parents=True, exist_ok=True)
    src = work / "fd25.raw"
    vol = volume_state("fd25", shape, 31)
    vol.tofile(src)
    reckoned = reckon_volume_peak(shape, VOLUME_RADII["fd25"], 4, (1, 1), 4)
    print(f"volume fd25 {n}^3 fuse 4: reckoned peak {reckoned / 1e9:.2f} GB "
          f"(state {vol.nbytes / 1e9:.3f} GB)")
    cli = {}
    for spec in ("1x1", "2x2"):
        dst = work / f"fd25.{spec}.raw"
        argv = ["run", str(src), str(n), str(n), str(VOLUME_FD25_SWEEPS),
                "grey", "-o", str(dst), "--rank", "3", "--depth", str(n),
                "--filter", "fd25", "--fuse", "4", "--mesh", spec]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        rc, secs = host_seconds(lambda: cli_main(argv))
        check(rc == 0, f"run --rank 3 fd25 --mesh {spec}: exit {rc}")
        cli[spec] = {"seconds": secs, "peak_bytes":
                     torch.cuda.max_memory_allocated(dev) - base}
    a = np.fromfile(work / "fd25.1x1.raw", np.float32)
    b = np.fromfile(work / "fd25.2x2.raw", np.float32)
    check(a.size == vol.size and np.isfinite(a).all(),
          "run --rank 3 fd25: the output is not the input's size, or "
          "not finite")
    check(a.tobytes() == b.tobytes(),
          "run --rank 3 fd25: 1x1 and 2x2 outputs differ")
    out["cli_fd25"] = dict(cli, sweeps=VOLUME_FD25_SWEEPS, fuse=4,
                           reckoned_peak_bytes=reckoned,
                           sha256_1x1=hashlib.sha256(a.tobytes()).hexdigest())
    for p in work.glob("fd25*.raw"):
        p.unlink()
    del a, b

    def run(state, name, iters, grid, **kw):
        return driver.volume_iterate(state, name, iters, grid=grid, **kw)

    # fd7, wave, grayscott at 512^3 x 50 sweeps: 1x1 against 2x2.
    for name in ("fd7", "wave", "grayscott"):
        vol = volume_state(name, shape, 37)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        x1, s1 = host_seconds(lambda: run(vol, name, VOLUME_SWEEPS, g1))
        peak = torch.cuda.max_memory_allocated(dev)
        x2, s2 = host_seconds(lambda: run(vol, name, VOLUME_SWEEPS, g2))
        check(x1.device == x2.device == dev
              and bool(torch.isfinite(x1).all()),
              f"volume {name}: not on {dev}, or not finite")
        check(torch.equal(x1, x2), f"volume {name}: 1x1 and 2x2 differ")
        out["forms"][name] = {"sweeps": VOLUME_SWEEPS, "seconds_1x1": s1,
                              "seconds_2x2": s2, "peak_bytes": peak}
        del x1, x2

    # The twins and fusion, bitwise at 512^3.
    vol = volume_state("fd7", shape, 41)
    for base, sweeps in (("fd7", 8), ("fd25", 2)):
        torch.cuda.empty_cache()
        x = run(vol, base, sweeps, g2)
        torch.cuda.reset_peak_memory_stats(dev)
        y = run(vol, base + "_stack", sweeps, g2)
        check(torch.equal(x, y), f"volume {base}_stack differs from {base}")
        out["forms"].setdefault(base + "_stack", {})["peak_bytes"] = (
            torch.cuda.max_memory_allocated(dev))
        del x, y
    for name, fuse in (("fd7", 4), ("fd25", 4), ("wave", 4)):
        x = run(vol, name, 8, g1, fuse=1)
        y = run(vol, name, 8, g1, fuse=fuse)
        check(torch.equal(x, y), f"volume {name}: fuse 1 and {fuse} differ")
        del x, y
    out["bitwise"] = ("1x1 = 2x2 (fd25 CLI, fd7, wave, grayscott); "
                      "fd7 / fd25 = their _stack twins; fuse 1 = fuse 4 "
                      "(fd7, fd25, wave)")

    # Every form against the oracle at 64^3 on 2x2, both boundaries.
    worst = 0.0
    for boundary in ("zero", "periodic"):
        for name in VOLUME_FORMS:
            small = volume_state(name, (64, 64, 64), 43)
            got = run(small, name, 3, g2, boundary=boundary).cpu().numpy()
            err = float(np.abs(got - oracle3.run_oracle(
                small, name, 3, boundary)).max())
            check(err <= 2e-5, f"volume {name} {boundary}: {err} from "
                  "oracle3 (atol 2e-5)")
            worst = max(worst, err)
    out["oracle_64_max_abs_err"] = worst

    # fd7 to tol on the periodic manufactured problem (scripts/
    # volume_smoke.py): u0 = 0, f = 3 (2 pi)^2 u* h^2, u* a sine product.
    N = 64
    h = 1.0 / N
    s = np.sin(2.0 * np.pi * np.arange(N) * h)
    ustar = np.einsum("i,j,k->ijk", s, s, s)
    problem = np.stack([np.zeros_like(ustar), 3.0 * (2.0 * np.pi) ** 2
                        * ustar * h * h]).astype(np.float32)
    driver.volume_converge.readbacks = 0
    (field, iters, diff), secs = host_seconds(lambda: driver.volume_converge(
        problem, "fd7", tol=VOLUME_TOL, max_iters=VOLUME_CAP,
        check_every=VOLUME_CHECK, grid=g2, boundary="periodic", fuse=4))
    fixed = run(problem, "fd7", iters, g2, boundary="periodic")
    check(torch.equal(field, fixed),
          "volume_converge: the chunks differ from the fixed count")
    err = float(np.abs(field[0].double().cpu().numpy() - ustar).max())
    out["converge_fd7_64"] = {
        "iters": iters, "diff": diff, "tol": VOLUME_TOL, "cap": VOLUME_CAP,
        "stopped_by": "tol" if diff < VOLUME_TOL else "cap",
        "readbacks": driver.volume_converge.readbacks, "seconds": secs,
        "max_err_vs_u_star": err}
    check(diff < VOLUME_TOL, f"volume_converge: not converged in {iters}")

    # One sweep of each form at 512^3 on 1x1, by CUDA events.
    from parallel_convolution_tpu_torch.volumes import forms

    for name in VOLUME_FORMS:
        xs, valid = driver.prepare_volume(volume_state(name, shape, 47), g1)
        stepf = forms.build_volume_step(name, (1, 1), n, valid, (n, n), 1,
                                        "zero")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ms = cuda_ms(lambda: stepf(xs), reps=3, warmup=1)
        row = out["forms"].setdefault(name, {})
        row.update(ms_per_sweep=ms, cells=n ** 3, fields=2,
                   step_peak_bytes=torch.cuda.max_memory_allocated(dev)
                   - base)
        del xs
    torch.cuda.empty_cache()
    return out


def volume_bounds(vol: dict, hbm_gbps: float) -> None:
    """Each form's sweep beside the cost model: the byte bound
    (``volume_bytes_per_cell_iter`` over this run's ``hbm_gbps``), the
    least bytes (both fields read and written once) over the data sheet's
    rate, and ``predict_volume_seconds_per_cell_iter`` on the committed
    H100 model, at 1x1."""
    from parallel_convolution_tpu_torch.tuning import costmodel
    from parallel_convolution_tpu_torch.utils.config import VOLUME_RADII

    for name, row in vol["forms"].items():
        if "ms_per_sweep" not in row:
            continue
        cells = row["cells"]
        row["bound_ms"] = (costmodel.volume_bytes_per_cell_iter("f32", 2)
                           * cells / (hbm_gbps * 1e9) * 1e3)
        row["least_bytes_ms"] = 16.0 * cells / HBM_BYTES_PER_S * 1e3
        n = round(cells ** (1 / 3))
        row["predicted_ms"] = costmodel.predict_volume_seconds_per_cell_iter(
            (1, 1), (n, n), n, VOLUME_RADII[name], 1, name,
            costmodel.H100) * cells * 1e3
        row["fraction_of_bound"] = row["bound_ms"] / row["ms_per_sweep"]
        row["hbm_gbps"] = hbm_gbps


# ---------------------------------------------------------------------------
# Phase 4b: run to convergence
# ---------------------------------------------------------------------------


def expected_converge_launches(filt, backend: str, fuse: int,
                               check_every: int, iters: int, max_iters: int,
                               grid_shape, block_hw) -> dict:
    """Launches of a convergence run that ran ``iters`` iterations: per
    chunk of n, ``(n-1)//f`` fused steps, ``(n-1)%f`` single ones and the
    pair step, f the run's fuse clamped to the chunk (step.py)."""
    from parallel_convolution_tpu_torch.ops import rdma, stencil

    counts = {k: 0 for k in KERNELS}
    nb = grid_shape[0] * grid_shape[1]

    def add(T, times):
        if times == 0:
            return
        if backend == "cuda_rdma":
            plan = rdma.rdma_plan(filt.radius, T, block_hw)
            counts["rdma_" + plan.kernel] += times
            counts["fused_iterate"] += times * nb * (len(plan.groups) - 1)
        elif T == 1:
            counts["stencil_step"] += times * nb
        else:
            groups = stencil.fused_plan(filt.radius, T, block_hw)[2]
            counts["fused_iterate"] += times * nb * len(groups)

    run_fuse = max(1, min(fuse, check_every - 1))
    done = 0
    while done < iters:
        n = min(check_every, max_iters - done)
        f = max(1, min(run_fuse, max(1, n - 1)))
        fused = (n - 1) // f if f > 1 and n > 1 else 0
        add(f, fused)
        add(1, n - 1 - fused * f + 1)
        done += n
    return counts


def converge_phase(dev, tmp: Path, totals: dict, keep: dict) -> list:
    """BASELINE config 5 at full size on one card, ``run --converge``
    through the CLI (--fast, and cuda_rdma at 16x16: K3), and the stream;
    each against the plain ``shifted`` converge on the card, its launches
    counted into ``totals``.  Config 5's field stays on the card in
    ``keep["config5"]`` for the multigrid phase (the same problem)."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import JacobiSolver
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import halo, step
    from parallel_convolution_tpu_torch.utils import imageio
    from parallel_convolution_tpu_torch.utils.bench import converge_input

    rows = []

    def counted(label, fn, expect_of):
        """``fn()`` with the counters at 0 before and read after; its
        launches checked against ``expect_of(result)`` and added to the
        totals."""
        def readbacks():
            return (step.sharded_converge.readbacks
                    + step.sharded_converge_stream.readbacks)

        stencil.reset_launch_counts()
        reads = readbacks()
        out, secs = host_seconds(fn)
        counts = stencil.launch_counts()
        reads = readbacks() - reads
        want = expect_of(out)
        check(counts == want,
              f"{label}: launches {counts}, expected {want}")
        check(any(counts.values()), f"{label}: no kernel launched")
        for k, v in counts.items():
            totals[k] += v
        print(f"converge {label}: launches {counts}, {secs:.4f} s, "
              f"{reads} readbacks")
        return out, counts, secs, reads

    # (a) BASELINE config 5: jacobi3 to tol 1e-3 on a normal field at
    # 32768x32768, one card, every 10 iterations a check.
    jacobi3 = get_filter("jacobi3")
    H, W = CONVERGE_HW
    t0 = time.perf_counter()
    x = converge_input(CONVERGE_HW, 1, seed=0)
    make_s = time.perf_counter() - t0
    solver = JacobiSolver("jacobi3", tol=1e-3, max_iters=CONVERGE_MAX_ITERS,
                          check_every=10, backend="cuda", quantize=False,
                          storage="f32", fuse=9, device=dev)
    label = f"config 5 jacobi3 {H}x{W} f32 cuda fuse 9 check_every 10"
    torch.cuda.reset_peak_memory_stats(dev)

    def expect5(res):
        return expected_converge_launches(jacobi3, "cuda", 9, 10, res[1],
                                          CONVERGE_MAX_ITERS, (1, 1), (H, W))

    (out, iters), counts, first, reads = counted(label,
                                                 lambda: solver.solve(x),
                                                 expect5)
    peak = torch.cuda.max_memory_allocated(dev)
    check(reads == -(-iters // 10), f"{label}: {reads} readbacks for "
          f"{iters} iterations")
    check(out.shape == (1, H, W) and bool(np.isfinite(out).all()),
          f"{label}: result not finite or of shape {out.shape}")
    # No second solve from the host (a 4.3 GB copy each way, 3.3 s on an
    # H100 80GB HBM3 host): first and resident are timed.
    xd = torch.from_numpy(x).to(dev)
    del x
    _, resident = host_seconds(lambda: step.sharded_converge(
        xd, jacobi3, 1e-3, CONVERGE_MAX_ITERS, check_every=10,
        backend="cuda", fuse=9, device=dev))
    stencil.reset_launch_counts()  # not main-path launches

    def stream(backend, **kw):
        """The stream of the same run: every chunk's (iterations, diff),
        and the last image (only it is kept: 4.29 GB a yield)."""
        diffs, last = [], None
        for last, done, d in step.sharded_converge_stream(
                xd, jacobi3, 1e-3, CONVERGE_MAX_ITERS, check_every=10,
                backend=backend, device=dev, **kw):
            diffs.append((done, d))
        return last, diffs

    # A run capped short of convergence stops at the cap on both sides, so
    # the stop quantity itself is compared: every chunk's diff.
    last, diffs = stream("cuda", fuse=9)
    check(diffs[-1][0] == iters and np.array_equal(last, out),
          f"{label}: the stream ran {diffs[-1][0]} iterations, or its last "
          "image differs from the solver's")
    del last
    ref, ref_diffs = stream("shifted")
    stencil.reset_launch_counts()  # not main-path launches
    diff, ref_iters = diffs[-1][1], ref_diffs[-1][0]
    check(ref_iters == iters,
          f"{label}: {iters} iterations, shifted {ref_iters}")
    got, ref = torch.from_numpy(out).to(dev), torch.from_numpy(ref).to(dev)
    del out
    # In f32: agree()'s float64 copies would take 26 GB at this size.
    err = float((got - ref).abs_().max())
    # jacobi3's taps are dyadic: every product is exact, so FMA and
    # multiply-then-add round alike and the kernels must give the plain
    # version's bits, field and diffs.
    check(err == 0.0 and diffs == ref_diffs,
          f"{label}: differs from shifted by {err}, or its diffs "
          f"{diffs[-3:]} from shifted's {ref_diffs[-3:]}")
    del got, ref
    # The pieces of one chunk, at this size: K2 (9 levels), K1 (the pair
    # step), the diff.
    padded9 = halo.halo_exchange([[xd]], 9, (1, 1), "zero")[0][0]
    k2_ms = cuda_ms(lambda: stencil.fused_iterate(
        padded9, (0, 0), jacobi3, 9, (H, W), quantize=False), reps=3,
        warmup=1)
    del padded9
    padded1 = halo.halo_exchange([[xd]], 1, (1, 1), "zero")[0][0]
    k1_ms = cuda_ms(lambda: stencil.stencil_step(padded1, jacobi3,
                                                 quantize=False), reps=5,
                    warmup=1)
    del padded1
    prev = xd + 1
    diff_ms = cuda_ms(lambda: step._max_abs_diff(xd, prev), reps=5, warmup=1)
    del prev
    keep["config5"] = xd
    del xd
    stencil.reset_launch_counts()  # not main-path launches
    torch.cuda.empty_cache()
    px = H * W
    rows.append({
        "path": label, "iters": iters, "max_iters": CONVERGE_MAX_ITERS,
        "final_diff": diff, "final_diff_shifted": ref_diffs[-1][1],
        "converged": diff < 1e-3, "launches": counts, "readbacks": reads,
        "max_abs_err": err,
        "input_s": make_s, "seconds_first": first,
        "seconds_resident": resident,
        "gpx_per_s_first": iters * px / first / 1e9,
        "gpx_per_s_resident": iters * px / resident / 1e9,
        "k2_T9_ms": k2_ms, "k1_ms": k1_ms, "diff_ms": diff_ms,
        "kernel_ms": (counts["fused_iterate"] * k2_ms
                      + counts["stencil_step"] * k1_ms),
        "diff_ms_per_run": reads * diff_ms,
        "max_memory_allocated": peak, "card": card_line()})
    print(f"config 5: {iters} iterations, final diff {diff}, converged "
          f"{rows[-1]['converged']}, max_memory_allocated {peak} B "
          f"({peak / 2**30:.2f} GiB)")

    # (b) run --converge through the CLI on BASELINE config 1's image.
    blur3 = get_filter("blur3")
    rows_, cols_ = RGB_HW
    img = imageio.generate_test_image(rows_, cols_, "grey", seed=2)
    src = tmp / "converge.raw"
    imageio.write_raw(src, img)
    xg = img[None].astype(np.float32)
    want, want_iters = step.sharded_converge(
        xg, blur3, 0.5, CONVERGE_CLI_MAX, check_every=10, quantize=True,
        backend="shifted", device=dev)
    stencil.reset_launch_counts()  # not main-path launches
    want = np.clip(np.rint(want.cpu().numpy()), 0, 255).astype(np.uint8)[0]
    check(want_iters < CONVERGE_CLI_MAX,
          f"shifted did not converge in {CONVERGE_CLI_MAX} iterations")
    # The separate-devices phase runs the same converge on slots.
    keep["cli_converge"] = (src, want, want_iters)
    block16 = tuple(-(-n // g) for n, g in zip(RGB_HW, GREY_GRID))
    grid16 = f"{GREY_GRID[0]}x{GREY_GRID[1]}"
    for tag, extra, expect in (
            ("--fast", ["--fast"],
             lambda it: expected_converge_launches(
                 blur3, "cuda_sep", 32, 10, it, CONVERGE_CLI_MAX, (1, 1),
                 RGB_HW)),
            (f"--backend cuda_rdma --mesh {grid16} --storage u8 --fuse 8",
             ["--backend", "cuda_rdma", "--mesh", grid16, "--storage", "u8",
              "--fuse", "8"],
             lambda it: expected_converge_launches(
                 blur3, "cuda_rdma", 8, 10, it, CONVERGE_CLI_MAX, GREY_GRID,
                 block16))):
        dst = tmp / "converge.out.raw"
        label = f"cli run --converge 0.5 --check-every 10 grey {rows_}x{cols_} blur3 {tag}"
        argv = ["run", str(src), str(rows_), str(cols_), str(CONVERGE_CLI_MAX),
                "grey", "-o", str(dst), "--converge", "0.5", "--check-every",
                "10"] + extra
        said = []

        def run_cli():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(argv)
            check(rc == 0, f"{label}: the CLI exited {rc}")
            said.append(buf.getvalue().strip().splitlines()[-1])
            return int(said[-1].split()[2])

        it, counts, secs, reads = counted(label, run_cli, expect)
        check(it == want_iters and said[-1].startswith(
            f"converged after {want_iters} iters"),
              f"{label}: said {said[-1]!r}, shifted ran {want_iters}")
        check(np.array_equal(imageio.read_raw(dst, rows_, cols_, "grey"),
                             want), f"{label}: differs from shifted")
        stencil.reset_launch_counts()
        _, warm = host_seconds(run_cli)
        stencil.reset_launch_counts()  # counted once, in the first run
        rows.append({"path": label, "iters": it, "converged": True,
                     "launches": counts, "readbacks": reads,
                     "seconds_first": secs, "seconds_warm": warm,
                     "gpx_per_s_first": it * rows_ * cols_ / secs / 1e9,
                     "gpx_per_s_warm": it * rows_ * cols_ / warm / 1e9})

    # (c) the stream: one yield and one readback a chunk, its last image
    # sharded_converge's bytes.
    kw = dict(check_every=10, quantize=True, backend="cuda_sep",
              storage="bf16", fuse=9, device=dev)
    label = f"sharded_converge_stream grey {rows_}x{cols_} blur3 cuda_sep bf16 fuse 9"
    streamed = []

    def stream():
        streamed.clear()
        before = step.sharded_converge_stream.readbacks
        streamed.extend(step.sharded_converge_stream(
            xg, blur3, 0.5, CONVERGE_CLI_MAX, **kw))
        return step.sharded_converge_stream.readbacks - before

    reads, counts, secs, _ = counted(
        label, stream, lambda r: expected_converge_launches(
            blur3, "cuda_sep", 9, 10, streamed[-1][1], CONVERGE_CLI_MAX,
            (1, 1), RGB_HW))
    whole, whole_iters = step.sharded_converge(xg, blur3, 0.5,
                                               CONVERGE_CLI_MAX, **kw)
    stencil.reset_launch_counts()  # not main-path launches
    chunks = -(-whole_iters // 10)
    check(len(streamed) == reads == chunks and streamed[-1][1] == whole_iters,
          f"{label}: {len(streamed)} yields, {reads} readbacks, "
          f"{chunks} chunks")
    check(streamed[-1][0].tobytes() == whole.cpu().numpy().tobytes(),
          f"{label}: the last image differs from sharded_converge's")
    check(streamed[-1][2] < 0.5, f"{label}: did not converge")
    rows.append({"path": label, "iters": whole_iters, "yields": len(streamed),
                 "readbacks": reads, "launches": counts, "seconds": secs})
    return rows


# ---------------------------------------------------------------------------
# Phase 4h: blocks on separate devices (ROADMAP item 10)
# ---------------------------------------------------------------------------


def slot_devices(dev, shape, layout: str):
    """A grid's slots: every one on ``dev`` (one card), or round-robin over
    the cards (``all``)."""
    return [dev] * (shape[0] * shape[1]) if layout == "one card" else "all"


def expected_slot_launches(filt, fuse: int, grid_shape, block_hw,
                           packed: bool) -> dict:
    """Launches of one ``ITERS``-iteration ``cuda_rdma`` run on a grid of
    slots: per chunk one K3 or K4 launch per slot (and one pack per slot
    with the packed transport on more than one column), and K2 once per
    slot for each later level group."""
    from parallel_convolution_tpu_torch.ops import rdma

    counts = {k: 0 for k in KERNELS}
    nb = grid_shape[0] * grid_shape[1]
    n_chunks, rem = divmod(ITERS, fuse)
    for T, n in ((fuse, n_chunks), (rem, 1 if rem else 0)):
        if n == 0:
            continue
        plan = rdma.rdma_plan(filt.radius, T, block_hw)
        counts[f"rdma_{plan.kernel}_slot"] += n * nb
        counts["fused_iterate"] += n * nb * (len(plan.groups) - 1)
        if packed and grid_shape[1] > 1:
            counts["rdma_pack"] += n * nb
    return counts


def slot_launch_ms(run, per_slot, reps: int) -> float:
    """CUDA-event ms of one launch on every slot of ``run`` (``per_slot(s)``
    on slot s's stream), between the fork from and the join into the
    current stream: the per-slot form's cost for the grid's work."""
    def once():
        run.fork()
        for s, st in enumerate(run.streams):
            per_slot(s)
            run.launched[s].record(st)
        run.join()

    return cuda_ms(once, reps=reps)


def first_group_plain(blocks, filt, grid_shape, T: int, levels: int,
                      valid, out_dtype):
    """Plain version of the first level group of a ``T``-level chunk on a
    grid of slots, as the per-slot K3 / K4 launch computes it: each block
    padded at depth r·T by the per-block exchange (NaN until its slab
    lands), then ``levels`` of K2's plain levels into the block widened by
    r·(T - levels) on each side, at that rim's global offsets."""
    import torch

    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.parallel import halo

    r = filt.radius
    ext = r * (T - levels)
    h, w = blocks[0][0].shape[1:]
    padded = halo.exchange_per_block(blocks, r * T, grid_shape, "zero",
                                     dtype=torch.float32, fill=float("nan"))
    return torch.stack([
        stencil.fused_iterate_plain(p, (i * h - ext, j * w - ext), filt,
                                    levels, valid, True, out_dtype)
        for i, row in enumerate(padded) for j, p in enumerate(row)])


def time_pack_alone(run, depth: int, nbytes: float) -> dict:
    """Slot 0's pack alone (``rdma.rdma_pack``), on its stream: launched
    back to back and queued ahead of the card (``device_ms``, the kernel's
    own time), beside an empty kernel (``torch.cuda._sleep(0)``) timed the
    same way on that stream (``floor_ms``: the launch's floor) and the
    same calls not queued ahead (``host_ms``); ``vec`` is the bytes a
    thread moves (``rdma.pack_plan``), ``bound_ms`` one slot's staging
    (``nbytes``) read once and written once."""
    import torch

    from parallel_convolution_tpu_torch.ops import rdma

    one = lambda: rdma.rdma_pack(run, 0, 0, depth)  # noqa: E731
    with torch.cuda.stream(run.streams[0]):
        device_ms = cuda_ms(one, reps=500, warmup=20, queue_ahead=True)
        floor_ms = cuda_ms(lambda: torch.cuda._sleep(0), reps=500,
                           warmup=20, queue_ahead=True)
        host_ms = cuda_ms(one, reps=500, warmup=20)
    b_ms, b_by = bound(nbytes, 0.0)
    return dict(vec=run.pack_plans[(0, 0, depth, 1)].vec,
                threads=list(run.pack_plans[(0, 0, depth, 1)].threads),
                device_ms=device_ms, floor_ms=floor_ms, host_ms=host_ms,
                bound_ms=b_ms, bound_by=b_by,
                over_floor=device_ms / max(b_ms, floor_ms))


def time_slot_kernels(dev, rgb, grey, big, blur3, edge5) -> dict:
    """The per-slot kernels at the separate-devices phase's launches, each
    over the whole grid (one launch a slot): the first level group of a
    chunk as ``rdma._slots_step`` plans it (its kernel, its levels and its
    widened output), beside its plain version and its bound; and the
    column-transport probe that ``pick_col_mode`` reads: those launches
    reading the staging (packed) against reading in place (strided), the
    pack launches, and the host's seconds a barrier wait.  The kernels
    line takes config 2's K4 and the 16x16 split's K3; config 3's K4 is
    reported beside them."""
    import torch

    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.ops import rdma, stencil
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.tuning import costmodel
    from parallel_convolution_tpu_torch.utils import imageio

    out, probe = {}, {}
    for key, img, storage, shape, T, filt in (
            ("config 2", rgb, "bf16", (2, 2), 32, blur3),
            ("config 3", big, "bf16", (4, 4), 32, edge5),
            ("grey 16x16", grey, "u8", GREY_GRID, 8, blur3)):
        planar = imageio.interleaved_to_planar(img)
        grid = mesh.make_grid(shape, devices=slot_devices(dev, shape,
                                                          "one card"))
        blocks = convert.blocks_from_numpy(planar, grid, storage)
        valid = planar.shape[1:]
        C, h, w = blocks[0][0].shape
        nb = shape[0] * shape[1]
        r = filt.radius
        plan = rdma.rdma_plan(r, T, (h, w), None, stencil._smem_limit(dev))
        levels = plan.groups[0]
        ext = r * (T - levels)
        tiled = plan.kernel == "tiled"
        launch = rdma.rdma_tiled_slot if tiled else rdma.rdma_block_slot
        kind = "rdma_tiled_slot" if tiled else "rdma_block_slot"
        mid = stencil.group_dtype(True, blocks[0][0].dtype)
        runs = {cm: rdma.slot_carry(blocks, grid, "zero", r * T, cm).run
                for cm in ("strided", "packed")}
        outs = [torch.empty((C, h + 2 * ext, w + 2 * ext), dtype=mid,
                            device=dev) for _ in range(nb)]
        kw = dict(ext=ext, **(dict(tile=plan.tile) if tiled else {}))

        def main(run):
            return lambda s: launch(run, 0, s, outs[s], filt, levels, valid,
                                    **kw)

        depth = r * T
        pack = lambda s: rdma.rdma_pack(runs["packed"], 0, s, depth)
        slot_launch_ms(runs["packed"], pack, reps=3)  # the staging filled
        reps = 20 if T * r * r <= 8 else 10
        ms = slot_launch_ms(runs["strided"], main(runs["strided"]), reps)
        got = torch.stack(outs)
        plain = lambda: first_group_plain(blocks, filt, shape, T, levels,
                                          valid, mid)
        want = plain()
        ok, err = agree(got, want, filt, levels, True)
        check(ok, f"{kind} at {key}'s blocks {shape} x {(C, h, w)}, the "
                  f"first {levels} of {T} levels into a {ext}-pixel rim: "
                  f"err {err}")
        packed_ms = slot_launch_ms(runs["packed"], main(runs["packed"]),
                                   reps)
        check(torch.equal(torch.stack(outs), got),
              f"{kind} at {key}: the packed transport differs from strided")
        plain_ms = cuda_ms(plain, reps=1, warmup=1)
        # The least work of the launch: each block's pixels once a level
        # (the rim is its neighbours' pixels, computed by them), each
        # block read once and its widened output written once.
        ops = nb * C * levels * level_ops(filt, False, h, w, True, False)
        nbytes = (nb * C * h * w * blocks[0][0].element_size()
                  + got.numel() * got.element_size())
        b_ms, b_by = bound(nbytes, ops)
        row = dict(grid=list(shape), block=[C, h, w], T=T, levels=levels,
                   ext=ext, filter=filt.name, dtype=str(got.dtype), ms=ms,
                   packed_ms=packed_ms, plain_ms=plain_ms, max_abs_err=err,
                   library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   fraction_of_bound=b_ms / ms)
        if kind in out:
            out[kind].setdefault("also", {})[key] = row
        else:
            out[kind] = dict(row, at=key)
        pack_ms = slot_launch_ms(runs["packed"], pack, reps=20)
        slabs = [rdma.staged_slabs(runs["packed"], s, depth)
                 for s in range(nb)]
        wants = rdma.rdma_pack_plain(blocks, shape, "zero", depth)
        perr = max(max_abs_err(a, b) for a, b in zip(slabs, wants))
        check(all(torch.equal(a, b) for a, b in zip(slabs, wants)),
              f"rdma_pack at {key}: staging differs from its plain version")
        rows = h + 2 * depth
        elt = blocks[0][0].element_size()
        nbytes = 2 * nb * 2 * C * rows * depth * elt
        pb_ms, pb_by = bound(nbytes, 0.0)
        alone = time_pack_alone(runs["packed"], depth, nbytes / nb)
        alone.update(slot_launch_ms=pack_ms,
                     parent=PACK_PARENT_MS.get(key))
        if key == "config 2":
            out["rdma_pack"] = dict(
                grid=list(shape), slab=[2, C, rows, depth], ms=pack_ms,
                plain_ms=cuda_ms(lambda: rdma.rdma_pack_plain(
                    blocks, shape, "zero", depth), reps=2, warmup=1),
                max_abs_err=perr, library_ms=None, bound_ms=pb_ms,
                bound_by=pb_by, fraction_of_bound=pb_ms / pack_ms,
                device_ms=alone["device_ms"], alone={})
        out["rdma_pack"]["alone"][key] = alone
        # The prices pick_col_mode reads: a padded row of one channel read
        # in place over read from the staging, and a pack launch's fixed
        # part (its time less its bytes at the data sheet's rate).
        probe[key] = dict(
            grid=list(shape), block=[C, h, w], radius=r, T=T,
            storage=storage, strided_ms=ms, packed_ms=packed_ms,
            pack_ms=pack_ms,
            col_row_s=max(0.0, (ms - packed_ms) / 1e3) / (nb * 2 * C * rows),
            pack_s=max(0.0, pack_ms / 1e3 / nb - nbytes / nb
                       / HBM_BYTES_PER_S))
        del runs, outs, got, want
    waits = torch.cuda.Stream(device=dev)
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.perf_counter()
    for _ in range(2000):
        waits.wait_event(ev)
    probe["event_s"] = (time.perf_counter() - t0) / 2000
    # The least over the shapes: where the launches are host-bound (256
    # slots of small blocks) the strided / packed difference is the host's
    # noise, not the column read.
    probe["col_row_s"] = min(p["col_row_s"] for k, p in probe.items()
                             if isinstance(p, dict))
    probe["pack_s"] = min(p["pack_s"] for k, p in probe.items()
                          if isinstance(p, dict))
    measured = dataclasses.replace(costmodel.H100,
                                   col_row_s=probe["col_row_s"],
                                   pack_s=probe["pack_s"],
                                   event_s=probe["event_s"])
    probe["picks"] = {
        k: costmodel.pick_col_mode(p["grid"], p["block"][1:], p["radius"],
                                   p["T"], p["storage"], measured,
                                   p["block"][0])
        for k, p in probe.items() if isinstance(p, dict)}
    probe["committed"] = {k: getattr(costmodel.H100, k)
                          for k in ("col_row_s", "pack_s", "event_s")}
    return {"kernels": out, "probe": probe}


def separate_devices_phase(dev, tmp: Path, refs: dict, totals: dict,
                           keep: dict) -> dict:
    """BASELINE configs 2 (2x2, 4 slots) and 3 (4x4, 16 slots), the 256-rank
    split (16x16, K3 per slot) and ``run --converge`` on config 1's image
    at 2x2, every block on a device slot of its own: the port's per-slot
    form against its one-card form and ``shifted``, counted into the
    kernels line; the per-slot kernels against their plain versions; the
    column-transport probe; and a 1 ms spin before each chunk on one
    slot's stream leaving the bytes unchanged.  With two cards or more the
    paths run again round-robin over the cards, peer access on."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import rdma, stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio

    cards = torch.cuda.device_count()
    layouts = ["one card"] + (["all"] if cards >= 2 else [])
    blur3, edge5 = get_filter("blur3"), get_filter("edge5")
    rgb, rgb_ref = refs["rgb"], refs["rgb_ref"]
    grey, grey_ref = refs["greys"]["blur3"], refs["grey_refs"]["blur3"]
    edge_ref = refs["grey_refs"]["edge5"]
    report = {"cards": cards, "layouts": layouts, "runs": []}
    px2 = RGB_HW[0] * RGB_HW[1] * 3
    block2 = tuple(-(-n // 2) for n in RGB_HW)
    block3 = tuple(n // 4 for n in BIG_HW)
    block16 = tuple(-(-n // g) for n, g in zip(RGB_HW, GREY_GRID))
    per = lambda f, T, hw, nb: {k: nb * v for k, v in
                                expected_launches(f, T, hw).items()}

    def resident(model, planar):
        return min(host_seconds(lambda: model.run_planar(planar, ITERS))[1]
                   for _ in range(2))

    for layout in layouts:
        print(f"separate devices ({layout}): {cards} card(s); slots of 2x2 "
              f"{mesh.make_grid((2, 2), devices=slot_devices(dev, (2, 2), layout)).slot_map()}")
        # (a) configs 2 and 3 and the 16x16 split through the model.
        planar_rgb = torch.from_numpy(
            imageio.interleaved_to_planar(rgb).copy()).to(dev, torch.float32)
        planar_grey = torch.from_numpy(grey[None].copy()).to(dev,
                                                             torch.float32)
        cases = []
        for cm in ("packed", "strided"):
            cases.append((f"config 2 rgb blur3 cuda_rdma bf16 fuse 32 "
                          f"col_mode {cm}", rgb, rgb_ref, planar_rgb, px2,
                          (2, 2), dict(backend="cuda_rdma", storage="bf16",
                                       fuse=32, col_mode=cm),
                          expected_slot_launches(blur3, 32, (2, 2), block2,
                                                 cm == "packed")))
        cases += [
            ("config 2 rgb blur3 cuda_sep bf16 fuse 32", rgb, rgb_ref,
             planar_rgb, px2, (2, 2),
             dict(backend="cuda_sep", storage="bf16", fuse=32),
             per(blur3, 32, block2, 4)),
            ("config 2 rgb blur3 cuda f32 fuse 1", rgb, rgb_ref, planar_rgb,
             px2, (2, 2), dict(backend="cuda", storage="f32", fuse=1),
             per(blur3, 1, block2, 4))]
        for cm in ("packed", "strided"):
            cases.append((f"grey 16x16 blur3 cuda_rdma u8 fuse 8 col_mode "
                          f"{cm}", grey, grey_ref, planar_grey,
                          RGB_HW[0] * RGB_HW[1], GREY_GRID,
                          dict(backend="cuda_rdma", storage="u8", fuse=8,
                               col_mode=cm),
                          expected_slot_launches(blur3, 8, GREY_GRID,
                                                 block16, cm == "packed")))
        for label, img, want, planar, pixels, shape, kw, expect in cases:
            grid = mesh.make_grid(shape, devices=slot_devices(dev, shape,
                                                              layout))
            model = ConvolutionModel("blur3", grid=grid, **kw)
            out, counts, secs = drive(f"{label} on {layout} slots",
                                      lambda: model.run_image(img, ITERS),
                                      expect, pixels,
                                      no_halo=kw["backend"] == "cuda_rdma")
            for k, v in counts.items():
                totals[k] += v
            check(np.array_equal(out, want), f"{label}: differs from shifted")
            one = ConvolutionModel("blur3", grid=mesh.make_grid(shape, dev),
                                   **kw)
            check(np.array_equal(one.run_image(img, ITERS), out),
                  f"{label}: differs from the one-card form")
            report["runs"].append(dict(
                path=label, layout=layout, slots=grid.slot_map()
                if layout != "one card" else f"{shape[0] * shape[1]} x {dev}",
                col_mode=model.effective_col_mode, launches=counts,
                seconds_first=secs,
                seconds_resident_slots=resident(model, planar),
                seconds_resident_one_card=resident(one, planar)))
        # (b) config 3 through the CLI (--device takes the slot list).
        src = tmp / "edge5.raw"
        dst = tmp / "edge5.slots.raw"
        shape = (4, 4)
        slots = slot_devices(dev, shape, layout)
        spec = ",".join(map(str, slots)) if layout == "one card" else "all"
        planar8k = torch.from_numpy(refs["greys"]["edge5"][None].copy()).to(
            dev, torch.float32)
        for backend, cm in (("cuda_rdma", "packed"), ("cuda_rdma", "strided"),
                            ("cuda", "auto")):
            label = (f"config 3 cli run grey 8192x8192 edge5 --backend "
                     f"{backend} --mesh 4x4 --device <16 slots> --storage "
                     f"bf16 --fuse 32 --col-mode {cm}")
            argv = ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]),
                    str(ITERS), "grey", "-o", str(dst), "--filter", "edge5",
                    "--backend", backend, "--mesh", "4x4", "--device", spec,
                    "--storage", "bf16", "--fuse", "32", "--col-mode", cm]

            def run_cli():
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli_main(argv)
                check(rc == 0, f"{label}: the CLI exited {rc}")
                return buf.getvalue().strip().splitlines()[-1]

            expect = (expected_slot_launches(edge5, 32, shape, block3,
                                             cm == "packed")
                      if backend == "cuda_rdma" else
                      per(edge5, 32, block3, 16))
            line, counts, secs = drive(f"{label} on {layout} slots", run_cli,
                                       expect, BIG_HW[0] * BIG_HW[1],
                                       no_halo=backend == "cuda_rdma")
            for k, v in counts.items():
                totals[k] += v
            check("slots " in line, f"{label}: said {line!r}")
            check(np.array_equal(imageio.read_raw(dst, *BIG_HW, "grey"),
                                 edge_ref), f"{label}: differs from shifted")
            kw = dict(backend=backend, storage="bf16", fuse=32, col_mode=cm)
            model = ConvolutionModel(
                "edge5", grid=mesh.make_grid(shape, devices=slots), **kw)
            one = ConvolutionModel("edge5", grid=mesh.make_grid(shape, dev),
                                   **kw)
            check(torch.equal(model.run_planar(planar8k, ITERS),
                              one.run_planar(planar8k, ITERS)),
                  f"{label}: differs from the one-card form")
            report["runs"].append(dict(
                path=label, layout=layout, said=line, launches=counts,
                seconds_first=secs,
                seconds_resident_slots=resident(model, planar8k),
                seconds_resident_one_card=resident(one, planar8k)))
        # (c) run --converge 0.5 --check-every 10 on config 1's image at
        # 2x2 slots, against the one-card 2x2 run and shifted.
        csrc, cwant, citers = keep["cli_converge"]
        spec = (",".join(map(str, slot_devices(dev, (2, 2), layout)))
                if layout == "one card" else "all")
        for backend in ("cuda_rdma", "cuda"):
            outs = {}
            for where, dflag in (("slots", ["--device", spec]),
                                 ("one card", [])):
                cdst = tmp / f"converge.{where.replace(' ', '_')}.raw"
                label = (f"cli run --converge 0.5 --check-every 10 grey "
                         f"1920x2520 blur3 --backend {backend} --mesh 2x2 "
                         f"on {where}")
                argv = (["run", str(csrc), str(RGB_HW[0]), str(RGB_HW[1]),
                         str(CONVERGE_CLI_MAX), "grey", "-o", str(cdst),
                         "--converge", "0.5", "--check-every", "10",
                         "--backend", backend, "--mesh", "2x2"] + dflag)
                buf = io.StringIO()
                stencil.reset_launch_counts()
                with contextlib.redirect_stdout(buf):
                    rc, secs = host_seconds(lambda: cli_main(argv))
                counts = stencil.launch_counts()
                check(rc == 0, f"{label}: the CLI exited {rc}")
                said = buf.getvalue().strip().splitlines()[-1]
                check(said.startswith(f"converged after {citers} iters"),
                      f"{label}: said {said!r}, shifted ran {citers}")
                outs[where] = imageio.read_raw(cdst, *RGB_HW, "grey")
                check(np.array_equal(outs[where], cwant),
                      f"{label}: differs from shifted")
                if where == "slots":
                    slot_kernel = ("rdma_tiled_slot" if backend == "cuda_rdma"
                                   else "stencil_step")
                    check(counts[slot_kernel] > 0
                          and counts["rdma_tiled"] == 0,
                          f"{label}: launches {counts}")
                    for k, v in counts.items():
                        totals[k] += v
                report["runs"].append(dict(path=label, layout=layout,
                                           iters=citers, launches=counts,
                                           seconds=secs))
                print(f"separate devices {label}: {counts}, {secs:.4f} s")
    # (d) the skew: ~1 ms of spin on slot 1's stream before each chunk of
    # config 2's cuda_rdma run leaves every byte where it was.
    planar = imageio.interleaved_to_planar(rgb)
    for cm in ("packed", "strided"):
        grid = mesh.make_grid((2, 2), devices=slot_devices(dev, (2, 2),
                                                           "one card"))
        carry = rdma.slot_carry(convert.blocks_from_numpy(planar, grid,
                                                          "bf16"),
                                grid, "zero", 32, cm)
        for T in (32, 32, 32, ITERS % 32):
            with torch.cuda.stream(carry.run.streams[1]):
                torch.cuda._sleep(2_000_000)
            carry = rdma.fused_rdma_slots(carry, blur3, (2, 2), "zero",
                                          fuse=T, valid_hw=RGB_HW,
                                          col_mode=cm)
        got = mesh.join_blocks(rdma.slot_blocks(carry, (2, 2)))
        got = got[:, :RGB_HW[0], :RGB_HW[1]].to(torch.uint8).cpu().numpy()
        check(np.array_equal(imageio.planar_to_interleaved(got), rgb_ref),
              f"skew ({cm}): the skewed run differs from shifted")
    report["skew"] = "equal under a 1 ms spin before every chunk on slot 1"
    stencil.reset_launch_counts()  # not main-path launches
    report["timed"] = time_slot_kernels(dev, rgb, grey,
                                        refs["greys"]["edge5"], blur3, edge5)
    return report


# ---------------------------------------------------------------------------
# Phase 4i: the overlapped pipeline (ROADMAP item 10b)
# ---------------------------------------------------------------------------


def expected_overlap_launches(filt, fuse: int, grid_shape, block_hw,
                              packed: bool) -> dict:
    """Launches of one ``ITERS``-iteration overlapped ``cuda_rdma`` run on a
    grid of slots: per chunk and slot the first level group's K3 or K4
    region by region (``rdma.overlap_regions`` on its rim-extended
    output), K2 for each later group, and a pack with the packed transport
    on more than one column."""
    from parallel_convolution_tpu_torch.ops import rdma

    counts = {k: 0 for k in KERNELS}
    nb = grid_shape[0] * grid_shape[1]
    r = filt.radius
    n_chunks, rem = divmod(ITERS, fuse)
    for T, n in ((fuse, n_chunks), (rem, 1 if rem else 0)):
        if n == 0:
            continue
        plan = rdma.rdma_plan(r, T, block_hw)
        ext = r * (T - plan.groups[0])
        regions = sum(len(g) for g in rdma.overlap_regions(
            block_hw[0] + 2 * ext, block_hw[1] + 2 * ext, r * T))
        counts[f"rdma_{plan.kernel}_region"] += n * nb * regions
        counts["fused_iterate"] += n * nb * (len(plan.groups) - 1)
        if packed and grid_shape[1] > 1:
            counts["rdma_pack"] += n * nb
    return counts


def slot_kernel_run(planar, grid, filt, storage: str, fuse: int, col_mode,
                    skew: bool = False, **kw):
    """``ITERS`` iterations of ``cuda_rdma`` on the grid of slots straight
    at the kernel layer (``rdma.fused_rdma_slots``: ``kw`` its overlap and
    partitioned), ``skew`` a ~10 ms spin on slot 0's stream before every
    chunk (slot 0 is a neighbour of every slot of a 2x2 grid, the
    diagonal of slot 3; and the host enqueues a step of region launches in
    about a millisecond, so phase 4h's 1 ms would leave no skew on the
    card); the interleaved u8 image."""
    import torch

    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio

    shape = grid.shape
    valid = planar.shape[1:]
    carry = rdma.slot_carry(convert.blocks_from_numpy(planar, grid, storage),
                            grid, "zero", filt.radius * fuse, col_mode)
    n, rem = divmod(ITERS, fuse)
    for T in [fuse] * n + ([rem] if rem else []):
        if skew:
            with torch.cuda.stream(carry.run.streams[0]):
                torch.cuda._sleep(20_000_000)
        carry = rdma.fused_rdma_slots(carry, filt, shape, "zero", fuse=T,
                                      valid_hw=valid, col_mode=col_mode,
                                      **kw)
    got = mesh.join_blocks(rdma.slot_blocks(carry, shape))
    got = got[:, :valid[0], :valid[1]].to(torch.uint8).cpu().numpy()
    return imageio.planar_to_interleaved(got)


@contextlib.contextmanager
def phase_order():
    """Every overlapped step in the JAX phase order (``partitioned=False``)
    while it is open: the entry points pass the knob's default."""
    import functools

    from parallel_convolution_tpu_torch.ops import rdma

    inner = rdma.fused_rdma_slots
    rdma.fused_rdma_slots = functools.partial(inner, partitioned=False)
    try:
        yield
    finally:
        rdma.fused_rdma_slots = inner


def time_region_kernels(dev, rgb, grey, big, blur3, edge5) -> dict:
    """The overlapped pipeline's region launches of K3 / K4 at the phase's
    shapes, each over the whole grid: the first level group of a chunk as
    ``rdma._slots_step`` plans it, its regions (``rdma.overlap_schedule``)
    launched one after another on every slot (the waits left out: the
    launches alone), assembled into the widened output and held against
    the plain first group; beside it the same group as one launch a slot
    (``rdma_*_slot``), in the same call."""
    import torch

    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.ops import rdma, stencil
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio

    out = {}
    for key, img, storage, shape, T, filt in (
            ("config 2", rgb, "bf16", (2, 2), 32, blur3),
            ("config 3", big, "bf16", (4, 4), 32, edge5),
            ("grey 16x16", grey, "u8", GREY_GRID, 8, blur3)):
        planar = imageio.interleaved_to_planar(img)
        grid = mesh.make_grid(shape, devices=slot_devices(dev, shape,
                                                          "one card"))
        blocks = convert.blocks_from_numpy(planar, grid, storage)
        valid = planar.shape[1:]
        C, h, w = blocks[0][0].shape
        nb = shape[0] * shape[1]
        r = filt.radius
        plan = rdma.rdma_plan(r, T, (h, w), None, stencil._smem_limit(dev))
        levels = plan.groups[0]
        ext = r * (T - levels)
        tiled = plan.kernel == "tiled"
        region = rdma.rdma_tiled_region if tiled else rdma.rdma_block_region
        whole = rdma.rdma_tiled_slot if tiled else rdma.rdma_block_slot
        kind = region.__name__
        mid = stencil.group_dtype(True, blocks[0][0].dtype)
        run = rdma.slot_carry(blocks, grid, "zero", r * T, "strided").run
        outs = [torch.full((C, h + 2 * ext, w + 2 * ext), float("nan"),
                           dtype=mid, device=dev) if mid.is_floating_point
                else torch.zeros((C, h + 2 * ext, w + 2 * ext), dtype=mid,
                                 device=dev) for _ in range(nb)]
        kw = dict(ext=ext, **(dict(tile=plan.tile) if tiled else {}))
        sched = rdma.overlap_schedule(h + 2 * ext, w + 2 * ext, r * T, ext)

        def regions(s):
            for _, rect, _ in sched:
                region(run, 0, s, outs[s], filt, levels, valid, rect, **kw)

        reps = 20 if T * r * r <= 8 else 10
        ms = slot_launch_ms(run, regions, reps)
        got = torch.stack(outs)
        want = first_group_plain(blocks, filt, shape, T, levels, valid, mid)
        ok, err = agree(got, want, filt, levels, True)
        check(ok, f"{kind} at {key}'s blocks {shape} x {(C, h, w)}, "
                  f"{len(sched)} regions of the first {levels} of {T} "
                  f"levels into a {ext}-pixel rim: err {err}")
        whole_ms = slot_launch_ms(
            run, lambda s: whole(run, 0, s, outs[s], filt, levels, valid,
                                 **kw), reps)
        check(torch.equal(torch.stack(outs), got),
              f"{kind} at {key}: the regions differ from the whole launch")
        plain_ms = cuda_ms(lambda: first_group_plain(
            blocks, filt, shape, T, levels, valid, mid), reps=1, warmup=1)
        ops = nb * C * levels * level_ops(filt, False, h, w, True, False)
        nbytes = (nb * C * h * w * blocks[0][0].element_size()
                  + got.numel() * got.element_size())
        b_ms, b_by = bound(nbytes, ops)
        row = dict(grid=list(shape), block=[C, h, w], T=T, levels=levels,
                   ext=ext, filter=filt.name, dtype=str(got.dtype),
                   regions=[lab for lab, _, _ in sched], ms=ms,
                   whole_launch_ms=whole_ms, plain_ms=plain_ms,
                   max_abs_err=err, library_ms=None, bound_ms=b_ms,
                   bound_by=b_by, fraction_of_bound=b_ms / ms)
        if kind in out:
            out[kind].setdefault("also", {})[key] = row
        else:
            out[kind] = dict(row, at=key)
        del run, outs, got, want
    return out


def overlap_phase(dev, tmp: Path, refs: dict, totals: dict,
                  keep: dict) -> dict:
    """BASELINE configs 2 (2x2, 4 slots) and 3 (4x4, 16 slots), the 256-rank
    split and ``run --converge`` on config 1's image at 2x2 slots, with
    ``cuda_rdma``'s overlapped pipeline, each in its three schedules:
    overlapped and partitioned through the entry points (counted into
    the kernels line), overlapped in the JAX phase order
    (``partitioned=False``) and serialized; both column transports; each
    byte-equal to the serialized per-slot run, to the one-card form and
    to ``shifted``, with both resident times.  Then the skew check with
    overlap on, and the region launches timed.  With two cards or more
    the paths run again round-robin over the cards."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio

    cards = torch.cuda.device_count()
    layouts = ["one card"] + (["all"] if cards >= 2 else [])
    blur3, edge5 = get_filter("blur3"), get_filter("edge5")
    rgb, grey, big = refs["rgb"], refs["greys"]["blur3"], refs["greys"]["edge5"]
    report = {"cards": cards, "layouts": layouts, "runs": []}
    block2 = tuple(-(-n // 2) for n in RGB_HW)
    block3 = tuple(n // 4 for n in BIG_HW)
    block16 = tuple(-(-n // g) for n, g in zip(RGB_HW, GREY_GRID))

    def resident(model, planar):
        return min(host_seconds(lambda: model.run_planar(planar, ITERS))[1]
                   for _ in range(2))

    for layout in layouts:
        cases = []
        for cm in ("packed", "strided"):
            cases += [
                (f"config 2 rgb blur3 cuda_rdma bf16 fuse 32 col_mode {cm}",
                 rgb, refs["rgb_ref"], (2, 2), "blur3", "bf16", 32, cm,
                 block2),
                (f"grey 16x16 blur3 cuda_rdma u8 fuse 8 col_mode {cm}", grey,
                 refs["grey_refs"]["blur3"], GREY_GRID, "blur3", "u8", 8, cm,
                 block16)]
        for label, img, want, shape, name, storage, fuse, cm, bhw in cases:
            filt = get_filter(name)
            grid = mesh.make_grid(shape, devices=slot_devices(dev, shape,
                                                              layout))
            kw = dict(backend="cuda_rdma", storage=storage, fuse=fuse,
                      col_mode=cm)
            model = ConvolutionModel(name, grid=grid, overlap=True, **kw)
            out, counts, secs = drive(
                f"overlapped {label} on {layout} slots",
                lambda: model.run_image(img, ITERS),
                expected_overlap_launches(filt, fuse, shape, bhw,
                                          cm == "packed"),
                int(np.prod(img.shape)), no_halo=True)
            for k, v in counts.items():
                totals[k] += v
            check(model.effective_overlap is True,
                  f"{label}: the model ran with overlap "
                  f"{model.effective_overlap}")
            check(np.array_equal(out, want), f"{label}: overlapped differs "
                                             "from shifted")
            planar = imageio.interleaved_to_planar(img)
            phase = slot_kernel_run(planar, grid, filt, storage, fuse, cm,
                                    overlap=True, partitioned=False)
            serial = ConvolutionModel(name, grid=grid, **kw)
            one = ConvolutionModel(name, grid=mesh.make_grid(shape, dev),
                                   **kw)
            for what, other in (("the phase order", phase),
                                ("the serialized per-slot run",
                                 serial.run_image(img, ITERS)),
                                ("the one-card form",
                                 one.run_image(img, ITERS))):
                check(np.array_equal(out, other),
                      f"{label}: overlapped differs from {what}")
            resident_in = torch.from_numpy(planar.copy()).to(dev,
                                                             torch.float32)
            with phase_order():
                phase_s = resident(model, resident_in)
            report["runs"].append(dict(
                path=label, layout=layout, launches=counts,
                seconds_first=secs,
                seconds_resident_overlapped=resident(model, resident_in),
                seconds_resident_phase_order=phase_s,
                seconds_resident_serialized=resident(serial, resident_in),
                seconds_resident_one_card=resident(one, resident_in)))
        # Config 3 through the CLI: --overlap on with the 16 slots.
        src, dst = tmp / "edge5.raw", tmp / "edge5.overlap.raw"
        shape = (4, 4)
        slots = slot_devices(dev, shape, layout)
        spec = ",".join(map(str, slots)) if layout == "one card" else "all"
        planar8k = torch.from_numpy(big[None].copy()).to(dev, torch.float32)
        for cm in ("strided", "packed"):
            label = (f"config 3 cli run grey 8192x8192 edge5 --backend "
                     f"cuda_rdma --mesh 4x4 --device <16 slots> --storage "
                     f"bf16 --fuse 32 --col-mode {cm} --overlap on")
            argv = ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]),
                    str(ITERS), "grey", "-o", str(dst), "--filter", "edge5",
                    "--backend", "cuda_rdma", "--mesh", "4x4", "--device",
                    spec, "--storage", "bf16", "--fuse", "32", "--col-mode",
                    cm, "--overlap", "on"]

            def run_cli():
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli_main(argv)
                check(rc == 0, f"{label}: the CLI exited {rc}")
                return buf.getvalue().strip().splitlines()[-1]

            line, counts, secs = drive(
                f"{label} on {layout} slots", run_cli,
                expected_overlap_launches(edge5, 32, shape, block3,
                                          cm == "packed"),
                BIG_HW[0] * BIG_HW[1], no_halo=True)
            for k, v in counts.items():
                totals[k] += v
            check("overlapped halo pipeline" in line,
                  f"{label}: said {line!r}")
            got = imageio.read_raw(dst, *BIG_HW, "grey")
            check(np.array_equal(got, refs["grey_refs"]["edge5"]),
                  f"{label}: differs from shifted")
            grid = mesh.make_grid(shape, devices=slots)
            kw = dict(backend="cuda_rdma", storage="bf16", fuse=32,
                      col_mode=cm)
            model = ConvolutionModel("edge5", grid=grid, overlap=True, **kw)
            serial = ConvolutionModel("edge5", grid=grid, **kw)
            one = ConvolutionModel("edge5", grid=mesh.make_grid(shape, dev),
                                   **kw)
            phase = slot_kernel_run(big[None], grid, edge5, "bf16", 32, cm,
                                    overlap=True, partitioned=False)
            check(np.array_equal(phase, got),
                  f"{label}: differs from the phase order")
            ser_out = serial.run_planar(planar8k, ITERS)
            check(torch.equal(model.run_planar(planar8k, ITERS), ser_out)
                  and torch.equal(one.run_planar(planar8k, ITERS), ser_out),
                  f"{label}: differs from the serialized per-slot run or "
                  "the one-card form")
            with phase_order():
                phase_s = resident(model, planar8k)
            report["runs"].append(dict(
                path=label, layout=layout, said=line, launches=counts,
                seconds_first=secs,
                seconds_resident_overlapped=resident(model, planar8k),
                seconds_resident_phase_order=phase_s,
                seconds_resident_serialized=resident(serial, planar8k),
                seconds_resident_one_card=resident(one, planar8k)))
        # run --converge 0.5 --check-every 10 on config 1's image at 2x2.
        csrc, cwant, citers = keep["cli_converge"]
        spec = (",".join(map(str, slot_devices(dev, (2, 2), layout)))
                if layout == "one card" else "all")
        for cm in ("strided", "packed"):
            seconds = {}
            for sched, flags in (("overlapped", ["--overlap", "on"]),
                                 ("phase order", ["--overlap", "on"]),
                                 ("serialized", [])):
                cdst = tmp / f"converge.{sched.replace(' ', '_')}.raw"
                label = (f"cli run --converge 0.5 --check-every 10 grey "
                         f"1920x2520 blur3 --backend cuda_rdma --mesh 2x2 "
                         f"--device <4 slots> --col-mode {cm} ({sched})")
                argv = (["run", str(csrc), str(RGB_HW[0]), str(RGB_HW[1]),
                         str(CONVERGE_CLI_MAX), "grey", "-o", str(cdst),
                         "--converge", "0.5", "--check-every", "10",
                         "--backend", "cuda_rdma", "--mesh", "2x2",
                         "--device", spec, "--col-mode", cm] + flags)
                buf = io.StringIO()
                stencil.reset_launch_counts()
                with contextlib.redirect_stdout(buf), (
                        phase_order() if sched == "phase order"
                        else contextlib.nullcontext()):
                    rc, secs = host_seconds(lambda: cli_main(argv))
                counts = stencil.launch_counts()
                check(rc == 0, f"{label}: the CLI exited {rc}")
                said = buf.getvalue().strip().splitlines()[-1]
                check(said.startswith(f"converged after {citers} iters"),
                      f"{label}: said {said!r}, shifted ran {citers}")
                check(np.array_equal(imageio.read_raw(cdst, *RGB_HW, "grey"),
                                     cwant), f"{label}: differs from shifted")
                overlapped = sched != "serialized"
                check((counts["rdma_tiled_region"] > 0) == overlapped
                      and (counts["rdma_tiled_slot"] > 0) != overlapped,
                      f"{label}: launches {counts}")
                if sched == "overlapped":
                    for k, v in counts.items():
                        totals[k] += v
                seconds[sched] = secs
                report["runs"].append(dict(path=label, layout=layout,
                                           iters=citers, launches=counts,
                                           seconds=secs))
                print(f"overlap {label}: {counts}, {secs:.4f} s")
    # The skew: ~10 ms of spin on slot 0's stream before each chunk of
    # config 2's run, overlapped, in both schedules and transports.
    planar = imageio.interleaved_to_planar(rgb)
    grid = mesh.make_grid((2, 2), devices=slot_devices(dev, (2, 2),
                                                       "one card"))
    for cm in ("packed", "strided"):
        for partitioned in (True, False):
            got = slot_kernel_run(planar, grid, blur3, "bf16", 32, cm,
                                  skew=True, overlap=True,
                                  partitioned=partitioned)
            check(np.array_equal(got, refs["rgb_ref"]),
                  f"skew ({cm}, partitioned={partitioned}): the skewed "
                  "overlapped run differs from shifted")
    report["skew"] = ("equal under a 10 ms spin before every chunk on slot "
                      "0, overlapped, both schedules and transports")
    stencil.reset_launch_counts()  # not main-path launches
    report["timed"] = time_region_kernels(dev, rgb, grey, big, blur3, edge5)
    return report


# ---------------------------------------------------------------------------
# Phase 4k: obs on the main path (ROADMAP item 9)
# ---------------------------------------------------------------------------

# obs-on resident seconds over obs-off at most this on a host-bound path: a
# synchronize or a per-launch hook would show as more.
OBS_OVERHEAD_LIMIT = 1.25
OBS_TURNS = 6              # off, on / on, off turns


def obs_resident(metrics, fn) -> dict:
    """Resident seconds of ``fn`` with obs off and on, in turns (off, on,
    on, off, ...): ``ratio`` is the least on over the least off (a cost
    of obs raises every run, the least too, while the host's noise
    spreads single runs 1.8x apart on one card), beside the medians."""
    import statistics

    times = {False: [], True: []}
    fn()  # warm
    for i in range(OBS_TURNS):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            metrics.set_enabled(on)
            times[on].append(host_seconds(fn)[1])
    metrics.set_enabled(True)
    off, on = min(times[False]), min(times[True])
    med_off, med_on = (statistics.median(times[k]) for k in (False, True))
    return {"seconds_off": off, "seconds_on": on, "ratio": on / off,
            "median_ratio": med_on / med_off, "turns_off": times[False],
            "turns_on": times[True]}


def check_exposition(metrics) -> int:
    """``render_text`` parsed back by ``parse_text``: every counter and
    gauge series, and every histogram's count and sum, as the snapshot
    holds them.  Returns the series checked."""
    parsed = metrics.parse_text(metrics.render_text())
    n = 0
    for m in metrics.snapshot()["metrics"]:
        for s in m["series"]:
            if m["kind"] == "histogram":
                want = {f"{m['name']}_count": s["count"],
                        f"{m['name']}_sum": s["sum"]}
            else:
                want = {m["name"]: s["value"]}
            for name, value in want.items():
                got = [v for lbl, v in parsed.get(name, [])
                       if lbl == {k: str(x) for k, x in s["labels"].items()}]
                check(got == [float(value)],
                      f"obs: {name}{s['labels']} parsed back as {got}, "
                      f"the snapshot holds {value}")
                n += 1
    return n


def obs_phase(dev, tmp: Path, refs: dict, totals: dict, keep: dict) -> dict:
    """Metrics, the event log, spans, halo attribution and the device trace
    on the main path, obs on, at config 2's full width; the launches
    counted into ``totals``.  See the module docstring, phase 4k."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.obs import (
        attribution, events, metrics, report, trace, trace_report,
    )
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh, step
    from parallel_convolution_tpu_torch.utils import (
        bench, checkpoint, imageio, tracing,
    )

    work = tmp / "obs"
    metrics.set_enabled(True)
    metrics.reset()
    log = events.configure(work / "events.jsonl", max_bytes=64 << 20)
    out = {"runs": [], "card": card_line()}
    dirs = attribution.DIRECTIONS
    blur3 = get_filter("blur3")
    rgb, ref = refs["rgb"], refs["rgb_ref"]
    px = RGB_HW[0] * RGB_HW[1] * 3
    block2 = tuple(-(-n // 2) for n in RGB_HW)
    grid2 = mesh.make_grid((2, 2), dev)
    planar = torch.from_numpy(imageio.interleaved_to_planar(rgb).copy()).to(
        device=dev, dtype=torch.float32)

    def new_events(n0: int) -> list:
        recs = events.read_events(log.path)[n0:]
        for r in recs:
            check(events.validate_event(r) == [],
                  f"obs: invalid event {r}: {events.validate_event(r)}")
        return recs

    def counted(fn):
        stencil.reset_launch_counts()
        res = fn()
        counts = stencil.launch_counts()
        for k, v in counts.items():
            totals[k] += v
        return res, counts

    iters_m = metrics.counter("pctpu_iterations_total", "", ("backend",))
    models = {}
    for label, grid, kw, expect, gshape, block in (
            ("cuda_sep bf16 fuse 32 1x1", None,
             dict(backend="cuda_sep", storage="bf16", fuse=32),
             expected_launches(blur3, 32, RGB_HW), (1, 1), RGB_HW),
            ("cuda f32 fuse 1 2x2", grid2,
             dict(backend="cuda", storage="f32", fuse=1),
             {k: 4 * v for k, v in expected_launches(blur3, 1,
                                                      block2).items()},
             (2, 2), block2),
            ("cuda_rdma bf16 fuse 32 2x2", grid2,
             dict(backend="cuda_rdma", storage="bf16", fuse=32),
             expected_rdma_launches(blur3, 32, (2, 2), block2), (2, 2),
             block2)):
        model = (ConvolutionModel("blur3", device=dev, **kw) if grid is None
                 else ConvolutionModel("blur3", grid=grid, **kw))
        models[label] = model
        n0 = len(events.read_events(log.path))
        before = iters_m.value(backend=kw["backend"])
        img, counts, secs = drive(f"obs rgb 1920x2520 blur3 {label}",
                                  lambda: model.run_image(rgb, ITERS), expect,
                                  px, no_halo=kw["backend"] == "cuda_rdma")
        for k, v in counts.items():
            totals[k] += v
        check(np.array_equal(img, ref), f"obs {label}: differs from shifted")
        ex = [r for r in new_events(n0) if r["kind"] == "exchange"]
        fuse = min(model.effective_fuse, ITERS)   # iterate_prepared's clamp
        want = attribution.halo_bytes_total(gshape, block, 1, fuse, ITERS, 3,
                                            kw["storage"])
        check(len(ex) == 1 and ex[0]["fuse"] == fuse,
              f"obs {label}: {len(ex)} exchange events, fuse "
              f"{[r['fuse'] for r in ex]} for {fuse}")
        check(ex[0]["halo_bytes"] == {d: want[d] for d in dirs}
              and ex[0]["rounds"] == want["rounds"],
              f"obs {label}: exchange {ex[0]['halo_bytes']} "
              f"{ex[0]['rounds']} rounds, halo_bytes_total says {want}")
        got_iters = iters_m.value(backend=kw["backend"]) - before
        check(got_iters == ITERS,
              f"obs {label}: pctpu_iterations_total +{got_iters}")
        out["runs"].append({"path": label, "launches": counts,
                            "seconds_first": secs,
                            "halo_bytes": ex[0]["halo_bytes"],
                            "rounds": ex[0]["rounds"],
                            "predicted_exchange_fraction":
                                ex[0]["exchange_fraction"]})

    # Overhead on two host-bound paths: obs on / off, resident, in turns.
    fuse1 = models["cuda f32 fuse 1 2x2"]
    grey = refs["greys"]["blur3"]
    grey_planar = torch.from_numpy(grey[None].copy()).to(
        device=dev, dtype=torch.float32)
    slots256 = mesh.make_grid(GREY_GRID, devices=slot_devices(
        dev, GREY_GRID, "one card"))
    split = ConvolutionModel("blur3", grid=slots256, backend="cuda_rdma",
                             storage="u8", fuse=8)
    check(np.array_equal(split.run_image(grey, ITERS),
                         refs["grey_refs"]["blur3"]),
          "obs: the 256-slot split differs from shifted")
    out["overhead"] = {}
    for label, model, x in (("cuda f32 fuse 1 2x2", fuse1, planar),
                            ("cuda_rdma u8 fuse 8 256 slots", split,
                             grey_planar)):
        row, counts = counted(lambda: obs_resident(
            metrics, lambda: model.run_planar(x, ITERS)))
        row["launches"] = counts
        out["overhead"][label] = row
        check(row["ratio"] <= OBS_OVERHEAD_LIMIT,
              f"obs overhead {label}: on / off {row['ratio']:.3f} above "
              f"{OBS_OVERHEAD_LIMIT} (turns off {row['turns_off']}, on "
              f"{row['turns_on']})")

    # The predicted exchange share of the fuse-1 run beside a measured one:
    # its rounds x the halo exchange's p50 at that block over its resident
    # seconds (no gate: the first card reading of the model's term).
    halo = bench.bench_halo_p50(block2, r=1, grid=grid2, channels=3,
                                trials=9, chain_rounds=64)
    res_off = out["overhead"]["cuda f32 fuse 1 2x2"]["seconds_off"]  # least
    out["attribution"] = {
        run["path"]: {"predicted": run["predicted_exchange_fraction"]}
        for run in out["runs"]}
    out["attribution"]["cuda f32 fuse 1 2x2"].update(
        halo_p50_us=halo["p50_us"], rounds=ITERS, resident_s=res_off,
        measured=(None if halo["p50_us"] is None
                  else ITERS * halo["p50_us"] * 1e-6 / res_off))

    # run --converge on config 1's image, cuda_rdma 2x2: one device span.
    csrc, cwant, citers = keep["cli_converge"]
    cdst = work / "converge.raw"
    argv = ["run", str(csrc), str(RGB_HW[0]), str(RGB_HW[1]),
            str(CONVERGE_CLI_MAX), "grey", "-o", str(cdst), "--converge",
            "0.5", "--check-every", "10", "--backend", "cuda_rdma",
            "--mesh", "2x2"]
    n0 = len(events.read_events(log.path))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        (rc, secs), counts = counted(lambda: host_seconds(
            lambda: cli_main(argv)))
    check(rc == 0, f"obs converge: the CLI exited {rc}")
    said = buf.getvalue().strip().splitlines()[-1]
    check(said.startswith(f"converged after {citers} iters"),
          f"obs converge: said {said!r}, shifted ran {citers}")
    check(np.array_equal(imageio.read_raw(cdst, *RGB_HW, "grey"), cwant),
          "obs converge: differs from shifted")
    recs = new_events(n0)
    spans = trace.span_records(recs)
    dev_spans = [s for s in spans if s["name"] == "device"]
    check(len(dev_spans) == 1 and dev_spans[0]["attrs"]["iters"] == citers,
          f"obs converge: device spans {dev_spans}, {citers} iterations")
    tree = trace.build_trees(spans)[dev_spans[0]["trace_id"]]
    kids = sorted(tree["spans"][k]["name"]
                  for k in tree["children"].get(dev_spans[0]["span_id"], []))
    check(kids == ["compute", "exchange"] and not tree["orphans"],
          f"obs converge: the device span's children {kids}")
    rep, rrc = trace_report.analyze(recs)
    check(rrc == 0, f"obs converge: trace_report found {rep['problems']}")
    ex = [r for r in recs if r["kind"] == "exchange"]
    out["converge"] = {"iters": citers, "seconds": secs, "launches": counts,
                       "device_span_s": dev_spans[0]["dur_s"],
                       "children": kids, "trace_report": {
                           k: rep[k] for k in ("spans", "traces",
                                               "orphan_spans")},
                       "predicted_exchange_fraction":
                           ex[0]["exchange_fraction"]}

    # A checkpoint save at config 3's size on 2x2, loaded back there and
    # onto 4x4: the events carry the bytes of the shard files on disk.
    img8k = refs["greys"]["edge5"]
    blocks, valid_hw, _ = step._prepare(img8k[None], grid2, "u8")
    ck = work / "ck"
    n0 = len(events.read_events(log.path))
    checkpoint.save_state(ck, blocks, {
        "grid": [2, 2], "iters_done": 25, "shape": [1, *BIG_HW],
        "valid_hw": list(valid_hw)}, grid2)
    loaded, _ = checkpoint.load_state(ck, grid2)
    check(all(torch.equal(loaded[i][j], blocks[i][j])
              for i in range(2) for j in range(2)),
          "obs checkpoint: the loaded blocks differ from the saved ones")
    del loaded
    resharded, meta = checkpoint.load_state(ck, mesh.make_grid((4, 4), dev))
    check(meta["resharded_from"] == [2, 2],
          "obs checkpoint: the 4x4 load did not reshard")
    del resharded, blocks
    on_disk = sum(p.stat().st_size
                  for p in (ck / "it_00000025").glob("shard_*.npy"))
    ops = [(r["kind"], r["bytes"]) for r in new_events(n0)
           if r["kind"].startswith("checkpoint_")]
    check(ops == [("checkpoint_save", on_disk), ("checkpoint_load", on_disk),
                  ("checkpoint_reshard", on_disk)],
          f"obs checkpoint: events {ops}, {on_disk} bytes on disk")
    out["checkpoint"] = {"events": ops, "bytes_on_disk": on_disk}

    # The device trace: the hand-written kernels at the counted launches.
    out["device_trace"] = {}
    for label in ("cuda_sep bf16 fuse 32 1x1", "cuda f32 fuse 1 2x2"):
        model = models[label]

        def traced():
            with tracing.device_trace(work / "trace") as tr:
                img = model.run_image(rgb, ITERS)
            return tr, img

        (tr, img), counts = counted(traced)
        check(np.array_equal(img, ref),
              f"obs device trace {label}: differs from shifted")
        seen = tracing.kernel_counts(tr, ("stencil_step_kernel",
                                          "fused_iterate_kernel"))
        want = {"stencil_step_kernel": counts["stencil_step"],
                "fused_iterate_kernel": counts["fused_iterate"]}
        check(seen == want and sum(want.values()) > 0,
              f"obs device trace {label}: the trace holds {seen}, the "
              f"counters say {want}")
        names = sorted({e["name"] for e in tr.events()
                        if e.get("cat") == "kernel"})
        out["device_trace"][label] = {"kernels": seen, "names": names[:4],
                                      "bytes": tr.path.stat().st_size}

    # The timeline as a whole, and the exposition.
    metrics.dump(work / "snapshot.json")
    with contextlib.redirect_stdout(io.StringIO()):
        rrc = report.main(["--events", str(log.path), "--metrics",
                           str(work / "snapshot.json"), "--quiet", "--out",
                           str(work / "report.json")])
    check(rrc == 0, "obs: obs.report failed on the phase's log")
    summary = json.loads((work / "report.json").read_text())
    out["report"] = {"events": summary["events"]["count"],
                     "kinds": summary["events"]["kinds"],
                     "exchange": summary["exchange"]}
    out["exposition_series"] = check_exposition(metrics)
    events.deconfigure()
    return out


# ---------------------------------------------------------------------------
# Phase 4l: elastic grids, the supervisor, the warm engine and the batcher
# (ROADMAP items 13 and 8a-i)
# ---------------------------------------------------------------------------

# The supervised leg: the port's CLI, its 4x4 attempt faulted in its second
# snapshot (the fault's text is the leg's device-loss pattern); every
# attempt appends its launch counts to $SMOKE_LAUNCHES.
LEG_SRC = """
import json, os, sys
from parallel_convolution_tpu_torch.cli import main
from parallel_convolution_tpu_torch.ops import stencil
if os.environ.get("PCTPU_MESH") == "4x4":
    os.environ["PCTPU_FAULTS"] = ("checkpoint_write_shard:"
                                  + os.environ["SMOKE_KILL_AT"])
rc = 1
try:
    rc = main(sys.argv[1:])
finally:
    with open(os.environ["SMOKE_LAUNCHES"], "a") as f:
        f.write(json.dumps({"mesh": os.environ.get("PCTPU_MESH"), "rc": rc,
                            "launches": stencil.launch_counts()}) + "\\n")
sys.exit(rc)
"""


def latency_ms(secs: list) -> dict:
    import numpy as np

    return {"n": len(secs),
            "p50_ms": float(np.percentile(secs, 50)) * 1e3,
            "p99_ms": float(np.percentile(secs, 99)) * 1e3}


def engine_requests(eng, key, payloads: list, wants: list,
                    label: str) -> tuple[list, list, list]:
    """``payloads`` submitted at once (a thread each) through a
    ``MicroBatcher`` at the JAX package's defaults whose executor runs
    ``eng.run_batch``; every output must be its image's ``wants`` bytes.
    Returns (each request's seconds, the batch sizes that ran, each
    batch's phase seconds)."""
    import threading

    import numpy as np

    from parallel_convolution_tpu_torch.serving import MicroBatcher

    sizes, phases = [], []

    def execute(k, items):
        out, info = eng.run_batch(k, np.stack([it.payload for it in items]))
        sizes.append(info["batch_size"])
        phases.append(info["phases"])
        for it, o in zip(items, out):
            it.slot.set(o)

    batcher = MicroBatcher(execute)
    n = len(payloads)
    got, secs = [None] * n, [0.0] * n
    go = threading.Barrier(n)

    def one(i):
        go.wait(60)
        t0 = time.perf_counter()
        slot = batcher.try_submit(key, payloads[i])
        got[i] = None if slot is None else slot.result(300)
        secs[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    batcher.close()
    for i, o in enumerate(got):
        check(isinstance(o, np.ndarray),
              f"{label}: request {i} got {o!r} instead of an image")
        img = o.transpose(1, 2, 0) if o.shape[0] > 1 else o[0]
        check(np.array_equal(img.astype(np.uint8), wants[i]),
              f"{label}: request {i} differs from shifted")
    return secs, sizes, phases


def mean_phases(phases: list) -> dict:
    """The mean seconds of each ``run_batch`` phase over batches."""
    return {k: sum(p[k] for p in phases) / len(phases) for k in phases[0]}


def engine_phase(dev, tmp: Path, here: Path, refs: dict, totals: dict,
                 keep: dict) -> dict:
    """The warm engine, the batcher, reshape, the supervised leg and
    ``set_grid`` at BASELINE configs 1-3's widths; the launches counted
    into ``totals``.  See the module docstring, phase 4l."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.models import (
        ConvolutionModel, JacobiSolver,
    )
    from parallel_convolution_tpu_torch.obs import events, metrics
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh, step
    from parallel_convolution_tpu_torch.resilience import supervisor
    from parallel_convolution_tpu_torch.serving import WarmEngine
    from parallel_convolution_tpu_torch.utils import imageio
    from parallel_convolution_tpu_torch.volumes import driver

    t_start = time.perf_counter()
    card = card_line()
    work = tmp / "engine"
    work.mkdir(parents=True, exist_ok=True)
    metrics.set_enabled(True)
    log = events.configure(work / "events.jsonl", max_bytes=64 << 20)
    out = {"card": card, "latency": {}}
    runs = {}   # path -> its launches, summed over its calls
    blur3 = get_filter("blur3")

    def add(label, counts):
        for k, v in counts.items():
            totals[k] += v
            runs.setdefault(label, dict.fromkeys(counts, 0))[k] += v

    def counted(label, fn):
        stencil.reset_launch_counts()
        res = fn()
        counts = stencil.launch_counts()
        add(label, counts)
        return res, counts

    def compiles() -> list:
        return [r for r in events.read_events(log.path)
                if r["kind"] == "compile"]

    # (a) Eight requests a wave, distinct seeds: seed 1 is phase 4's image.
    rgbs = [refs["rgb"]] + [imageio.generate_test_image(*RGB_HW, "rgb",
                                                         seed=s)
                            for s in range(2, ENGINE_WAVE + 1)]
    plain = ConvolutionModel("blur3", backend="shifted", device=dev)
    wants = [refs["rgb_ref"]] + [plain.run_image(im, ITERS)
                                 for im in rgbs[1:]]
    payloads = [imageio.interleaved_to_planar(im).astype(np.float32)
                for im in rgbs]
    keep["engine_wave"] = (rgbs, wants)   # phase 4m's requests
    slots4 = mesh.make_grid((2, 2), devices=[dev] * 4)
    eng1 = WarmEngine(mesh.make_grid((1, 1), dev), fallback=False)
    eng4 = WarmEngine(slots4, fallback=False)
    shape = (3, *RGB_HW)
    keys = {
        "cuda_sep bf16 fuse 32 1x1": (eng1, eng1.key_for(
            shape, iters=ITERS, backend="cuda_sep", storage="bf16",
            fuse=32)),
        "cuda f32 fuse 1 2x2 slots": (eng4, eng4.key_for(
            shape, iters=ITERS, backend="cuda", storage="f32", fuse=1)),
        "cuda_rdma bf16 fuse 32 2x2 slots strided": (eng4, eng4.key_for(
            shape, iters=ITERS, backend="cuda_rdma", storage="bf16",
            fuse=32, col_mode="strided")),
        "cuda_rdma bf16 fuse 32 2x2 slots packed": (eng4, eng4.key_for(
            shape, iters=ITERS, backend="cuda_rdma", storage="bf16",
            fuse=32, col_mode="packed")),
    }
    check(len({k for _, k in keys.values()}) == 4,
          "engine: the four keys are not distinct")
    for label, (eng, key) in keys.items():
        t0 = time.perf_counter()
        counted(f"4l warmup {label}", lambda: eng.warmup(
            [key], batch_sizes=range(1, ENGINE_WAVE + 1)))
        warm_s = time.perf_counter() - t0
        n0 = len(compiles())
        (secs1, sizes1, _), _ = counted(
            f"4l wave 1 {label}",
            lambda: engine_requests(eng, key, payloads, wants, label))
        n1 = len(compiles())
        (secs2, sizes2, _), counts2 = counted(
            f"4l wave 2 {label}",
            lambda: engine_requests(eng, key, payloads, wants, label))
        fresh = compiles()[n1:]
        check(not fresh, f"engine {label}: the second wave built "
              f"{[(r['builder'], r['backend']) for r in fresh]}")
        check(any(counts2.values()),
              f"engine {label}: the second wave launched no kernel")
        singles, ph1 = [], []
        for i in range(ENGINE_SINGLES):
            j = i % ENGINE_WAVE
            (secs, _, ph), _ = counted(f"4l singles {label}", lambda: (
                engine_requests(eng, key, payloads[j:j + 1], wants[j:j + 1],
                                label)))
            singles += secs
            ph1 += ph
        eights, ph8 = [], []
        for _ in range(ENGINE_WAVES):
            (secs, _, ph), _ = counted(f"4l waves {label}", lambda: (
                engine_requests(eng, key, payloads, wants, label)))
            eights += secs
            ph8 += ph
        out["latency"][label] = {
            "batch_1": dict(latency_ms(singles),
                            phases_s=mean_phases(ph1)),
            "batch_8": dict(latency_ms(eights), phases_s=mean_phases(ph8),
                            batches=len(ph8)),
            "warmup_s": warm_s, "wave_1_compiles": n1 - n0,
            "wave_2_compiles": len(fresh),
            "wave_batch_sizes": [sizes1, sizes2]}
        print(f"4l latency {label}: " + json.dumps(
            dict(out["latency"][label], card=card)))
    # K2's launches of a batch of 8 are one run's over 24 planes.
    eng, key = keys["cuda_sep bf16 fuse 32 1x1"]
    _, batch_counts = counted("4l cuda_sep batch of 8",
                              lambda: eng.run_batch(key, np.stack(payloads)))
    model = ConvolutionModel("blur3", backend="cuda_sep", storage="bf16",
                             fuse=32, device=dev)
    planes = torch.from_numpy(np.concatenate(payloads)).to(dev)
    _, run_counts = counted("4l cuda_sep one run of 24 planes",
                            lambda: model.run_planar(planes, ITERS))
    del planes
    want_k2 = expected_launches(blur3, 32, RGB_HW)["fused_iterate"]
    check(batch_counts["fused_iterate"] == run_counts["fused_iterate"]
          == want_k2, f"engine: K2 launched {batch_counts['fused_iterate']}"
          f" times for a batch of 8, {run_counts['fused_iterate']} for 24 "
          f"planes, the plan says {want_k2}")
    out["k2_batch_of_8"] = batch_counts["fused_iterate"]

    # (b) run_converge on config 1's image, 2x2 slots, against the port's
    # own stream, row by row.
    grey = refs["greys"]["blur3"]
    xg = grey[None].astype(np.float32)
    ckey = eng4.key_for(xg.shape, filter_name="blur3", iters=10,
                        backend="cuda_rdma", storage="u8", fuse=8)
    _, cwant, citers = keep["cli_converge"]

    def converge():
        rows = 0
        last = None
        for got, ref in zip(
                eng4.run_converge(ckey, xg, tol=0.5,
                                  max_iters=CONVERGE_CLI_MAX,
                                  check_every=10),
                step.sharded_converge_stream(
                    xg, blur3, 0.5, CONVERGE_CLI_MAX, 10, grid=slots4,
                    quantize=True, backend="cuda_rdma", storage="u8",
                    fuse=8)):
            check(got[1:3] == ref[1:] and np.array_equal(got[0], ref[0]),
                  f"engine converge: row {rows} {got[1:]} differs from the "
                  f"stream's {ref[1:]}")
            rows += 1
            last = got
        return rows, last

    t0 = time.perf_counter()
    (rows, last), _ = counted("4l run_converge config 1 cuda_rdma 2x2 slots",
                              converge)
    check(last[1] == citers and np.array_equal(
        last[0][0].astype(np.uint8), cwant),
        f"engine converge: {last[1]} iterations, phase 4b's {citers}")
    out["converge"] = {"rows": rows, "iters": last[1], "diff": last[2],
                       "seconds": time.perf_counter() - t0}

    # reshape 2x2 slots -> 1x1 mid-process.
    stale = keys["cuda f32 fuse 1 2x2 slots"][1]
    t0 = time.perf_counter()
    info, _ = counted("4l reshape 2x2 slots -> 1x1",
                      lambda: eng4.reshape(mesh.make_grid((1, 1), dev)))
    reshape_s = time.perf_counter() - t0
    resident = len(eng4.snapshot()["resident"])
    check(info["old_grid"] == (2, 2) and info["grid"] == (1, 1)
          and info["skipped"] == 0 and info["rewarmed"] == 4 == resident,
          f"engine reshape: {info}, {resident} resident")
    try:
        eng4.run_batch(stale, payloads[0][None])
    except ValueError as e:
        check("stale" in str(e), f"engine reshape: {e}")
    else:
        check(False, "engine reshape: an old key ran on the new grid")
    for label in ("cuda f32 fuse 1", "cuda_rdma bf16 fuse 32"):
        kw = dict(iters=ITERS, backend=label.split()[0],
                  storage=label.split()[1], fuse=int(label.split()[-1]))
        key = eng4.key_for(shape, **kw)
        c0 = eng4.stats["compiles"]
        counted(f"4l after reshape {label} 1x1", lambda: engine_requests(
            eng4, key, payloads[:1], wants[:1], f"reshaped {label}"))
        check(eng4.stats["compiles"] == c0,
              f"engine reshape: {label} was not re-warmed")
        counted(f"4l wave after reshape {label} 1x1", lambda: engine_requests(
            eng4, key, payloads, wants, f"reshaped {label}"))
    out["reshape"] = dict(info, reshape_s=reshape_s,
                          seconds=time.perf_counter() - t0,
                          stats=dict(eng4.stats))

    # A volume key: fd7 at 512^3 against volumes.driver on the same grid.
    gen = torch.Generator(device=dev).manual_seed(15)
    vol = torch.rand((2, VOLUME_N, VOLUME_N, VOLUME_N), generator=gen,
                     device=dev)
    vkey = eng1.key_for(tuple(vol.shape[1:]), filter_name="fd7",
                        iters=ENGINE_VOLUME_SWEEPS, rank=3, quantize=False)
    vhost = vol.cpu().numpy()
    t0 = time.perf_counter()
    vout, vinfo = eng1.run_batch(vkey, vhost[None])
    vsecs = time.perf_counter() - t0
    vref = driver.volume_iterate(vol, "fd7", ENGINE_VOLUME_SWEEPS,
                                 grid=eng1.grid).cpu().numpy()
    verr = float(np.abs(vout[0] - vref).max())
    check(verr <= 2e-5, f"engine volume: max abs err {verr} > 2e-5")
    out["volume"] = {"max_abs_err": verr, "seconds": vsecs,
                     "phases": vinfo["phases"]}
    del vol, vhost, vout, vref
    torch.cuda.empty_cache()

    # (c) The supervised leg on config 3.
    sup_dir, ck = work / "supervised", work / "ck"
    dst, launches = work / "supervised.raw", work / "launches.jsonl"
    argv = ["run", str(tmp / "edge5.raw"), str(BIG_HW[0]), str(BIG_HW[1]),
            str(ITERS), "grey", "-o", str(dst), "--filter", "edge5",
            "--backend", "cuda_rdma", "--device", "all", "--checkpoint",
            str(ck), "--checkpoint-every", str(CKPT_EVERY)]
    pattern = "injected fault at 'checkpoint_write_shard'"
    legs = work / "legs.json"
    legs.write_text(json.dumps([{
        "name": "config3", "cmd": [sys.executable, "-c", LEG_SRC, *argv],
        "done_file": str(dst), "timeout": 600,
        "env": {"SMOKE_LAUNCHES": str(launches),
                "SMOKE_KILL_AT": str(CKPT_KILL)},
        "meshes": SUPERVISOR_LADDER, "reshape_pattern": pattern}]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m",
         "parallel_convolution_tpu_torch.resilience.supervisor", "--legs",
         str(legs), "--state-dir", str(sup_dir), "--max-attempts", "3",
         "--base-delay", "0.1", "--max-delay", "0.1"],
        cwd=here, env=dict(os.environ, PCTPU_SIM_DEVICES="4"),
        capture_output=True, text=True, timeout=900)
    sup_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"supervisor exited {proc.returncode}: "
          f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    ledger = supervisor.read_ledger(sup_dir / supervisor.LEDGER_NAME)
    leg = ledger["legs"]["config3"]
    check(leg["state"] == "done" and leg["mesh"] == "2x2"
          and leg.get("reshapes") == 1 and leg["attempts"] == 2,
          f"supervisor: the leg's ledger says {leg}")
    attempts = [json.loads(line)
                for line in launches.read_text().splitlines()]
    check([(a["mesh"], a["rc"]) for a in attempts] == [("4x4", 1),
                                                       ("2x2", 0)],
          f"supervisor: attempts {[(a['mesh'], a['rc']) for a in attempts]}")
    for a in attempts:
        add(f"4l supervised config 3 {a['mesh']}", a["launches"])
    resumed = attempts[1]["launches"]
    check(resumed["rdma_tiled_slot"] == (ITERS - CKPT_EVERY) * 4,
          f"supervisor: the resumed leg launched {resumed}")
    err = (sup_dir / "config3.err").read_text()
    check("from grid 4x4 onto 2x2" in err,
          "supervisor: the resumed leg did not reshard the 4x4 snapshot")
    check(np.array_equal(imageio.read_raw(dst, *BIG_HW, "grey"),
                         refs["grey_refs"]["edge5"]),
          "supervisor: the resumed leg's output differs from shifted")
    out["supervisor"] = {"seconds": sup_s, "leg": {
        k: leg[k] for k in ("state", "attempts", "mesh", "reshapes",
                            "last_rc")}}

    # (d) The models after set_grid.
    big = refs["greys"]["edge5"]
    model = ConvolutionModel("edge5", grid=mesh.make_grid(
        (4, 4), devices=[dev] * 16), backend="cuda_rdma", storage="bf16",
        fuse=32)
    prev = None
    for label, swap in (("4x4 slots", None), ("2x2 slots", "2x2"),
                        ("2x2 one device", mesh.make_grid((2, 2), dev))):
        if swap is not None:
            model.set_grid(swap)
        img, counts, secs = drive(f"4l set_grid config 3 {label}",
                                  lambda: model.run_image(big, ITERS), {},
                                  BIG_HW[0] * BIG_HW[1], no_halo=True)
        add(f"4l set_grid config 3 {label}", counts)
        check(np.array_equal(img, refs["grey_refs"]["edge5"])
              and (prev is None or np.array_equal(img, prev)),
              f"set_grid: config 3 on {label} differs")
        prev = img
        out.setdefault("set_grid_s", {})[f"config 3 {label}"] = secs
    solver = JacobiSolver("blur3", tol=0.5, max_iters=CONVERGE_CLI_MAX,
                          check_every=10, grid=slots4, backend="cuda_rdma",
                          quantize=True, storage="u8", fuse=8)
    prev = None
    for label, swap in (("2x2 slots", None), ("1x1 slots", "1x1"),
                        ("2x2 one device", mesh.make_grid((2, 2), dev))):
        if swap is not None:
            solver.set_grid(swap)
        (sol, iters), counts, secs = drive(
            f"4l set_grid JacobiSolver config 1 {label}",
            lambda: solver.solve(xg), {}, RGB_HW[0] * RGB_HW[1])
        add(f"4l set_grid JacobiSolver config 1 {label}", counts)
        check(iters == citers and np.array_equal(
            sol[0].astype(np.uint8), cwant),
            f"set_grid: JacobiSolver on {label} ran {iters} iterations or "
            "differs from phase 4b")
        check(prev is None or np.array_equal(sol, prev),
              f"set_grid: JacobiSolver on {label} differs from before")
        prev = sol
        out["set_grid_s"][f"JacobiSolver config 1 {label}"] = secs
    events.deconfigure()
    out["runs"] = [{"path": k, "launches": v} for k, v in runs.items()]
    out["seconds"] = time.perf_counter() - t_start
    return out


# ---------------------------------------------------------------------------
# Phase 4m: one replica's service over HTTP (ROADMAP item 8a-ii)
# ---------------------------------------------------------------------------

# The service's client: another process, since a client in the server's
# process would share its interpreter lock.  It loads the port's frames
# codec from its file (numpy only).  Modes: ``convolve`` (every image of
# an .npy stack, ``conc`` at a time; one JSON record a request) and
# ``converge`` (one stream; the image of the row at ``save_at`` iterations
# and the final one saved beside ``out``).
SERVICE_CLIENT_SRC = r"""
import base64, importlib.util, json, struct, sys, time, urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
import numpy as np

spec = importlib.util.spec_from_file_location("frames", sys.argv[1])
frames = importlib.util.module_from_spec(spec)
spec.loader.exec_module(frames)
mode, url, wire, head = sys.argv[2], sys.argv[3], sys.argv[4], json.loads(
    sys.argv[5])


def encode(arrays):
    if wire == "frames":
        return frames.encode_envelope(head, arrays), frames.FRAMES_CONTENT_TYPE
    return json.dumps(dict(head, image_b64=base64.b64encode(
        arrays["image"].tobytes()).decode("ascii"))).encode(), \
        "application/json"


def post(path, data, ctype):
    return urllib.request.urlopen(urllib.request.Request(
        url + path, data=data, headers={"Content-Type": ctype}), timeout=600)


def image_of(row, shape):
    return np.frombuffer(base64.b64decode(row.pop("image_b64")),
                         np.uint8).reshape(shape)


if mode == "convolve":
    conc = int(sys.argv[6])
    imgs = np.load(sys.argv[7], mmap_mode="r")
    wants = np.load(sys.argv[8], mmap_mode="r")

    def one(i):
        img = np.ascontiguousarray(imgs[i])
        t0 = time.perf_counter()
        data, ctype = encode({"image": img})
        t1 = time.perf_counter()
        try:
            with post("/v1/convolve", data, ctype) as resp:
                status, body = resp.status, resp.read()
        except urllib.error.HTTPError as e:   # a typed refusal
            status, body = e.code, e.read()
        t2 = time.perf_counter()
        if wire == "frames":
            r, arrays = frames.decode_envelope(body)
            out = arrays.get("image")
        else:
            r = json.loads(body)
            out = image_of(r, img.shape) if "image_b64" in r else None
        t3 = time.perf_counter()
        return {"status": status, "cache": r.get("cache"),
                "batch_size": r.get("batch_size"), "phases": r.get("phases"),
                "equal": out is not None and bool(np.array_equal(out,
                                                                 wants[i])),
                "effective_backend": r.get("effective_backend"),
                "rejected": r.get("rejected"),
                "retryable": r.get("retryable"), "router": r.get("router"),
                "client_encode": t1 - t0, "client_decode": t3 - t2,
                "wall": t3 - t0}

    with ThreadPoolExecutor(conc) as pool:
        print(json.dumps(list(pool.map(one, range(len(imgs))))))
else:
    image = np.load(sys.argv[6])
    save_at, out = int(sys.argv[7]), sys.argv[8]
    arrays = {"image": image}
    if len(sys.argv) > 9:
        arrays["resume_state"] = np.load(sys.argv[9])
    rows, keep = [], {}
    t0 = time.perf_counter()
    with post("/v1/converge", *encode(arrays)) as resp:
        while True:
            if wire == "frames":
                prefix = resp.read(4)
                if not prefix:
                    break
                h, a = frames.decode_envelope(resp.read(
                    struct.unpack("<I", prefix)[0]))
                img = a["image"]
            else:
                line = resp.readline()
                if not line:
                    break
                if not line.strip():
                    continue
                h = json.loads(line)
                img = (image_of(h, image.shape)
                       if h["iters"] == save_at or h["kind"] == "final"
                       else h.pop("image_b64") and None)
            rows.append(h)
            if h["iters"] == save_at and h["kind"] == "snapshot":
                keep["mid"] = np.array(img)
            if h["kind"] == "final":
                keep["final"] = np.array(img)
    seconds = time.perf_counter() - t0
    for name, a in keep.items():
        np.save(f"{out}_{name}.npy", a)
    print(json.dumps({"rows": rows, "seconds": seconds}))
"""


def http_call(url: str, data: bytes | None = None,
              ctype: str = "application/json"):
    """(status, headers, body) of one request; an HTTP error status is a
    result here, not an exception."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def service_client_start(mode: str, url: str, wire: str, head: dict,
                         *args) -> subprocess.Popen:
    """``SERVICE_CLIENT_SRC`` started in a process of its own."""
    frames_src = (Path(__file__).resolve().parent
                  / "parallel_convolution_tpu_torch" / "serving" / "frames.py")
    return subprocess.Popen(
        [sys.executable, "-c", SERVICE_CLIENT_SRC, str(frames_src), mode, url,
         wire, json.dumps(head), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def service_client_result(proc: subprocess.Popen, mode: str, wire: str):
    """The last line of a started client, once it has exited 0."""
    try:
        out, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    check(proc.returncode == 0, f"service client {mode} {wire}: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def service_client(mode: str, url: str, wire: str, head: dict, *args):
    """One run of ``SERVICE_CLIENT_SRC`` in a process of its own."""
    return service_client_result(
        service_client_start(mode, url, wire, head, *args), mode, wire)


def codec_seconds() -> dict:
    """The service's codec seconds so far, by wire and operation
    (``pctpu_codec_seconds_total``)."""
    from parallel_convolution_tpu_torch.obs import metrics

    c = metrics.counter("pctpu_codec_seconds_total",
                        "wall seconds spent encoding/decoding wire payloads",
                        ("codec", "op"))
    return {(w, op): float(c.value(codec=w, op=op))
            for w in ("json", "frames") for op in ("decode", "encode")}


def service_round(svc, url: str, head: dict, files, wire: str, conc: int,
                  label: str) -> dict:
    """``SERVICE_REQUESTS`` distinct images of one key on one wire,
    ``conc`` at a time, from a client process; every answer must be its
    image's plain bytes, and a miss (the cache is emptied after the
    round).  Returns the latency row, the split in mean ms a request."""
    b0, c0 = svc.engine.stats["batches"], codec_seconds()
    got = service_client("convolve", url, wire, head, conc, *files)
    c1 = codec_seconds()
    svc.cache.invalidate_all()
    for i, r in enumerate(got):
        check(r["status"] == 200 and r["cache"] == "miss" and r["equal"],
              f"service {label}: request {i} {r}")
    mean = lambda xs: 1e3 * sum(xs) / len(xs)
    split = {name: mean([r[name] for r in got])
             for name in ("client_encode", "client_decode")}
    split["server_decode"] = 1e3 * (c1[(wire, "decode")]
                                    - c0[(wire, "decode")]) / len(got)
    for ph in ("queue", "compile", "copy_in", "device", "copy_out"):
        split[ph] = mean([r["phases"][ph] for r in got])
    split["server_encode"] = 1e3 * (c1[(wire, "encode")]
                                    - c0[(wire, "encode")]) / len(got)
    walls = [r["wall"] for r in got]
    split["rest"] = mean(walls) - sum(split.values())
    return dict(latency_ms(walls), mean_ms=mean(walls), split_ms=split,
                batches=svc.engine.stats["batches"] - b0,
                batch_sizes=sorted({r["batch_size"] for r in got}))


def host_steps(img) -> dict:
    """Milliseconds of the host steps one config-2 request takes inside
    the service that no phase times (the least of three): the u8 -> f32
    widening, the input digest, the u8 store-back and interleave of the
    answer, and each wire's codec of the image."""
    import base64

    import numpy as np

    from parallel_convolution_tpu_torch.serving import cache, frames
    from parallel_convolution_tpu_torch.utils import imageio

    planar = imageio.interleaved_to_planar(img).astype(np.float32)
    steps = {
        "widen_u8_to_f32": lambda: imageio.interleaved_to_planar(
            img).astype(np.float32),
        "input_digest": lambda: cache.input_digest(planar),
        "store_back_u8": lambda: imageio.planar_to_interleaved(np.clip(
            np.rint(planar), 0.0, 255.0).astype(np.uint8)),
        "json_image_encode": lambda: base64.b64encode(img.tobytes()),
        "json_image_decode": lambda: np.frombuffer(base64.b64decode(
            base64.b64encode(img.tobytes())), np.uint8),
        "frames_image_encode": lambda: frames.encode_frame(img),
        "frames_image_decode": lambda: frames.decode_frame(
            frames.encode_frame(img)),
    }
    out = {}
    for name, fn in steps.items():
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            secs.append(time.perf_counter() - t0)
        out[name] = 1e3 * min(secs)
    return out


def slot_converge_plan(filt, iters: int, block_hw,
                       check_every: int = 10) -> dict:
    """The per-slot launches of a ``cuda_rdma`` u8 fuse-8 converge on 2x2
    slots that ran ``iters`` iterations: the one-card plan's K3 / K4
    launch a chunk is one a slot."""
    plan = expected_converge_launches(filt, "cuda_rdma", 8, check_every, iters,
                                      CONVERGE_CLI_MAX, (2, 2), block_hw)
    for k in ("rdma_block", "rdma_tiled"):
        plan[k + "_slot"] += 4 * plan.pop(k)
        plan[k] = 0
    return plan


def service_phase(dev, tmp: Path, refs: dict, totals: dict,
                  keep: dict) -> dict:
    """One replica's service over HTTP on two grids at BASELINE configs
    1-2's widths; the launches counted into ``totals``.  See the module
    docstring, phase 4m."""
    import base64
    import threading

    import numpy as np

    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.obs import metrics
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.serving import (
        ConvolutionService, frames, make_http_server,
    )
    from parallel_convolution_tpu_torch.utils import imageio

    t_start = time.perf_counter()
    card = card_line()
    metrics.set_enabled(True)
    blur3 = get_filter("blur3")
    work = tmp / "service"
    work.mkdir(parents=True, exist_ok=True)
    out = {"card": card, "latency": {}}
    runs = {}

    def counted(label, fn):
        stencil.reset_launch_counts()
        res = fn()
        counts = stencil.launch_counts()
        for k, v in counts.items():
            totals[k] += v
            runs.setdefault(label, dict.fromkeys(counts, 0))[k] += v
        return res, counts

    # SERVICE_REQUESTS distinct images: phase 4l's eight (and more), each
    # with the plain shifted run's bytes; phase 4n takes them over.
    rgbs, wants = keep.pop("engine_wave")
    plain = ConvolutionModel("blur3", backend="shifted", device=dev)
    for seed in range(len(rgbs) + 1, SERVICE_REQUESTS + 1):
        rgbs.append(imageio.generate_test_image(*RGB_HW, "rgb", seed=seed))
        wants.append(plain.run_image(rgbs[-1], ITERS))
    stencil.reset_launch_counts()   # not main-path launches
    keep["service_imgs"] = (rgbs, wants)
    files = (work / "imgs.npy", work / "wants.npy")
    np.save(files[0], np.stack(rgbs[:SERVICE_REQUESTS]))
    np.save(files[1], np.stack(wants[:SERVICE_REQUESTS]))
    lone = (work / "imgs1.npy", work / "wants1.npy")
    np.save(lone[0], np.stack(rgbs[:SERVICE_LONE]))
    np.save(lone[1], np.stack(wants[:SERVICE_LONE]))
    out["host_steps_ms"] = host_steps(rgbs[0])
    print("4m host steps a request: " + json.dumps(
        dict(out["host_steps_ms"], card=card)))
    block_hw = tuple(mesh.padded_extent(v, 2) // 2 for v in RGB_HW)
    keys = {
        "cuda_sep bf16 fuse 32 1x1": (
            mesh.make_grid((1, 1), dev),
            {"backend": "cuda_sep", "storage": "bf16", "fuse": 32},
            expected_launches(blur3, 32, RGB_HW)),
        "cuda_rdma bf16 fuse 32 2x2 slots strided": (
            mesh.make_grid((2, 2), devices=[dev] * 4),
            {"backend": "cuda_rdma", "storage": "bf16", "fuse": 32,
             "col_mode": "strided"},
            expected_slot_launches(blur3, 32, (2, 2), block_hw, False)),
    }
    servers = {}
    try:
        for label, (grid, knobs, _) in keys.items():
            svc = ConvolutionService(grid, cache=True, max_batch=8,
                                     max_delay_s=0.005, max_queue=64)
            srv = make_http_server(svc, "127.0.0.1", 0)
            th = threading.Thread(target=srv.serve_forever, daemon=True)
            th.start()
            servers[label] = (svc, srv, th,
                              f"http://127.0.0.1:{srv.server_address[1]}")
        for label, (grid, knobs, plan) in keys.items():
            svc, _, _, url = servers[label]
            head = {"rows": RGB_HW[0], "cols": RGB_HW[1], "mode": "rgb",
                    "filter": "blur3", "iters": ITERS, **knobs}
            t0 = time.perf_counter()
            (status, _, body), _ = counted(
                f"4m warm {label}", lambda: http_call(
                    url + "/v1/warm",
                    json.dumps({"configs": [head]}).encode()))
            check(status == 200 and json.loads(body)["effective_backends"]
                  == [knobs["backend"]], f"service {label}: warm {body!r}")
            key = svc.engine.key_for(
                (3, *RGB_HW), filter_name="blur3", storage=knobs["storage"],
                iters=ITERS, fuse=32, boundary="zero", quantize=True,
                backend=knobs["backend"], overlap=None,
                col_mode=knobs.get("col_mode"))
            counted(f"4m warm batch sizes {label}", lambda: svc.engine.warmup(
                [key], batch_sizes=range(2, 9)))
            warm_s = time.perf_counter() - t0
            compiles = svc.engine.stats["compiles"]
            rows = {}
            for conc in SERVICE_CONCURRENCY:
                for wire in ("json", "frames"):
                    name = f"{label} {wire} concurrency {conc}"
                    row, counts = counted(f"4m {name}", lambda: service_round(
                        svc, url, head, lone if conc == 1 else files, wire,
                        conc, name))
                    want = {k: v * row["batches"] for k, v in plan.items()}
                    check(all(counts[k] == want.get(k, 0) for k in counts),
                          f"service {name}: launches {counts}, the plan "
                          f"{want} for {row['batches']} batches")
                    row["launches"] = counts
                    rows[f"{wire} concurrency {conc}"] = row
                    print(f"4m latency {name}: " + json.dumps(
                        dict(row, card=card)))
            check(svc.engine.stats["compiles"] == compiles,
                  f"service {label}: a request built a runner")
            out["latency"][label] = dict(rows, warm_s=warm_s)

        # A duplicate body: served from the cache, no engine batch.
        svc, _, _, url = servers["cuda_sep bf16 fuse 32 1x1"]
        body = json.dumps({
            "rows": RGB_HW[0], "cols": RGB_HW[1], "mode": "rgb",
            "filter": "blur3", "iters": ITERS, "backend": "cuda_sep",
            "storage": "bf16", "fuse": 32, "image_b64": base64.b64encode(
                rgbs[0].tobytes()).decode("ascii")}).encode()
        (s1, _, r1), _ = counted("4m duplicate's first", lambda: http_call(
            url + "/v1/convolve", body))
        b0 = svc.engine.stats["batches"]
        t0 = time.perf_counter()
        (s2, _, r2), counts = counted("4m duplicate", lambda: http_call(
            url + "/v1/convolve", body))
        out["duplicate_ms"] = 1e3 * (time.perf_counter() - t0)
        r1, r2 = json.loads(r1), json.loads(r2)
        check(s1 == s2 == 200 and r1["cache"] == "miss"
              and r2["cache"] == "hit" and r1["image_b64"] == r2["image_b64"]
              and svc.engine.stats["batches"] == b0
              and not any(counts.values())
              and base64.b64decode(r2["image_b64"]) == wants[0].tobytes(),
              f"service: the duplicate was {r2.get('cache')}, {counts}")

        # Typed refusals.
        status, _, body = http_call(url + "/v1/convolve", json.dumps({
            "rows": 8, "cols": 8, "backend": "pallas", "image_b64":
            "A" * 86 + "=="}).encode())
        bad = json.loads(body)
        check(status == 400 and bad["rejected"] == "invalid"
              and "'pallas' is 'cuda' here" in bad["detail"],
              f"service: backend pallas answered {status} {bad}")
        status, _, body = http_call(url + "/v1/convolve", b"PCTE garbage",
                                    frames.FRAMES_CONTENT_TYPE)
        check(status == 400 and frames.decode_envelope(body)[0]["rejected"]
              == "bad_frame", f"service: a malformed frame answered {status}")

        # A volume on frames against the engine's own run of its key.
        n = SERVICE_VOLUME_N
        vol = np.random.default_rng(16).random((2, n, n, n),
                                               dtype=np.float32)
        vhead = {"rows": n, "cols": n, "depth": n, "mode": "volume",
                 "filter": "fd7", "iters": ENGINE_VOLUME_SWEEPS}
        t0 = time.perf_counter()
        (status, _, body), _ = counted("4m volume fd7 256^3", lambda: (
            http_call(url + "/v1/convolve", frames.encode_envelope(
                vhead, {"volume": vol}), frames.FRAMES_CONTENT_TYPE)))
        vsecs = time.perf_counter() - t0
        vh, va = frames.decode_envelope(body)
        vkey = svc.engine.key_for(
            (n, n, n), rank=3, filter_name="fd7", storage="f32",
            iters=ENGINE_VOLUME_SWEEPS, fuse=1, boundary="zero",
            quantize=False, backend="shifted", overlap=None, col_mode=None,
            solver="jacobi")
        (vref, _), _ = counted("4m volume engine run", lambda: (
            svc.engine.run_batch(vkey, vol[None])))
        verr = float(np.abs(va["image"] - vref[0]).max())
        check(status == 200 and vh["ok"] and verr <= 2e-5,
              f"service volume: {status}, max abs err {verr}")
        out["volume"] = {"max_abs_err": verr, "seconds": vsecs,
                         "phases": vh["phases"]}
        del vol, va, vref, body

        # Converge on config 1's image, 2x2 slots: framed, NDJSON, and
        # resumed from a token of the middle row.
        svc, _, _, url = servers["cuda_rdma bf16 fuse 32 2x2 slots strided"]
        grey = work / "grey.npy"
        np.save(grey, refs["greys"]["blur3"])
        _, cwant, citers = keep["cli_converge"]
        ce = SERVICE_CONVERGE_CHECK
        mid = (citers // ce // 2) * ce
        chead = {"rows": RGB_HW[0], "cols": RGB_HW[1], "mode": "grey",
                 "filter": "blur3", "backend": "cuda_rdma", "storage": "u8",
                 "fuse": 8, "quantize": True, "tol": 0.5, "check_every": ce,
                 "max_iters": CONVERGE_CLI_MAX}
        conv, streams = {}, {}
        for wire in ("frames", "json"):
            stream, counts = counted(f"4m converge {wire}", lambda: (
                service_client("converge", url, wire, chead, grey, mid,
                               work / wire)))
            svc.cache.invalidate_all()   # a converged final is cached
            rows = stream["rows"]
            final = np.load(work / f"{wire}_final.npy")
            check(rows[-1]["kind"] == "final" and rows[-1]["converged"]
                  and rows[-1]["iters"] == citers
                  and np.array_equal(final, cwant)
                  and [r["iters"] for r in rows[:-1]]
                  == list(range(ce, citers + 1, ce)),
                  f"service converge {wire}: {rows[-1]['iters']} iterations "
                  f"in {len(rows)} rows, phase 4b's {citers}")
            streams[wire] = (rows, counts)
            conv[f"{wire}_s"] = stream["seconds"]
        check(np.array_equal(np.load(work / "frames_mid.npy"),
                             np.load(work / "json_mid.npy")),
              "service converge: the middle rows of the two wires differ")
        full = slot_converge_plan(blur3, citers, block_hw, ce)
        jcounts, fcounts = streams["json"][1], streams["frames"][1]
        check(all(jcounts[k] == full.get(k, 0) for k in jcounts)
              and all(fcounts[k] >= v for k, v in jcounts.items()),
              f"service converge: launches {jcounts} (framed {fcounts}), "
              f"the plan {full}")
        # A u8 job's row image is its exact carry, so the middle row makes
        # the token's state.
        mrow = streams["frames"][0][mid // ce - 1]
        token = {k: mrow[k] for k in ("iters", "diff", "work_units",
                                      "solver")}
        state = work / "state.npy"
        np.save(state, np.load(work / "frames_mid.npy")[None].astype(
            np.float32))
        stream, rcounts = counted("4m converge resumed", lambda: (
            service_client("converge", url, "frames",
                           dict(chead, resume=token), grey, -1,
                           work / "resumed", state)))
        rows = stream["rows"]
        part = slot_converge_plan(blur3, mid, block_hw, ce)
        check(rows[-1]["iters"] == citers and rows[0]["iters"] == mid + ce
              and np.array_equal(np.load(work / "resumed_final.npy"), cwant)
              and all(rcounts[k] == full.get(k, 0) - part.get(k, 0)
                      for k in rcounts),
              f"service converge resumed at {mid}: {rows[-1]['iters']} "
              f"iterations, launches {rcounts}")
        conv.update(resumed_s=stream["seconds"],
                    rows=len(streams["json"][0]), iters=citers,
                    resumed_at=mid, resumed_rows=len(rows), launches=jcounts)
        out["converge"] = conv

        # Probes.
        for label, (svc, _, _, url) in servers.items():
            status, _, body = http_call(url + "/readyz")
            check(status == 200 and json.loads(body)["ready"],
                  f"service {label}: /readyz {status}")
            status, _, body = http_call(url + "/metrics")
            parsed = metrics.parse_text(body.decode())
            check(status == 200 and any(
                k.startswith("pctpu_request_phase_seconds") for k in parsed),
                f"service {label}: /metrics lacks the request phases")
        out["stats"] = {label: dict(svc.stats)
                        for label, (svc, *_) in servers.items()}
    finally:
        for svc, srv, th, _ in servers.values():
            srv.shutdown()
            srv.server_close()
            svc.close()
            th.join(60)
        shutil.rmtree(work, ignore_errors=True)
    out["runs"] = [{"path": k, "launches": v} for k, v in runs.items()]
    out["seconds"] = time.perf_counter() - t_start
    return out


# ---------------------------------------------------------------------------
# Phase 4n: the fleet's front tier (ROADMAP item 8b-i)
# ---------------------------------------------------------------------------

FLEET_REQUESTS = 8          # 4n: requests a key at concurrency 8 (frames)
FLEET_LONE = 4              # 4n: ... at concurrency 1
FLEET_CONCURRENCY = (1, 8)
FLEET_CRASH_ROWS = 5        # 4n: converge rows the crashed router streams
# 4n's crash drill checks every 130 iterations: 2730 (phase 4b's count) is
# a multiple, and a u8 carry that changed at 2720 changed at every earlier
# iteration, so the job still stops at 2730 with the same bytes, in 21
# rows whose 25.8 MB tokens the WAL journals (273 rows at check every 10
# took 60.8 s of appends on an H100 80GB HBM3 host).
FLEET_CRASH_CHECK = 130
FLEET_LOADGEN = 8           # 4n: the loadgen entry point's requests
FLEET_DISCONNECT_ITERS = 200  # 4n: the budget of the disconnected stream
FLEET_WAL_SEGMENT = 1 << 30  # 4n: a config-1 token is a 25.8 MB record


def fleet_names(keys: dict) -> dict:
    """Three replica names, ``r0``-style, whose hash ring homes the
    ``cuda_sep`` key and the ``cuda_rdma`` key on different replicas, and
    the converge keys with the ``cuda_rdma`` key (so that one chaos wrapper
    covers a convolve key and the stream, and every converge runs on 2x2
    slots): ``{"sep": A, "rdma": B, "other": C}``."""
    import itertools

    from parallel_convolution_tpu_torch.serving.router import (
        HashRing, route_key,
    )

    rk = {k: route_key(h) for k, h in keys.items()}
    for names in itertools.combinations([f"r{i}" for i in range(12)], 3):
        ring = HashRing(names)
        home = {k: ring.candidates(v)[0] for k, v in rk.items()}
        if home["sep"] != home["rdma"] == home["converge"] == home["crash"]:
            other, = set(names) - {home["sep"], home["rdma"]}
            return {"sep": home["sep"], "rdma": home["rdma"], "other": other}
    raise SmokeFailure("no three replica names split the keys' homes")


def reckon_replica_peak(batch: int, rows: int, cols: int, grid_shape,
                        fuse_pad: int) -> int:
    """Device bytes one replica's warm config-2 key holds at ``batch``
    images: the f32 planar in and out of every image and two bf16 carries
    of the padded extent (the block rims of a ``fuse``-deep chunk)."""
    r, c = grid_shape
    hp = rows + 2 * fuse_pad * r
    wp = cols + 2 * fuse_pad * c
    return batch * (2 * 3 * rows * cols * 4 + 2 * 3 * hp * wp * 2)


def fleet_round(url: str, head: dict, files, conc: int, label: str,
                card: str) -> dict:
    """``FLEET_REQUESTS`` distinct images of one key on frames, ``conc``
    at a time from a client process; every answer must be its image's
    ``shifted`` bytes."""
    got = service_client("convolve", url, "frames", head, conc, *files)
    for i, r in enumerate(got):
        check(r["status"] == 200 and r["equal"]
              and r["effective_backend"] == head["backend"],
              f"fleet {label}: request {i} {r}")
    walls = [r["wall"] for r in got]
    row = dict(latency_ms(walls), mean_ms=1e3 * sum(walls) / len(walls),
               batch_sizes=sorted({r["batch_size"] for r in got}),
               stamps=[r["router"] for r in got])
    print(f"4n latency {label}: " + json.dumps(
        {k: v for k, v in dict(row, card=card).items() if k != "stamps"}))
    return row


def fleet_phase(dev, tmp: Path, refs: dict, totals: dict,
                keep: dict) -> dict:
    """The fleet's front tier on the card: a ``ReplicaRouter`` over three
    replicas (two in process, one over HTTP), its own HTTP server, and the
    entry points; the launches counted into ``totals``.  See the module
    docstring, phase 4n."""
    import base64
    import gc
    import threading

    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.obs import events, metrics
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.resilience import diskio, faults
    from parallel_convolution_tpu_torch.serving import (
        ChaosTransport, ConvolutionService, HTTPReplica, InProcessReplica,
        ReplicaRouter, TenantQuotas, frames, make_http_server, router as rt,
        wal as wal_mod,
    )

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    metrics.set_enabled(True)
    blur3 = get_filter("blur3")
    work = tmp / "fleet"
    work.mkdir(parents=True, exist_ok=True)
    log = events.configure(work / "events.jsonl", max_bytes=64 << 20)
    out = {"card": card, "latency": {}, "hop_ms": {}, "steps_s": {}}
    runs = {}
    mark = [time.perf_counter()]

    def step_done(name):
        now = time.perf_counter()
        out["steps_s"][name] = now - mark[0]
        mark[0] = now

    def counted(label, fn):
        stencil.reset_launch_counts()
        res = fn()
        counts = stencil.launch_counts()
        for k, v in counts.items():
            totals[k] += v
            runs.setdefault(label, dict.fromkeys(counts, 0))[k] += v
        return res, counts

    def nvcc_builds() -> int:
        return sum(1 for r in events.read_events(log.path)
                   if r["kind"] == "compile" and r.get("builder") == "nvcc")

    rgbs, wants = keep["service_imgs"]     # 4o pops them
    files = (work / "imgs.npy", work / "wants.npy")
    np.save(files[0], np.stack(rgbs[:FLEET_REQUESTS]))
    np.save(files[1], np.stack(wants[:FLEET_REQUESTS]))
    lone = (work / "imgs1.npy", work / "wants1.npy")
    np.save(lone[0], np.stack(rgbs[:FLEET_LONE]))
    np.save(lone[1], np.stack(wants[:FLEET_LONE]))
    base = {"rows": RGB_HW[0], "cols": RGB_HW[1], "mode": "rgb",
            "filter": "blur3", "iters": ITERS}
    heads = {
        "sep": dict(base, backend="cuda_sep", storage="bf16", fuse=32),
        "rdma": dict(base, backend="cuda_rdma", storage="bf16", fuse=32,
                     col_mode="strided"),
    }
    _, cwant, citers = keep["cli_converge"]
    chead = {"rows": RGB_HW[0], "cols": RGB_HW[1], "mode": "grey",
             "filter": "blur3", "backend": "cuda_rdma", "storage": "u8",
             "fuse": 8, "quantize": True, "tol": 0.5, "check_every": 10,
             "max_iters": CONVERGE_CLI_MAX}
    crash_head = dict(chead, check_every=FLEET_CRASH_CHECK)
    names = fleet_names(dict(heads, converge=chead, crash=crash_head))
    out["names"] = names
    slots4 = mesh.make_grid((2, 2), devices=[dev] * 4)
    grids = {names["sep"]: mesh.make_grid((1, 1), dev),
             names["rdma"]: slots4, names["other"]: slots4}
    block_hw = tuple(mesh.padded_extent(v, 2) // 2 for v in RGB_HW)
    plans = {"sep": expected_launches(blur3, 32, RGB_HW),
             "rdma": expected_slot_launches(blur3, 32, (2, 2), block_hw,
                                            False)}
    peaks = {n: reckon_replica_peak(8, *RGB_HW, g.shape, 32)
             for n, g in grids.items()}
    print("4n replica peaks reckoned (batch 8, bytes): " + json.dumps(peaks))

    def factory(name):
        def make():
            return ConvolutionService(grids[name], max_batch=8,
                                      max_delay_s=0.005, max_queue=64,
                                      fallback=False)
        return make

    def key_of(svc, head):
        return svc.engine.key_for(
            (3, *RGB_HW), filter_name="blur3", storage=head["storage"],
            iters=ITERS, fuse=32, boundary="zero", quantize=True,
            backend=head["backend"], overlap=None,
            col_mode=head.get("col_mode"))

    servers, routers = [], []

    def serve(obj, make):
        srv = make(obj, "127.0.0.1", 0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        servers.append((srv, th))
        return srv, f"http://127.0.0.1:{srv.server_address[1]}"

    def stop(srv):
        for i, (s, th) in enumerate(servers):
            if s is srv:
                s.shutdown()
                s.server_close()
                th.join(60)
                del servers[i]
                return

    a_name, b_name, c_name = names["sep"], names["rdma"], names["other"]
    grey = refs["greys"]["blur3"]
    np.save(work / "grey.npy", grey)
    rep_a = rep_b = svc_c = None
    try:
        torch.cuda.synchronize()
        m_empty = torch.cuda.memory_allocated()
        rep_a = InProcessReplica(factory(a_name), name=a_name)
        rep_b = InProcessReplica(factory(b_name), name=b_name)
        svc_c = factory(c_name)()
        _, c_url = serve(svc_c, make_http_server)
        rep_c = HTTPReplica(c_url, name=c_name, timeout=600)
        chaos_b = ChaosTransport(rep_b, seed=17, latency_s=1.0)
        svcs = {a_name: lambda: rep_a.service, b_name: lambda: rep_b.service,
                c_name: lambda: svc_c}
        for name, get in svcs.items():
            snap = get().snapshot()
            check(snap["platform"] == "gpu" and snap["device_kind"] == kind,
                  f"fleet: replica {name} reports {snap['platform']} "
                  f"{snap['device_kind']!r}, not the card {kind!r}")
        # Each key warm on its ring home only, batch sizes 1-8; an engine's
        # warm footprint is its peak over the warm-up (its runners hold
        # next to nothing between batches).
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        for k, name in (("sep", a_name), ("rdma", b_name)):
            svc = svcs[name]()
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            counted(f"4n warm {k} on {name}", lambda: svc.engine.warmup(
                [key_of(svc, heads[k])], batch_sizes=range(1, 9)))
            torch.cuda.synchronize()
            m1 = torch.cuda.memory_allocated()
            out.setdefault("warm", {})[k] = {
                "replica": name, "seconds": time.perf_counter() - t0,
                "held_bytes": m1 - m0,
                "footprint_bytes": torch.cuda.max_memory_allocated() - m0}
            m0 = m1
        print("4n warm: " + json.dumps(dict(out["warm"], card=card,
                                            replicas_bytes=m0 - m_empty)))
        quotas = TenantQuotas(rate=1000.0, burst=1000.0,
                              overrides={"greedy": (0.05, 2.0)})
        # load_factor 4: a burst of one max_batch (8) stays on its home
        # (at the default of 2 the bounded-load cap spills a third of it).
        router = ReplicaRouter([rep_a, chaos_b, rep_c], quotas=quotas,
                               load_factor=4.0, breaker_cooldown_s=0.5,
                               poll_interval_s=0.25)
        routers.append(router)
        rsrv, r_url = serve(router, rt.make_router_http_server)
        out["backlog"] = rsrv.request_queue_size
        step_done("0 set-up")
        check(out["backlog"] >= 8, "fleet: the router's backlog is "
              f"{out['backlog']}, under a burst of max_batch")

        # (1) Partition: each key on its home, through the router and
        # straight at the home, at concurrency 1 and 8.
        for k, name in (("sep", a_name), ("rdma", b_name)):
            svc = svcs[name]()
            rows = {}
            for conc in FLEET_CONCURRENCY:
                b0 = svc.engine.stats["batches"]
                row, counts = counted(f"4n router {k} concurrency {conc}",
                                      lambda: fleet_round(
                                          r_url, heads[k],
                                          lone if conc == 1 else files, conc,
                                          f"router {k} concurrency {conc}",
                                          card))
                nb = svc.engine.stats["batches"] - b0
                want = {x: v * nb for x, v in plans[k].items()}
                check(all(counts[x] == want.get(x, 0) for x in counts),
                      f"fleet {k}: launches {counts}, the plan {want} for "
                      f"{nb} batches")
                check(all(s["replica"] == s["home"] == name
                          and s["failovers"] == 0 for s in row.pop("stamps")),
                      f"fleet {k}: a request left its home {name}")
                dsrv, d_url = serve(svc, make_http_server)
                direct, _ = counted(f"4n direct {k} concurrency {conc}",
                                    lambda: fleet_round(
                                        d_url, heads[k],
                                        lone if conc == 1 else files, conc,
                                        f"direct {k} concurrency {conc}",
                                        card))
                stop(dsrv)
                direct.pop("stamps")
                rows[f"concurrency {conc}"] = {"router": row,
                                               "direct": direct,
                                               "batches": nb}
                out["hop_ms"][f"{k} concurrency {conc}"] = (
                    row["p50_ms"] - direct["p50_ms"])
            out["latency"][k] = rows
        for k, name in (("sep", a_name), ("rdma", b_name)):
            resident = [n for n, get in svcs.items()
                        if key_of(get(), heads[k]) in get().engine._entries]
            check(resident == [name], f"fleet: key {k} resident on "
                  f"{resident}, its home is {name}")
        print("4n router hop ms (router p50 - direct p50, frames): "
              + json.dumps(dict(out["hop_ms"], card=card)))
        step_done("1 partition")

        # (2) Failover: the cuda_sep key's home killed mid-round.
        torch.cuda.synchronize()
        a_warm = out["warm"]["sep"]["footprint_bytes"]
        builds0 = nvcc_builds()
        state_a = router._replicas[a_name]
        done0 = state_a.stats["completed"]
        proc = service_client_start("convolve", r_url, "frames",
                                    heads["sep"], 1, *files)
        deadline = time.perf_counter() + 300
        while state_a.stats["completed"] < done0 + 3:
            if proc.poll() is not None or time.perf_counter() > deadline:
                proc.kill()
                proc.wait()
                raise SmokeFailure("fleet failover: the round ended (or "
                                   "stalled) before the kill")
            time.sleep(0.01)
        torch.cuda.synchronize()
        m_before = torch.cuda.memory_allocated()
        stencil.reset_launch_counts()
        rep_a.kill()
        got = service_client_result(proc, "convolve", "frames")
        counts = stencil.launch_counts()
        for x, v in counts.items():
            totals[x] += v
            runs.setdefault("4n failover round", dict.fromkeys(counts, 0))[
                x] += v
        for i, r in enumerate(got):
            check((r["status"] == 200 and r["equal"])
                  or (r["rejected"] and r["retryable"]),
                  f"fleet failover: request {i} {r}")
        stamps = [r["router"] for r in got if r["status"] == 200]
        # A failover as a client sees it (loadgen's failovers_observed):
        # a failed dispatch, or an answer off the home (the health poll
        # marked it unready first and the walk spilled past it).
        moved = [s for s in stamps if s["replica"] != a_name]
        check(moved and all(s["failovers"] >= 1 or s["spills"] >= 1
                            for s in moved),
              f"fleet failover: no failover stamped {stamps}")
        rehomes = {s["replica"] for s in moved}
        resident = [n for n in (b_name, c_name)
                    if key_of(svcs[n](), heads["sep"])
                    in svcs[n]().engine._entries]
        check(len(rehomes) == 1 and set(resident) == rehomes,
              f"fleet failover: re-homed on {rehomes}, resident on "
              f"{resident}")
        gc.collect()
        torch.cuda.synchronize()
        m_killed = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        rep_a.revive()
        counted("4n revive warm", lambda: rep_a.service.engine.warmup(
            [key_of(rep_a.service, heads["sep"])], batch_sizes=range(1, 9)))
        torch.cuda.synchronize()
        m_after = torch.cuda.memory_allocated()
        revive_s = time.perf_counter() - t0
        builds = nvcc_builds() - builds0
        check(builds == 0, f"fleet revive: {builds} nvcc builds")
        check(m_after - m_before <= a_warm,
              f"fleet revive: {m_after - m_before} bytes more than before "
              f"the kill, above one engine's warm footprint {a_warm}")
        out["failover"] = {
            "requests": len(got), "completed": len(stamps),
            "shed": len(got) - len(stamps),
            "failovers": sum(s["failovers"] for s in stamps),
            "failovers_observed": len(moved),
            "rehome": sorted(rehomes), "revive_s": revive_s,
            "nvcc_builds": builds, "bytes_before_kill": m_before,
            "bytes_killed": m_killed, "bytes_after_revive": m_after,
            "warm_footprint": a_warm}
        print("4n failover: " + json.dumps(dict(out["failover"], card=card)))
        router.poll_once()
        step_done("2 failover")

        # (3) Tenants: the greedy one overruns its bucket, the polite one
        # never notices.
        body0 = dict(heads["sep"], image_b64=base64.b64encode(
            rgbs[0].tobytes()).decode("ascii"))
        outcomes = {"greedy": [], "polite": []}
        for tenant in ("greedy", "greedy", "greedy", "polite", "greedy",
                       "polite"):
            (status, wire), _ = counted("4n tenants", lambda: router.request(
                dict(body0), tenant=tenant))
            outcomes[tenant].append((status, wire.get("rejected"),
                                     wire.get("retryable"),
                                     wire.get("retry_after_s")))
            if status == 200:
                check(base64.b64decode(wire["image_b64"])
                      == wants[0].tobytes(), f"fleet tenants: {tenant} bytes")
        check(any(o[:3] == (429, "tenant_quota", True) and o[3] > 0
                  for o in outcomes["greedy"])
              and all(o[0] == 200 for o in outcomes["polite"]),
              f"fleet tenants: {outcomes}")
        out["tenants"] = outcomes
        step_done("3 tenants")

        # (4) Hedge and chaos on the cuda_rdma key's home.
        body_r = dict(heads["rdma"], image_b64=base64.b64encode(
            rgbs[1].tobytes()).decode("ascii"))
        want_r = wants[1].tobytes()

        def answer_ok(wire):
            return (wire.get("ok") and base64.b64decode(
                wire["image_b64"]) == want_r)

        svc_b = rep_b.service
        chaos = {}
        # A dropped response after the work ran: one replica's router says
        # retryable, the retry is served from B's dedup ledger.
        solo = ReplicaRouter([chaos_b], start_health=False)
        routers.append(solo)
        b0, d0 = svc_b.engine.stats["batches"], svc_b.stats["deduped"]
        chaos_b.modes["transport_recv"] = "drop"
        with faults.injected("transport_recv:1", seed=17):
            (s1, w1), _ = counted("4n chaos recv drop", lambda: solo.request(
                dict(body_r, request_id="recv-drop")))
            (s2, w2), _ = counted("4n chaos recv retry", lambda: solo.request(
                dict(body_r, request_id="recv-drop")))
        check(s1 == 503 and w1["rejected"] == "replica_unavailable"
              and w1["retryable"] and s2 == 200 and answer_ok(w2)
              and svc_b.engine.stats["batches"] - b0 == 1
              and svc_b.stats["deduped"] - d0 == 1,
              f"fleet chaos recv drop: {s1} {w1.get('rejected')}, {s2}, "
              f"batches {svc_b.engine.stats['batches'] - b0}")
        chaos["recv_drop"] = {"first": s1, "retry": s2, "batches": 1}
        # A hedge past a slow send.
        hedged = ReplicaRouter([rep_a, chaos_b, rep_c], hedge_s=0.25,
                               start_health=False)
        routers.append(hedged)
        chaos_b.modes["transport_send"] = "latency"
        with faults.injected("transport_send:1", seed=17):
            t0 = time.perf_counter()
            (s, w), _ = counted("4n hedge", lambda: hedged.request(
                dict(body_r, request_id="hedge-1")))
            hedge_ms = 1e3 * (time.perf_counter() - t0)
        check(s == 200 and answer_ok(w) and hedged.stats["hedges"] == 1,
              f"fleet hedge: {s}, hedges {hedged.stats['hedges']}")
        chaos["hedge"] = {"ms": hedge_ms, "replica": w["router"]["replica"],
                          "hedges": hedged.stats["hedges"]}
        # A disconnect mid-stream resumes on the next ring candidate: the
        # job's budget cut to FLEET_DISCONNECT_ITERS, whose final is the
        # plain run of that many iterations (u8 carries are exact).
        cbody = dict(chead, image_b64=base64.b64encode(
            grey.tobytes()).decode("ascii"), request_id="disconnect",
            max_iters=FLEET_DISCONNECT_ITERS)
        dwant = ConvolutionModel("blur3", backend="shifted",
                                 device=dev).run_image(
                                     grey, FLEET_DISCONNECT_ITERS)
        stencil.reset_launch_counts()   # not main-path launches

        def whole_stream():
            st, rows = router.converge(dict(cbody))
            return st, list(rows)

        t0 = time.perf_counter()
        with faults.injected("transport_stream:5", seed=17):
            (status, rows), counts = counted("4n chaos disconnect",
                                             whole_stream)
        last = rows[-1]
        check(status == 200 and last["kind"] == "final"
              and last["iters"] == FLEET_DISCONNECT_ITERS
              and last["router"].get("resume_count") == 1
              and rows[4]["iters"] == 50
              and base64.b64decode(last["image_b64"]) == dwant.tobytes(),
              f"fleet chaos disconnect: {len(rows)} rows, last "
              f"{last.get('kind')} at {last.get('iters')}, "
              f"{last.get('router')}")
        chaos["disconnect"] = {"seconds": time.perf_counter() - t0,
                               "rows": len(rows),
                               "resumed_on": last["router"]["replica"],
                               "launches": counts}
        # Corrupt bodies open B's breaker and the key fails over (then
        # spills past the open breaker, or, where a request outlasts the
        # cooldown, fails over from each half-open probe).
        chaos_b.modes["transport_recv"] = "corrupt"
        snap0 = router.snapshot()["replicas"][b_name]
        stamps = []
        with faults.injected("transport_recv:*", seed=17):
            for i in range(4):
                (s, w), _ = counted("4n chaos corrupt", lambda: router.request(
                    dict(body_r, request_id=f"corrupt-{i}")))
                check(s == 200 and answer_ok(w),
                      f"fleet chaos corrupt: request {i} {s}")
                stamps.append(w["router"])
        snap = router.snapshot()["replicas"][b_name]
        corrupt = snap["corrupt_responses"] - snap0["corrupt_responses"]
        opened = snap["breaker"]["opened"] - snap0["breaker"]["opened"]
        check(corrupt >= 1 and opened >= 1
              and snap["breaker"]["state"] == "open"
              and stamps[0]["failovers"] == 1
              and all(st["replica"] != b_name
                      and st["failovers"] + st["spills"] >= 1
                      for st in stamps),
              f"fleet chaos corrupt: {snap}, {stamps}")
        chaos["corrupt"] = {"stamps": stamps, "corrupt_responses": corrupt,
                            "breaker_opened": opened,
                            "breaker": snap["breaker"]["state"]}
        chaos["injected"] = dict(chaos_b.injected)
        out["chaos"] = chaos
        print("4n chaos: " + json.dumps(dict(chaos, card=card)))
        time.sleep(0.6)    # B's breaker half-opens
        step_done("4 hedge and chaos")

        # (5) A durable converge across a router crash, on frames.
        wal_path = work / "router.wal"
        wal_times = {"append": [0, 0.0], "fsync": [0, 0.0]}
        real_append, real_fsync = wal_mod.RouterWAL.append, diskio.guarded_fsync

        def timed_append(self, kind, **fields):
            t = time.perf_counter()
            try:
                return real_append(self, kind, **fields)
            finally:
                wal_times["append"][0] += 1
                wal_times["append"][1] += time.perf_counter() - t

        def timed_fsync(site, fh):
            t = time.perf_counter()
            try:
                return real_fsync(site, fh)
            finally:
                wal_times["fsync"][0] += 1
                wal_times["fsync"][1] += time.perf_counter() - t

        wal_mod.RouterWAL.append, diskio.guarded_fsync = (timed_append,
                                                          timed_fsync)
        try:
            w1 = ReplicaRouter([rep_a, chaos_b, rep_c], wal=wal_mod.RouterWAL(
                wal_path, max_bytes=FLEET_WAL_SEGMENT), start_health=False)
            routers.append(w1)
            env = frames.encode_envelope(
                dict(crash_head, request_id="crash", tenant="ops"),
                {"image": grey})
            header, arrays = frames.decode_envelope(env)
            header.pop("_frame_fields", None)
            t0 = time.perf_counter()
            status, stream = w1.converge(
                rt._frames_converge_to_json(header, arrays), tenant="ops")
            consumed = []
            for row in stream:
                h, _ = frames.decode_envelope(rt._reframe_row(row))
                consumed.append(h)
                if len(consumed) == FLEET_CRASH_ROWS:
                    break          # the crash: the stream abandoned unclosed
            crash_s = time.perf_counter() - t0
            w2 = ReplicaRouter([rep_a, chaos_b, rep_c], wal=wal_mod.RouterWAL(
                wal_path, max_bytes=FLEET_WAL_SEGMENT), start_health=False)
            routers.append(w2)
            zs, zw = w1.request(dict(body0, request_id="zombie"),
                                tenant="ops")
            check(zs == 409 and zw["rejected"] == "stale_epoch"
                  and zw["retryable"] is False,
                  f"fleet crash: the zombie router got {zs} {zw}")
            w1.close(close_replicas=False)
            stream.close()
            _, w2_url = serve(w2, rt.make_router_http_server)
            t0 = time.perf_counter()
            retry, counts = counted("4n crash retry", lambda: service_client(
                "converge", w2_url, "frames",
                dict(crash_head, request_id="crash", tenant="ops"),
                work / "grey.npy", -1, work / "crash"))
            retry_s = time.perf_counter() - t0
        finally:
            wal_mod.RouterWAL.append, diskio.guarded_fsync = (real_append,
                                                              real_fsync)
        rrows = retry["rows"]
        final = np.load(work / "crash_final.npy")
        finals = sum(r["kind"] == "final" for r in consumed + rrows)
        check(status == 200 and w2.epoch > w1.epoch
              and w2.recovery["jobs_restored"] == 1
              and rrows[0]["iters"] == consumed[-1]["iters"]
              + FLEET_CRASH_CHECK
              and rrows[-1]["kind"] == "final"
              and rrows[-1]["iters"] == citers and finals == 1
              and rrows[-1]["router"]["resume_count"] >= 1
              and rrows[-1]["router"]["epoch"] == w2.epoch
              and np.array_equal(final, cwant),
              f"fleet crash: crashed at {consumed[-1]['iters']}, the retry "
              f"from {rrows[0]['iters']} to {rrows[-1]['iters']} "
              f"({rrows[-1]['kind']}), finals {finals}, epochs "
              f"{w1.epoch} -> {w2.epoch}, {w2.recovery}")
        out["crash"] = {
            "crashed_at": consumed[-1]["iters"], "crash_s": crash_s,
            "resumed_from": rrows[0]["iters"] - FLEET_CRASH_CHECK,
            "retry_s": retry_s,
            "retry_rows": len(rrows), "epochs": [w1.epoch, w2.epoch],
            "recovery": w2.recovery, "zombie": [zs, zw["rejected"]],
            "wal": {"appends": wal_times["append"][0],
                    "append_s": wal_times["append"][1],
                    "fsyncs": wal_times["fsync"][0],
                    "fsync_s": wal_times["fsync"][1],
                    "snapshot": w2.wal.snapshot()},
            "launches": counts}
        print("4n crash: " + json.dumps(dict(out["crash"], card=card)))
        step_done("5 crash")

        # (6) The entry points: loadgen through the router, route's help
        # and the JAX script's refusal of --shards without --state-dir.
        loadgen_argv = [
            sys.executable, "-m", "parallel_convolution_tpu_torch.serving."
            "loadgen", "--target", r_url, "--wire", "frames", "--n",
            str(FLEET_LOADGEN), "--concurrency", "4", "--rows",
            str(RGB_HW[0]), "--cols", str(RGB_HW[1]), "--mode", "rgb",
            "--filter", "blur3", "--iters", str(ITERS), "--backend",
            "cuda_sep", "--storage", "bf16", "--fuse", "32", "--seed", "3"]
        here = Path(__file__).resolve().parent
        route_cmd = [sys.executable, "-m",
                     "parallel_convolution_tpu_torch.serving.route"]
        # route's two runs import the package (torch) while loadgen runs.
        procs = [subprocess.Popen(route_cmd + flags, cwd=here,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for flags in (["--help"],
                               ["--replicas", "1", "--shards", "2"])]
        try:
            t0 = time.perf_counter()
            lg, counts = counted("4n loadgen", lambda: subprocess.run(
                loadgen_argv, capture_output=True, text=True, timeout=600,
                cwd=here))
            lg_s = time.perf_counter() - t0
            (h_out, _), (_, s_err) = (pr.communicate(timeout=120)
                                      for pr in procs)
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        check(lg.returncode == 0, f"fleet loadgen: rc {lg.returncode} "
              f"{lg.stderr[-2000:]}")
        lrow = json.loads(lg.stdout.strip().splitlines()[-1])
        check(lrow["completed"] == FLEET_LOADGEN
              and lrow["non_rejected_failures"] == 0
              and lrow["p50_ms"] and lrow["p99_ms"]
              and "failovers_observed" in lrow
              and lrow["effective_backend"] == "cuda_sep",
              f"fleet loadgen: {lrow}")
        out["loadgen"] = {k: lrow.get(k) for k in (
            "completed", "p50_ms", "p95_ms", "p99_ms", "failovers_observed",
            "replicas_seen", "batch_mean", "gpixels_per_s", "wall_s")}
        out["loadgen"].update(seconds=lg_s, launches=counts)
        print("4n loadgen: " + json.dumps(dict(out["loadgen"], card=card)))
        check(procs[0].returncode == 0 and "usage" in h_out
              and procs[1].returncode == 2
              and "--shards requires --state-dir" in s_err,
              f"fleet route: --help {procs[0].returncode}, --shards 2 "
              f"{procs[1].returncode} {s_err[-500:]}")
        out["stats"] = router.snapshot()["router"]
        status, payload = router.readyz()
        check(status == 200 and payload["ready"],
              f"fleet: the router is not ready at the end: {payload}")
        step_done("6 entry points")
    finally:
        for r in routers:
            r.close(close_replicas=False)
        for srv, th in servers:
            srv.shutdown()
            srv.server_close()
            th.join(60)
        for obj in (rep_a, rep_b, svc_c):
            if obj is not None:
                obj.close()
        shutil.rmtree(work, ignore_errors=True)
    fired = [f for f in ("fused_iterate", "rdma_tiled_slot")
             if not any(r.get(f) for r in runs.values())]
    check(not fired, f"fleet: {fired} never launched in phase 4n")
    out["runs"] = [{"path": k, "launches": v} for k, v in runs.items()]
    out["seconds"] = time.perf_counter() - t_start
    return out


# ---------------------------------------------------------------------------
# Phase 4o: the rest of the fleet (ROADMAP item 8b-ii)
# ---------------------------------------------------------------------------

SHARD_NAMES = ("sA", "sB", "sC")  # 4o: the three routers of the shard fleet
SHARD_CLIENTS = 4           # 4o (b): client threads on the surviving shards
SHARD_IMAGES = 4            # 4o (b): config-2 images a surviving shard
SHARD_CRASH_ROWS = 5        # 4o (b): converge rows before the hard stop
SHARD_BASELINE_S = 3.0      # 4o (b): the pre-kill window
SHARD_HOLD_S = 1.5          # 4o (b): the window held open after takeover
SHARD_LOADGEN = 16          # 4o (c): loadgen --shardmap's requests
SCALE_CLIENTS = 8           # 4o (d): the closed-loop pack
SCALE_KEYS = 6              # 4o (d): config-2 keys (iters 100, 101, ...)
SCALE_IMAGES = 2            # 4o (d): images a key
# 4o (e): the soak's drills at the JAX script's sizes, in-process on the
# card; the two supervised fault soaks run as child processes of their own
# from the start of the phase (each leg a further child).
SOAK_DRILLS = (["--shard-kill", "1"], ["--autoscale", "1"],
               ["--router-kill", "1"], ["--chaos", "1"],
               ["--router-restart", "1"], ["--chaos-matrix", "1"])
SOAK_CHILD_DRILLS = (["--faults", "1"], ["--serve", "--faults", "1"])


def free_ports(n: int) -> list:
    """``n`` ports free on localhost now (bound and released)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def soak_run(argv: list) -> tuple:
    """``soak.main(argv)`` in this process: its exit code and its JSON
    rows (the summary last)."""
    from parallel_convolution_tpu_torch import soak

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = soak.main(argv)
    rows = [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]
    return rc, rows


def shard_names(keys: dict) -> dict:
    """Three replica names whose hash ring homes the converge key on a
    replica of 2x2 slots (the two named ``slots``) and the config-2
    traffic keys on the 1x1 one (``one``) where it can: ``{"one": A,
    "slots": [B, C]}``."""
    import itertools

    from parallel_convolution_tpu_torch.serving.router import (
        HashRing, route_key,
    )

    conv, traffic = route_key(keys["converge"]), [
        route_key(h) for h in keys["traffic"]]
    best = None
    for names in itertools.combinations([f"q{i}" for i in range(12)], 3):
        ring = HashRing(names)
        home = ring.candidates(conv)[0]
        for one in names:
            if one == home:
                continue
            on_one = sum(ring.candidates(k)[0] == one for k in traffic)
            if best is None or on_one > best[0]:
                best = (on_one, {"one": one, "slots": [
                    n for n in names if n != one]})
            if on_one == len(traffic):
                return best[1]
    return best[1]


def fleet_rest_phase(dev, tmp: Path, refs: dict, totals: dict,
                     keep: dict) -> dict:
    """The rest of the fleet on the card: the soak, the sharded control
    plane in process and over HTTP, the autoscaler and the soak's drills;
    the launches counted into ``totals``.  See the module docstring,
    phase 4o."""
    import base64
    import gc
    import signal
    import threading
    import urllib.request

    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.obs import events, metrics
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.serving import (
        AutoScaler, ConvolutionService, InProcessReplica, ReplicaRouter,
        frames, peers,
    )
    from parallel_convolution_tpu_torch.serving.router import (
        HashRing, route_key,
    )
    from parallel_convolution_tpu_torch.utils import imageio

    t_start = time.perf_counter()
    card = card_line()
    metrics.set_enabled(True)
    work = tmp / "fleet_rest"
    work.mkdir(parents=True, exist_ok=True)
    log = events.configure(work / "events.jsonl", max_bytes=64 << 20)
    out = {"card": card, "steps_s": {}}
    runs = {}
    mark = [time.perf_counter()]
    here = Path(__file__).resolve().parent

    def step_done(name):
        now = time.perf_counter()
        out["steps_s"][name] = now - mark[0]
        mark[0] = now
        print(f"4o step {name}: {out['steps_s'][name]:.2f} s", flush=True)

    def counted(label, fn):
        stencil.reset_launch_counts()
        res = fn()
        counts = stencil.launch_counts()
        for k, v in counts.items():
            totals[k] += v
            runs.setdefault(label, dict.fromkeys(counts, 0))[k] += v
        return res, counts

    def compiles() -> list:
        return [r for r in events.read_events(log.path)
                if r["kind"] == "compile"]

    def shifted(img, iters):
        return ConvolutionModel("blur3", backend="shifted",
                                device=dev).run_image(img, iters)

    rgbs, wants = keep.pop("service_imgs")
    keep["engine_pair"] = (rgbs[:2], wants[:2])   # phase 4j (e)'s batch
    _, cwant, citers = keep["cli_converge"]
    grey = refs["greys"]["blur3"]
    base = {"rows": RGB_HW[0], "cols": RGB_HW[1], "mode": "rgb",
            "filter": "blur3", "backend": "cuda_sep", "storage": "bf16",
            "fuse": 32, "boundary": "zero"}
    chead = {"rows": RGB_HW[0], "cols": RGB_HW[1], "mode": "grey",
             "filter": "blur3", "backend": "cuda_rdma", "storage": "u8",
             "fuse": 8, "quantize": True, "tol": 0.5,
             "check_every": FLEET_CRASH_CHECK,
             "max_iters": CONVERGE_CLI_MAX}

    # The processes of (c), (d) and (e), started now: each takes seconds
    # to import torch and reach the card, in parallel with (a) and (b).
    # They run on the card by default; a rehearsal on the CPU asks.
    dev_args = ["--device", "cpu"] if dev.type == "cpu" else []
    dev_name = "cpu" if dev.type == "cpu" else "cuda:0"
    ports = free_ports(len(SHARD_NAMES))
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    route_cmd = [sys.executable, "-m",
                 "parallel_convolution_tpu_torch.serving.route"]
    procs = {}

    def start(name, cmd):
        procs[name] = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)

    http_dir = work / "http_state"
    for i, nm in enumerate(SHARD_NAMES):
        start(nm, [*route_cmd, *dev_args, "--port", str(ports[i]),
                   "--replicas", "1", "--mesh", "1x1",
                   "--shards", str(len(SHARD_NAMES)),
                   "--name", nm, "--state-dir", str(http_dir),
                   "--advertise", urls[i],
                   *[a for j, o in enumerate(SHARD_NAMES)
                     for a in ("--assign", f"{j}={o}")],
                   *[a for j, o in enumerate(SHARD_NAMES) if j != i
                     for a in ("--peer", f"{o}={urls[j]}")]])
    start("autoscale route", [*route_cmd, *dev_args, "--port", "0",
                              "--replicas", "1", "--mesh", "1x1",
                              "--autoscale-max", "2"])
    for argv in SOAK_CHILD_DRILLS:
        start(" ".join(argv), [sys.executable, "-m",
                               "parallel_convolution_tpu_torch.soak", *argv,
                               *dev_args, "--state-dir",
                               str(work / "_".join(argv))])
    routers, reps, scaler = [], [], None
    try:
        # (a) The randomized soak on the card, through the main path's
        # entry (step.sharded_iterate / sharded_converge on grids of slots).
        soak_out = {}
        for label, argv in (("iterate", ["--n", "32", "--seed", "0"]),
                            ("converge", ["--converge", "--n", "8",
                                          "--seed", "0"])):
            t0 = time.perf_counter()
            (rc, rows), counts = counted(f"4o soak {label}",
                                         lambda: soak_run(argv + dev_args))
            summary = rows.pop()
            for r in rows:
                if not r["ok"]:
                    print("4o soak FAILED row: " + json.dumps(r))
            check(rc == 0 and summary["failures"] == 0 and len(rows)
                  == int(argv[argv.index("--n") + 1])
                  and all(r["ok"] for r in rows),
                  f"4o soak {label}: rc {rc}, {summary}")
            soak_out[label] = {
                "rows": len(rows), "seconds": time.perf_counter() - t0,
                "backends": sorted({r["backend"] for r in rows}),
                "grids": sorted({r["mesh"] for r in rows}),
                "launches": counts}
        out["soak"] = soak_out
        print("4o soak: " + json.dumps(dict(soak_out, card=card)))
        step_done("a soak")

        # (b) The sharded control plane at BASELINE sizes, in process.
        # iters is a route-key field: scan it from config 2's 100 until
        # every shard has a traffic key.
        n = len(SHARD_NAMES)
        cbody = dict(chead, image_b64=base64.b64encode(
            grey.tobytes()).decode("ascii"))
        kill_shard = peers.shard_of(route_key(cbody), n)
        by_shard = {}
        for it in range(ITERS, ITERS + 200):
            by_shard.setdefault(
                peers.shard_of(route_key(dict(base, iters=it)), n), it)
            if len(by_shard) == n:
                break
        check(len(by_shard) == n, f"4o shards: keys {by_shard}")
        live = [s for s in sorted(by_shard) if s != kill_shard]
        iters_of = {s: by_shard[s] for s in live}
        imgs = rgbs[:SHARD_IMAGES]
        t0 = time.perf_counter()
        want_of = {(s, i): (wants[i] if iters_of[s] == ITERS
                            else shifted(imgs[i], iters_of[s]))
                   for s in live for i in range(len(imgs))}
        out["shard_refs_s"] = time.perf_counter() - t0
        heads = {s: dict(base, iters=iters_of[s]) for s in live}
        names = shard_names({"converge": cbody,
                             "traffic": list(heads.values())})
        slots4 = mesh.make_grid((2, 2), devices=[dev] * 4)
        grids = {names["one"]: mesh.make_grid((1, 1), dev),
                 **{nm: slots4 for nm in names["slots"]}}

        def factory(grid):
            def make():
                return ConvolutionService(grid, max_batch=8,
                                          max_delay_s=0.005, max_queue=64,
                                          fallback=False)
            return make

        reps = [InProcessReplica(factory(g), name=nm)
                for nm, g in sorted(grids.items())]
        # Each traffic key warm on its home (batch sizes 1-4): the pre-kill
        # window measures serving, not builds.
        ring = HashRing([r.name for r in reps])
        for s in live:
            home = ring.candidates(route_key(heads[s]))[0]
            svc = next(r for r in reps if r.name == home).service
            counted("4o shards warm", lambda: svc.engine.warmup(
                [svc.engine.key_for((3, *RGB_HW), filter_name="blur3",
                                    storage="bf16", iters=iters_of[s],
                                    fuse=32, boundary="zero", quantize=True,
                                    backend="cuda_sep", overlap=None,
                                    col_mode=None)],
                batch_sizes=range(1, SHARD_CLIENTS + 1)))
        state_dir = work / "shards"
        assign = {str(i): SHARD_NAMES[i] for i in range(n)}
        fleet = {}
        for nm in SHARD_NAMES:
            fleet[nm] = peers.ShardRouter(
                nm, reps, n_shards=n,
                owned=[s for s, o in assign.items() if o == nm],
                state_dir=state_dir, assignments=assign,
                sync_interval_s=0.25, suspect_after=3, start_sync=False,
                breaker_cooldown_s=0.5, load_factor=4.0, poll_interval_s=0.25)
            routers.append(fleet[nm])
        for nm in SHARD_NAMES:
            fleet[nm].peers = [peers.InProcessPeer(fleet[o])
                               for o in SHARD_NAMES if o != nm]
            fleet[nm].start_sync()
        victim = fleet[assign[kill_shard]]
        survivors = [r for r in fleet.values() if r is not victim]
        step_done("b0 set-up")

        phase = {"now": "before"}
        lat = {"before": [], "during": [], "after": []}
        lock = threading.Lock()
        stop = threading.Event()
        failures = []
        served = {"before": 0, "during": 0, "after": 0}

        def frames_body(head, img, rid):
            env = frames.encode_envelope(dict(head, request_id=rid),
                                         {"image": img})
            hdr, raw = frames.split_envelope(env)
            return dict(hdr, _frames_raw=bytes(raw))

        def pound(widx):
            try:
                pound_loop(widx)
            except Exception as e:  # noqa: BLE001 — a failure, not a hang
                with lock:
                    failures.append(f"client {widx} raised {e!r}")

        def pound_loop(widx):
            client = peers.ShardClient(list(fleet.values()))
            s = live[widx % len(live)]
            j = 0
            while not stop.is_set():
                i = (j + widx) % len(imgs)
                j += 1
                t1 = time.perf_counter()
                _, w = client.request(frames_body(heads[s], imgs[i],
                                                  f"c{widx}-{j}"))
                dt = time.perf_counter() - t1
                raw = w.pop("_frames_raw", b"")
                if w.get("ok"):
                    _, arrays = frames.decode_envelope(
                        frames.join_envelope(w, raw))
                    with lock:
                        lat[phase["now"]].append(dt)
                        served[phase["now"]] += 1
                        if not np.array_equal(arrays["image"],
                                              want_of[(s, i)]):
                            failures.append(f"shard {s} image {i}: bytes")
                elif not w.get("retryable"):
                    with lock:
                        failures.append(f"shard {s}: non-rejected "
                                        f"{w.get('rejected')!r} "
                                        f"{str(w.get('detail'))[:200]}")
                else:
                    time.sleep(0.01)

        threads = [threading.Thread(target=pound, args=(w,), daemon=True)
                   for w in range(SHARD_CLIENTS)]
        stencil.reset_launch_counts()
        for th in threads:
            th.start()
        time.sleep(SHARD_BASELINE_S)
        client = peers.ShardClient(list(fleet.values()))
        st, rows = client.converge(dict(cbody, request_id="shard-job"))
        consumed = []
        for row in rows:
            consumed.append(row)
            if len(consumed) == SHARD_CRASH_ROWS:
                break          # the crash: the stream abandoned unclosed
        phase["now"] = "during"
        t_kill = time.perf_counter()
        victim.hard_stop()
        owner = None
        while owner is None and time.perf_counter() - t_kill < 30.0:
            owner = next((r for r in survivors if kill_shard in r._sub),
                         None)
            time.sleep(0.005)
        takeover_s = time.perf_counter() - t_kill
        check(owner is not None, "4o shards: no takeover within 30 s")
        time.sleep(SHARD_HOLD_S)
        phase["now"] = "after"
        client.refresh()
        t0 = time.perf_counter()
        st2, rows2 = client.converge(dict(cbody, request_id="shard-job"))
        retry = list(rows2) if st2 == 200 else []
        retry_s = time.perf_counter() - t0
        _, zrows = victim.sub(kill_shard).converge(
            dict(cbody, request_id="shard-zombie"))
        zombie = next(iter(zrows), {})
        stop.set()
        for th in threads:
            th.join(120)
        counts = stencil.launch_counts()
        for k, v in counts.items():
            totals[k] += v
        runs["4o shards"] = counts
        final = retry[-1] if retry else {}
        finals = sum(r.get("kind") == "final" for r in consumed + retry)
        got = (np.frombuffer(base64.b64decode(final["image_b64"]), np.uint8)
               .reshape(grey.shape) if final.get("kind") == "final"
               else None)
        p_before, p_during = (latency_ms(lat[k]) if lat[k] else None
                              for k in ("before", "during"))
        out["shards"] = {
            "kill_shard": kill_shard, "victim": victim.name,
            "successor": owner.name, "traffic_iters": iters_of,
            "replicas": names, "takeover_s": takeover_s,
            "epochs": [victim.sub(kill_shard).epoch,
                       owner.sub(kill_shard).epoch],
            "takeovers": sum(r.stats["takeovers"] for r in survivors),
            "crashed_at": consumed[-1]["iters"],
            "resumed_from": retry[0]["iters"] - FLEET_CRASH_CHECK
            if retry else None, "retry_rows": len(retry),
            "retry_s": retry_s, "finals": finals,
            "zombie": zombie.get("rejected"), "served": served,
            "p99_before_ms": p_before and p_before["p99_ms"],
            "p99_during_ms": p_during and p_during["p99_ms"],
            "latency": {k: latency_ms(v) for k, v in lat.items() if v},
            "map_version": owner.map.version(), "launches": counts}
        print("4o shards: " + json.dumps(dict(out["shards"], card=card)))
        check(not failures, f"4o shards: {failures[:4]}")
        check(out["shards"]["takeovers"] == 1
              and out["shards"]["epochs"][1] > out["shards"]["epochs"][0],
              f"4o shards: takeovers {out['shards']['takeovers']}, "
              f"epochs {out['shards']['epochs']}")
        check(st == st2 == 200 and final.get("kind") == "final"
              and final["iters"] == citers and finals == 1
              and final["router"]["resume_count"] >= 1
              and final["router"]["shard"] == kill_shard
              and retry[0]["iters"] > consumed[-1]["iters"]
              and got is not None and np.array_equal(got, cwant),
              f"4o shards: the retry {st2} from "
              f"{retry[0]['iters'] if retry else None} to "
              f"{final.get('iters')} ({final.get('kind')}), finals {finals}")
        check(zombie.get("rejected") == "stale_epoch",
              f"4o shards: the zombie got {zombie}")
        check(p_during is not None and p_before is not None
              and p_during["p99_ms"] <= 5 * p_before["p99_ms"] + 25,
              f"4o shards: survivors' p99 {p_during} through the takeover "
              f"against {p_before} before it")
        for r in routers:
            r.close(close_replicas=False)
        routers.clear()
        for rep in reps:
            rep.close()
        reps = []
        step_done("b shards")

        # The route processes of (c): read their boot lines and send each
        # one config-2 request of its own shard's key from a thread while
        # (d) runs (its replica's first request initialises CUDA there).
        boots, warmed = {}, {}

        def warm_routes():
            for nm in SHARD_NAMES:
                boots[nm] = json.loads(procs[nm].stdout.readline())

            def one(i, nm):
                body = json.dumps(dict(
                    base, iters=by_shard[str(i)], image_b64=base64.b64encode(
                        rgbs[0].tobytes()).decode("ascii"))).encode()
                req = urllib.request.Request(
                    urls[i] + "/v1/convolve", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=600) as r:
                    w = json.loads(r.read())
                warmed[nm] = {"ok": w.get("ok"),
                              "backend": w.get("effective_backend")}
            ths = [threading.Thread(target=one, args=(i, nm))
                   for i, nm in enumerate(SHARD_NAMES)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(600)

        warmer = threading.Thread(target=warm_routes, daemon=True)
        warmer.start()

        # (d) The autoscaler over a 1x1 pool, config-2 keys at batch 1
        # (the pre-warm builds batch 1, as the JAX engine does).
        pool = list(range(ITERS, ITERS + SCALE_KEYS))
        bodies = {it: dict(base, iters=it) for it in pool}
        ring2 = HashRing(["r0", "as1"])
        check(any(ring2.candidates(route_key(b))[0] == "as1"
                  for b in bodies.values()),
              "4o autoscale: no key of the pool homes on the first grown "
              "replica")
        simgs = rgbs[:SCALE_IMAGES]
        t0 = time.perf_counter()
        swant = {(it, i): (wants[i] if it == ITERS else shifted(simgs[i], it))
                 for it in pool for i in range(len(simgs))}
        out["scale_refs_s"] = time.perf_counter() - t0
        one = mesh.make_grid((1, 1), dev)

        def sfactory():
            return ConvolutionService(one, max_batch=1, max_delay_s=0.001,
                                      max_queue=16, fallback=False)

        router = ReplicaRouter([InProcessReplica(sfactory, name="r0")],
                               poll_interval_s=0.25, breaker_cooldown_s=0.5)
        routers.append(router)
        sres = {"ok": 0, "retryable": 0, "bad": []}

        def one_request(it, i, rid):
            body = dict(bodies[it], request_id=rid,
                        image_b64=base64.b64encode(
                            simgs[i].tobytes()).decode("ascii"))
            for _ in range(8):
                _, w = router.request(dict(body))
                if w.get("ok") or not w.get("retryable"):
                    break
                time.sleep(min(float(w.get("retry_after_s") or 0.05), 0.5))
            with lock:
                if w.get("ok"):
                    sres["ok"] += 1
                    if base64.b64decode(w["image_b64"]) != swant[
                            (it, i)].tobytes():
                        sres["bad"].append(f"{rid}: bytes")
                elif w.get("retryable"):
                    sres["retryable"] += 1
                else:
                    sres["bad"].append(f"{rid}: {w.get('rejected')!r}")
            return w

        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for it in pool:     # the observatory sees every key; r0 builds it
            counted("4o autoscale warm", lambda: one_request(
                it, 0, f"warm{it}"))
        torch.cuda.synchronize()
        footprint = torch.cuda.max_memory_allocated() - m0
        m_before = torch.cuda.memory_allocated()
        scaler = AutoScaler(
            router, lambda name: InProcessReplica(sfactory, name=name),
            min_replicas=1, max_replicas=3, interval_s=0.25, cooldown_s=1.0)
        scaler.start()
        stop = threading.Event()
        counter = [0]

        def worker():
            while not stop.is_set():
                with lock:
                    k = counter[0]
                    counter[0] += 1
                one_request(pool[k % len(pool)], k % len(simgs), f"s{k}")

        stencil.reset_launch_counts()
        t0 = time.perf_counter()
        pack = [threading.Thread(target=worker, daemon=True)
                for _ in range(SCALE_CLIENTS)]
        for th in pack:
            th.start()
        while (len(router.ring.members()) < 2
               and time.perf_counter() - t0 < 120):
            time.sleep(0.05)
        grew_s = time.perf_counter() - t0
        stop.set()
        for th in pack:
            th.join(120)
        members = router.ring.members()
        check(len(members) >= 2, f"4o autoscale: no growth in {grew_s:.1f} s")
        grown = scaler.snapshot()["added"]
        # After the join: each pre-warmed key the newcomer is home of, once
        # more, served warm (no compile event, no new runner).  The loop
        # is paused meanwhile, so an idle tick cannot shrink the pool under
        # the round.
        scaler.close()
        newcomer = router.replica(grown[0]).service
        eng = newcomer.engine
        shard_keys = [it for it in pool
                      if router.ring.candidates(route_key(
                          bodies[it]))[0] == grown[0]]
        before = {k.iters: e.compiles for k, e in eng._entries.items()}
        n_compiles = len(compiles())
        for it in shard_keys:
            w = one_request(it, 0, f"post{it}")
            check(w.get("ok") and w["router"]["replica"] == grown[0],
                  f"4o autoscale: post-join key {it} {w.get('router')}")
        after = {k.iters: e.compiles for k, e in eng._entries.items()}
        new_compiles = compiles()[n_compiles:]
        scaler.start()
        t1 = time.perf_counter()
        while (len(router.ring.members()) > 1
               and time.perf_counter() - t1 < 120):
            time.sleep(0.05)
        shrank_s = time.perf_counter() - t1
        counts = stencil.launch_counts()
        for k, v in counts.items():
            totals[k] += v
        runs["4o autoscale"] = counts
        scaler.close()
        stats = dict(scaler.stats)
        del newcomer, eng
        gc.collect()
        torch.cuda.synchronize()
        m_after = torch.cuda.memory_allocated()
        out["autoscale"] = {
            "grew_s": grew_s, "shrank_s": shrank_s, "grown": grown,
            "members_at_growth": members, "shard_keys": shard_keys,
            "runner_builds_before": before, "runner_builds_after": after,
            "compile_events_after_join": len(new_compiles),
            "answers": {k: v for k, v in sres.items() if k != "bad"},
            "stats": stats, "footprint_bytes": footprint,
            "bytes_before_growth": m_before, "bytes_after_shrink": m_after,
            "launches": counts}
        print("4o autoscale: " + json.dumps(dict(out["autoscale"],
                                                 card=card)))
        check(not sres["bad"], f"4o autoscale: {sres['bad'][:4]}")
        check(stats["prewarmed_configs"] >= 1 and shard_keys
              and all(before.get(it) == after.get(it) == 1
                      for it in shard_keys) and not new_compiles,
              f"4o autoscale: warm placement {shard_keys}, runners "
              f"{before} -> {after}, compiles {new_compiles[:3]}")
        check(len(router.ring.members()) == 1,
              f"4o autoscale: no shrink in {shrank_s:.1f} s")
        check(m_after - m_before <= footprint,
              f"4o autoscale: {m_after - m_before} bytes more after the "
              f"shrink, above one replica's warm footprint {footprint}")
        boot = json.loads(procs["autoscale route"].stdout.readline())
        check(boot["autoscale_max"] == 2 and boot["device"] == dev_name,
              f"4o autoscale: route --autoscale-max 2 boot line {boot}")
        procs["autoscale route"].send_signal(signal.SIGTERM)
        procs.pop("autoscale route").communicate(timeout=120)
        router.close()
        routers.clear()
        step_done("d autoscale")

        # (c) The same over HTTP: three route --shards 3 processes (booted
        # at the start of the phase, warmed during (d)), loadgen
        # --shardmap, the owner of the requests' shard SIGKILLed mid-run.
        warmer.join(600)
        check(len(warmed) == n and all(w.get("ok") for w in warmed.values()),
              f"4o http: the route processes' warm-up {warmed}")
        check([boots[nm]["owned"] for nm in SHARD_NAMES]
              == [[str(i)] for i in range(n)]
              and all(b["device"] == dev_name for b in boots.values()),
              f"4o http: boot lines {boots}")
        lg_seed = 11
        lg_img = imageio.generate_test_image(*RGB_HW, "rgb", seed=lg_seed)
        np.save(work / "lg_want.npy", shifted(lg_img, ITERS))
        lg_shard = peers.shard_of(route_key(dict(base, iters=ITERS)), n)
        lg_owner = SHARD_NAMES[int(lg_shard)]
        lg_argv = [sys.executable, "-m",
                   "parallel_convolution_tpu_torch.serving.loadgen",
                   "--shardmap", *[a for u in urls for a in ("--target", u)],
                   "--n", str(SHARD_LOADGEN), "--concurrency", "4",
                   "--rows", str(RGB_HW[0]), "--cols", str(RGB_HW[1]),
                   "--mode", "rgb", "--filter", "blur3", "--iters",
                   str(ITERS), "--backend", "cuda_sep", "--storage", "bf16",
                   "--fuse", "32", "--seed", str(lg_seed),
                   "--check-against", str(work / "lg_want.npy"),
                   "--trace-out", str(work / "lg_trace.jsonl"),
                   # A request once took 65.3 s across the kill (PERF.md
                   # §7): a stuck one is retried after 30 s.
                   "--timeout", "30"]
        t0 = time.perf_counter()
        lg = subprocess.Popen(lg_argv, cwd=here, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
        owner_url = urls[int(lg_shard)]
        done = 0
        while done < 2 and lg.poll() is None:
            with urllib.request.urlopen(owner_url + "/stats",
                                        timeout=30) as r:
                snap = json.loads(r.read())
            done = snap["shards"][lg_shard]["router"]["completed"]
            time.sleep(0.05)
        procs[lg_owner].send_signal(signal.SIGKILL)
        procs[lg_owner].wait(60)
        t_killed = time.perf_counter() - t0
        lg_out, lg_err = lg.communicate(timeout=600)
        lg_s = time.perf_counter() - t0
        check(lg.returncode == 0, f"4o http loadgen: rc {lg.returncode} "
              f"{lg_err[-2000:]}")
        lrow = json.loads(lg_out.strip().splitlines()[-1])
        out["http"] = {k: lrow.get(k) for k in (
            "completed", "rejected", "non_rejected_failures",
            "oracle_mismatches", "shardmap_refreshes", "shards_seen",
            "router_restarts_observed", "p50_ms", "p99_ms", "wall_s")}
        trace = [json.loads(ln) for ln in
                 (work / "lg_trace.jsonl").read_text().splitlines()]
        out["http"].update(killed=lg_owner, killed_after_s=t_killed,
                           completed_at_kill=done, seconds=lg_s,
                           slowest=sorted(trace, key=lambda r: -r[
                               "latency_ms"])[:2])
        print("4o http: " + json.dumps(dict(out["http"], card=card)))
        check(done >= 2 and lrow["non_rejected_failures"] == 0
              and lrow["oracle_mismatches"] == 0
              and lrow["completed"] == SHARD_LOADGEN
              and lrow["shardmap_refreshes"] >= 2,
              f"4o http: {out['http']}")
        for nm in SHARD_NAMES:
            if procs[nm].poll() is None:
                procs[nm].send_signal(signal.SIGTERM)
        for nm in SHARD_NAMES:
            procs.pop(nm).communicate(timeout=120)
        step_done("c http")

        # (e) The soak's drills at the JAX script's sizes, on the card.
        drills = {}
        for argv in SOAK_DRILLS:
            t0 = time.perf_counter()
            state = ["--state-dir", str(work / "_".join(argv))]
            (rc, rows), counts = counted("4o drills", lambda: soak_run(
                [*argv, *dev_args,
                 *(state if argv[0] != "--chaos-matrix" else [])]))
            summary = rows[-1] if rows else {}
            drills[" ".join(argv)] = {
                "rc": rc, "seconds": time.perf_counter() - t0,
                "failures": summary.get("failures"),
                **{k: summary[k] for k in (
                    "takeovers", "failovers_observed", "resumes_observed",
                    "prewarmed_configs", "epochs", "per_cycle")
                   if k in summary}}
            check(rc == 0 and summary.get("failures") == 0,
                  f"4o drill {' '.join(argv)}: rc {rc} {summary}")
        for argv in SOAK_CHILD_DRILLS:
            name = " ".join(argv)
            p = procs.pop(name)
            o, e = p.communicate(timeout=600)
            summary = json.loads(o.strip().splitlines()[-1])
            drills[name] = {"rc": p.returncode,
                            "seconds": summary.get("wall_s"),
                            "failures": summary.get("failures")}
            check(p.returncode == 0 and summary.get("failures") == 0,
                  f"4o drill {name}: rc {p.returncode} {summary} "
                  f"{e[-1500:]}")
        out["drills"] = drills
        print("4o drills: " + json.dumps(dict(drills, card=card)))
        step_done("e drills")
    finally:
        if scaler is not None:
            scaler.close()
        for r in routers:
            r.close(close_replicas=False)
        for rep in reps:
            rep.close()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.communicate()
        shutil.rmtree(work, ignore_errors=True)
    out["runs"] = [{"path": k, "launches": v} for k, v in runs.items()]
    out["seconds"] = time.perf_counter() - t_start
    return out


# ---------------------------------------------------------------------------
# Phase 4d: multigrid (ROADMAP item 5)
# ---------------------------------------------------------------------------


def mg_counted(label, fn, levels, backend, totals: dict):
    """``fn()`` -> ``(field, MGResult)`` with the counters at 0 before and
    read after: its launches must be the schedule's per-cycle launches
    (``multigrid.cycle_launches``) times its cycles, one readback a cycle;
    they are added to the totals."""
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.solvers import multigrid as mg

    stencil.reset_launch_counts()
    reads = mg.mg_converge.readbacks
    (out, res), secs = host_seconds(fn)
    counts = stencil.launch_counts()
    reads = mg.mg_converge.readbacks - reads
    per = mg.cycle_launches(levels, backend, 1, col_mode=res.col_mode,
                            overlap=res.overlap)
    want = {k: v * res.cycles for k, v in per.items()}
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    check(any(counts.values()), f"{label}: no kernel launched")
    check(reads == res.cycles == len(res.residuals),
          f"{label}: {reads} readbacks for {res.cycles} cycles")
    for k, v in counts.items():
        totals[k] += v
    print(f"multigrid {label}: {res.cycles} cycles, {res.work_units} work "
          f"units, launches {counts} ({per} a cycle), {secs:.4f} s")
    return out, res, counts, per, secs


def mg_row(label, res, counts, per, secs, **extra) -> dict:
    return {"path": label, "backend": res.backend, "cycles": res.cycles,
            "work_units": res.work_units, "converged": res.converged,
            "residuals": res.residuals, "levels": res.levels,
            "level_grids": res.level_grids, "level_shapes": res.level_shapes,
            "launches": counts, "launches_per_cycle": per, "seconds": secs,
            "measured_s_per_cycle": secs / max(1, res.cycles),
            "predicted_s_per_cycle": res.predicted_s_per_cycle, **extra}


def multigrid_phase(dev, tmp: Path, totals: dict, field,
                    jacobi_row: dict, keep: dict) -> list:
    """BASELINE config 5 with ``--solver multigrid``: the field of the
    Jacobi phase on the card, jacobi3, tol 1e-3, f32, the Jacobi phase's
    budget in fine-grid work units, with ``cuda`` at 1x1 (through
    ``JacobiSolver`` from the host, and resident) and at 2x2 (bitwise the
    1x1 field), ``cuda_rdma`` at 4x4 and the plain ``shifted`` run (the
    same residuals and the same field bit for bit); then
    ``run --converge 0.5 --solver multigrid`` through the CLI on the grey
    1920x2520 image with ``cuda`` and with ``cuda_rdma`` at 16x16 (coarse
    levels on sub-grids), against the CLI's ``shifted`` run.  The shifted
    field and residuals go into ``keep["mg_shifted"]`` (the field on the
    host) for phase 4j's plain reference."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import JacobiSolver
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.solvers import multigrid as mg
    from parallel_convolution_tpu_torch.utils import imageio

    rows = []
    card = card_line()
    jacobi3 = get_filter("jacobi3")
    H, W = CONVERGE_HW
    tol, budget = 1e-3, CONVERGE_MAX_ITERS
    field_bytes = field.numel() * field.element_size()

    def solve(grid_shape, backend):
        return lambda: mg.mg_converge(field, jacobi3, tol, budget,
                                      grid=make_grid(grid_shape, dev),
                                      backend=backend)

    def levels_of(grid_shape, shape=CONVERGE_HW):
        return mg.plan_levels(make_grid(grid_shape, dev), shape, 1)

    # (a) cuda at 1x1 through JacobiSolver, from a host array as a user
    # calls it, then resident: the input already on the card.
    host = field.cpu().numpy()
    solver = JacobiSolver("jacobi3", tol=tol, max_iters=budget,
                          backend="cuda", quantize=False, storage="f32",
                          solver="multigrid", device=dev)
    label = f"config 5 multigrid jacobi3 {H}x{W} f32 cuda 1x1"
    out_host, res_a, counts, per, first = mg_counted(
        label, lambda: (solver.solve(host)[0], solver.last_mg),
        levels_of((1, 1)), "cuda", totals)
    del host
    check(out_host.shape == (1, H, W) and bool(np.isfinite(out_host).all()),
          f"{label}: result not finite or of shape {out_host.shape}")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    (out_a, res), resident = host_seconds(solve((1, 1), "cuda"))
    peak = torch.cuda.max_memory_allocated(dev)
    stencil.reset_launch_counts()  # counted once, in the first run
    check(res.cycles == res_a.cycles and res.residuals == res_a.residuals,
          f"{label}: resident run {res.cycles} cycles, first {res_a.cycles}")
    check(torch.equal(out_a, torch.from_numpy(out_host).to(dev)),
          f"{label}: the resident field differs from JacobiSolver's")
    del out_host
    rows.append(mg_row(
        label, res_a, counts, per, first, seconds_first=first,
        seconds_resident=resident,
        measured_s_per_cycle=resident / res_a.cycles, max_units=budget,
        max_memory_allocated=peak, allocated_before=before,
        fields_at_peak=(peak - before) / field_bytes, card=card))

    # (b) cuda at 2x2: the 1x1 field, bit for bit.
    label = f"config 5 multigrid jacobi3 {H}x{W} f32 cuda 2x2"
    out_b, res_b, counts, per, secs = mg_counted(
        label, solve((2, 2), "cuda"), levels_of((2, 2)), "cuda", totals)
    check(res_b.cycles == res_a.cycles and torch.equal(out_b, out_a),
          f"{label}: differs from cuda 1x1 ({res_b.cycles} cycles, "
          f"{res_a.cycles})")
    del out_b
    rows.append(mg_row(label, res_b, counts, per, secs, bitwise_1x1=True,
                       card=card))

    # (c) the plain shifted run on the card: the reference.  jacobi3's
    # taps and the transfers' weights are dyadic, so every product is exact
    # and the kernels' FMA gives the plain bits: the fields and every
    # cycle's residual must be equal, not close.
    (out_d, res_d), shifted_s = host_seconds(solve((1, 1), "shifted"))
    stencil.reset_launch_counts()  # not main-path launches
    field_max = float(out_d.abs().max())
    err_a = float((out_a - out_d).abs_().max())
    print(f"config 5 multigrid: max |field| {field_max} after "
          f"{res_d.cycles} cycles; cuda max err vs shifted {err_a}")
    check(res_a.residuals == res_d.residuals and torch.equal(out_a, out_d),
          f"config 5 multigrid cuda: {res_a.cycles} cycles against "
          f"shifted's {res_d.cycles}, residuals {res_a.residuals} against "
          f"{res_d.residuals}, max err {err_a} (max |field| {field_max})")
    rows[0].update(max_abs_err_vs_shifted=err_a, bitwise_shifted=True,
                   max_abs_field=field_max)
    del out_a

    # (d) cuda_rdma at 4x4: K4 on the fine levels, K3 on the small blocks.
    g = MG_RDMA_GRID
    label = f"config 5 multigrid jacobi3 {H}x{W} f32 cuda_rdma {g[0]}x{g[1]}"
    out_c, res_c, counts, per, secs = mg_counted(
        label, solve(g, "cuda_rdma"), levels_of(g), "cuda_rdma", totals)
    err_c = float((out_c - out_d).abs_().max())
    print(f"{label}: max err vs shifted {err_c}")
    check(res_c.residuals == res_d.residuals and torch.equal(out_c, out_d),
          f"{label}: {res_c.cycles} cycles against shifted's "
          f"{res_d.cycles}, residuals {res_c.residuals} against "
          f"{res_d.residuals}, max err {err_c} (max |field| {field_max})")
    keep["mg_shifted"] = (out_d.cpu(), res_d.residuals)
    del out_c, out_d
    rows.append(mg_row(label, res_c, counts, per, secs,
                       max_abs_err_vs_shifted=err_c, bitwise_shifted=True,
                       max_abs_field=field_max, card=card))
    rows.append(mg_row(f"config 5 multigrid jacobi3 {H}x{W} f32 shifted 1x1",
                       res_d, {}, {}, shifted_s, card=card))
    torch.cuda.empty_cache()
    print("config 5 work units to tol 1e-3 (cap "
          f"{budget}): " + json.dumps({
              "jacobi": {"work_units": jacobi_row["iters"],
                         "converged": jacobi_row["converged"],
                         "final_diff": jacobi_row["final_diff"]},
              "multigrid": {"work_units": res_a.work_units,
                            "converged": res_a.converged,
                            "final_residual": res_a.residual,
                            "cycles": res_a.cycles},
              "jacobi_over_multigrid_at_least": (
                  jacobi_row["iters"] / res_a.work_units
                  if res_a.converged else None)}))

    # (e) run --converge 0.5 --solver multigrid through the CLI on BASELINE
    # config 1's grey image.
    rows_, cols_ = RGB_HW
    img = imageio.generate_test_image(rows_, cols_, "grey", seed=2)
    src = tmp / "mg.raw"
    imageio.write_raw(src, img)

    def cli(extra, dst):
        argv = ["run", str(src), str(rows_), str(cols_),
                str(CONVERGE_CLI_MAX), "grey", "-o", str(dst), "--converge",
                "0.5", "--solver", "multigrid"] + extra
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        check(rc == 0, f"cli {extra}: exited {rc}")
        line = buf.getvalue().strip().splitlines()[-1]
        return line, int(line.split()[2])

    ref_dst = tmp / "mg.shifted.raw"
    ref_line, ref_cycles = cli(["--backend", "shifted"], ref_dst)
    stencil.reset_launch_counts()  # not main-path launches
    ref = imageio.read_raw(ref_dst, rows_, cols_, "grey")
    grid16 = f"{GREY_GRID[0]}x{GREY_GRID[1]}"
    for backend, extra, shape in (
            ("cuda", ["--backend", "cuda"], (1, 1)),
            ("cuda_rdma", ["--backend", "cuda_rdma", "--mesh", grid16],
             GREY_GRID)):
        dst = tmp / f"mg.{backend}.raw"
        label = (f"cli run --converge 0.5 --solver multigrid grey "
                 f"{rows_}x{cols_} blur3 {' '.join(extra)}")
        levels = mg.plan_levels(make_grid(shape, dev), RGB_HW, 1)
        per = mg.cycle_launches(levels, backend, 1)
        stencil.reset_launch_counts()
        (line, cycles), secs = host_seconds(lambda: cli(extra, dst))
        counts = stencil.launch_counts()
        want = {k: v * cycles for k, v in per.items()}
        check(counts == want and any(counts.values()),
              f"{label}: launches {counts}, expected {want}")
        for k, v in counts.items():
            totals[k] += v
        out = imageio.read_raw(dst, rows_, cols_, "grey")
        delta = np.abs(out.astype(int) - ref.astype(int))
        # blur3's taps are dyadic too: the bytes of the shifted run.
        check(line.split("->")[0] == ref_line.split("->")[0]
              and np.array_equal(out, ref),
              f"{label}: said {line!r}, shifted {ref_line!r}, max byte "
              f"delta {int(delta.max())}")
        stencil.reset_launch_counts()
        _, warm = host_seconds(lambda: cli(extra, dst))
        stencil.reset_launch_counts()  # counted once, in the first run
        print(f"multigrid {label}: {line}")
        rows.append({"path": label, "said": line, "cycles": cycles,
                     "launches": counts, "launches_per_cycle": per,
                     "level_grids": [f"{lv.grid.rows}x{lv.grid.cols}"
                                     for lv in levels],
                     "bytes_differing_from_shifted": int((delta > 0).sum()),
                     "seconds_first": secs, "seconds_warm": warm,
                     "card": card})
    return rows


# ---------------------------------------------------------------------------
# Phase 4j: multigrid, volumes, checkpoints and a grid over two processes
# on slots (ROADMAP item 10c); config 4 on 16 slots runs in phase 4c
# ---------------------------------------------------------------------------


def reckon_mg_slots_peak(field_bytes: int, backend: str) -> int:
    """The peak device bytes reckoned for config 5's V-cycle on a grid of
    slots: the caller's field and the fine state, then a fine sweep's
    working set (the per-block exchange's padded copy or, for
    ``cuda_rdma``, the level's two run buffers; the stencil's output; the
    damped update and its temporary; the readout's f32 difference), and
    the coarse levels' errors and residuals (a third of a field)."""
    working = 4 if backend == "cuda" else 5
    return int(field_bytes * (2 + working + 1 / 3))


def ckpt_slots_argv(src: Path, dst: Path, ck: Path, mesh_spec: str,
                    device: str) -> list:
    return ckpt_argv(src, dst, ck, mesh_spec) + ["--device", device,
                                                 "--col-mode", "strided"]


def slots_rest_phase(dev, tmp: Path, here: Path, refs: dict, totals: dict,
                     field, volume_sha: str, mg_shifted,
                     engine_imgs, cli_converge) -> dict:
    """Phase 4j: (a) BASELINE config 5 under the V-cycle (32768² jacobi3,
    tol 1e-3, 100 work units) on 2x2 slots with ``cuda`` (K1 per slot) and
    ``cuda_rdma`` (K3 / K4 per slot), each bit-equal to the one-card 2x2
    run of its backend (its field kept on the host, the card's copy freed
    before the slot run) and both to phase 4d's plain ``shifted`` field
    and residuals (``mg_shifted``), the same cycles, work units and level
    grids, the peak reckoned and measured; (b) fd25 at 512³ x 40 sweeps fuse 4
    through ``run --rank 3 --device <4 slots>``, the bytes of phase 4g's
    1x1 run; (c) checkpoints on config 3's image at 4x4 slots: a child
    dies in the second snapshot, the run resumes on 16 slots, and a
    second torn run reshards onto 2x2 slots and a third onto one device,
    each byte-equal to ``shifted``; (d) two spawned processes sharing the
    card, 2 slots each of a 2x2 grid over gloo, running the JAX package's
    two-process job (``utils/multihost_job.py``) at config 2's size with
    ``cuda`` f32 fuse 1 and ``cuda_sep`` bf16 fuse 32 (the second in (e)'s
    spawn), byte-equal to the same job in one process and both to the
    plain ``shifted`` config 2 output of the main paths
    (``refs["rgb_ref"]``), the f32 resume bit-identical, the broadcast
    agreed; (e) ``cuda_rdma``, ``auto``, ``fallback``, the engine,
    multigrid and volumes on grids over two ranks sharing the card
    (:func:`processes_leg`, item 10d-i), and (f) ``cuda_rdma`` with the
    ranks on two reported hosts (item 10d-ii-a) in the same spawn; (g)
    one card a process over NCCL (item 10d-ii-b, :func:`cards_phase`),
    which with one card prints that it needs two.  Every run counted into
    the kernels line (the ranks' launches as they report them)."""
    import numpy as np
    import torch

    card = card_line()
    out = {"card": card,
           "multigrid": multigrid_slots_leg(dev, totals, field, mg_shifted,
                                            card)}
    # Config 5's field for (e)'s ranks, off the card before they start.
    work = here / "build" / "chip_smoke_processes"
    work.mkdir(parents=True, exist_ok=True)
    field_path = work / "config5.npy"
    np.save(field_path, field.cpu().numpy())
    del field
    torch.cuda.empty_cache()
    out["volume"] = volume_slots_leg(dev, here, volume_sha, card)
    out["checkpoint"] = checkpoint_slots_leg(tmp, here, refs, totals)
    out["two_processes"] = two_process_leg(tmp, totals, refs, card)
    cross = processes_leg(
        dev, tmp, work, refs, totals, card, field_path, mg_shifted,
        out["multigrid"], {"sha": volume_sha,
                           "seconds": out["volume"]["seconds"]}, engine_imgs,
        cli_converge)
    out["processes"], out["processes_timed"] = cross["rows"], cross["timed"]
    out["two_processes"].append(cross["job"])
    try:
        cards = cards_phase(dev, tmp, here, work, refs, totals, field_path,
                            mg_shifted, out["multigrid"], cli_converge,
                            cross["rows"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["cards"], out["cards_timed"] = cards.pop("rows"), cards.pop("timed")
    out["cards_phase"] = cards
    return out


def multigrid_slots_leg(dev, totals: dict, field, mg_shifted,
                        card: str) -> list:
    """Phase 4j (a): config 5's V-cycle on 2x2 slots, ``cuda`` and
    ``cuda_rdma``, each against the one-card 2x2 run of its backend and
    both against the plain ``shifted`` field and residuals of phase 4d
    (``mg_shifted``: the field on the host).  jacobi3's taps and the
    transfers' weights are dyadic, so the fields are equal, not close."""
    import torch

    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.solvers import multigrid as mg

    rows = []
    slots4 = [dev] * 4
    jacobi3 = get_filter("jacobi3")
    H, W = CONVERGE_HW
    field_bytes = field.numel() * field.element_size()
    band = 2048
    shifted, shifted_residuals = mg_shifted
    for backend in ("cuda", "cuda_rdma"):
        one = mesh.make_grid((2, 2), dev)
        slots = mesh.make_grid((2, 2), devices=slots4)
        solve = (lambda g: lambda: mg.mg_converge(
            field, jacobi3, 1e-3, CONVERGE_MAX_ITERS, grid=g,
            backend=backend))
        (ref, rres), one_s = host_seconds(solve(one))
        _, one_resident = host_seconds(solve(one))
        stencil.reset_launch_counts()  # the reference is not this path
        ref_host = ref.cpu()
        del ref
        torch.cuda.empty_cache()
        label = (f"4j config 5 multigrid jacobi3 {H}x{W} f32 {backend} "
                 "2x2 slots")
        reckoned = reckon_mg_slots_peak(field_bytes, backend)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        levels = mg.plan_levels(slots, CONVERGE_HW, 1)
        out, res, counts, per, first = mg_counted(
            label, solve(slots), levels, backend, totals)
        peak = torch.cuda.max_memory_allocated(dev) - base
        check(res.cycles == rres.cycles and res.work_units == rres.work_units
              and res.level_grids == rres.level_grids
              and res.residuals == rres.residuals,
              f"{label}: {res.cycles} cycles / {res.work_units} units / "
              f"{res.level_grids} against the one-card {rres.cycles} / "
              f"{rres.work_units} / {rres.level_grids}")
        same = plain = True
        for a in range(0, H, band):
            got = out[:, a:a + band].cpu()
            same = same and torch.equal(got, ref_host[:, a:a + band])
            plain = plain and torch.equal(got, shifted[:, a:a + band])
        check(same, f"{label}: differs from the one-card 2x2 field")
        check(plain and rres.residuals == shifted_residuals,
              f"{label}: differs from the plain shifted field (residuals "
              f"{rres.residuals} against {shifted_residuals})")
        check(all(lv.grid.slots == slots.slots[:lv.grid.rows * lv.grid.cols]
                  for lv in levels), f"{label}: a level off the first slots")
        del out, ref_host
        stencil.reset_launch_counts()
        _, resident = host_seconds(solve(slots))
        stencil.reset_launch_counts()  # counted once, in the first run
        torch.cuda.empty_cache()
        row = mg_row(label, res, counts, per, first, seconds_first=first,
                     seconds_resident=resident, one_card_first=one_s,
                     one_card_resident=one_resident, col_mode=res.col_mode,
                     reckoned_peak_bytes=reckoned, peak_bytes=peak,
                     fields_at_peak=peak / field_bytes,
                     bitwise_one_card=True, bitwise_shifted=True, card=card)
        rows.append(row)
        print(f"4j {label}: first {first:.4f} s, resident {resident:.4f} s "
              f"(one card: {one_s:.4f} / {one_resident:.4f} s); peak "
              f"{peak / 1e9:.2f} GB, reckoned {reckoned / 1e9:.2f} GB")
    return rows


def volume_slots_leg(dev, here: Path, volume_sha: str, card: str) -> dict:
    """Phase 4j (b): fd25 at 512^3 through ``run --rank 3`` on 2x2 slots,
    the bytes of phase 4g's 1x1 run (``volume_sha``)."""
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main

    slots4 = [dev] * 4
    n = VOLUME_N
    work = here / "build" / "chip_smoke_volume"
    work.mkdir(parents=True, exist_ok=True)
    try:
        src, dst = work / "fd25.raw", work / "fd25.slots.raw"
        volume_state("fd25", (n, n, n), 31).tofile(src)
        argv = ["run", str(src), str(n), str(n), str(VOLUME_FD25_SWEEPS),
                "grey", "-o", str(dst), "--rank", "3", "--depth", str(n),
                "--filter", "fd25", "--fuse", "4", "--mesh", "2x2",
                "--device", ",".join(str(d) for d in slots4)]
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        rc, secs = host_seconds(lambda: cli_main(argv))
        check(rc == 0, f"4j run --rank 3 fd25 on slots: exit {rc}")
        digest = hashlib.sha256(dst.read_bytes()).hexdigest()
        check(digest == volume_sha, "4j run --rank 3 fd25 on 2x2 slots: "
              "the bytes differ from phase 4g's 1x1 run")
        return {"path": f"fd25 {n}^3 x {VOLUME_FD25_SWEEPS} fuse 4, run "
                "--rank 3, 2x2 slots", "seconds": secs, "bitwise_1x1": True,
                "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
                "card": card}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def checkpoint_slots_leg(tmp: Path, here: Path, refs: dict,
                         totals: dict) -> dict:
    """Phase 4j (c): config 3's image with ``--checkpoint`` at 4x4 slots,
    torn in its second snapshot by one child process, its directory copied
    once a target and resumed on 16 slots, on 2x2 slots and on one device,
    each byte-equal to ``shifted``."""
    import warnings

    import numpy as np

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.utils import imageio

    src = tmp / "edge5.raw"  # written by main_paths
    want = refs["grey_refs"]["edge5"]
    slots16 = ",".join(["cuda:0"] * 16)
    bh = BIG_HW[0]
    rest = ITERS - CKPT_EVERY

    def resumed(label, argv, expect):
        def run():
            rc = cli_main(argv)
            check(rc == 0, f"{label}: the CLI exited {rc}")

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, counts, secs = drive(label, run, expect, bh * BIG_HW[1])
        for k, v in counts.items():
            totals[k] += v
        check(np.array_equal(imageio.read_raw(argv[7], *BIG_HW, "grey"),
                             want), f"{label}: differs from shifted")
        return {"launches": counts, "seconds": secs,
                "warnings": [str(w.message) for w in caught
                             if "resharding" in str(w.message)]}

    # One kill: each resume reads a copy of its torn directory (a kill a
    # target took 11.4 s each on an H100 80GB HBM3 host).
    dead = tmp / "ck4j_dead"
    killed = killed_run(ckpt_slots_argv(src, tmp / "ck_dead.raw", dead,
                                        "4x4", slots16), here)
    latest = (dead / "LATEST").read_text()
    check(latest == f"it_{CKPT_EVERY:08d}",
          f"4j checkpoint: LATEST is {latest} after the kill")
    ckpt = {}
    for key, mesh_spec, device, expect in (
            ("resume on 4x4 slots", "4x4", slots16,
             {"rdma_tiled_slot": rest * 16}),
            ("reshard onto 2x2 slots", "2x2", ",".join(["cuda:0"] * 4),
             {"rdma_tiled_slot": rest * 4}),
            ("reshard onto one device", "1x1", "cuda:0",
             {"rdma_tiled": rest})):
        ck = tmp / f"ck4j_{mesh_spec}"
        shutil.copytree(dead, ck)
        row = resumed(f"4j checkpoint {key} from {CKPT_EVERY}",
                      ckpt_slots_argv(src, tmp / "ck4j.raw", ck, mesh_spec,
                                      device), expect)
        check(mesh_spec == "4x4" or any(
            "from grid 4x4 onto " + mesh_spec in m for m in row["warnings"]),
            f"4j checkpoint {key}: no reshard warning")
        ckpt[key] = row
        shutil.rmtree(ck, ignore_errors=True)
    ckpt["killed"] = killed
    shutil.rmtree(dead, ignore_errors=True)
    return ckpt


def job_kw(backend: str, storage: str, fuse: int) -> dict:
    """The two-process job's arguments at config 2's size (phase 4j (d))."""
    rows_, cols_ = RGB_HW
    return dict(device="cuda", shape=(2, 2), rows=rows_, cols=cols_,
                mode="rgb", iters=ITERS, every=ITERS // 2, filt="blur3",
                backend=backend, storage=storage, fuse=fuse, seed=1)


def job_one_process(tmp: Path, kw: dict) -> dict:
    """The two-process job's run in this process (the reference of its
    ranks' run): its row, seconds, launches and work directories."""
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.utils import multihost_job

    label = (f"4j two processes config 2 {kw['backend']} {kw['storage']} "
             f"fuse {kw['fuse']}")
    w1, w2 = tmp / f"job1_{kw['backend']}", tmp / f"job2_{kw['backend']}"
    stencil.reset_launch_counts()
    one, one_s = host_seconds(lambda: multihost_job.job(
        None, 1, None, w1, slots=["cuda:0"] * 4, **kw))
    counts = stencil.launch_counts()  # the resident run's too
    check(one["slots"] == "cuda:0,cuda:0,cuda:0,cuda:0"
          and not one["owners"], f"{label}: the one-process grid is "
          f"{one['slots']} owned by {one['owners']}")
    stencil.reset_launch_counts()
    return {"label": label, "row": one, "seconds": one_s, "counts": counts,
            "w1": w1, "w2": w2, "storage": kw["storage"]}


def job_checks(one: dict, two: list, two_s: float, refs: dict,
               totals: dict, card: str) -> dict:
    """The ranks' rows of the two-process job (``two``) against its run in
    one process (:func:`job_one_process`) and the plain ``shifted``
    output; both runs' launches go into ``totals``.  Returns the row."""
    import numpy as np

    from parallel_convolution_tpu_torch.utils import imageio

    label, w1, w2 = one["label"], one["w1"], one["w2"]
    ref = one["row"]
    rows_, cols_ = RGB_HW
    sent = {k: two[0]["launches"][k] + two[1]["launches"][k]
            for k in one["counts"]}
    check(sent == ref["launches"] and any(sent.values()),
          f"{label}: the ranks launched {sent}, one process "
          f"{ref['launches']}")
    for k, v in sent.items():
        totals[k] += v + ref["launches"][k]
    check((w1 / "out.raw").read_bytes() == (w2 / "out.raw").read_bytes(),
          f"{label}: the two-process output differs from the one-process "
          "one")
    check(np.array_equal(imageio.read_raw(w1 / "in.raw", rows_, cols_,
                                          "rgb"), refs["rgb"]),
          f"{label}: the job's input is not config 2's image")
    check(np.array_equal(imageio.read_raw(w2 / "out.raw", rows_, cols_,
                                          "rgb"), refs["rgb_ref"]),
          f"{label}: differs from the plain shifted output")
    check(all(r["broadcast"] == 7.0 for r in two)
          and [r["owners"] for r in two] == [[0, 0, 1, 1]] * 2,
          f"{label}: broadcast / owners {two}")
    if one["storage"] != "bf16":  # a snapshot holds f32 or u8
        check(ref["resume_bitexact"] is True
              and all(r["resume_bitexact"] is True for r in two),
              f"{label}: the resume is not bit-identical")
    row = {"path": label, "launches_two": sent,
           "first_s_two": max(r["first_s"] for r in two),
           "resident_s_two": max(r["resident_s"] for r in two),
           "spawn_to_end_s": two_s, "first_s_one": ref["first_s"],
           "resident_s_one": ref["resident_s"],
           "one_process_s": one["seconds"], "bitwise_one_process": True,
           "bitwise_shifted": True,
           "resume_bitexact": two[0]["resume_bitexact"], "card": card}
    print(f"{label}: two processes first {row['first_s_two']:.4f} s, "
          f"resident {row['resident_s_two']:.4f} s; one process "
          f"{ref['first_s']:.4f} / {ref['resident_s']:.4f} s")
    shutil.rmtree(w1, ignore_errors=True)
    shutil.rmtree(w2, ignore_errors=True)
    return row


def two_process_leg(tmp: Path, totals: dict, refs: dict,
                    card: str) -> list:
    """Phase 4j (d): the two-process job on the card (2 ranks, 2 slots of
    ``cuda:0`` each, gloo) against the same job in this process, at
    config 2's size, ``cuda`` f32 fuse 1 in a spawn of its own (its
    ``cuda_sep`` bf16 fuse 32 run rides phase 4j (e)'s spawn); both
    outputs against the plain ``shifted`` run of the main paths on the
    same image (``refs``: seed 1, blur3 x ITERS).  The kernels are built
    (``main``) before any rank starts."""
    from parallel_convolution_tpu_torch.utils import multihost_job

    print("4j two processes: two CUDA contexts time-slice one card, so "
          "their seconds measure the cost of the path, not scaling")
    kw = job_kw("cuda", "f32", 1)
    one = job_one_process(tmp, kw)
    with first_card_only():
        two, two_s = host_seconds(lambda: multihost_job.spawn(
            2, one["w2"], timeout=400, group="gloo", **kw))
    return [job_checks(one, two, two_s, refs, totals, card)]


@contextlib.contextmanager
def first_card_only():
    """Processes started inside see only the first card
    (``CUDA_VISIBLE_DEVICES``), so that ranks meant to share one card do
    on a machine with several."""
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (old or "0").split(",")[0].strip()
    try:
        yield
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old


def _sha(data) -> str:
    """SHA-256 of an array's or tensor's bytes (on the host)."""
    import numpy as np
    import torch

    if torch.is_tensor(data):
        data = data.detach().cpu().contiguous().numpy()
    return hashlib.sha256(np.ascontiguousarray(data).tobytes()).hexdigest()


def rank_legs(rank: int, port: int, spec: dict) -> dict:
    """Phase 4j (e), one rank's share: every leg on grids over the two
    ranks (2 slots of ``cuda:0`` each at 2x2, 8 at 4x4), each between two
    barriers, its seconds, its launches (``stencil.launch_counts``) and its
    output's SHA-256 in the row."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch import tuning
    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import rdma, stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh, multihost, step
    from parallel_convolution_tpu_torch.serving.engine import WarmEngine
    from parallel_convolution_tpu_torch.solvers import multigrid as mg
    from parallel_convolution_tpu_torch.utils import imageio, multihost_job

    # Two ranks sharing the card mean gloo: NCCL refuses that.
    multihost.initialize(f"localhost:{port}", num_processes=2,
                         process_id=rank, backend="gloo")
    dev = torch.device("cuda", 0)
    row = {"rank": rank}

    def leg(name, fn):
        multihost.barrier(name)
        torch.cuda.synchronize(dev)
        stencil.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn() or {}
        torch.cuda.synchronize(dev)
        multihost.barrier(name)
        row[name] = dict(res, seconds=time.perf_counter() - t0,
                         launches=stencil.launch_counts())

    # Phase 4j (d)'s cuda_sep bf16 fuse 32 job (K2 per block, depth-32
    # rims between the ranks, the sharded load and save), in this group.
    leg("job", lambda: {"row": multihost_job.job(
        rank, 2, None, spec["job"]["work"], **spec["job"]["kw"])})
    grid = mesh.make_grid((2, 2), devices="all")
    rgb = imageio.read_raw(spec["rgb"], *RGB_HW, "rgb")
    blur3 = get_filter("blur3")
    kw = dict(backend="cuda_rdma", storage="bf16", fuse=32)
    for cm in ("strided", "packed"):
        model = ConvolutionModel("blur3", grid=grid, col_mode=cm, **kw)
        for name in (f"config 2 {cm}", f"config 2 {cm} resident"):
            leg(name, lambda: {"sha256": _sha(model.run_image(rgb, ITERS)),
                               "col_mode": model.effective_col_mode})
    # The skew check: rank 1's host sleeps 50 ms before each of its first
    # four chunks (all of this run's), so rank 0's launches are enqueued
    # ahead and wait on rank 1's counters.
    real, calls = rdma._slots_step, [0]

    def late(*a, **k):
        calls[0] += 1
        if rank == 1 and calls[0] <= 4:
            time.sleep(0.05)
        return real(*a, **k)

    rdma._slots_step = late
    model = ConvolutionModel("blur3", grid=grid, col_mode="packed", **kw)
    leg("skew", lambda: {"sha256": _sha(model.run_image(rgb, ITERS)),
                         "late_chunks": min(calls[0], 4) if rank else 0})
    rdma._slots_step = real
    planar = imageio.interleaved_to_planar(rgb).astype(np.float32)

    def auto():
        out = step.sharded_iterate(planar, blur3, ITERS, grid=grid,
                                   backend="auto", storage="bf16")
        res = tuning.last_resolution()
        return {"sha256": _sha(imageio.planar_to_interleaved(
                    out.cpu().numpy().astype(np.uint8))),
                "resolution": [res.backend, res.fuse,
                               list(res.tile) if res.tile else None,
                               res.overlap, res.col_mode, res.source]}

    leg("auto", auto)

    def fallback():
        model = ConvolutionModel("blur3", grid=grid, fallback=True, **kw)
        return {"sha256": _sha(model.run_image(rgb, ITERS)),
                "rung": model.effective_backend}

    leg("fallback", fallback)
    imgs = [imageio.read_raw(p, *RGB_HW, "rgb") for p in spec["engine"]]
    eng = WarmEngine(grid, fallback=False)
    key = eng.key_for((3, *RGB_HW), filter_name="blur3", iters=ITERS, **kw)
    leg("engine warm", lambda: {"effective": eng.entry(key).effective_backend})

    def batch():
        out, info = eng.run_batch(key, np.stack([
            imageio.interleaved_to_planar(im).astype(np.float32)
            for im in imgs]))
        return {"sha256": [_sha(imageio.planar_to_interleaved(
                    np.clip(np.rint(o), 0, 255).astype(np.uint8)))
                           for o in out],
                "device_s": info["phases"]["device"]}

    leg("engine", batch)
    leg("engine resident", batch)
    del eng
    n = str(BIG_HW[0])
    leg("config 3", lambda: {"rc": cli_main([
        "run", spec["edge5"], n, n, str(ITERS), "grey", "-o",
        spec["edge5_out"], "--filter", "edge5", "--backend", "cuda_rdma",
        "--mesh", "4x4", "--device", "all", "--storage", "bf16", "--fuse",
        "32", "--col-mode", "packed"])})
    field = np.load(spec["field"])

    def multigrid():
        out, res = mg.mg_converge(field, get_filter("jacobi3"), 1e-3,
                                  CONVERGE_MAX_ITERS, grid=grid,
                                  backend="cuda_rdma")
        return {"cycles": res.cycles, "work_units": res.work_units,
                "level_grids": res.level_grids, "residuals": res.residuals,
                "col_mode": res.col_mode,
                "sha256": _sha(out) if rank == 0 else None}

    leg("multigrid", multigrid)
    del field
    torch.cuda.empty_cache()
    v = str(VOLUME_N)
    if rank == 0:
        volume_state("fd25", (VOLUME_N,) * 3, 31).tofile(spec["volume"])
    leg("fd25", lambda: {"rc": cli_main([
        "run", spec["volume"], v, v, str(VOLUME_FD25_SWEEPS), "grey", "-o",
        spec["volume_out"], "--rank", "3", "--depth", v, "--filter", "fd25",
        "--fuse", "4", "--mesh", "2x2", "--device", "all"])})
    # The per-slot kernels over the two ranks, timed (not main-path
    # launches): config 2's K4 and the 16x16 split's K3.
    grey = imageio.generate_test_image(*RGB_HW, "grey", seed=2)

    def kernels():
        return {"config 2": cross_slot_times(dev, rgb, "bf16", (2, 2), 32,
                                             blur3),
                "grey 16x16": cross_slot_times(dev, grey, "u8", GREY_GRID, 8,
                                               blur3)}

    row["kernels"] = kernels()
    # Phase 4j (f), item 10d-ii-a: each rank reports a host of its own (as
    # two hosts' ranks do), so it reads the other's slots from mirrors
    # that gloo fills once a chunk; the package has no switch for it.
    real_host = multihost.hostname
    multihost.hostname = lambda: f"host{rank}"
    try:
        far_legs(spec, leg, grid, rgb, row)
        row["far_kernels"] = kernels()
    finally:
        multihost.hostname = real_host
    multihost.barrier("done")
    return row


def far_legs(spec: dict, leg, grid, rgb, row: dict) -> None:
    """Phase 4j (f), one rank's share, the ranks on two reported hosts:
    config 2 ``cuda_rdma`` bf16 fuse 32 on 2x2 strided and packed (first
    and resident) and overlapped (strided), config 1's image on the
    256-rank split (u8 fuse 8, K3), config 3 through ``run --device all
    --mesh 4x4``, and ``run --converge 0.5 --check-every 10`` on config
    1's image (``cuda_rdma`` u8 fuse 8, 2x2); each leg's row carries its
    far exchange's rounds and their split (``rdma._FarExchange``)."""
    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio

    made = []
    real_init = rdma._FarExchange.__init__

    def init(ex, *a, **k):
        real_init(ex, *a, **k)
        made.append(ex)

    def far_leg(name, fn):
        del made[:]
        leg(name, fn)
        row[name]["exchange"] = [t for ex in made for t in ex.split()]
        row[name]["rounds"] = sum(ex.rounds for ex in made)

    rdma._FarExchange.__init__ = init
    try:
        kw = dict(backend="cuda_rdma", storage="bf16", fuse=32)
        for cm in ("strided", "packed"):
            model = ConvolutionModel("blur3", grid=grid, col_mode=cm, **kw)
            for name in (f"far config 2 {cm}", f"far config 2 {cm} resident"):
                far_leg(name, lambda: {
                    "sha256": _sha(model.run_image(rgb, ITERS)),
                    "col_mode": model.effective_col_mode})
        model = ConvolutionModel("blur3", grid=grid, col_mode="strided",
                                 overlap=True, **kw)
        far_leg("far config 2 overlap", lambda: {
            "sha256": _sha(model.run_image(rgb, ITERS)),
            "overlap": model.effective_overlap})
        # The 256-rank split (K3 per slot, 128 slots a rank).
        split = ConvolutionModel(
            "blur3", grid=mesh.make_grid(GREY_GRID, devices="all"),
            backend="cuda_rdma", storage="u8", fuse=8)
        grey = imageio.generate_test_image(*RGB_HW, "grey", seed=2)
        far_leg("far grey 16x16", lambda: {
            "sha256": _sha(split.run_image(grey, ITERS))})
        n = str(BIG_HW[0])
        far_leg("far config 3", lambda: {"rc": cli_main([
            "run", spec["edge5"], n, n, str(ITERS), "grey", "-o",
            spec["edge5_far_out"], "--filter", "edge5", "--backend",
            "cuda_rdma", "--mesh", "4x4", "--device", "all", "--storage",
            "bf16", "--fuse", "32", "--col-mode", "packed"])})

        def converge():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main([
                    "run", spec["converge"], str(RGB_HW[0]), str(RGB_HW[1]),
                    str(CONVERGE_CLI_MAX), "grey", "-o",
                    spec["converge_out"], "--converge", "0.5",
                    "--check-every", "10", "--backend", "cuda_rdma",
                    "--mesh", "2x2", "--device", "all", "--storage", "u8",
                    "--fuse", "8"])
            return {"rc": rc, "said": buf.getvalue().strip().splitlines()[-1]}

        far_leg("far converge", converge)
    finally:
        rdma._FarExchange.__init__ = real_init


def cross_slot_times(dev, img, storage: str, shape, T: int, filt) -> dict:
    """One rank's share of a per-slot kernel on a grid over two ranks
    (phase 4j (e)): the first level group of a ``T``-level chunk as
    ``rdma._slots_step`` plans it, launched for this rank's slots between
    a fork and a join with the barrier's waits (events for a neighbour in
    this process, the step counters for one in the other), timed by CUDA
    events on the current stream; the same step with no launch (the
    barrier's own cost a chunk); one slot's launch alone, queued ahead;
    and the packs of every local slot the same way, and one alone.  The
    launches' outputs are held against the plain version of the whole
    grid (``first_group_plain``), the staging each pack wrote against
    ``rdma_pack_plain``'s."""
    import torch

    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.ops import rdma, stencil
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio

    planar = imageio.interleaved_to_planar(img)
    valid = planar.shape[1:]
    grid = mesh.make_grid(shape, devices="all")
    blocks = convert.blocks_from_numpy(planar, grid, storage)
    C, h, w = mesh.first_block(blocks).shape
    r = filt.radius
    plan = rdma.rdma_plan(r, T, (h, w), None, stencil._smem_limit(dev))
    levels = plan.groups[0]
    ext = r * (T - levels)
    tiled = plan.kernel == "tiled"
    launch = rdma.rdma_tiled_slot if tiled else rdma.rdma_block_slot
    mid = stencil.group_dtype(True, mesh.first_block(blocks).dtype)
    kw = dict(ext=ext, **(dict(tile=plan.tile) if tiled else {}))
    out = {"kernel": "rdma_tiled_slot" if tiled else "rdma_block_slot",
           "levels": levels, "ext": ext, "block": [C, h, w]}
    one = convert.blocks_from_numpy(planar, mesh.make_grid(
        shape, devices=[dev] * (shape[0] * shape[1])), storage)
    for cm in ("strided", "packed"):
        run = rdma.slot_carry(blocks, grid, "zero", r * T, cm).run
        outs = {s: torch.empty((C, h + 2 * ext, w + 2 * ext), dtype=mid,
                               device=dev) for s in run.local}

        # Between hosts (4j (f)) each step carries the far exchange's
        # round; no far neighbour is a column one here (the ranks split
        # the rows), so no staging round.
        check(run.far is None or not run.far.stages,
              f"{cm} at {shape}: a far column neighbour")

        def step(per_slot):
            def once():
                run.fork()
                k = run.step + 1
                if run.far is not None:
                    run.far.send(0, r * T, run.packed)
                    run.far.receive(0, r * T, run.packed)
                for s in run.local:
                    for n in run.neighbours[s]:
                        run.after(s, n, run.step)
                for s in run.local:
                    per_slot(s)
                for s in run.local:
                    run.launched[s].record(run.streams[s])
                    run.mark(s, k)
                run.step = k
                run.join()
            return once

        reps = 10 if T * r * r > 8 else 20
        s0 = run.local[0]
        if cm == "packed":
            pack = step(lambda s: rdma.rdma_pack(run, 0, s, r * T))
            pack()
            slabs = [rdma.staged_slabs(run, s, r * T) for s in run.local]
            wants = rdma.rdma_pack_plain(one, shape, "zero", r * T)
            check(all(torch.equal(a, wants[s])
                      for a, s in zip(slabs, run.local)),
                  f"rdma_pack over two ranks at {shape}: the staging "
                  "differs from its plain version")
            out["pack_max_abs_err"] = max(
                max_abs_err(a, wants[s]) for a, s in zip(slabs, run.local))
            del slabs, wants
            out["pack_ms"] = cuda_ms(pack, reps=reps)
            with torch.cuda.stream(run.streams[s0]):
                out["pack_alone_ms"] = cuda_ms(lambda: rdma.rdma_pack(
                    run, 0, s0, r * T), reps=reps, queue_ahead=True)
            out["packed_ms"] = cuda_ms(step(lambda s: launch(
                run, 0, s, outs[s], filt, levels, valid, **kw)), reps=reps)
        else:
            out["ms"] = cuda_ms(step(lambda s: launch(
                run, 0, s, outs[s], filt, levels, valid, **kw)), reps=reps)
            out["barrier_ms"] = cuda_ms(step(lambda s: None), reps=reps)
            with torch.cuda.stream(run.streams[s0]):
                out["alone_ms"] = cuda_ms(lambda: launch(
                    run, 0, s0, outs[s0], filt, levels, valid, **kw),
                    reps=reps, queue_ahead=True)
        want = first_group_plain(one, filt, shape, T, levels, valid, mid)
        got = torch.stack([outs[s] for s in run.local])
        ok, err = agree(got, want[run.local], filt, levels, True)
        check(ok, f"{out['kernel']} over two ranks {cm} at {shape}: err "
                  f"{err}")
        out[f"max_abs_err_{cm}"] = err
        if run.far is not None:
            out[f"exchange_{cm}"] = exchange_summary(run.far.split())
        rdma.close_carry(rdma.SlotCarry(run, run.bufs[0]))
        del outs, got, want
    out["local_slots"] = len(run.local)
    return out


def exchange_summary(rounds: list) -> dict:
    """The far exchange's timed rounds (``rdma._FarExchange.split``, the
    last 256 of a run) as their count and each part's median
    milliseconds: the copy out (the slowest slot's, CUDA events), the
    host's wait for it, the swap (gloo's on the host, or NCCL's on the
    card by CUDA events and the host's seconds enqueueing it), the copy
    in (CUDA events), and the bytes a round sends."""
    import statistics

    if not rounds:
        return {"timed": 0}
    keys = [k for k in ("out_ms", "wait_ms", "gloo_ms", "nccl_ms",
                        "swap_host_ms", "in_ms") if k in rounds[0]]
    return dict({f"{k}_median": statistics.median(t[k] for t in rounds)
                 for k in keys},
                timed=len(rounds), bytes_out=rounds[0]["bytes_out"])


def _rank_legs(rank: int, port: int, spec: dict, results) -> None:
    import torch.distributed as dist

    try:
        results[rank] = rank_legs(rank, port, spec)
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        results[rank] = {"rank": rank, "error": f"{type(e).__name__}: {e}"}
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def processes_leg(dev, tmp: Path, work: Path, refs: dict, totals: dict,
                  card: str, field_path: Path, mg_ref, mg_rows: list,
                  volume: dict, engine_imgs, cli_converge) -> dict:
    """Phase 4j (e): ``cuda_rdma`` on grids over two spawned ranks sharing
    the card (item 10d-i: the neighbours on the other rank read in place
    through CUDA IPC behind the step counters), one spawn for every leg
    (:func:`rank_legs`): phase 4j (d)'s ``cuda_sep`` bf16 fuse 32 job
    (:func:`job_checks`); config 2 bf16 fuse 32 on 2x2, strided and packed
    (byte-equal to the one-process run on 2x2 slots and to ``shifted``,
    the ranks' launches summing to its launches, packed launching the
    pack); the same with rank 1's host 50 ms late before each chunk (the
    skew check); ``auto`` and ``fallback=True`` on config 2 (both ranks one
    resolution, one rung); the engine with config 2's key and a batch of
    phase 4l's first two images; config 3 through ``run --device all
    --mesh 4x4`` (8 slots a rank; the one-process 16-slot bytes, which are
    ``shifted``'s); config 5's V-cycle on 2x2 (``cuda_rdma``, the 100-unit
    cap; bit-equal to 4j (a)'s one-process run, which is ``shifted``'s)
    and fd25 512^3 x 40 fuse 4 through ``run --rank 3 --device all`` (the
    bytes of phase 4g's 1x1 run).  Then phase 4j (f) in the same spawn
    (:func:`far_legs`, item 10d-ii-a): each rank reports a host of its
    own, so it reads the other's slots from mirrors gloo fills once a
    chunk: config 2 strided and packed (first and resident) and
    overlapped, config 3 on 4x4 and config 1's converge (``cuda_rdma`` u8
    fuse 8, 2x2), each byte-equal to its one-host run and ``shifted``
    (the converge: the same stop), with the far exchange's split a round.
    Every rank's launches go into the kernels line; each leg prints its
    seconds beside the one-process run's; the per-slot kernels are timed
    on one host and between hosts."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.serving.engine import WarmEngine
    from parallel_convolution_tpu_torch.utils import imageio, multihost_job

    t0 = time.perf_counter()
    spec = {"rgb": str(work / "rgb.raw"), "edge5": str(tmp / "edge5.raw"),
            "edge5_out": str(work / "edge5.out.raw"),
            "field": str(field_path),
            "volume": str(work / "fd25.raw"),
            "volume_out": str(work / "fd25.out.raw"),
            "engine": [str(work / f"engine{k}.raw") for k in range(2)],
            "edge5_far_out": str(work / "edge5.far.raw"),
            "converge": str(cli_converge[0]),
            "converge_out": str(work / "converge.far.raw")}
    imageio.write_raw(spec["rgb"], refs["rgb"])
    rgbs, wants = engine_imgs
    for path, img in zip(spec["engine"], rgbs):
        imageio.write_raw(path, img)
    mg_sha = _sha(mg_ref[0])
    job_kwargs = job_kw("cuda_sep", "bf16", 32)
    job = job_one_process(tmp, job_kwargs)
    spec["job"] = {"work": str(job["w2"]), "kw": job_kwargs}
    setup_s = time.perf_counter() - t0
    # The one-process forms the legs are held against, timed here.
    one = {}
    slots4 = mesh.make_grid((2, 2), devices=[dev] * 4)
    kw = dict(backend="cuda_rdma", storage="bf16", fuse=32)
    for cm in ("strided", "packed"):
        model = ConvolutionModel("blur3", grid=slots4, col_mode=cm, **kw)
        stencil.reset_launch_counts()
        got, secs = host_seconds(lambda: model.run_image(refs["rgb"], ITERS))
        counts = stencil.launch_counts()
        check(np.array_equal(got, refs["rgb_ref"]),
              f"4j (e) config 2 {cm} one process: differs from shifted")
        _, resident = host_seconds(lambda: model.run_image(refs["rgb"],
                                                           ITERS))
        one[cm] = {"seconds": secs, "resident": resident, "launches": counts}
    eng = WarmEngine(slots4, fallback=False)
    key = eng.key_for((3, *RGB_HW), filter_name="blur3", iters=ITERS, **kw)
    eng.entry(key)
    stack = np.stack([imageio.interleaved_to_planar(im).astype(np.float32)
                      for im in rgbs])
    eng.run_batch(key, stack)
    _, one["engine"] = host_seconds(lambda: eng.run_batch(key, stack))
    del eng
    stencil.reset_launch_counts()  # the references are not this path
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    port = multihost_job.free_port()
    t0 = time.perf_counter()
    with ctx.Manager() as manager, first_card_only():
        results = manager.dict()
        procs = [ctx.Process(target=_rank_legs,
                             args=(r, port, spec, results)) for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 420
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        got = [dict(results.get(r, {"rank": r, "error": "no result"}))
               for r in range(2)]
    spawn_s = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    check(codes == [0, 0] and not any("error" in g for g in got),
          f"4j (e) the ranks failed: exit codes {codes}, "
          f"{[g.get('error') for g in got]}")
    rows = []

    def both(name, what):
        return [g[name][what] for g in got]

    job_row = dict(job_checks(job, both("job", "row"),
                              max(both("job", "seconds")), refs, totals,
                              card), in_spawn_of="4j (e)")

    def launches(name):
        sent = {k: sum(g[name]["launches"][k] for g in got)
                for k in got[0][name]["launches"]}
        for k, v in sent.items():
            totals[k] += v
        return sent

    rgb_sha = _sha(refs["rgb_ref"])
    for cm in ("strided", "packed"):
        for res in ("", " resident"):
            name = f"config 2 {cm}{res}"
            sent = launches(name)
            label = f"4j (e) config 2 cuda_rdma bf16 fuse 32 2x2 {cm}{res}"
            check(both(name, "sha256") == [rgb_sha] * 2,
                  f"{label}: differs from shifted and the one-process run")
            check(both(name, "col_mode") == [cm] * 2,
                  f"{label}: ran col_mode {both(name, 'col_mode')}")
            if not res:
                check(sent == one[cm]["launches"],
                      f"{label}: the ranks launched {sent}, one process "
                      f"{one[cm]['launches']}")
                check((sent["rdma_pack"] > 0) == (cm == "packed"),
                      f"{label}: {sent['rdma_pack']} packs")
            rows.append({"path": label, "launches": sent,
                         "seconds": max(both(name, "seconds")),
                         "one_process_s": one[cm]["resident" if res else
                                                  "seconds"],
                         "bitwise_one_process": True,
                         "bitwise_shifted": True, "card": card})
    sent = launches("skew")
    check(both("skew", "sha256") == [rgb_sha] * 2
          and both("skew", "late_chunks") == [0, 4],
          f"4j (e) skew: the bytes differ, or rank 1 was late "
          f"{both('skew', 'late_chunks')} times")
    rows.append({"path": "4j (e) skew: config 2 packed, rank 1 50 ms late "
                 "before each of its 4 chunks", "launches": sent,
                 "seconds": max(both("skew", "seconds")),
                 "bitwise_shifted": True, "card": card})
    sent = launches("auto")
    res = both("auto", "resolution")
    check(res[0] == res[1] and both("auto", "sha256") == [rgb_sha] * 2,
          f"4j (e) auto: the ranks resolved {res}, or differ from shifted")
    rows.append({"path": "4j (e) auto, config 2 bf16 2x2", "resolution":
                 res[0], "launches": sent,
                 "seconds": max(both("auto", "seconds")), "card": card})
    sent = launches("fallback")
    check(both("fallback", "rung") == ["cuda_rdma"] * 2
          and both("fallback", "sha256") == [rgb_sha] * 2,
          f"4j (e) fallback: the ranks ran {both('fallback', 'rung')}")
    rows.append({"path": "4j (e) fallback=True, config 2 cuda_rdma bf16 "
                 "fuse 32 2x2", "rung": "cuda_rdma", "launches": sent,
                 "seconds": max(both("fallback", "seconds")), "card": card})
    for name in ("engine warm", "engine", "engine resident"):
        sent = launches(name)
        if name != "engine warm":
            check(both(name, "sha256") == [[_sha(w) for w in wants]] * 2,
                  f"4j (e) {name}: differs from phase 4l's answers")
        rows.append({"path": f"4j (e) {name}: config 2 cuda_rdma bf16 "
                     "fuse 32 key, a batch of two", "launches": sent,
                     "seconds": max(both(name, "seconds")),
                     "one_process_s": one["engine"], "card": card})
    sent = launches("config 3")
    check(both("config 3", "rc") == [0, 0] and np.array_equal(
        imageio.read_raw(spec["edge5_out"], *BIG_HW, "grey"),
        refs["grey_refs"]["edge5"]),
        "4j (e) config 3 on 4x4 over two ranks: differs from shifted (the "
        "one-process 16-slot bytes)")
    rows.append({"path": "4j (e) config 3 run --device all --mesh 4x4 "
                 "cuda_rdma bf16 fuse 32 packed", "launches": sent,
                 "seconds": max(both("config 3", "seconds")),
                 "bitwise_shifted": True, "card": card})
    sent = launches("multigrid")
    mg_one = next(r for r in mg_rows if "cuda_rdma" in r["path"])
    check(both("multigrid", "sha256")[0] == mg_sha
          and both("multigrid", "residuals") == [mg_ref[1]] * 2
          and both("multigrid", "cycles") == [mg_one["cycles"]] * 2,
          "4j (e) config 5 multigrid over two ranks: differs from 4j (a)'s "
          "one-process field or residuals (shifted's)")
    rows.append({"path": "4j (e) config 5 multigrid jacobi3 32768x32768 "
                 "cuda_rdma 2x2", "cycles": mg_one["cycles"],
                 "level_grids": both("multigrid", "level_grids")[0],
                 "launches": sent,
                 "seconds": max(both("multigrid", "seconds")),
                 "one_process_s": mg_one["seconds_first"],
                 "bitwise_one_process": True, "card": card})
    sent = launches("fd25")
    check(both("fd25", "rc") == [0, 0] and hashlib.sha256(
        Path(spec["volume_out"]).read_bytes()).hexdigest()
        == volume["sha"], "4j (e) fd25 over two ranks: differs from phase "
        "4g's 1x1 run")
    rows.append({"path": f"4j (e) fd25 {VOLUME_N}^3 x {VOLUME_FD25_SWEEPS} "
                 "fuse 4, run --rank 3 --device all 2x2", "launches": sent,
                 "seconds": max(both("fd25", "seconds")),
                 "one_process_s": volume["seconds"], "bitwise_1x1": True,
                 "card": card})
    rows += far_rows(got, spec, refs, cli_converge, launches, card)
    for row in rows:
        print(f"{row['path']}: {row['seconds']:.4f} s over two ranks"
              + (f" (one process {row['one_process_s']:.4f} s)"
                 if "one_process_s" in row else ""))
    print(f"4j (e): setup {setup_s:.2f} s, spawn to end {spawn_s:.2f} s; "
          f"card {card}")
    # The per-slot kernels over the two ranks (cross_slot_times): both
    # ranks step their slots at once on the one card, so a row's ms is the
    # slower rank's, its bound the whole grid's work.
    timed = {}
    far = [r for r in rows if r["path"].startswith("4j (f)")]
    for where, suffix, counted in (
            ("kernels", "", [r for r in rows if r not in far]),
            ("far_kernels", " between hosts", far)):
        timed.update(slot_kernel_rows(got, where, "over 2 ranks" + suffix,
                                      counted, bool(suffix)))
    for name, row in timed.items():
        print(f"time {name}: " + json.dumps(dict(row, card=card)))
    return {"rows": rows, "timed": timed, "job": job_row}


def slot_kernel_rows(got: list, where: str, label: str, counted: list,
                     exchange: bool) -> dict:
    """The kernels line's rows of the per-slot kernels that the ranks
    timed (:func:`cross_slot_times`, each rank's ``got[r][where]``) at
    config 2 and, where they timed it, the 16x16 split:
    ``"<kernel> <label>"`` and the pack's;
    a row's ms is the slowest rank's, its bound the whole grid's work, its
    launches those of the ``counted`` rows, and with ``exchange`` the far
    exchange's split."""
    from parallel_convolution_tpu_torch.ops.filters import get_filter

    timed = {}
    filt = get_filter("blur3")
    for key, storage, shape, T in (("config 2", "bf16", (2, 2), 32),
                                   ("grey 16x16", "u8", GREY_GRID, 8)):
        if key not in got[0][where]:
            continue
        t = [g[where][key] for g in got]
        C, h, w = t[0]["block"]
        nb = shape[0] * shape[1]
        ext, levels = t[0]["ext"], t[0]["levels"]
        elt = 1 if storage == "u8" else 2
        mid_elt = elt if storage == "u8" else 2
        ops = nb * C * levels * level_ops(filt, False, h, w, True, False)
        nbytes = nb * C * (h * w * elt + (h + 2 * ext) * (w + 2 * ext)
                           * mid_elt)
        b_ms, b_by = bound(nbytes, ops)
        depth = filt.radius * T
        pb_ms, pb_by = bound(2 * nb * 2 * C * (h + 2 * depth) * depth * elt,
                             0.0)
        name = t[0]["kernel"]
        timed[f"{name} {label}"] = dict(
            base=name, at=key, grid=list(shape), block=[C, h, w], T=T,
            levels=levels, ext=ext, ms=max(x["ms"] for x in t),
            packed_ms=max(x["packed_ms"] for x in t),
            alone_ms=max(x["alone_ms"] for x in t),
            barrier_ms=max(x["barrier_ms"] for x in t),
            max_abs_err=max(max(x["max_abs_err_strided"],
                                x["max_abs_err_packed"]) for x in t),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            launches=sum(r["launches"].get(name, 0) for r in counted),
            **({"exchange": t[0].get("exchange_strided"),
                "exchange_packed": t[0].get("exchange_packed")}
               if exchange else {}))
        if key == "config 2":
            timed[f"rdma_pack {label}"] = dict(
                base="rdma_pack", at=key, grid=list(shape),
                ms=max(x["pack_ms"] for x in t),
                alone_ms=max(x["pack_alone_ms"] for x in t),
                barrier_ms=max(x["barrier_ms"] for x in t),
                max_abs_err=max(x["pack_max_abs_err"] for x in t),
                bound_ms=pb_ms, bound_by=pb_by, library_ms=None,
                launches=sum(r["launches"].get("rdma_pack", 0)
                             for r in counted))
    return timed


def far_rows(got: list, spec: dict, refs: dict, cli_converge, launches,
             card: str) -> list:
    """Phase 4j (f)'s checks and rows (:func:`far_legs`, the ranks on two
    reported hosts): every leg byte-equal to ``shifted`` and to its
    one-host run in 4j (e) (config 2, config 3), the converge the same
    stop and bytes as one process; one exchange round a chunk (no staging
    round: the ranks split the rows); each row's far exchange split
    (:func:`exchange_summary`), config 2's strided first run printed a
    chunk at a time."""
    import numpy as np

    from parallel_convolution_tpu_torch.utils import imageio

    def both(name, what):
        return [g[name][what] for g in got]

    def split(name):
        return [exchange_summary(g[name]["exchange"]) for g in got]

    rgb_sha = _sha(refs["rgb_ref"])
    rows = []
    chunks = -(-ITERS // 32)
    legs = [(f"far config 2 {cm}{res}", f"config 2 {cm}{res}",
             f"config 2 cuda_rdma bf16 fuse 32 2x2 {cm}{res}")
            for cm in ("strided", "packed") for res in ("", " resident")]
    legs.append(("far config 2 overlap", None,
                 "config 2 cuda_rdma bf16 fuse 32 2x2 strided overlap=True"))
    for name, near, what in legs:
        sent = launches(name)
        label = f"4j (f) {what} between hosts"
        check(both(name, "sha256") == [rgb_sha] * 2,
              f"{label}: differs from shifted and the one-host run")
        ex = split(name)
        check(both(name, "rounds") == [chunks] * 2
              and all(t["round"] == 0 for g in got
                      for t in g[name]["exchange"]),
              f"{label}: {both(name, 'rounds')} exchange rounds, "
              f"{chunks} chunks")
        rows.append({"path": label, "launches": sent,
                     "seconds": max(both(name, "seconds")),
                     **({"one_host_s": max(both(near, "seconds"))}
                        if near else {}),
                     "exchange": ex[0], "bitwise_one_host": True,
                     "bitwise_shifted": True, "card": card})
    for k, t in enumerate(got[0]["far config 2 strided"]["exchange"]):
        print(f"4j (f) config 2 strided between hosts, chunk {k}: copy out "
              f"{t['out_ms']:.4f} ms, the host's wait {t['wait_ms']:.4f} "
              f"ms, gloo {t['gloo_ms']:.4f} ms, copy in {t['in_ms']:.4f} "
              f"ms, {t['bytes_out']} B each way; card {card}")
    sent = launches("far grey 16x16")
    check(both("far grey 16x16", "sha256")
          == [_sha(refs["grey_refs"]["blur3"])] * 2
          and both("far grey 16x16", "rounds") == [-(-ITERS // 8)] * 2,
          "4j (f) grey 16x16 between hosts: differs from shifted, or "
          f"{both('far grey 16x16', 'rounds')} exchange rounds")
    rows.append({"path": "4j (f) grey 1920x2520 blur3 cuda_rdma u8 fuse 8 "
                 "16x16 between hosts", "launches": sent,
                 "seconds": max(both("far grey 16x16", "seconds")),
                 "exchange": split("far grey 16x16")[0],
                 "bitwise_shifted": True, "card": card})
    sent = launches("far config 3")
    check(both("far config 3", "rc") == [0, 0] and np.array_equal(
        imageio.read_raw(spec["edge5_far_out"], *BIG_HW, "grey"),
        refs["grey_refs"]["edge5"]),
        "4j (f) config 3 on 4x4 between hosts: differs from shifted")
    rows.append({"path": "4j (f) config 3 run --device all --mesh 4x4 "
                 "cuda_rdma bf16 fuse 32 packed between hosts",
                 "launches": sent,
                 "seconds": max(both("far config 3", "seconds")),
                 "one_host_s": max(both("config 3", "seconds")),
                 "exchange": split("far config 3")[0],
                 "bitwise_shifted": True, "card": card})
    _, cwant, citers = cli_converge
    sent = launches("far converge")
    said = both("far converge", "said")
    check(both("far converge", "rc") == [0, 0]
          and all(x.startswith(f"converged after {citers} iters")
                  for x in said)
          and np.array_equal(imageio.read_raw(spec["converge_out"],
                                              *RGB_HW, "grey"), cwant),
          f"4j (f) converge between hosts: said {said}, shifted stopped "
          f"after {citers}, or the bytes differ")
    rows.append({"path": "4j (f) cli run --converge 0.5 --check-every 10 "
                 "grey 1920x2520 blur3 cuda_rdma u8 fuse 8 2x2 between "
                 "hosts", "launches": sent, "iters": citers,
                 "seconds": max(both("far converge", "seconds")),
                 "rounds": both("far converge", "rounds")[0],
                 "exchange": split("far converge")[0],
                 "bitwise_shifted": True, "card": card})
    return rows


# ---------------------------------------------------------------------------
# Phase 4j (g): one card a process (ROADMAP item 10d-ii-b)
# ---------------------------------------------------------------------------

# torchrun's ranks run this: the CLI, then each rank appends its exit code,
# its group and its launch counts to $SMOKE_LAUNCHES.
CARD_RANK_SRC = """
import json, os, sys
from parallel_convolution_tpu_torch.cli import main
from parallel_convolution_tpu_torch.ops import stencil
from parallel_convolution_tpu_torch.parallel import multihost
rc = 1
try:
    rc = main(sys.argv[1:])
finally:
    with open(os.environ["SMOKE_LAUNCHES"], "a") as f:
        f.write(json.dumps({"rank": os.environ.get("RANK"), "rc": rc,
                            "group": multihost.backend(),
                            "launches": stencil.launch_counts()}) + "\\n")
sys.exit(rc)
"""
# The 2x2 legs of config 2 on the cards: (col_mode, overlap).
CARD_LEGS = [("strided", False), ("packed", False), ("strided", True)]


def card_ranks(cards: int) -> int:
    """4j (g)'s ranks: four where the machine has four cards, else two
    (a 2x2 grid splits into neither three shares nor one card a rank)."""
    return 4 if cards >= 4 else 2 if cards >= 2 else 0


def card_rank_legs(rank: int, port: int, spec: dict) -> dict:
    """Phase 4j (g), one rank's share: an NCCL group of ``spec["n"]``
    ranks, each on its own card; every leg between two barriers, its
    seconds, launches and output's SHA-256 in the row (as
    :func:`rank_legs`), then the same group with the ranks reporting two
    hosts (:data:`FOUR_HOSTS`' rows layout, or a host each of two)."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import rdma, stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh, multihost
    from parallel_convolution_tpu_torch.solvers import multigrid as mg
    from parallel_convolution_tpu_torch.utils import imageio, multihost_job

    n = spec["n"]
    multihost.initialize(f"localhost:{port}", num_processes=n,
                         process_id=rank)
    dev = multihost.card()
    row = {"rank": rank, "group": multihost.backend(), "card": str(dev),
           "uuid": multihost.card_uuid(dev)}
    made = []
    real_init = rdma._FarExchange.__init__

    def init(ex, *a, **k):
        real_init(ex, *a, **k)
        made.append(ex)

    def leg(name, fn):
        del made[:]
        multihost.barrier(name)
        torch.cuda.synchronize(dev)
        stencil.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn() or {}
        torch.cuda.synchronize(dev)
        multihost.barrier(name)
        row[name] = dict(res, seconds=time.perf_counter() - t0,
                         launches=stencil.launch_counts(),
                         exchange=[t for ex in made for t in ex.split()],
                         rounds=sum(ex.rounds for ex in made))

    rdma._FarExchange.__init__ = init
    real_host = multihost.hostname
    try:
        for backend, storage, fuse in (("cuda", "f32", 1),
                                       ("cuda_sep", "bf16", 32)):
            leg(f"job {backend}", lambda: {"row": multihost_job.job(
                rank, n, None, spec["job"][backend],
                **job_kw(backend, storage, fuse))})
        grid = mesh.make_grid((2, 2), devices="all")
        row["slots"] = grid.slot_map()
        rgb = imageio.read_raw(spec["rgb"], *RGB_HW, "rgb")
        grey = imageio.generate_test_image(*RGB_HW, "grey", seed=2)
        blur3 = get_filter("blur3")
        kw = dict(backend="cuda_rdma", storage="bf16", fuse=32)

        def config2(prefix):
            for cm, ov in CARD_LEGS:
                model = ConvolutionModel("blur3", grid=grid, col_mode=cm,
                                         overlap=ov, **kw)
                for res in ("", " resident"):
                    leg(f"{prefix}config 2 {cm}{' overlap' * ov}{res}",
                        lambda: {"sha256": _sha(model.run_image(rgb, ITERS)),
                                 "col_mode": model.effective_col_mode,
                                 "overlap": model.effective_overlap})

        def config3(name, out):
            leg(name, lambda: {"rc": cli_main([
                "run", spec["edge5"], str(BIG_HW[0]), str(BIG_HW[1]),
                str(ITERS), "grey", "-o", out, "--filter", "edge5",
                "--backend", "cuda_rdma", "--mesh", "4x4", "--device", "all",
                "--storage", "bf16", "--fuse", "32", "--col-mode",
                "packed"])})

        def kernels(split=True):
            out = {"config 2": cross_slot_times(dev, rgb, "bf16", (2, 2),
                                                32, blur3)}
            if split:
                out["grey 16x16"] = cross_slot_times(dev, grey, "u8",
                                                     GREY_GRID, 8, blur3)
            return out

        config2("")
        field = np.load(spec["field"])

        def multigrid():
            out, res = mg.mg_converge(field, get_filter("jacobi3"), 1e-3,
                                      CONVERGE_MAX_ITERS, grid=grid,
                                      backend="cuda_rdma")
            return {"cycles": res.cycles, "residuals": res.residuals,
                    "level_grids": res.level_grids,
                    "sha256": _sha(out) if rank == 0 else None}

        leg("multigrid", multigrid)
        del field
        torch.cuda.empty_cache()

        def converge():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main([
                    "run", spec["converge"], str(RGB_HW[0]), str(RGB_HW[1]),
                    str(CONVERGE_CLI_MAX), "grey", "-o",
                    spec["converge_out"], "--converge", "0.5",
                    "--check-every", "10", "--backend", "cuda_rdma",
                    "--mesh", "2x2", "--device", "all", "--storage", "u8",
                    "--fuse", "8"])
            return {"rc": rc, "said": buf.getvalue().strip().splitlines()[-1]}

        leg("converge", converge)
        row["kernels"] = kernels()
        hosts = (0, 0, 1, 1) if n == 4 else (0, 1)
        multihost.hostname = lambda: f"host{hosts[rank]}"
        row["hosts"] = multihost.hosts_of(multihost.peer_records({}))
        config2("far ")
        config3("far config 3", spec["edge5_far_out"])
        # No leg between hosts here runs the 16x16 split (K3), so only
        # config 2's kernels are timed there.
        row["far_kernels"] = kernels(split=False)
    finally:
        multihost.hostname = real_host
        rdma._FarExchange.__init__ = real_init
    multihost.barrier("done")
    return row


def _card_rank_legs(rank: int, port: int, spec: dict, results) -> None:
    import torch.distributed as dist

    try:
        results[rank] = card_rank_legs(rank, port, spec)
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        results[rank] = {"rank": rank, "error": f"{type(e).__name__}: {e}"}
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def torchrun(n: int, argv: list, here: Path, work: Path, label: str,
             faults: str | None = None) -> dict:
    """``torchrun --standalone --nproc-per-node n`` of the ``run`` CLI
    (:data:`CARD_RANK_SRC`), its ranks' exit codes, groups and launch
    counts, its seconds (the launch included) and its stderr's tail."""
    script = work / "card_rank.py"
    script.write_text(CARD_RANK_SRC)
    counts = work / f"launches_{label.replace(' ', '_')}.jsonl"
    counts.unlink(missing_ok=True)
    env = dict(os.environ, SMOKE_LAUNCHES=str(counts), PYTHONPATH=str(here))
    env.pop("PCTPU_FAULTS", None)
    if faults:
        env["PCTPU_FAULTS"] = faults
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), str(script), *argv],
        cwd=here, env=env, capture_output=True, text=True, timeout=600)
    ranks = ([json.loads(x) for x in counts.read_text().splitlines()]
             if counts.exists() else [])
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"rc": proc.returncode, "ranks": ranks, "launches": launches,
            "seconds": time.perf_counter() - t0, "stderr": proc.stderr}


def cards_phase(dev, tmp: Path, here: Path, work: Path, refs: dict,
                totals: dict, field_path: Path, mg_ref, mg_rows: list,
                cli_converge, gloo_rows: list) -> dict:
    """Phase 4j (g): one card a process (item 10d-ii-b).  With N =
    :func:`card_ranks` ranks (four on a four-card machine), each on its
    own card, in one NCCL group (the default where the host has a card
    for each rank), one spawn (:func:`card_rank_legs`): the two-process
    job's config 2 ``cuda`` f32 fuse 1 and ``cuda_sep`` bf16 fuse 32 (N
    ranks, the sharded load and save, the checkpointed run and its
    resume); config 2 ``cuda_rdma`` bf16 fuse 32 on 2x2, strided, packed
    and ``overlap=True``, first and resident; config 5's V-cycle on 2x2;
    config 1's converge (``cuda_rdma`` u8 fuse 8, 2x2); the per-slot
    kernels between cards; then the ranks reporting two hosts (a far
    neighbour's mirror filled by NCCL, card to card): config 2 strided,
    packed and overlapped, config 3 on 4x4, the kernels between hosts.
    Then through ``torchrun --nproc-per-node N`` of the ``run`` CLI
    (``--device all``): config 3 on 4x4, and its checkpoint killed in the
    second snapshot and resumed.  Each output byte-equal to ``shifted``
    (which the one-card forms of 4h, 4j (a) and 4b equal) and config 2's
    to its one-card run here; each leg's first and resident seconds
    beside its one-card form and 4j (e) / (f)'s gloo form
    (``gloo_rows``); the NCCL round split per chunk.  With one card the
    phase runs nothing: NCCL refuses two ranks on one card."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio, multihost_job

    cards = torch.cuda.device_count()
    n = card_ranks(cards)
    if not n:
        print(f"4j (g) one card a process: needs two cards ({cards} "
              "visible): NCCL refuses two ranks on one card; nothing run")
        return {"skipped": f"{cards} card(s)", "rows": [], "timed": {}}
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60).stdout
    every = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = "; ".join(every)
    print(f"4j (g) one card a process: {n} ranks on {cards} cards\n"
          f"nvidia-smi topo -m:\n{topo}cards: {card}")
    t0 = time.perf_counter()
    rgb_sha = _sha(refs["rgb_ref"])
    spec = {"n": n, "rgb": str(work / "rgb_g.raw"),
            "edge5": str(tmp / "edge5.raw"),
            "edge5_far_out": str(work / "edge5.g_far.raw"),
            "field": str(field_path), "converge": str(cli_converge[0]),
            "converge_out": str(work / "converge.g.raw"),
            "job": {b: str(work / f"job_g_{b}") for b in ("cuda",
                                                          "cuda_sep")}}
    imageio.write_raw(spec["rgb"], refs["rgb"])
    # Config 2's one-card forms (2x2 slots of this card), timed here.
    one = {}
    slots4 = mesh.make_grid((2, 2), devices=[dev] * 4)
    for cm, ov in CARD_LEGS:
        model = ConvolutionModel("blur3", grid=slots4, col_mode=cm,
                                 overlap=ov, backend="cuda_rdma",
                                 storage="bf16", fuse=32)
        got, first = host_seconds(lambda: model.run_image(refs["rgb"],
                                                          ITERS))
        check(np.array_equal(got, refs["rgb_ref"]),
              f"4j (g) config 2 {cm} overlap={ov} on one card: differs "
              "from shifted")
        _, res = host_seconds(lambda: model.run_image(refs["rgb"], ITERS))
        one[cm, ov] = (first, res)
    stencil.reset_launch_counts()  # the references are not this path
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    ctx = mp.get_context("spawn")
    port = multihost_job.free_port()
    t0 = time.perf_counter()
    with ctx.Manager() as manager:
        results = manager.dict()
        procs = [ctx.Process(target=_card_rank_legs,
                             args=(r, port, spec, results)) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 480
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        got = [dict(results.get(r, {"rank": r, "error": "no result"}))
               for r in range(n)]
    spawn_s = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    check(codes == [0] * n and not any("error" in g for g in got),
          f"4j (g) the ranks failed: exit codes {codes}, "
          f"{[g.get('error') for g in got]}")
    check([g["group"] for g in got] == ["nccl"] * n
          and len({g["uuid"] for g in got}) == n,
          f"4j (g): groups {[g['group'] for g in got]}, cards "
          f"{[g['card'] for g in got]}: not one card a process over NCCL")

    def both(name, what):
        return [g[name][what] for g in got]

    def launches(name):
        sent = {k: sum(g[name]["launches"][k] for g in got)
                for k in got[0][name]["launches"]}
        for k, v in sent.items():
            totals[k] += v
        return sent

    gloo = {r["path"]: r["seconds"] for r in gloo_rows}
    rows = []

    def add(path, name, sent, **extra):
        rows.append(dict({"path": path, "launches": sent,
                          "seconds": max(both(name, "seconds")),
                          "card": card}, **extra))

    for backend in ("cuda", "cuda_sep"):
        name = f"job {backend}"
        sent = launches(name)
        jobs = both(name, "row")
        out = Path(spec["job"][backend]) / "out.raw"
        check(np.array_equal(imageio.read_raw(out, *RGB_HW, "rgb"),
                             refs["rgb_ref"])
              and all(j["group"] == "nccl" and j["broadcast"] == 7.0
                      for j in jobs)
              and all(j["resume_bitexact"] in ((True,) if backend == "cuda"
                                               else (None,)) for j in jobs),
              f"4j (g) {name} over {n} cards: the output differs from "
              "shifted, the resume was not bit-identical, or the group is "
              f"{[j['group'] for j in jobs]}")
        add(f"4j (g) job config 2 {backend} over {n} cards", name, sent,
            first_s=max(j["first_s"] for j in jobs),
            resident_s=max(j["resident_s"] for j in jobs),
            bitwise_shifted=True)
    chunks = -(-ITERS // 32)
    for prefix, where in (("", "between cards"),
                          ("far ", "between hosts over NCCL")):
        for cm, ov in CARD_LEGS:
            for res in ("", " resident"):
                name = f"{prefix}config 2 {cm}{' overlap' * ov}{res}"
                sent = launches(name)
                label = (f"4j (g) config 2 cuda_rdma bf16 fuse 32 2x2 {cm}"
                         f"{' overlap=True' * ov}{res} {where}")
                check(both(name, "sha256") == [rgb_sha] * n
                      and both(name, "col_mode") == [cm] * n
                      and both(name, "overlap") == [ov] * n,
                      f"{label}: differs from shifted and the one-card run, "
                      f"or ran {both(name, 'col_mode')} overlap "
                      f"{both(name, 'overlap')}")
                far = bool(prefix)
                check(both(name, "rounds") == ([chunks] * n if far
                                               else [0] * n),
                      f"{label}: {both(name, 'rounds')} exchange rounds")
                gl = (f"4j ({'f' if far else 'e'}) config 2 cuda_rdma bf16 "
                      f"fuse 32 2x2 {cm}{' overlap=True' * ov}{res}"
                      + (" between hosts" if far else ""))
                add(label, name, sent, one_card_s=one[cm, ov][bool(res)],
                    gloo_s=gloo.get(gl), bitwise_one_card=True,
                    bitwise_shifted=True,
                    **({"exchange": exchange_summary(
                        got[0][name]["exchange"])} if far else {}))
    for k, t in enumerate(got[0]["far config 2 strided"]["exchange"]):
        print(f"4j (g) config 2 strided between hosts over NCCL, chunk {k}: "
              f"copy out {t['out_ms']:.4f} ms, the host's wait "
              f"{t['wait_ms']:.4f} ms, NCCL {t['nccl_ms']:.4f} ms (host "
              f"{t['swap_host_ms']:.4f} ms to enqueue), copy in "
              f"{t['in_ms']:.4f} ms, {t['bytes_out']} B each way; {card}")
    sent = launches("multigrid")
    mg_one = next(r for r in mg_rows if "cuda_rdma" in r["path"])
    check(both("multigrid", "sha256")[0] == _sha(mg_ref[0])
          and both("multigrid", "residuals") == [mg_ref[1]] * n
          and both("multigrid", "cycles") == [mg_one["cycles"]] * n,
          f"4j (g) config 5 multigrid over {n} cards: differs from 4j (a)'s "
          "one-card field or residuals (shifted's)")
    add(f"4j (g) config 5 multigrid jacobi3 32768x32768 cuda_rdma 2x2 over "
        f"{n} cards", "multigrid", sent, cycles=mg_one["cycles"],
        one_card_s=mg_one["seconds_first"],
        gloo_s=gloo.get("4j (e) config 5 multigrid jacobi3 32768x32768 "
                        "cuda_rdma 2x2"), bitwise_one_card=True)
    _, cwant, citers = cli_converge
    sent = launches("converge")
    said = both("converge", "said")
    check(both("converge", "rc") == [0] * n
          and all(x.startswith(f"converged after {citers} iters")
                  for x in said)
          and np.array_equal(imageio.read_raw(spec["converge_out"],
                                              *RGB_HW, "grey"), cwant),
          f"4j (g) converge over {n} cards: said {said}, shifted stopped "
          f"after {citers}, or the bytes differ")
    add(f"4j (g) cli run --converge 0.5 --check-every 10 grey 1920x2520 "
        f"blur3 cuda_rdma u8 fuse 8 2x2 over {n} cards", "converge", sent,
        iters=citers, bitwise_shifted=True)
    sent = launches("far config 3")
    check(both("far config 3", "rc") == [0] * n and np.array_equal(
        imageio.read_raw(spec["edge5_far_out"], *BIG_HW, "grey"),
        refs["grey_refs"]["edge5"]),
        "4j (g) config 3 on 4x4 between hosts over NCCL: differs from "
        "shifted")
    add("4j (g) config 3 run --device all --mesh 4x4 cuda_rdma bf16 fuse 32 "
        "packed between hosts over NCCL", "far config 3", sent,
        gloo_s=gloo.get("4j (f) config 3 run --device all --mesh 4x4 "
                        "cuda_rdma bf16 fuse 32 packed between hosts"),
        exchange=exchange_summary(got[0]["far config 3"]["exchange"]),
        bitwise_shifted=True)
    near = [r for r in rows if "between hosts" not in r["path"]]
    far = [r for r in rows if "between hosts" in r["path"]]
    timed = slot_kernel_rows(got, "kernels", "between cards", near, False)
    timed.update(slot_kernel_rows(got, "far_kernels",
                                  "between hosts over NCCL", far, True))
    for name, row in timed.items():
        print(f"time {name}: " + json.dumps(dict(row, card=card)))
    print(f"4j (g): setup {setup_s:.2f} s, spawn to end {spawn_s:.2f} s; "
          f"{card}")
    show_card_rows(rows)
    spawned = len(rows)
    # Through torchrun: config 3 on 4x4, and its checkpoint killed in the
    # second snapshot (each rank's shard writes counted alone: 16 / N a
    # snapshot), then resumed.
    edge = refs["grey_refs"]["edge5"]
    src = tmp / "edge5.raw"
    dst = work / "edge5.g.raw"
    run3 = torchrun(n, ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]),
                        str(ITERS), "grey", "-o", str(dst), "--filter",
                        "edge5", "--backend", "cuda_rdma", "--mesh", "4x4",
                        "--device", "all", "--storage", "bf16", "--fuse",
                        "32", "--col-mode", "packed"], here, work,
                    "config 3")
    check(run3["rc"] == 0 and [r["group"] for r in run3["ranks"]]
          == ["nccl"] * n and np.array_equal(
              imageio.read_raw(dst, *BIG_HW, "grey"), edge),
          f"4j (g) torchrun config 3: exit {run3['rc']}, groups "
          f"{[r['group'] for r in run3['ranks']]}, or the bytes differ from "
          f"shifted: {run3['stderr'][-3000:]}")
    for k, v in run3["launches"].items():
        totals[k] += v
    rows.append({"path": f"4j (g) torchrun --nproc-per-node {n} run "
                 "--device all --mesh 4x4 cuda_rdma bf16 fuse 32 packed "
                 "(config 3)", "launches": run3["launches"],
                 "seconds": run3["seconds"],
                 "gloo_s": gloo.get("4j (e) config 3 run --device all "
                                    "--mesh 4x4 cuda_rdma bf16 fuse 32 "
                                    "packed"),
                 "bitwise_shifted": True, "card": card,
                 "note": "seconds include torchrun's start"})
    ck = work / "ck_g"
    shutil.rmtree(ck, ignore_errors=True)
    per_snapshot = 16 // n
    kill = per_snapshot + 2
    argv = ckpt_argv(src, work / "ck_g.raw", ck, "4x4") + ["--device", "all"]
    dead = torchrun(n, argv, here, work, "checkpoint killed",
                    faults=f"checkpoint_write_shard:{kill}")
    latest = (ck / "LATEST").read_text() if (ck / "LATEST").exists() else ""
    check(dead["rc"] != 0 and "injected fault at 'checkpoint_write_shard'"
          in dead["stderr"] and latest == f"it_{CKPT_EVERY:08d}",
          f"4j (g) checkpoint: the faulted torchrun exited {dead['rc']}, "
          f"LATEST {latest!r}: {dead['stderr'][-3000:]}")
    for k, v in dead["launches"].items():
        totals[k] += v
    back = torchrun(n, argv, here, work, "checkpoint resumed")
    rest = ITERS - CKPT_EVERY
    check(back["rc"] == 0 and np.array_equal(
        imageio.read_raw(work / "ck_g.raw", *BIG_HW, "grey"), edge)
        and back["launches"].get("rdma_tiled_slot") == rest * 16,
        f"4j (g) checkpoint resume: exit {back['rc']}, launches "
        f"{back['launches']}, or the bytes differ from shifted: "
        f"{back['stderr'][-3000:]}")
    for k, v in back["launches"].items():
        totals[k] += v
    rows.append({"path": f"4j (g) checkpoint config 3 4x4 over {n} cards: "
                 f"torchrun killed in its second snapshot (shard write "
                 f"{kill} of each rank), resumed from {CKPT_EVERY}",
                 "launches": back["launches"], "seconds": back["seconds"],
                 "killed_s": dead["seconds"], "bitwise_shifted": True,
                 "card": card})
    shutil.rmtree(ck, ignore_errors=True)
    show_card_rows(rows[spawned:])
    return {"rows": rows, "timed": timed, "ranks": n, "cards": card,
            "topo": topo}


def show_card_rows(rows: list) -> None:
    """4j (g)'s rows as one line each: seconds, first and resident, the
    one-card and the gloo forms beside them where measured."""
    for row in rows:
        print(f"{row['path']}: {row['seconds']:.4f} s"
              + (f" (first {row['first_s']:.4f} s, resident "
                 f"{row['resident_s']:.4f} s)" if "first_s" in row else "")
              + (f"; one card {row['one_card_s']:.4f} s"
                 if row.get("one_card_s") is not None else "")
              + (f"; gloo {row['gloo_s']:.4f} s"
                 if row.get("gloo_s") is not None else ""), flush=True)


# ---------------------------------------------------------------------------
# Phase 4e: the host tools (ROADMAP item 12)
# ---------------------------------------------------------------------------


def cpu_brand(tmp: Path) -> str:
    """The host CPU's brand string from ``cpuid`` (x86), for a host whose
    ``/proc/cpuinfo`` does not name its model (some virtualised hosts)."""
    src, exe = tmp / "brand.cpp", tmp / "brand"
    src.write_text(
        "#include <cpuid.h>\n#include <cstdio>\n#include <cstring>\n"
        "int main() { unsigned r[12] = {0}; char s[49] = {0};\n"
        "  for (unsigned i = 0; i < 3; ++i)\n"
        "    __get_cpuid(0x80000002u + i, &r[4 * i], &r[4 * i + 1],\n"
        "                &r[4 * i + 2], &r[4 * i + 3]);\n"
        "  std::memcpy(s, r, 48); std::puts(s); }\n")
    res = subprocess.run(["g++", "-O1", "-o", str(exe), str(src)],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        return f"not known (cpuid: {res.stderr.strip()[:120]})"
    run = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=60)
    return run.stdout.strip() or "not known"


def host_tools_phase(dev, tmp: Path, native_build_s: float) -> dict:
    """``serial --impl native`` on BASELINE config 1 (grey 1920x2520,
    blur3, 100 iterations) byte-equal to the NumPy oracle, with the host
    CPU and its threads (and the strict one-thread baseline,
    ``bench_oracle_proxy``); ``bench`` on RGB 1920x2520 cuda_sep bf16 fuse
    32; ``bench_halo_p50`` at BASELINE config 2's block (960x1260 RGB on
    2x2, r = 1) and config 3's (2048x2048 grey on 4x4, r = 2); ``convert``
    and ``info`` once each."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.native import build as nbuild
    from parallel_convolution_tpu_torch.native import serial_native
    from parallel_convolution_tpu_torch.ops import oracle
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils import bench, imageio

    def cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main([str(a) for a in argv])
        check(rc == 0, f"cli {argv[0]}: exited {rc}")
        return buf.getvalue().strip().splitlines()

    out = {"native_build_s": native_build_s}
    rows_, cols_ = RGB_HW
    img = imageio.generate_test_image(rows_, cols_, "grey", seed=2)
    src, dst = tmp / "config1.raw", tmp / "config1.native.raw"
    imageio.write_raw(src, img)
    t0 = time.perf_counter()
    said = cli(["serial", src, rows_, cols_, ITERS, "grey", "-o", dst,
                "--impl", "native"])
    secs = time.perf_counter() - t0
    check(said[-1].startswith("serial[native]:"), f"serial said {said}")
    t0 = time.perf_counter()
    want = oracle.run_serial_u8(img, get_filter("blur3"), ITERS)
    oracle_s = time.perf_counter() - t0
    check(np.array_equal(imageio.read_raw(dst, rows_, cols_, "grey"), want),
          "serial --impl native differs from the NumPy oracle")
    px = rows_ * cols_ * ITERS
    out["serial_native"] = {
        "path": f"cli serial --impl native grey {rows_}x{cols_} blur3 "
                f"{ITERS} iterations",
        "seconds": secs, "gpx_per_s": px / secs / 1e9,
        "threads": serial_native.num_threads(),
        "cpuinfo_model": nbuild.host_cpu(), "cpuid_brand": cpu_brand(tmp),
        "os_cpu_count": os.cpu_count(), "oracle_seconds": oracle_s,
        "oracle_gpx_per_s": px / oracle_s / 1e9, "byte_equal_oracle": True}
    out["serial_one_thread"] = bench.bench_oracle_proxy(RGB_HW, iters=2,
                                                        reps=3)
    check(out["serial_one_thread"]["impl"] == "cpp-serial",
          f"the one-thread baseline ran {out['serial_one_thread']['impl']}")

    row = json.loads(cli(["bench", rows_, cols_, ITERS, "rgb", "--backend",
                          "cuda_sep", "--storage", "bf16", "--fuse", "32"])[-1])
    check(row["effective_backend"] == "cuda_sep" and row["gpixels_per_s"] > 0
          and row["device_kind"] == torch.cuda.get_device_name(dev)
          and row["power_limit_w"] is not None, f"bench row {row}")
    out["bench"] = row

    out["halo_p50_config2"] = bench.bench_halo_p50(
        (960, 1260), r=1, grid=make_grid((2, 2), dev), trials=20,
        chain_rounds=128, channels=3)
    out["halo_p50_config3"] = bench.bench_halo_p50(
        (2048, 2048), r=2, grid=make_grid((4, 4), dev), trials=20,
        chain_rounds=64)
    for key in ("halo_p50_config2", "halo_p50_config3"):
        h = out[key]
        check(h["p50_us"] is not None or h.get("noise_floor"),
              f"{key}: {h}")

    pgm = tmp / "config1.pgm"
    cli(["convert", dst, rows_, cols_, "grey", "-o", pgm])
    head = f"P5\n{cols_} {rows_}\n255\n".encode()
    check(pgm.read_bytes() == head + want.tobytes(),
          "convert: the PGM is not the header and the image's bytes")
    info = cli(["info"])
    check(any(torch.cuda.get_device_name(dev) in ln for ln in info),
          f"info did not name the card: {info}")
    out["info"] = info
    return out


# ---------------------------------------------------------------------------
# Phase 4c: the huge-image workflow — BASELINE config 4 through
# run --sharded-io, checkpoints and backend fallback
# ---------------------------------------------------------------------------


def machine_room(work: Path) -> dict:
    """Free disk where the config-4 files go, and the host's RAM (GB)."""
    import shutil

    work.mkdir(parents=True, exist_ok=True)
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                mem[key] = int(value.split()[0]) * 1024 / 1e9
    return {"disk_free_gb": shutil.disk_usage(work).free / 1e9,
            "work": str(work), "ram_total_gb": mem.get("MemTotal"),
            "ram_available_gb": mem.get("MemAvailable")}


def host_rss() -> int:
    """This process's resident set now, in bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise SmokeFailure("no VmRSS in /proc/self/status")


@contextlib.contextmanager
def host_rss_growth(out: dict):
    """Sample the resident set every 10 ms in a thread while the block
    runs; ``out["growth"]``: its peak over its size at the start."""
    import threading

    stop, start = threading.Event(), host_rss()
    peak = [start]

    def sample():
        while not stop.wait(0.01):
            peak[0] = max(peak[0], host_rss())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join()
        out["growth"] = max(peak[0], host_rss()) - start


def config4_side(free_bytes: float) -> int:
    """The side of the square RGB image the phase runs: BASELINE config
    4's 65536 when the input and one output fit on the disk with 10% to
    spare, else the largest multiple of 4096 that does (a printed cut)."""
    side = CONFIG4_SIDE
    while side > 4096 and 2 * 3 * side * side * 1.1 > free_bytes:
        side -= 4096
    return side


def write_seeded_raw(path: Path, side: int, dev, seed: int) -> float:
    """A seeded side x side RGB u8 image, made on the card a row band at a
    time by an explicit generator (uniform bytes plus a 256-pixel
    checkerboard ramp, so that the filter has edges to blur) and written
    with ``imageio.write_block``; returns the seconds."""
    import torch

    from parallel_convolution_tpu_torch.utils import imageio

    t0 = time.perf_counter()
    imageio.allocate_raw(path, side, side, "rgb")
    gen = torch.Generator(device=dev).manual_seed(seed)
    band = max(1, (64 << 20) // (3 * side))
    cols = torch.arange(side, device=dev)[None, :, None] // 256
    chan = torch.arange(3, device=dev)[None, None, :] * 85
    for r0 in range(0, side, band):
        n = min(band, side - r0)
        rows = torch.arange(r0, r0 + n, device=dev)[:, None, None] // 256
        noise = torch.randint(0, 64, (n, side, 3), generator=gen, device=dev,
                              dtype=torch.int32)
        img = (noise + ((rows + cols) * 37 + chan) % 192).to(torch.uint8)
        imageio.write_block(path, side, side, "rgb", r0, 0,
                            img.cpu().numpy())
    return time.perf_counter() - t0


@contextlib.contextmanager
def timed_sharded_io(times: dict):
    """Add the host seconds of every ``sharded_io.load_sharded`` and
    ``save_sharded`` call (the card synchronised on both sides) to
    ``times`` while the block runs."""
    import torch

    from parallel_convolution_tpu_torch.utils import sharded_io

    orig = {n: getattr(sharded_io, n) for n in ("load_sharded",
                                                  "save_sharded")}

    def wrap(name):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[name](*args, **kwargs)
            torch.cuda.synchronize()
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
            return out
        return timed

    for name in orig:
        setattr(sharded_io, name, wrap(name))
    try:
        yield times
    finally:
        for name, fn in orig.items():
            setattr(sharded_io, name, fn)


def oracle_windows(src: Path, dst: Path, side: int, filt) -> list:
    """Every config-4 window of the written output against the NumPy oracle
    on the input crop that reaches ITERS * r pixels beyond it (clamped to
    the image, whose edge is the true zero boundary; every other edge of a
    crop is that far from the window), read back from the files; one
    thread a window.  Returns the windows."""
    from concurrent.futures import ThreadPoolExecutor

    from parallel_convolution_tpu_torch.ops import oracle
    from parallel_convolution_tpu_torch.utils import imageio

    s, m, half, q = WINDOW, ITERS * filt.radius, side // 2, side // 4
    wins = [(0, 0), (0, side - s), (side - s, 0), (side - s, side - s),
            (half - s // 2, half - s // 2), (side - s, half - s // 2),
            (half - s // 2, side - s),
            # the 4x4 grid's seams: (16384, 16384) and (32768, 49152)
            (q - s // 2, q - s // 2), (half - s // 2, 3 * q - s // 2)]

    def one(win):
        y, x = win
        cy0, cx0 = max(0, y - m), max(0, x - m)
        cy1, cx1 = min(side, y + s + m), min(side, x + s + m)
        crop = imageio.read_block(src, side, side, "rgb", cy0, cy1, cx0, cx1)
        want = oracle.run_serial_u8(crop, filt, ITERS)[
            y - cy0:y - cy0 + s, x - cx0:x - cx0 + s]
        got = imageio.read_block(dst, side, side, "rgb", y, y + s, x, x + s)
        return bool((got == want).all())

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        ok = list(ex.map(one, wins))
    bad = [w for w, good in zip(wins, ok) if not good]
    check(not bad, f"config 4: windows {bad} differ from the NumPy oracle")
    return wins


def band_crcs(path: Path) -> list:
    """CRC32 of the file in 256 MB bands, one thread a band at a time."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    band = 256 << 20

    def crc(i):
        with open(path, "rb") as f:
            f.seek(i * band)
            return zlib.crc32(f.read(band))

    n = -(-path.stat().st_size // band)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        return list(ex.map(crc, range(n)))


def config4_kernel_rows(dev, side: int) -> dict:
    """K2 and K4 at config 4's shapes on the card, each beside its bound
    (``level_ops``, ``bound``): K2 T = 16 as the 1x1 run's second
    level-group launch (u8 in, u8 out; the first reads 0.1% more) and its
    T = 4 tail; K4 T = 16 on
    the 4x4 grid's 16 blocks (the exchange in the launch, 16 ghost rows
    out), K2 T = 16 on one such extended block, and K4's T = 4 tail.  The
    plain versions at these shapes would need more than the card's memory
    (their f32 levels): none is timed; no one PyTorch call runs T levels."""
    import torch

    from parallel_convolution_tpu_torch.ops import rdma, stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter

    f, r, C = get_filter("blur3"), 1, 3
    gen = torch.Generator(device=dev).manual_seed(4)
    u8 = dict(dtype=torch.uint8, device=dev)
    valid = (side, side)
    rows = {}

    def k2_row(T, hw, sep, reps=3):
        h, w = hw
        p = torch.randint(0, 256, (C, h + 2 * r * T, w + 2 * r * T),
                          generator=gen, **u8)
        kw = dict(quantize=True, out_dtype=torch.uint8, separable=sep)
        ms = cuda_ms(lambda: stencil.fused_iterate(p, (0, 0), f, T, valid,
                                                   **kw), reps=reps,
                     warmup=1)
        ops = sum(C * level_ops(f, sep, h + 2 * r * (T - s),
                                w + 2 * r * (T - s), True, True)
                  for s in range(1, T + 1))
        b_ms, b_by = bound(p.numel() + C * h * w, ops)
        del p
        torch.cuda.empty_cache()
        return dict(shape=[C, h + 2 * r * T, w + 2 * r * T], T=T,
                    separable=sep, ms=ms, bound_ms=b_ms, bound_by=b_by,
                    fraction_of_bound=b_ms / ms, plain_ms=None,
                    library_ms=None)

    def k4_row(T, ext, grid_shape, reps=3):
        nb = grid_shape[0] * grid_shape[1]
        h, w = side // grid_shape[0], side // grid_shape[1]
        x = torch.randint(0, 256, (nb, C, h, w), generator=gen, **u8)
        fire, out = rdma._bind(True, x, f, grid_shape, "zero", T, valid,
                               True, torch.uint8, ext, stencil.FUSED_TILE)
        ms = cuda_ms(fire, reps=reps, warmup=1)
        ops = nb * C * T * level_ops(f, False, h + 2 * ext, w + 2 * ext,
                                     True, False)
        b_ms, b_by = bound(x.numel() + out.numel(), ops)
        del x, out, fire
        torch.cuda.empty_cache()
        return dict(grid=list(grid_shape), block=[C, h, w], T=T, ext=ext,
                    ms=ms, bound_ms=b_ms, bound_by=b_by,
                    fraction_of_bound=b_ms / ms, plain_ms=None,
                    library_ms=None)

    rows["fused_iterate 1x1 T=16 group"] = k2_row(16, (side, side), True)
    rows["fused_iterate 1x1 T=4 tail"] = k2_row(4, (side, side), True)
    q = side // 4
    rows["rdma_tiled 4x4 T=16 group"] = k4_row(16, 16, (4, 4))
    rows["fused_iterate 4x4 block T=16 group"] = k2_row(16, (q, q), False,
                                                        reps=10)
    rows["rdma_tiled 4x4 T=4 tail"] = k4_row(4, 0, (4, 4))
    return rows


def config4_phase(dev, work: Path, totals: dict) -> dict:
    """BASELINE config 4 (3x3 blur, 65536x65536 RGB, 100 iterations) from a
    seeded file through ``run --sharded-io`` twice: (a) 1x1 ``cuda_sep`` u8
    fuse 32 (K2) and (b) 4x4 ``cuda_rdma`` u8 fuse 32 (K4 and K2), the
    counters at 0 before each and read after.  Oracle windows of (a)'s
    output file; (b)'s file byte-equal to (a)'s by CRC32 in bands; at most
    the input and one output on disk.  Its bands are read through the
    native reader (``main`` builds the library first)."""
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import halo
    from parallel_convolution_tpu_torch.utils import sharded_io

    room = machine_room(work)
    side = config4_side(room["disk_free_gb"] * 1e9)
    print("config 4 machine: " + json.dumps(room))
    if side != CONFIG4_SIDE:
        print(f"config 4 CUT: {side}x{side} RGB, not {CONFIG4_SIDE}: "
              f"{room['disk_free_gb']:.1f} GB free at {work} hold no "
              f"input and output of the full size")
    blur3 = get_filter("blur3")
    src, dst = work / "config4.raw", work / "config4.out.raw"
    report = {"side": side, "room": room,
              "write_input_s": write_seeded_raw(src, side, dev, seed=4)}
    px = 3 * side * side
    runs = {}
    for key, flags, expect, no_halo in (
            ("1x1 cuda_sep", ["--backend", "cuda_sep"],
             expected_launches(blur3, 32, (side, side)), False),
            ("4x4 cuda_rdma", ["--backend", "cuda_rdma", "--mesh", "4x4"],
             expected_rdma_launches(blur3, 32, (4, 4),
                                    (side // 4, side // 4)), True)):
        label = f"config 4 {side}x{side} rgb blur3 {key} u8 fuse 32"
        argv = ["run", str(src), str(side), str(side), str(ITERS), "rgb",
                "-o", str(dst), "--sharded-io", "--storage", "u8",
                "--fuse", "32", *flags]

        def run_cli():
            rc = cli_main(argv)
            check(rc == 0, f"{label}: the CLI exited {rc}")

        torch.cuda.reset_peak_memory_stats()
        io_s, rss = {}, {}
        with timed_sharded_io(io_s), host_rss_growth(rss):
            _, counts, secs = drive(label, run_cli, expect, px,
                                    no_halo=no_halo)
        # What the run added to the host's resident set at its peak: bands
        # of BAND_BYTES, never a block (12.9 GB at 1x1).
        growth = rss["growth"]
        check(growth < HOST_GROWTH_LIMIT,
              f"{label}: the host's resident set grew by {growth} B")
        for k, v in counts.items():
            totals[k] += v
        halo_calls = halo.halo_exchange.calls
        row = {"launches": counts, "halo_exchange_calls": halo_calls,
               "seconds_first": secs, "gpx_per_s_first": px * ITERS / secs
               / 1e9, "read_and_copy_in_s": io_s.get("load_sharded"),
               "copy_out_and_write_s": io_s.get("save_sharded"),
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "host_peak_growth_bytes": growth}
        if key.startswith("1x1"):
            t0 = time.perf_counter()
            row["windows"] = oracle_windows(src, dst, side, blur3)
            row["windows_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        row["crcs"] = band_crcs(dst)
        row["crc_s"] = time.perf_counter() - t0
        dst.unlink()
        runs[key] = row
    check(runs["1x1 cuda_sep"]["crcs"] == runs["4x4 cuda_rdma"]["crcs"],
          "config 4: the 4x4 cuda_rdma output differs from the 1x1 cuda_sep "
          "output")
    src.unlink()
    for row in runs.values():
        row["crcs"] = len(row["crcs"])
    report["runs"] = runs
    # main() built the native library first: the bands were read through it.
    report["reader"] = sharded_io.default_reader()
    check(report["reader"] == "native",
          f"config 4 read through the {report['reader']} reader")
    report["kernels"] = config4_kernel_rows(dev, side)
    k = report["kernels"]
    # Kernel time of each run: the launches it counted times the event time
    # at their shape (the 1x1 run's first group reads a slightly larger
    # block).  The last chunk's ITERS % 32 levels are one launch of the
    # kernel that starts a chunk (K2 at 1x1, K4 at 4x4); every other launch
    # runs a group of 16.
    tail = 1 if ITERS % 32 else 0
    c = runs["1x1 cuda_sep"]["launches"]
    runs["1x1 cuda_sep"]["kernels_s"] = (
        (c["fused_iterate"] - tail) * k["fused_iterate 1x1 T=16 group"]["ms"]
        + tail * k["fused_iterate 1x1 T=4 tail"]["ms"]) / 1e3
    c = runs["4x4 cuda_rdma"]["launches"]
    runs["4x4 cuda_rdma"]["kernels_s"] = (
        (c["rdma_tiled"] - tail) * k["rdma_tiled 4x4 T=16 group"]["ms"]
        + tail * k["rdma_tiled 4x4 T=4 tail"]["ms"]
        + c["fused_iterate"]
        * k["fused_iterate 4x4 block T=16 group"]["ms"]) / 1e3
    for row in runs.values():
        row["host_s"] = row["seconds_first"] - row["kernels_s"]
    return report


def ckpt_argv(src: Path, dst: Path, ck: Path, mesh_spec: str) -> list:
    return ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]), str(ITERS),
            "grey", "-o", str(dst), "--filter", "edge5", "--checkpoint",
            str(ck), "--checkpoint-every", str(CKPT_EVERY), "--backend",
            "cuda_rdma", "--mesh", mesh_spec]


def killed_run(argv: list, here: Path) -> dict:
    """The first process: the ``run`` CLI in a child process with a fault
    plan that tears the second snapshot; it must die with the fault."""
    env = dict(os.environ, PCTPU_FAULTS=f"checkpoint_write_shard:{CKPT_KILL}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "parallel_convolution_tpu_torch", *argv],
                          cwd=here, env=env, capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode != 0 and "injected fault at "
          f"'checkpoint_write_shard' (hit {CKPT_KILL}" in proc.stderr,
          f"checkpoint: the faulted process exited {proc.returncode} without "
          f"the injected fault: {proc.stderr[-2000:]}")
    return {"rc": proc.returncode, "seconds": time.perf_counter() - t0}


def checkpoint_phase(dev, tmp: Path, here: Path, refs: dict,
                     totals: dict) -> dict:
    """BASELINE config 3's image (8192x8192 grey edge5, 100 iterations) with
    ``--checkpoint --checkpoint-every 25 --backend cuda_rdma --mesh 4x4``:
    a child process dies in the second snapshot; this process resumes from
    iteration 25 (75 K4 launches), byte-equal to an uninterrupted
    ``--sharded-io`` run and to ``shifted``; a second torn run resumes on
    ``--mesh 2x2`` with the reshard warning and the same bytes; then
    ``save_state`` / ``load_state`` timed on the snapshot."""
    import warnings

    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils import checkpoint, imageio

    src = tmp / "edge5.raw"  # written by main_paths
    want = refs["grey_refs"]["edge5"]
    report = {}

    def resumed(label, argv, expect):
        def run():
            rc = cli_main(argv)
            check(rc == 0, f"{label}: the CLI exited {rc}")

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, counts, secs = drive(label, run, expect, BIG_HW[0] * BIG_HW[1])
        for k, v in counts.items():
            totals[k] += v
        check(np.array_equal(imageio.read_raw(argv[7], *BIG_HW, "grey"),
                             want), f"{label}: differs from shifted")
        return counts, secs, [str(w.message) for w in caught]

    def torn(ck):
        report.setdefault("killed", []).append(
            killed_run(ckpt_argv(src, tmp / "ck_dead.raw", ck, "4x4"), here))
        latest = (ck / checkpoint.LATEST_NAME).read_text()
        check(latest == f"it_{CKPT_EVERY:08d}",
              f"checkpoint: LATEST is {latest} after the kill")
        check(not (ck / f"it_{2 * CKPT_EVERY:08d}"
                   / checkpoint.META_NAME).exists(),
              "checkpoint: the torn snapshot has a meta")

    k4 = {"stencil_step": 0, "fused_iterate": 0, "rdma_block": 0}
    ck = tmp / "ck4"
    torn(ck)
    counts, secs, _ = resumed(
        "checkpoint resume 4x4 cuda_rdma from 25",
        ckpt_argv(src, tmp / "ck_resume.raw", ck, "4x4"),
        dict(k4, rdma_tiled=ITERS - CKPT_EVERY))
    report["resume"] = {"launches": counts, "seconds": secs}
    counts, secs, _ = resumed(
        "uninterrupted --sharded-io 4x4 cuda_rdma f32",
        ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]), str(ITERS), "grey",
         "-o", str(tmp / "ck_whole.raw"), "--filter", "edge5", "--sharded-io",
         "--backend", "cuda_rdma", "--mesh", "4x4"],
        dict(k4, rdma_tiled=ITERS))
    report["uninterrupted"] = {"launches": counts, "seconds": secs}
    check((tmp / "ck_resume.raw").read_bytes()
          == (tmp / "ck_whole.raw").read_bytes(),
          "checkpoint: the resumed run differs from the uninterrupted one")

    ck2 = tmp / "ck2"
    torn(ck2)
    counts, secs, caught = resumed(
        "checkpoint resume onto 2x2 from 25",
        ckpt_argv(src, tmp / "ck_2x2.raw", ck2, "2x2"),
        dict(k4, rdma_tiled=ITERS - CKPT_EVERY))
    check(any(f"from grid 4x4 onto 2x2" in m for m in caught),
          f"checkpoint: no reshard warning in {caught}")
    report["reshard"] = {"launches": counts, "seconds": secs,
                         "warnings": caught}

    # save_state / load_state on the 4x4 snapshot, timed.
    grid = make_grid((4, 4), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks, meta = checkpoint.load_state(ck, grid)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    checkpoint.save_state(tmp / "ck_saved", blocks, meta)
    save_s = time.perf_counter() - t0
    report.update(load_s=load_s, save_s=save_s, snapshot_bytes=sum(
        s["bytes"] for s in meta["shards"].values()),
        snapshot=f"it_{meta['iters_done']:08d}")
    return report


def fallback_phase(dev, tmp: Path, refs: dict, totals: dict) -> dict:
    """``--fallback`` on BASELINE config 3's image: with
    ``PCTPU_FAULTS=backend_compile:1`` ``cuda_rdma`` degrades to ``cuda``
    (warned, named in the summary line, the same bytes); without a fault
    every ``--fallback`` run keeps the backend asked for (the probe ran
    the real kernel at the real block size: its launches are counted);
    with every tier refused the walk stops at ``cuda`` and raises, with no
    launch; and a real refused launch (5b over the opt-in limit) is named
    by the runtime and classifies as transient, a canary launch after it
    passing."""
    import warnings

    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.ops import _build, rdma, stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.probes import smem_budget
    from parallel_convolution_tpu_torch.resilience import (
        degrade, faults, retry,
    )
    from parallel_convolution_tpu_torch.utils import imageio

    src, want = tmp / "edge5.raw", refs["grey_refs"]["edge5"]
    edge5 = get_filter("edge5")
    block = (BIG_HW[0] // 4, BIG_HW[1] // 4)
    report = {}

    def plus(run, probe):
        return {k: run.get(k, 0) + probe.get(k, 0) for k in KERNELS}

    # bf16, fuse 32 (--fast's).  Each run's launches are its own plus the
    # probe's one 32-level chunk at the real block.
    rdma_groups = len(rdma.rdma_plan(edge5.radius, 32, block).groups)
    k2_groups = lambda hw: len(stencil.fused_plan(edge5.radius, 32, hw)[2])
    on_grid = {k: 16 * v for k, v in
               expected_launches(edge5, 32, block).items()}

    def run(label, flags, expect, fault=None):
        dst = tmp / "fallback.raw"
        argv = ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]), str(ITERS),
                "grey", "-o", str(dst), "--filter", "edge5", "--storage",
                "bf16", "--fuse", "32", "--fallback", *flags]
        degrade.clear_probe_cache()
        if fault:
            os.environ["PCTPU_FAULTS"] = fault
        out = io.StringIO()

        def call():
            with contextlib.redirect_stdout(out):
                rc = cli_main(argv)
            check(rc == 0, f"{label}: the CLI exited {rc}")

        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _, counts, secs = drive(label, call, expect,
                                        BIG_HW[0] * BIG_HW[1],
                                        no_halo="cuda_rdma" in flags
                                        and not fault)
        finally:
            os.environ.pop("PCTPU_FAULTS", None)
            faults.uninstall_plan()
            degrade.clear_probe_cache()
        for k, v in counts.items():
            totals[k] += v
        line = out.getvalue().strip().splitlines()[-1]
        print(f"{label}: {line}")
        check(np.array_equal(imageio.read_raw(dst, *BIG_HW, "grey"), want),
              f"{label}: differs from shifted")
        return {"launches": counts, "seconds": secs, "summary": line,
                "warnings": [str(w.message)[:160] for w in caught
                             if issubclass(w.category,
                                           degrade.BackendDegradedWarning)]}

    report["cuda_rdma"] = run(
        "fallback cuda_rdma 4x4, no fault",
        ["--backend", "cuda_rdma", "--mesh", "4x4"],
        plus(expected_rdma_launches(edge5, 32, (4, 4), block),
             {"rdma_tiled": 1, "fused_iterate": 16 * (rdma_groups - 1)}))
    report["cuda_sep"] = run(
        "fallback cuda_sep 1x1, no fault", ["--backend", "cuda_sep"],
        plus(expected_launches(edge5, 32, BIG_HW),
             {"fused_iterate": k2_groups(BIG_HW)}))
    for key, name in (("cuda_rdma", "cuda_rdma"), ("cuda_sep", "cuda_sep")):
        r = report[key]
        check(f"({name}, bf16, fuse 32," in r["summary"]
              and not r["warnings"],
              f"fallback: {name} did not stay {name}: {r}")
    # The fault fails the cuda_rdma probe's build (no launch); the cuda
    # probe runs one chunk on every block, then the run on cuda.
    report["degraded"] = run(
        "fallback cuda_rdma 4x4, backend_compile:1",
        ["--backend", "cuda_rdma", "--mesh", "4x4"],
        plus(on_grid, {"fused_iterate": 16 * k2_groups(block)}),
        fault="backend_compile:1")
    r = report["degraded"]
    check("(cuda_rdma degraded to cuda, bf16, fuse 32," in r["summary"]
          and any("'cuda_rdma' degraded to 'cuda'" in w
                  for w in r["warnings"]),
          f"fallback: the injected fault did not degrade to cuda: {r}")

    # Every tier refused on the card: the walk stops at cuda and raises;
    # nothing runs the plain version in a kernel's place, nothing launches.
    stencil.reset_launch_counts()
    degrade.clear_probe_cache()
    stopped = None
    try:
        with faults.injected("backend_compile:*"):
            degrade.resolve_backend(mesh.make_grid((4, 4), dev), edge5,
                                    "cuda_rdma", fuse=32, storage="bf16",
                                    block_hw=block)
    except retry.RetryExhausted as e:
        stopped = e
    finally:
        degrade.clear_probe_cache()
    launched = sum(stencil.launch_counts().values())
    check(stopped is not None and launched == 0,
          f"fallback: every tier refused on the card gave {stopped!r} "
          f"after {launched} launches, not RetryExhausted after none")
    report["every_tier_refused"] = {"error": str(stopped)[:160],
                                    "launches": launched}

    # A real refused launch: 5b asks for one byte over the opt-in limit.
    x = torch.ones(256, device=dev)
    _, attr, err = smem_budget.smem_probe(x, stencil._smem_limit(dev) + 1,
                                          True)
    code = attr or err
    check(code != 0, "fallback: the over-limit 5b launch was not refused")
    try:
        stencil._raise_on(code, "smem_probe (5b)")
    except RuntimeError as e:
        refused = e
    verdict = retry.classify(refused)
    # The names come from the runtime (pc_error_name), and the stand-ins
    # used before a library loads agree with it.
    lib = _build.load_library("probes")
    stand_ins = {c: lib.pc_error_name(c).decode()
                 for c in _build.FALLBACK_ERROR_NAMES}
    check(stand_ins == _build.FALLBACK_ERROR_NAMES,
          f"fallback: the runtime names {stand_ins} differ from the "
          f"stand-ins")
    out, attr, err = smem_budget.smem_probe(x, 0, False)
    torch.cuda.synchronize()
    canary = (attr, err) == (0, 0) and bool(torch.equal(out, x + 1))
    check(verdict == retry.TRANSIENT and canary,
          f"fallback: the refused launch ({refused}) classified {verdict}, "
          f"canary {'passed' if canary else 'failed'}")
    report["refused_launch"] = {"error": str(refused), "class": verdict,
                                "canary_ok": canary}
    return report


# ---------------------------------------------------------------------------
# Phase 6: the probes (TPU kernel 5)
# ---------------------------------------------------------------------------


def probe_phase(dev) -> dict:
    """5a, 5b and 5c on the card, every row printed; returns each probe's
    entry of the kernels line (launches: the probe phase's own count)."""
    import torch

    from parallel_convolution_tpu_torch import probes
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.probes import (
        op_price, rdma_ladder, smem_budget,
    )

    probes.reset_launch_counts()
    price = op_price.measure(dev)
    for row in price:
        print("probe op_price: " + json.dumps(row))
    check([(r["op"], r["dtype"]) for r in price]
          == [c[:2] for c in op_price.CANDIDATES],
          "op_price: a candidate gave no row")
    check(all(r["correct"] for r in price),
          "op_price: a chain differs from its plain version")
    fma = price[0]
    check(2 * fma["gops_per_s"] * 1e9 <= 1.05 * FP32_OPS_PER_S,
          f"op_price: f32 FMA at {2 * fma['gops_per_s']:.0f} Gop/s, above "
          f"105% of the card's {FP32_OPS_PER_S / 1e9:.0f}")

    budget = smem_budget.measure(dev)
    for row in budget:
        print("probe smem_budget: " + json.dumps(row))
        want = "ok" if row["fits"] else "clean_refusal"
        check(row["error_class"] == want and (row["correct"] or not row["fits"]),
              f"smem_budget: {row['bytes']} B opt_in={row['opt_in']} gave "
              f"{row['error_class']}, expected {want}")
    x = (torch.arange(smem_budget.SHAPE[0] * smem_budget.SHAPE[1],
                      dtype=torch.float32, device=dev)
         .reshape(smem_budget.SHAPE) % 251.0)
    probe_ms = cuda_ms(lambda: smem_budget.smem_probe(x, 100 * 1024, True),
                       reps=50)
    probe_plain_ms = cuda_ms(lambda: smem_budget.smem_probe_plain(x), reps=50)
    probe_lib_ms = cuda_ms(lambda: torch.add(x, 1.0), reps=50)
    # The same two calls queued ahead of the card: each one's device time.
    probe_dev_ms = cuda_ms(
        lambda: smem_budget.smem_probe(x, 100 * 1024, True), reps=200,
        warmup=20, queue_ahead=True)
    probe_lib_dev_ms = cuda_ms(lambda: torch.add(x, 1.0), reps=200,
                               warmup=20, queue_ahead=True)
    print("probe smem_probe times: " + json.dumps(dict(
        shape=list(smem_budget.SHAPE), bytes=100 * 1024, ms=probe_ms,
        device_ms=probe_dev_ms, add_ms=probe_lib_ms,
        add_device_ms=probe_lib_dev_ms,
        bound_ms=bound(2.0 * x.numel() * 4, float(x.numel()))[0],
        parent=SMEM_PARENT_MS)))
    got = smem_budget.smem_probe(x, 100 * 1024, True)[0]
    probe_err = max_abs_err(got, smem_budget.smem_probe_plain(x))

    ladder = rdma_ladder.measure(dev)
    for row in ladder:
        print("probe rdma_ladder: " + json.dumps(row))
        check(row["built"] and row["correct"],
              f"rdma_ladder {row['rung']}: built {row['built']}, "
              f"correct {row['correct']}")
    check(ladder[-1]["equal_k4"], "rdma_ladder r3 differs from K4")
    counts = probes.launch_counts()

    n = fma["elems"]
    b_fma = bound(4.0 * n * (1 + op_price.CHAINS),
                  2.0 * n * op_price.CHAINS * op_price.STEPS)
    b_probe = bound(2.0 * x.numel() * 4, float(x.numel()))
    nb, C, h, w = ladder[-1]["shape"]
    blur3 = get_filter(rdma_ladder.FILTER)
    b_ladder = bound(2.0 * nb * C * h * w * 2,
                     nb * C * rdma_ladder.T_LEVELS
                     * level_ops(blur3, False, h, w, True, False))
    # library_ms: one PyTorch call of the same function, where there is one
    # (out = in + 1 is torch.add); none runs a 128-step chain or T levels.
    entries = {
        "op_chain": dict(ms=fma["ms"], plain_ms=fma["plain_ms"],
                         max_abs_err=fma["max_abs_err"], bound=b_fma,
                         library_ms=None),
        "smem_probe": dict(ms=probe_ms, plain_ms=probe_plain_ms,
                           max_abs_err=probe_err, bound=b_probe,
                           library_ms=probe_lib_ms),
        "rdma_ladder": dict(ms=ladder[-1]["ms"], plain_ms=ladder[-1]["plain_ms"],
                            max_abs_err=ladder[-1]["max_abs_err"],
                            bound=b_ladder, library_ms=None),
    }
    for name, e in entries.items():
        e["launches"] = counts[name]
    print(f"probe launches: {counts}")
    return {"entries": entries, "op_price": price, "ladder": ladder}


def time_host_calls(dev, n: int = 400) -> dict:
    """Host seconds per K1 wrapper call and per eager PyTorch op (a slice
    copy), each on a tiny block so the card is idle: the cost model's
    ``launch_s`` and ``op_s``."""
    import torch

    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter

    blur3 = get_filter("blur3")
    p = torch.zeros((1, 10, 10), device=dev)
    a, b = torch.zeros((1, 12, 12), device=dev), torch.ones((1, 10, 10),
                                                            device=dev)

    def per_call(fn):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    before = stencil.stencil_step.launches
    launch_s = per_call(lambda: stencil.stencil_step(
        p, blur3, quantize=True, out_dtype=p.dtype))
    stencil.stencil_step.launches = before  # not main-path launches

    def copy():
        a[:, 1:11, 1:11] = b

    return {"launch_s": launch_s, "op_s": per_call(copy), "calls": n}


def hardware_constants(k1, k2, k4, price, host) -> dict:
    """``tuning.costmodel.H100``'s constants as this run measures them."""
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.tuning import costmodel

    blur3 = get_filter("blur3")
    rows = {(r["op"], r["dtype"]): r for r in price}
    step = lambda op: rows[(op, "f32")]["per_step_vs_f32_fma"]  # noqa: E731
    q = 2 * (step("magicround+add") - step("add"))
    q_rint = 2 * (step("rint+add") - step("add"))

    def slots_rate(pixels, T, tile, sep, ms):
        """The model's executed slots for T levels over ``pixels`` in
        ``tile`` tiles, per second of the kernel's time."""
        slots = costmodel.flops_per_px_iter(blur3.size, sep, True, T, tile,
                                            blur3.radius, q)
        return slots * pixels * T / (ms / 1e3) / 1e9

    C, Hp, Wp = k2["shape"]
    d = blur3.radius * k2["T"]
    k2_px = C * (Hp - 2 * d) * (Wp - 2 * d)
    k4_px = k4["grid"][0] * k4["grid"][1] * k4["block"][0] * k4["block"][1] \
        * k4["block"][2]
    # The memory rate from K1's device time: its wrapper-call time counts
    # the host too.
    return {"hbm_gbps": k1["device_gbps"],
            "flop_gops": 2 * rows[("fma", "f32")]["gops_per_s"],
            "tap_gops": slots_rate(k4_px, k4["T"], stencil.FUSED_TILE,
                                   False, k4["ms"]),
            "sep_tap_gops": slots_rate(k2_px, k2["T"], tuple(k2["tile"]),
                                       True, k2["ms"]),
            "quantize_slots": q, "rint_quantize_slots": q_rint,
            "launch_s": host["launch_s"], "op_s": host["op_s"]}


# ---------------------------------------------------------------------------
# Phase 7: backend="auto" and a measured tune
# ---------------------------------------------------------------------------


def auto_paths(dev, tmp: Path, refs: dict, rows: list, totals: dict) -> list:
    """The four auto runs, each byte-equal to shifted and (3 iterations)
    to the oracle, printed with its Resolution beside the explicit path
    at the same grid."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch import tuning
    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import oracle
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils import imageio

    os.environ.pop(tuning.PLAN_FILE_ENV, None)  # the model, not a plan file
    by_label = {r["path"]: r for r in rows}
    hw = "x".join(map(str, RGB_HW))
    rgb, grey = refs["rgb"], refs["greys"]["blur3"]
    out_rows = []

    def report(label, res, counts, pixels, first, warm, resident, explicit):
        for k, v in counts.items():
            totals[k] += v
        row = {"path": label, "resolution": {
            "backend": res.backend, "fuse": res.fuse,
            "tile": list(res.tile) if res.tile else None,
            "source": res.source, "predicted_gpx": res.predicted_gpx},
            "launches": counts}
        for key, secs in (("first", first), ("warm", warm),
                          ("resident", resident)):
            row[f"gpx_per_s_{key}"] = (None if secs is None
                                       else pixels * ITERS / secs / 1e9)
        ex = by_label[explicit]
        row["explicit"] = {"path": explicit, **{
            f"gpx_per_s_{k}": ex[f"gpx_per_s_{k}"]
            for k in ("first", "warm", "resident")}}
        print("auto: " + json.dumps(row))
        out_rows.append(row)

    blur3, edge5 = get_filter("blur3"), get_filter("edge5")
    for grid_shape, storage, img, ref, explicit in (
            ((1, 1), "bf16", rgb, refs["rgb_ref"],
             f"rgb {hw} blur3 cuda_sep bf16 fuse 32"),
            ((2, 2), "bf16", rgb, refs["rgb_ref"],
             f"rgb {hw} blur3 cuda_rdma bf16 fuse 32 grid 2x2"),
            (GREY_GRID, "u8", grey, refs["grey_refs"]["blur3"],
             f"grey {hw} blur3 cuda_rdma u8 fuse 8 grid "
             f"{GREY_GRID[0]}x{GREY_GRID[1]}")):
        grid = make_grid(grid_shape, dev)
        model = ConvolutionModel("blur3", grid=grid, backend="auto",
                                 storage=storage, fuse=None)
        planar = torch.from_numpy(imageio.interleaved_to_planar(img).copy())
        shape = tuple(planar.shape)
        res = tuning.resolve(grid, blur3, shape, storage=storage)
        label = (f"auto {'rgb' if shape[0] == 3 else 'grey'} {hw} blur3 "
                 f"{storage} grid {grid_shape[0]}x{grid_shape[1]}")
        out, counts, secs = drive(
            label, lambda: model.run_image(img, ITERS),
            expected_for(res, blur3, grid_shape, shape), shape[0] * RGB_HW[0]
            * RGB_HW[1], no_halo=res.backend == "cuda_rdma")
        check(model.resolution == res,
              f"{label}: resolved {model.resolution}, expected {res}")
        check(np.array_equal(out, ref), f"{label}: differs from shifted")
        check(np.array_equal(model.run_image(img, 3),
                             oracle.run_serial_u8(img, blur3, 3)),
              f"{label}: 3 iterations differ from the NumPy oracle")
        _, warm = host_seconds(lambda: model.run_image(img, ITERS))
        resident_in = planar.to(device=dev, dtype=torch.float32)
        _, resident = host_seconds(lambda: model.run_planar(resident_in,
                                                            ITERS))
        report(label, res, counts, shape[0] * RGB_HW[0] * RGB_HW[1], secs,
               warm, resident, explicit)

    # The CLI with an explicit --backend auto and --fast: storage bf16 and
    # fuse 32 fill in, auto tunes backend and tile.
    src, dst = tmp / "edge5.raw", tmp / "edge5.auto.raw"
    label = (f"cli run grey {BIG_HW[0]}x{BIG_HW[1]} edge5 --backend auto "
             "--mesh 4x4 --fast")
    argv = ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]), str(ITERS),
            "grey", "-o", str(dst), "--filter", "edge5", "--backend", "auto",
            "--mesh", "4x4", "--fast"]

    def run_cli():
        rc = cli_main(argv)
        check(rc == 0, f"{label}: the CLI exited {rc}")

    grid4 = make_grid((4, 4), dev)
    res = tuning.resolve(grid4, edge5, (1, *BIG_HW), storage="bf16", fuse=32)
    _, counts, secs = drive(label, run_cli,
                            expected_for(res, edge5, (4, 4), (1, *BIG_HW)),
                            BIG_HW[0] * BIG_HW[1],
                            no_halo=res.backend == "cuda_rdma")
    check(np.array_equal(imageio.read_raw(dst, *BIG_HW, "grey"),
                         refs["grey_refs"]["edge5"]),
          f"{label}: differs from shifted")
    crop = refs["greys"]["edge5"][:ORACLE_CROP, :ORACLE_CROP]
    small = ConvolutionModel("edge5", grid=grid4, backend="auto",
                             storage="bf16", fuse=32)
    check(np.array_equal(small.run_image(crop, 3),
                         oracle.run_serial_u8(crop, edge5, 3)),
          f"{label}: 3 iterations on {crop.shape} differ from the oracle")
    _, warm = host_seconds(run_cli)
    report(label, res, counts, BIG_HW[0] * BIG_HW[1], secs, warm, None,
           f"cli run grey {BIG_HW[0]}x{BIG_HW[1]} edge5 --backend cuda_rdma "
           "--mesh 4x4 --fast")
    return out_rows


def run_tune(argv: list, label: str) -> tuple[dict, list]:
    """The ``tune`` subcommand in this process: its summary and its
    measured rows, each printed; no row may be an error."""
    from parallel_convolution_tpu_torch.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    rows = []
    for line in err.getvalue().splitlines():
        print(f"tune {label} row: {line}")
        if line.startswith("{"):
            rows.append(json.loads(line))
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and lines != [], f"tune {label} exited {rc}")
    summary = json.loads(lines[-1])
    print(f"tune {label} summary: " + json.dumps(summary))
    check(summary["errors"] == 0 and summary["measured_points"] >= 1,
          f"tune {label}: {summary['errors']} error rows, "
          f"{summary['measured_points']} measured")
    return summary, rows


def tune_auto_grids(tmp: Path) -> list:
    """A measured tune (4 candidates, 32 iterations each) at each auto
    grid: the model's pick (the shortlist's first row) beside the measured
    winner, on the same measurement."""
    out = []
    for rows_, cols_, mode, name, storage, mesh_, fuses in (
            (*RGB_HW, "rgb", "blur3", "bf16", "1x1", None),
            (*RGB_HW, "rgb", "blur3", "bf16", "2x2", None),
            (*BIG_HW, "grey", "edge5", "bf16", "4x4", "32"),
            (*RGB_HW, "grey", "blur3", "u8",
             f"{GREY_GRID[0]}x{GREY_GRID[1]}", None)):
        label = f"{mode} {rows_}x{cols_} {name} {storage} grid {mesh_}"
        argv = ["tune", "--rows", str(rows_), "--cols", str(cols_), "--mode",
                mode, "--filter", name, "--storage", storage, "--mesh", mesh_,
                "--iters", "32", "--max-measure", "4"]
        summary, rows = run_tune(argv + (["--fuses", fuses] if fuses else []),
                                 label)
        pick, best = rows[0], max(rows, key=lambda r: r["gpixels_per_s_per_chip"])
        row = {"grid": label,
               "pick": {k: pick[k] for k in ("effective_backend", "fuse",
                                             "tile", "gpixels_per_s_per_chip",
                                             "predicted_gpx_per_chip")},
               "winner": {k: best[k] for k in ("effective_backend", "fuse",
                                               "tile", "gpixels_per_s_per_chip",
                                               "predicted_gpx_per_chip")},
               "winner_over_pick": best["gpixels_per_s_per_chip"]
               / pick["gpixels_per_s_per_chip"]}
        print("pick vs measured winner: " + json.dumps(row))
        out.append(row)
    return out


def measured_tune(dev, tmp: Path, refs: dict, totals: dict) -> dict:
    """``tune`` the RGB 2x2 bf16 workload on the card (4 candidates, each
    at least one full chunk), ``--verify-auto``, then ``auto`` through the
    plan file must resolve to the measured winner, byte-equal to shifted."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch import tuning
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils import imageio

    plans = tmp / "plans.json"
    summary, _ = run_tune(
        ["tune", "--rows", str(RGB_HW[0]), "--cols", str(RGB_HW[1]),
         "--mode", "rgb", "--filter", "blur3", "--storage", "bf16",
         "--mesh", "2x2", "--iters", "32", "--max-measure", "4",
         "--emit-plans", "--out", str(plans), "--verify-auto"],
        "rgb 2x2 --emit-plans")
    check(summary["auto_ok"], "tune --verify-auto did not round-trip")
    plan = summary["plan"]
    check(plan["source"] == "measured", f"tune plan {plan}")

    os.environ[tuning.PLAN_FILE_ENV] = str(plans)
    try:
        blur3 = get_filter("blur3")
        grid = make_grid((2, 2), dev)
        model = ConvolutionModel("blur3", grid=grid, backend="auto",
                                 storage="bf16", fuse=None)
        res = tuning.resolve(grid, blur3, (3, *RGB_HW), storage="bf16")
        label = "auto rgb blur3 bf16 grid 2x2 through the measured plan file"
        out_img, counts, secs = drive(
            label, lambda: model.run_image(refs["rgb"], ITERS),
            expected_for(res, blur3, (2, 2), (3, *RGB_HW)),
            3 * RGB_HW[0] * RGB_HW[1], no_halo=res.backend == "cuda_rdma")
    finally:
        os.environ.pop(tuning.PLAN_FILE_ENV, None)
    for k, v in counts.items():
        totals[k] += v
    got = model.resolution
    check(got.source == "measured"
          and [got.backend, got.fuse, list(got.tile) if got.tile else None]
          == [plan["backend"], plan["fuse"], plan["tile"]],
          f"{label}: resolved {got}, the plan file holds {plan}")
    check(np.array_equal(out_img, refs["rgb_ref"]),
          f"{label}: differs from shifted")
    os.environ[tuning.PLAN_FILE_ENV] = str(plans)
    try:
        _, warm = host_seconds(lambda: model.run_image(refs["rgb"], ITERS))
        planar = torch.from_numpy(imageio.interleaved_to_planar(
            refs["rgb"]).copy()).to(device=dev, dtype=torch.float32)
        _, resident = host_seconds(lambda: model.run_planar(planar, ITERS))
    finally:
        os.environ.pop(tuning.PLAN_FILE_ENV, None)
    px = 3 * RGB_HW[0] * RGB_HW[1] * ITERS / 1e9
    return {"plan": plan, "resolution": [got.backend, got.fuse, got.tile,
                                         got.source],
            "launches": counts, "gpx_per_s_first": px / secs,
            "gpx_per_s_warm": px / warm, "gpx_per_s_resident": px / resident}


def supervised_on_cards(tmp: Path, here: Path, refs: dict) -> dict:
    """Phase 4l's supervised config 3 leg on the machine's own cards (no
    ``PCTPU_SIM_DEVICES``: the device probe counts the real ones): its
    4x4 attempt over every card dies in the second snapshot, the
    supervisor reshapes onto 2x2 (a slot a card) and the resumed leg
    gives ``shifted``'s bytes."""
    import numpy as np

    from parallel_convolution_tpu_torch.resilience import supervisor
    from parallel_convolution_tpu_torch.utils import imageio

    work = tmp / "supervised_cards"
    work.mkdir()
    sup_dir, ck = work / "supervised", work / "ck"
    dst, launches = work / "supervised.raw", work / "launches.jsonl"
    argv = ["run", str(tmp / "edge5.raw"), str(BIG_HW[0]), str(BIG_HW[1]),
            str(ITERS), "grey", "-o", str(dst), "--filter", "edge5",
            "--backend", "cuda_rdma", "--device", "all", "--checkpoint",
            str(ck), "--checkpoint-every", str(CKPT_EVERY)]
    legs = work / "legs.json"
    legs.write_text(json.dumps([{
        "name": "config3", "cmd": [sys.executable, "-c", LEG_SRC, *argv],
        "done_file": str(dst), "timeout": 600,
        "env": {"SMOKE_LAUNCHES": str(launches),
                "SMOKE_KILL_AT": str(CKPT_KILL)},
        "meshes": SUPERVISOR_LADDER,
        "reshape_pattern": "injected fault at 'checkpoint_write_shard'"}]))
    env = dict(os.environ)
    env.pop("PCTPU_SIM_DEVICES", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m",
         "parallel_convolution_tpu_torch.resilience.supervisor", "--legs",
         str(legs), "--state-dir", str(sup_dir), "--max-attempts", "3",
         "--base-delay", "0.1", "--max-delay", "0.1"],
        cwd=here, env=env, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"supervisor on the cards exited "
          f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    leg = supervisor.read_ledger(sup_dir / supervisor.LEDGER_NAME)[
        "legs"]["config3"]
    attempts = [json.loads(line)
                for line in launches.read_text().splitlines()]
    check(leg["state"] == "done" and leg["mesh"] == "2x2"
          and [(a["mesh"], a["rc"]) for a in attempts] == [("4x4", 1),
                                                           ("2x2", 0)]
          and attempts[1]["launches"]["rdma_tiled_slot"]
          == (ITERS - CKPT_EVERY) * 4
          and np.array_equal(imageio.read_raw(dst, *BIG_HW, "grey"),
                             refs["grey_refs"]["edge5"]),
          f"supervisor on the cards: ledger {leg}, attempts "
          f"{[(a['mesh'], a['rc']) for a in attempts]}, or the output "
          "differs from shifted")
    return {"seconds": secs, "leg": {k: leg[k] for k in (
        "state", "attempts", "mesh", "reshapes", "last_rc")},
        "attempts": attempts}


# ``--cards``' phases after their references, by name.
CARD_PHASES = ("4jg", "4l", "4h", "4i")


def cards_main(here: Path, card: str, phases: list) -> None:
    """``chip_smoke.py --cards``: on a machine with several cards, the
    phases that run across cards, each with what it needs built first:
    the build, the main paths (the ``shifted`` references), 4b (config 1's
    converge, config 5's field), 4d (config 5's plain V-cycle), 4j (a)
    (its one-card V-cycle), then 4j (g), 4l's supervised leg on the real
    cards (:func:`supervised_on_cards`), 4h and 4i (their ``all``
    layouts), each of the last four run whatever the one before it did
    (a failure is printed and fails the run at its end), and only those
    of them named in ``phases`` (:data:`CARD_PHASES`); every row printed,
    and 4j (g)'s kernels rows as the kernels line gives them."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.native import build as nbuild
    from parallel_convolution_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    nbuild.build()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda", 0)
    laps, last = {}, time.perf_counter()

    def lap(name):
        nonlocal last
        laps[name], last = time.perf_counter() - last, time.perf_counter()
        print(f"phase {name}: {laps[name]:.2f} s", flush=True)

    failed = []
    check(set(phases) <= set(CARD_PHASES),
          f"--cards runs {CARD_PHASES}, not {phases}")

    def attempt(name, fn):
        """``fn()``, its failure kept (and printed) so that the phases
        after it still run; any failure fails the run at its end."""
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 -- the run fails at its end
            import traceback

            traceback.print_exc()
            print(f"chip_smoke --cards: {name} FAILED: "
                  f"{type(e).__name__}: {e}", flush=True)
            failed.append(f"{name}: {type(e).__name__}: {e}")
            return None
        finally:
            lap(name)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        totals, _, refs = main_paths(dev, tmp)
        lap("4 main paths")
        keep = {}
        converge_rows = converge_phase(dev, tmp, totals, keep)
        lap("4b converge")
        mg_rows = multigrid_phase(dev, tmp, totals, keep["config5"],
                                  converge_rows[0], keep)
        lap("4d multigrid")
        field, mg_shifted = keep.pop("config5"), keep.pop("mg_shifted")
        mg4j = multigrid_slots_leg(dev, totals, field, mg_shifted, card)
        lap("4j (a)")
        work = here / "build" / "chip_smoke_processes"
        work.mkdir(parents=True, exist_ok=True)
        field_path = work / "config5.npy"
        np.save(field_path, field.cpu().numpy())
        del field
        torch.cuda.empty_cache()
        cards = sup = slots = overlap = None
        try:
            if "4jg" in phases:
                cards = attempt("4j (g)", lambda: cards_phase(
                    dev, tmp, here, work, refs, totals, field_path,
                    mg_shifted, mg4j, keep["cli_converge"], []))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        if "4l" in phases:
            sup = attempt("4l supervised on the cards",
                          lambda: supervised_on_cards(tmp, here, refs))
        if "4h" in phases:
            slots = attempt("4h slots", lambda: separate_devices_phase(
                dev, tmp, refs, totals, keep))
        if "4i" in phases:
            overlap = attempt("4i overlap", lambda: overlap_phase(
                dev, tmp, refs, totals, keep))
    if sup is not None:
        print("supervised config 3 on the cards: " + json.dumps(
            dict(sup, card=card)))
    slot_timed = {"kernels": {}}
    if slots is not None:
        for row in slots.pop("runs"):
            print("end to end separate devices: " + json.dumps(row))
        slot_timed = slots.pop("timed")
        for name, row in slot_timed["kernels"].items():
            print(f"time {name}: " + json.dumps(row))
    if overlap is not None:
        for row in overlap.pop("runs"):
            print("end to end overlap: " + json.dumps(row))
    for row in mg4j + mg_rows:
        print("end to end multigrid: " + json.dumps(row))
    kernels = []
    if cards is not None:
        for row in cards.pop("rows"):
            print("end to end 4j one card a process: " + json.dumps(row))
        kernels = [{
            "name": name, "route": "cuda", "source": SOURCES[t["base"]],
            "replaces": REPLACES[t["base"]], "launches": t["launches"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": slot_timed["kernels"].get(t["base"], {}).get(
                "plain_ms"),
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None} for name, t in cards.pop("timed").items()]
    print("phase seconds: " + json.dumps(laps))
    print(json.dumps({"kernels": kernels}))
    check(not failed, f"--cards: {len(failed)} phase(s) failed: {failed}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    try:
        import parallel_convolution_tpu_torch as port
        from parallel_convolution_tpu_torch.native import build as nbuild
        from parallel_convolution_tpu_torch.ops import _build, stencil
        from parallel_convolution_tpu_torch.ops.filters import get_filter
        from parallel_convolution_tpu_torch.utils import imageio
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1
    if Path(port.__file__).resolve().parent.parent != here:
        # An installed copy elsewhere is not the checkout under test.
        print(f"chip_smoke: the port imported from {port.__file__}, not from "
              f"the checkout at {here}", file=sys.stderr)
        return 1

    start = last = time.perf_counter()
    laps = {}

    def lap(name: str) -> None:
        """The seconds since the previous lap, under ``name``."""
        nonlocal last
        now = time.perf_counter()
        laps[name] = now - last
        last = now
        print(f"phase {name}: {laps[name]:.2f} s", flush=True)

    try:
        card = card_line()
        print(f"card: {card}")
        dev = torch.device("cuda", 0)
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}")
        if sys.argv[1:2] == ["--cards"]:
            cards_main(here, card, sys.argv[2:] or list(CARD_PHASES))
            print(f"card: {card}")
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}))
            return 0

        t0 = time.perf_counter()
        built = _build.build_all()
        each = ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in built.items())
        print(f"build: {time.perf_counter() - t0:.2f} s "
              f"({each or 'up to date'})")
        # The g++ baseline before any file is read: every load_sharded of
        # this process (config 4's included) then reads through the native
        # reader, whatever an earlier run left under build/.
        t0 = time.perf_counter()
        nbuild.build()
        native_s = time.perf_counter() - t0
        print(f"native build: {native_s:.2f} s")
        for name in _build.SOURCES:
            _build.load_library(name)
        print_ptxas()
        lap("2 build")

        check_kernels(dev)
        check_rdma_kernels(dev)
        lap("3 kernel checks")
        probe = probe_phase(dev)
        lap("6 probes")

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            totals, rows, refs = main_paths(dev, Path(tmp))
            lap("4 main paths")
            split_rows = interior_split_phase(dev, refs, totals)
            lap("4f interior split")
            torch.cuda.empty_cache()
            work = here / "build" / "chip_smoke_volume"
            try:
                volume = volume_phase(dev, work)
            finally:
                shutil.rmtree(work, ignore_errors=True)
            lap("4g volumes")
            torch.cuda.empty_cache()
            keep = {}
            converge_rows = converge_phase(dev, Path(tmp), totals, keep)
            lap("4b converge")
            slots = separate_devices_phase(dev, Path(tmp), refs, totals,
                                           keep)
            lap("4h slots")
            t0 = time.perf_counter()
            overlap = overlap_phase(dev, Path(tmp), refs, totals, keep)
            overlap["seconds"] = time.perf_counter() - t0
            lap("4i overlap")
            obs = obs_phase(dev, Path(tmp), refs, totals, keep)
            lap("4k obs")
            torch.cuda.empty_cache()
            engine = engine_phase(dev, Path(tmp), here, refs, totals, keep)
            lap("4l elastic and serving")
            torch.cuda.empty_cache()
            served = service_phase(dev, Path(tmp), refs, totals, keep)
            lap("4m the service over HTTP")
            torch.cuda.empty_cache()
            fleet = fleet_phase(dev, Path(tmp), refs, totals, keep)
            lap("4n the fleet's front tier")
            torch.cuda.empty_cache()
            fleet_rest = fleet_rest_phase(dev, Path(tmp), refs, totals, keep)
            lap("4o the rest of the fleet")
            torch.cuda.empty_cache()
            mg_rows = multigrid_phase(dev, Path(tmp), totals,
                                      keep["config5"], converge_rows[0], keep)
            lap("4d multigrid")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            rest = slots_rest_phase(dev, Path(tmp), here, refs, totals,
                                    keep.pop("config5"),
                                    volume["cli_fd25"]["sha256_1x1"],
                                    keep.pop("mg_shifted"),
                                    keep.pop("engine_pair"),
                                    keep["cli_converge"])
            rest["seconds"] = time.perf_counter() - t0
            lap("4j the rest on slots")
            torch.cuda.empty_cache()
            auto_rows = auto_paths(dev, Path(tmp), refs, rows, totals)
            picks = tune_auto_grids(Path(tmp))
            tuned = measured_tune(dev, Path(tmp), refs, totals)
            lap("7 auto and tune")
            ckpt = checkpoint_phase(dev, Path(tmp), here, refs, totals)
            fallback = fallback_phase(dev, Path(tmp), refs, totals)
            lap("4c checkpoint and fallback")
        work = here / "build" / "chip_smoke_config4"
        try:
            config4 = config4_phase(dev, work, totals)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        lap("4c config 4")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            host_tools = host_tools_phase(dev, Path(tmp), native_s)
        lap("4e host tools")

        rgb = imageio.generate_test_image(*RGB_HW, "rgb", seed=1)
        grey8k = imageio.generate_test_image(*BIG_HW, "grey", seed=2)
        blur3, edge5 = get_filter("blur3"), get_filter("edge5")
        k1 = time_step(rgb, blur3, "f32", dev)
        k1_rows = {"stencil_step rgb blur3 bf16": time_step(rgb, blur3, "bf16",
                                                            dev),
                   "stencil_step rgb blur3 u8": time_step(rgb, blur3, "u8",
                                                          dev),
                   "stencil_step rgb blur3 f32 sep": time_step(
                       rgb, blur3, "f32", dev, separable=True),
                   "stencil_step grey8k edge5 f32": time_step(grey8k, edge5,
                                                              "f32", dev)}
        k2 = time_fused(rgb, blur3, "bf16", 32, True, dev)
        k2_edge = time_fused(grey8k, edge5, "bf16", 32, True, dev)
        grey = imageio.generate_test_image(*RGB_HW, "grey", seed=2)
        k3 = time_rdma("rdma_block", grey, blur3, "u8", GREY_GRID, 8, dev)
        k3_t1 = time_rdma("rdma_block", grey, blur3, "u8", GREY_GRID, 1, dev)
        k4 = time_rdma("rdma_tiled", rgb, blur3, "bf16", (2, 2), 32, dev)
        k4_t1 = time_rdma("rdma_tiled", rgb, blur3, "bf16", (2, 2), 1, dev)
        chunk8k = time_rdma_chunk(grey8k, edge5, "bf16", (4, 4), 32, dev)
        for name, t in (("stencil_step rgb blur3 f32", k1),
                        *k1_rows.items(),
                        ("fused_iterate rgb blur3 bf16 T=32", k2),
                        ("fused_iterate grey8k edge5 bf16 T=32", k2_edge),
                        ("rdma_block grey 16x16 blur3 u8 T=8", k3),
                        ("rdma_block grey 16x16 blur3 u8 T=1", k3_t1),
                        ("rdma_tiled rgb 2x2 blur3 bf16 T=32", k4),
                        ("rdma_tiled rgb 2x2 blur3 bf16 T=1", k4_t1),
                        ("fused_rdma_step grey8k 4x4 edge5 bf16 T=32", chunk8k)):
            print(f"time {name}: " + json.dumps(t))
        for row in rows:
            print("end to end: " + json.dumps(row))
        for row in converge_rows:
            print("end to end converge: " + json.dumps(row))
        for row in mg_rows:
            print("end to end multigrid: " + json.dumps(row))
        for key, row in host_tools.items():
            print(f"host tools {key}: " + json.dumps(row))
        for row in auto_rows:
            print("end to end auto: " + json.dumps(row))
        for key, row in config4.pop("runs").items():
            print(f"end to end config 4 {key}: " + json.dumps(row))
        for key, row in config4.pop("kernels").items():
            print(f"time config 4 {key}: " + json.dumps(row))
        print("config 4: " + json.dumps(config4))
        print("checkpoint: " + json.dumps(ckpt))
        print("fallback: " + json.dumps(fallback))
        print("measured tune: " + json.dumps(tuned))
        host = time_host_calls(dev)
        print("time host calls: " + json.dumps(host))
        from parallel_convolution_tpu_torch.tuning import costmodel

        measured = hardware_constants(k1, k2, k4, probe["op_price"], host)
        committed = {k: getattr(costmodel.H100, k) for k in measured}
        print("hardware model: " + json.dumps(
            {"measured": measured, "committed": committed, "card": card}))
        volume_bounds(volume, measured["hbm_gbps"])
        for name, row in volume.pop("forms").items():
            print(f"volume {name}: " + json.dumps(row))
        print("volume: " + json.dumps(volume))
        for row in split_rows:
            print("end to end interior split: " + json.dumps(row))
        for row in slots.pop("runs"):
            print("end to end separate devices: " + json.dumps(row))
        slot_timed = slots.pop("timed")
        for name, row in slot_timed["kernels"].items():
            print(f"time {name}: " + json.dumps(row))
        print("probe col_mode: " + json.dumps(
            dict(slot_timed["probe"], card=card)))
        print("separate devices: " + json.dumps(slots))
        for row in overlap.pop("runs"):
            print("end to end overlap: " + json.dumps(row))
        region_timed = overlap.pop("timed")
        for name, row in region_timed.items():
            print(f"time {name}: " + json.dumps(row))
        print("overlap: " + json.dumps(overlap))
        for row in rest.pop("multigrid"):
            print("end to end 4j multigrid: " + json.dumps(row))
        for row in rest.pop("two_processes"):
            print("end to end 4j two processes: " + json.dumps(row))
        for row in rest.pop("processes"):
            print("end to end 4j over processes: " + json.dumps(row))
        for row in rest.pop("cards"):
            print("end to end 4j one card a process: " + json.dumps(row))
        cross_timed = dict(rest.pop("processes_timed"),
                           **rest.pop("cards_timed"))
        print("4j: " + json.dumps(rest))
        for row in obs.pop("runs"):
            print("end to end 4k obs: " + json.dumps(row))
        for key in ("overhead", "attribution", "converge", "checkpoint",
                    "device_trace", "report"):
            print(f"obs {key}: " + json.dumps(obs.pop(key)))
        print("4k: " + json.dumps(obs))
        for row in engine.pop("runs"):
            print("end to end 4l: " + json.dumps(row))
        print("4l: " + json.dumps(engine))
        for row in served.pop("runs"):
            print("end to end 4m: " + json.dumps(row))
        print("4m: " + json.dumps(served))
        for row in fleet.pop("runs"):
            print("end to end 4n: " + json.dumps(row))
        print("4n: " + json.dumps(fleet))
        for row in fleet_rest.pop("runs"):
            print("end to end 4o: " + json.dumps(row))
        print("4o: " + json.dumps(fleet_rest))
        check(all(totals[k] for k in KERNELS),
              f"a kernel never ran on a main path: {totals}")

        kernels = []
        for name, t in (("stencil_step", k1), ("fused_iterate", k2),
                        ("rdma_block", k3), ("rdma_tiled", k4),
                        *slot_timed["kernels"].items(),
                        *region_timed.items()):
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": totals[name],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        # The same kernels over two ranks (phase 4j (e) / (f)) and one card
        # a process (4j (g), with two cards or more): their launches in
        # those legs (already in the one-process rows' counts too), the
        # plain version the same function as the one-process row's.
        for name, t in cross_timed.items():
            base = t["base"]
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[base],
                "replaces": REPLACES[base], "launches": t["launches"],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": slot_timed["kernels"][base]["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None})
        for name, e in probe["entries"].items():
            b_ms, b_by = e["bound"]
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": e["launches"],
                "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                "plain_ms": e["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": e["library_ms"]})
        print("fraction of bound: " + json.dumps(
            {k["name"]: k["bound_ms"] / k["ms"] for k in kernels}))
        lap("5 and 8 kernel times, hardware model")
        print("phase seconds: " + json.dumps(
            dict(laps, total=time.perf_counter() - start)))
        print(f"card: {card}")
        print(json.dumps({"kernels": kernels}))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
