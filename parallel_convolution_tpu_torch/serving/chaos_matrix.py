"""Unified storage-chaos matrix.

``python -m parallel_convolution_tpu_torch.serving.chaos_matrix`` (the
JAX package's ``scripts/chaos_matrix.py``).  The chaos transport drills
the network, the WAL takeover the control plane's death; this matrix
drills the DISK under the whole serving surface at once.  It crosses
every storage fault mode

    {ENOSPC, EIO, torn-write, slow-write, process kill}

with every workload shape the stack serves

    {batch JSON, batch frames, converge resume, rank-3 volume stream,
     cross-shard takeover, cache hit/spill}

— one small, seeded cell per pair — and gates the STANDING invariants
in every cell:

* **zero non-typed failures** — every request either completed or shed
  with a typed retryable rejection; nothing raised into the client;
* **byte-identical or typed-retryable** — every completion matches the
  uninterrupted oracle bit-for-bit;
* **exactly-once finals** — one final row per request_id, across router
  lives where the cell kills one;
* **no stale-byte serves** — a torn spill / healed WAL tail / recovered
  cache never surfaces garbage as a completion;
* **the fault actually fired** — ``diskio.injected_counts()`` must grow
  for the cell's site x mode (a dead drill proves nothing).

Two site drills cover the telemetry/evidence ladders the matrix's
workloads don't route through: ``events_emit`` under ENOSPC counts
dropped lines instead of raising, and ``evidence_write`` under ENOSPC
fails typed BEFORE any byte of the shared curve moves.

The dedicated **ENOSPC degrade drill** proves the durability ladder
end-to-end: sustained ``wal_write`` ENOSPC flips the router into
``durability: degraded`` (stamped on every response) while it KEEPS
SERVING; the first healthy write re-arms durability with a fresh
compaction snapshot of the live state; and a takeover replay after the
healed window resumes from that snapshot — the job finalized during the
window is still finalized, nothing stale resurrects.

The replicas run on the card unless ``--device cpu`` asks for the CPU,
each on ``--mesh`` slots of it:

  python -m parallel_convolution_tpu_torch.serving.chaos_matrix --device cpu
  python -m parallel_convolution_tpu_torch.serving.chaos_matrix \\
      --out build/storage_smoke.json

The summary row is printed (and written to ``--out`` when given) with
``"failures": 0`` iff every gate held; the exit status is 1 otherwise.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import tempfile
import time
from pathlib import Path

MODES = ("enospc", "eio", "torn_write", "slow_write", "kill")
WORKLOADS = ("batch_json", "batch_frames", "converge", "volume",
             "shard", "cache")


def run_matrix(seed: int = 0, mesh: str = "1x2", rows: int = 40,
               cols: int = 56, modes=MODES, workloads=WORKLOADS,
               log=print, device=None) -> dict:
    """Run the full matrix + site drills + the ENOSPC degrade drill;
    returns the summary row (``soak --chaos-matrix`` reuses this).
    ``mesh`` is every replica's R x C grid of slots of ``device`` (the
    card by default, ``cpu`` on request)."""
    import numpy as np

    from parallel_convolution_tpu_torch.serving._chaos_common import (
        converge_body as _cbody, oracle_converge_final,
        request_with_backoff,
    )
    from parallel_convolution_tpu_torch.obs import events as obs_events
    from parallel_convolution_tpu_torch.ops import filters, oracle
    from parallel_convolution_tpu_torch.resilience.elastic import parse_spec
    from parallel_convolution_tpu_torch.resilience import diskio, faults
    from parallel_convolution_tpu_torch.serving import frames
    from parallel_convolution_tpu_torch.serving.cache import ResultCache
    from parallel_convolution_tpu_torch.serving.chaos import router_kill_due
    from parallel_convolution_tpu_torch.serving.pricing import WorkPricer
    from parallel_convolution_tpu_torch.serving.router import (
        InProcessReplica, ReplicaRouter, TenantQuotas, route_key,
    )
    from parallel_convolution_tpu_torch.serving.service import (
        ConvolutionService,
    )
    from parallel_convolution_tpu_torch.soak import slot_grid
    from parallel_convolution_tpu_torch.utils import evidence_io, imageio

    failures: list[str] = []
    t0 = time.time()
    tmp = Path(tempfile.mkdtemp(prefix="pctpu-storage-"))

    img = imageio.generate_test_image(rows, cols, "grey", seed=7)
    b64 = base64.b64encode(np.ascontiguousarray(img).tobytes()).decode()
    batch_iters = 2
    batch_oracle = oracle.run_serial_u8(
        img, filters.get_filter("blur3"), batch_iters)
    vol = np.random.default_rng(11).random((2, 4, 16, 16),
                                           dtype=np.float32)
    vol_b64 = base64.b64encode(vol.tobytes()).decode()

    grid = slot_grid(parse_spec(mesh), device)

    def factory():
        return ConvolutionService(grid, max_delay_s=0.002, max_queue=256)

    def batch_body(rid: str) -> dict:
        return {"image_b64": b64, "rows": rows, "cols": cols,
                "mode": "grey", "filter": "blur3", "iters": batch_iters,
                "request_id": rid, "tenant": "drill"}

    def cbody(rid: str) -> dict:
        return _cbody(b64, rows, cols, rid, tenant="drill")

    def vbody(rid: str) -> dict:
        return {"rows": 16, "cols": 16, "depth": 4, "mode": "volume",
                "volume_b64": vol_b64, "filter": "wave",
                "boundary": "periodic", "tol": 0.0, "max_iters": 12,
                "check_every": 4, "request_id": rid, "tenant": "drill"}

    # Uninterrupted oracles, once (clean router, no faults).
    try:
        cv_oracle = oracle_converge_final(factory, cbody("oracle"))
        vol_oracle = oracle_converge_final(factory, vbody("oracle-v"))
    except RuntimeError as e:
        failures.append(f"oracle run failed: {e}")
        cv_oracle = vol_oracle = {}

    # The shared replica pool (plain services); cache cells build their
    # own cache-armed replica per cell.
    reps = [InProcessReplica(factory, name=f"s{i}") for i in range(2)]
    clock = [0.0]

    def mk_router(wal_path):
        return ReplicaRouter(
            reps, wal=str(wal_path),
            quotas=TenantQuotas(rate=1.0, burst=1e6,
                                clock=lambda: clock[0]),
            pricer=WorkPricer(min_units=1e-9),
            breaker_threshold=3, breaker_cooldown_s=0.2,
            start_health=False)

    def drain(rows_iter, finals: dict):
        out = []
        for r in rows_iter:
            out.append(r)
            if r.get("kind") == "final":
                rid = r.get("request_id", "")
                finals[rid] = finals.get(rid, 0) + 1
        return out

    def check_batch(wire, cell: str, errs: list[str]):
        if wire.get("ok"):
            if (base64.b64decode(wire["image_b64"])
                    != batch_oracle.tobytes()):
                errs.append(f"{cell}: batch bytes differ from oracle")
        elif not wire.get("retryable"):
            errs.append(f"{cell}: non-typed failure "
                        f"{wire.get('rejected')!r}")

    def frames_request(router, rid: str):
        """One batch request on the binary wire; returns (wire, bytes)."""
        header = {k: v for k, v in batch_body(rid).items()
                  if k != "image_b64"}
        env = frames.encode_envelope(header, {"image": img})
        hdr, raw = frames.split_envelope(env)
        body = dict(hdr)
        body["_frames_raw"] = bytes(raw)
        wire = request_with_backoff(router, body)
        out_raw = wire.pop("_frames_raw", b"")
        if not wire.get("ok"):
            return wire, b""
        _, arrays = frames.decode_envelope(
            frames.join_envelope(wire, out_raw))
        return wire, arrays["image"].tobytes()

    def check_frames(wire, got: bytes, cell: str, errs: list[str]):
        if wire.get("ok"):
            if got != batch_oracle.tobytes():
                errs.append(f"{cell}: framed bytes differ from oracle")
        elif not wire.get("retryable"):
            errs.append(f"{cell}: non-typed failure "
                        f"{wire.get('rejected')!r}")

    def check_stream(got: list, oracle_final: dict, cell: str,
                     errs: list[str], finals: dict):
        final = got[-1] if got else {}
        if final.get("kind") != "final":
            if not final.get("retryable"):
                errs.append(f"{cell}: stream ended non-typed: "
                            f"{final.get('rejected')!r}")
            return
        if final.get("image_b64") != oracle_final.get("image_b64"):
            errs.append(f"{cell}: final not byte-identical to oracle")
        dup = {r: n for r, n in finals.items() if n != 1}
        if dup:
            errs.append(f"{cell}: exactly-once finals violated: {dup}")

    # ------------------------------------------------------------ cells
    def cell_batch(kind: str, mode: str, cell: str,
                   errs: list[str]) -> None:
        """batch_json / batch_frames x one disk mode or kill."""
        wal = tmp / f"{cell}.wal"
        r1 = mk_router(wal)
        send = ((lambda rt, rid: check_frames(
                    *frames_request(rt, rid), cell, errs))
                if kind == "batch_frames"
                else (lambda rt, rid: check_batch(
                    request_with_backoff(rt, batch_body(rid)),
                    cell, errs)))
        if mode == "kill":
            for i in range(2):
                send(r1, f"{cell}-a{i}")
            r2 = mk_router(wal)   # fenced takeover of the same lineage
            if r2.epoch <= r1.epoch:
                errs.append(f"{cell}: takeover epoch did not bump")
            _, wz = r1.request(batch_body(f"{cell}-zombie"))
            if wz.get("rejected") != "stale_epoch" or wz.get("retryable"):
                errs.append(f"{cell}: zombie not fenced typed "
                            f"({wz.get('rejected')!r})")
            for i in range(2):
                send(r2, f"{cell}-b{i}")
            r1.close(close_replicas=False)
            r2.close(close_replicas=False)
            return
        diskio.install_modes({"wal_write": mode})
        try:
            with faults.injected("wal_write:1+", seed=seed):
                for i in range(3):
                    send(r1, f"{cell}-{i}")
        finally:
            diskio.uninstall_modes()
            r1.close(close_replicas=False)

    def cell_stream(body_fn, oracle_final: dict, mode: str, cell: str,
                    errs: list[str]) -> None:
        """converge / volume stream x one disk mode or kill."""
        wal = tmp / f"{cell}.wal"
        finals: dict[str, int] = {}
        r1 = mk_router(wal)
        rid = f"{cell}-cv"
        if mode == "kill":
            killed = False
            with faults.injected("router_kill:2", seed=seed):
                st, rows_it = r1.converge(body_fn(rid))
                if st != 200:
                    errs.append(f"{cell}: admission failed: {st}")
                else:
                    n_rows = 0
                    for row in rows_it:
                        drain([row], finals)
                        n_rows += 1
                        if router_kill_due():
                            killed = True
                            break   # abandoned un-closed: the crash
            if not killed:
                errs.append(f"{cell}: router_kill never fired")
            r2 = mk_router(wal)
            if r2.epoch <= r1.epoch:
                errs.append(f"{cell}: takeover epoch did not bump")
            r1.close(close_replicas=False)
            st, rows_it = r2.converge(body_fn(rid))
            got = drain(rows_it, finals) if st == 200 else []
            check_stream(got, oracle_final, cell, errs, finals)
            final = got[-1] if got else {}
            if (final.get("kind") == "final"
                    and final.get("router", {}).get("resume_count", 0)
                    < 1):
                errs.append(f"{cell}: takeover retry did not resume "
                            "from the ledger token")
            r2.close(close_replicas=False)
            return
        diskio.install_modes({"wal_write": mode})
        try:
            with faults.injected("wal_write:1+", seed=seed):
                st, rows_it = r1.converge(body_fn(rid))
                got = drain(rows_it, finals) if st == 200 else []
            check_stream(got, oracle_final, cell, errs, finals)
        finally:
            diskio.uninstall_modes()
            r1.close(close_replicas=False)

    def cell_shard(mode: str, cell: str, errs: list[str]) -> None:
        """Cross-shard control plane x one disk mode or kill."""
        from parallel_convolution_tpu_torch.serving.peers import (
            InProcessPeer, ShardClient, ShardRouter, shard_of,
        )

        state_dir = tmp / cell
        state_dir.mkdir()
        names = ["rA", "rB"]
        assign = {"0": "rA", "1": "rB"}
        routers = {}
        for nm in names:
            routers[nm] = ShardRouter(
                nm, reps, n_shards=2,
                owned=[s for s, o in assign.items() if o == nm],
                state_dir=state_dir, assignments=assign,
                quotas=TenantQuotas(rate=1.0, burst=1e6,
                                    clock=lambda: clock[0]),
                pricer=WorkPricer(min_units=1e-9),
                start_sync=False, start_health=False,
                breaker_cooldown_s=0.2, clock=lambda: clock[0])
        for nm in names:
            routers[nm].peers = [InProcessPeer(routers[o])
                                 for o in names if o != nm]
        client = ShardClient(list(routers.values()))
        finals: dict[str, int] = {}
        body = cbody(f"{cell}-cv")
        try:
            if mode == "kill":
                shard = shard_of(route_key(dict(body)), 2)
                victim = routers[assign[shard]]
                survivor = [routers[n] for n in names
                            if n != assign[shard]][0]
                st, rows_it = client.converge(dict(body))
                if st != 200:
                    errs.append(f"{cell}: admission failed: {st}")
                    return
                drain([next(rows_it), next(rows_it)], finals)
                victim.hard_stop()
                for _ in range(survivor.suspect_after + 1):
                    survivor.sync_now()
                if survivor.stats.get("takeovers", 0) < 1:
                    errs.append(f"{cell}: no fenced takeover observed")
                client.refresh()
                st, rows_it = client.converge(dict(body))
                got = drain(rows_it, finals) if st == 200 else []
                check_stream(got, cv_oracle, cell, errs, finals)
                final = got[-1] if got else {}
                if (final.get("kind") == "final"
                        and final.get("router", {}).get(
                            "resume_count", 0) < 1):
                    errs.append(f"{cell}: cross-shard retry did not "
                                "resume from the ledger token")
                return
            diskio.install_modes({"wal_write": mode})
            try:
                with faults.injected("wal_write:1+", seed=seed):
                    st, rows_it = client.converge(dict(body))
                    got = drain(rows_it, finals) if st == 200 else []
                check_stream(got, cv_oracle, cell, errs, finals)
            finally:
                diskio.uninstall_modes()
        finally:
            for r in routers.values():
                try:
                    r.close(close_replicas=False)
                except (OSError, RuntimeError):
                    pass

    def cell_cache(mode: str, cell: str, errs: list[str]) -> None:
        """Cache hit/spill/promote x one disk mode or kill."""
        disk = tmp / f"{cell}-rc"

        def cache_factory():
            return ConvolutionService(
                grid, max_delay_s=0.002, max_queue=256,
                cache=ResultCache(capacity_entries=1, disk_dir=disk))

        rep = InProcessReplica(cache_factory, name="rc0")
        wal = tmp / f"{cell}.wal"

        def mk(wal_path):
            return ReplicaRouter(
                [rep], wal=str(wal_path),
                quotas=TenantQuotas(rate=1.0, burst=1e6,
                                    clock=lambda: clock[0]),
                pricer=WorkPricer(min_units=1e-9),
                breaker_threshold=3, breaker_cooldown_s=0.2,
                start_health=False)

        r1 = mk(wal)
        a = dict(batch_body(f"{cell}-a"))
        b = dict(batch_body(f"{cell}-b"), iters=1)
        b_oracle = oracle.run_serial_u8(img, filters.get_filter("blur3"),
                                        1)

        def send(rt, body, want):
            wire = request_with_backoff(rt, dict(body))
            if wire.get("ok"):
                if base64.b64decode(wire["image_b64"]) != want.tobytes():
                    errs.append(f"{cell}: served bytes differ from "
                                "oracle (stale/torn serve)")
            elif not wire.get("retryable"):
                errs.append(f"{cell}: non-typed failure "
                            f"{wire.get('rejected')!r}")
            return wire

        try:
            if mode == "kill":
                send(r1, a, batch_oracle)   # populate A
                send(r1, b, b_oracle)       # evict A -> disk spill
                r2 = mk(wal)                # takeover, same WAL + disk
                r1.close(close_replicas=False)
                # Post-takeover, A must come back CORRECT — from the
                # disk tier (CRC-verified) or recomputed; never stale.
                wire = send(r2, dict(a, request_id=f"{cell}-a2"),
                            batch_oracle)
                if not wire.get("ok"):
                    errs.append(f"{cell}: post-takeover request failed")
                r2.close(close_replicas=False)
                return
            dmodes = {"cache_spill": mode}
            spec = "cache_spill:1+"
            if mode in ("eio", "slow_write"):
                dmodes["cache_promote"] = mode
                spec += ",cache_promote:1"
            diskio.install_modes(dmodes)
            try:
                with faults.injected(spec, seed=seed):
                    send(r1, a, batch_oracle)               # miss
                    send(r1, dict(a, request_id=f"{cell}-a2"),
                         batch_oracle)                      # memory hit
                    send(r1, b, b_oracle)                   # spill fault
                    send(r1, dict(a, request_id=f"{cell}-a3"),
                         batch_oracle)   # promote path or clean recompute
            finally:
                diskio.uninstall_modes()
            r1.close(close_replicas=False)
        finally:
            rep.close()

    RUNNERS = {
        "batch_json": lambda m, c, e: cell_batch("batch_json", m, c, e),
        "batch_frames": lambda m, c, e: cell_batch("batch_frames",
                                                   m, c, e),
        "converge": lambda m, c, e: cell_stream(cbody, cv_oracle,
                                                m, c, e),
        "volume": lambda m, c, e: cell_stream(vbody, vol_oracle,
                                              m, c, e),
        "shard": cell_shard,
        "cache": cell_cache,
    }
    PRIMARY_SITE = {"cache": "cache_spill"}   # default: wal_write

    cells = []
    for wl in workloads:
        for mode in modes:
            cell = f"{wl}x{mode}"
            errs: list[str] = []
            before = diskio.injected_counts()
            try:
                RUNNERS[wl](mode, cell, errs)
            except Exception as e:  # noqa: BLE001 — the standing
                # zero-non-typed gate: ANY exception out of a cell is a
                # finding, recorded typed in the row, never a crash of
                # the whole matrix.
                errs.append(f"{cell}: raised {type(e).__name__}: "
                            f"{str(e)[:160]}")
            after = diskio.injected_counts()
            delta = {k: after.get(k, 0) - before.get(k, 0)
                     for k in after
                     if after.get(k, 0) > before.get(k, 0)}
            if mode != "kill":
                key = f"{PRIMARY_SITE.get(wl, 'wal_write')}={mode}"
                if delta.get(key, 0) < 1:
                    errs.append(
                        f"{cell}: fault never fired ({key} flat — a "
                        "dead drill proves nothing)")
            cells.append({"cell": cell, "workload": wl, "mode": mode,
                          "ok": not errs, "injected": delta,
                          **({"errors": errs[:3]} if errs else {})})
            failures.extend(errs)
            log(f"  cell {cell}: {'ok' if not errs else errs[0]}")

    # -------------------------------------------------- site drills
    site_drills = {}
    # events_emit under ENOSPC: dropped lines counted, never a raise.
    elog = obs_events.EventLog(tmp / "drill-events.ndjson")
    diskio.install_modes({"events_emit": "enospc"})
    try:
        with faults.injected("events_emit:2+", seed=seed):
            for i in range(4):
                elog.emit("heartbeat", i=i)
    except (OSError, Exception) as e:  # noqa: BLE001 — the contract
        # under test IS "never raises"; anything escaping is the finding.
        failures.append(f"events_emit drill raised {e!r}")
    finally:
        diskio.uninstall_modes()
        elog.close()
    written = len([ln for ln in (tmp / "drill-events.ndjson")
                   .read_text().splitlines() if ln.strip()])
    if elog.dropped < 1:
        failures.append("events_emit drill dropped nothing")
    if written + elog.dropped != 4:
        failures.append(f"events ledger drift: {written} written + "
                        f"{elog.dropped} dropped != 4 emitted")
    site_drills["events_emit"] = {"written": written,
                                  "dropped": elog.dropped}

    # evidence_write under ENOSPC: typed failure BEFORE any byte moves.
    curve = tmp / "drill-curve.jsonl"
    evidence_io.rewrite_shared_jsonl(curve, [{"a": 1}], lane="keep")
    before_bytes = curve.read_bytes()
    diskio.install_modes({"evidence_write": "enospc"})
    try:
        with faults.injected("evidence_write:1", seed=seed):
            try:
                evidence_io.rewrite_shared_jsonl(
                    curve, [{"b": 2}], lane="other")
                failures.append("evidence_write ENOSPC not surfaced")
                typed = False
            except OSError:
                typed = True
    finally:
        diskio.uninstall_modes()
    if curve.read_bytes() != before_bytes:
        failures.append("evidence_write fault tore the shared curve")
    site_drills["evidence_write"] = {
        "typed": typed, "curve_intact": curve.read_bytes() == before_bytes}

    # -------------------------------- the ENOSPC degrade ladder drill
    log("  enospc degrade drill: degrade -> serve -> re-arm -> replay")
    wal = tmp / "degrade.wal"
    r1 = mk_router(wal)
    finals: dict[str, int] = {}
    stamps = []
    diskio.install_modes({"wal_write": "enospc"})
    try:
        with faults.injected("wal_write:1+", seed=seed):
            for i in range(4):
                wire = request_with_backoff(r1, batch_body(f"deg-b{i}"))
                check_batch(wire, "degrade-drill", failures)
                stamps.append(wire.get("router", {}).get("durability"))
            # A whole converge job lives inside the degraded window:
            # served correctly, finalized in MEMORY only (every WAL
            # append fails) — the re-arm snapshot must carry it.
            st, rows_it = r1.converge(cbody("deg-cv"))
            got = drain(rows_it, finals) if st == 200 else []
            check_stream(got, cv_oracle, "degrade-drill", failures,
                         finals)
    finally:
        diskio.uninstall_modes()
    degraded_window = (r1.stats.get("wal_degraded_windows", 0) >= 1
                       and "degraded" in stamps)
    if not degraded_window:
        failures.append(
            f"no degraded window observed (stamps {stamps}, windows "
            f"{r1.stats.get('wal_degraded_windows')})")
    # Heal: the next successful append must re-arm with a fresh
    # compaction snapshot of the LIVE state.
    wire = request_with_backoff(r1, batch_body("heal-b0"))
    check_batch(wire, "degrade-drill-heal", failures)
    rearmed = (r1.stats.get("wal_rearms", 0) >= 1
               and wire.get("router", {}).get("durability") == "ok")
    if not rearmed:
        failures.append(
            f"durability did not re-arm on heal (rearms "
            f"{r1.stats.get('wal_rearms')}, stamp "
            f"{wire.get('router', {}).get('durability')!r})")
    snap1 = r1.snapshot()
    # Replay after the healed window: the takeover reads the re-arm
    # snapshot — the degraded-window job is STILL finalized (exactly
    # once), and no stale pre-degrade state resurrects as live.
    r2 = mk_router(wal)
    r1.close(close_replicas=False)
    jobs2, finalized2 = r2.jobs.export()
    finalized_carried = "drill\x1fdeg-cv" in finalized2
    if not finalized_carried:
        failures.append(
            "re-arm snapshot lost the degraded-window finalization — "
            "replay would re-run a finished job")
    stale_live = [lid for lid in jobs2 if lid.startswith("drill\x1f")]
    if stale_live:
        failures.append(
            f"replay resurrected stale live jobs: {stale_live}")
    st, rows_it = r2.converge(cbody("post-heal-cv"))
    got = drain(rows_it, finals) if st == 200 else []
    check_stream(got, cv_oracle, "degrade-drill-replay", failures,
                 finals)
    enospc_drill = {
        "degraded_window": degraded_window,
        "stamps": stamps,
        "degraded_windows": snap1["router"].get("wal_degraded_windows"),
        "rearmed": rearmed,
        "wal_rearms": snap1["router"].get("wal_rearms"),
        "finalized_carried": finalized_carried,
        "stale_live_jobs": len(stale_live),
        "replay": r2.recovery,
    }
    r2.close(close_replicas=False)

    for rep in reps:
        rep.close()
    wall = time.time() - t0
    bad_cells = [c["cell"] for c in cells if not c["ok"]]
    return {
        "workload": f"storage-chaos-matrix {len(modes)}x"
                    f"{len(workloads)} blur3+jacobi3+wave "
                    f"{rows}x{cols} mesh {mesh}",
        "seed": seed,
        "cells_total": len(cells),
        "cells_failed": len(bad_cells),
        "cells": cells,
        "site_drills": site_drills,
        "enospc_drill": enospc_drill,
        "injected_counts": diskio.injected_counts(),
        "wall_s": round(wall, 3),
        "failures": len(failures),
        "failure_detail": failures[:12],
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m parallel_convolution_tpu_torch.serving.chaos_matrix",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", type=int, default=40)
    ap.add_argument("--cols", type=int, default=56)
    ap.add_argument("--mesh", default="1x2", help="grid per replica")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda[:N] (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the summary row JSON to this path")
    args = ap.parse_args(argv)

    from parallel_convolution_tpu_torch.obs import events as obs_events

    obs_events.install_from_env()
    row = run_matrix(seed=args.seed, mesh=args.mesh, rows=args.rows,
                     cols=args.cols, device=args.device)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(row, indent=2))
    print(json.dumps({k: v for k, v in row.items() if k != "cells"}),
          flush=True)
    return 1 if row["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
