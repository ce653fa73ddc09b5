"""Supervised leg queue (the JAX package's ``resilience/supervisor.py``,
the port's own copy on its ``obs`` and ``retry``).

Three ideas as one tested class: (1) a queue of legs, each complete iff
its output artifact exists (often with a required content pattern, e.g. a
``"summary"`` row); (2) retry on a transient failure, with the
``RetryPolicy`` backoff between attempts; (3) a terminal-failure sentinel
(``HALT``) that stops the queue when retrying cannot heal the condition.
A reshape-aware leg (``meshes`` / ``reshape_pattern``) walks its grid
ladder on a device-loss signature, to the first rung that fits the live
device count (``utils.platform.probe_device_count``, ``elastic.next_fit``),
each rung exported through ``PCTPU_MESH`` (``elastic.MESH_ENV``), which the
port's CLI reads when ``--mesh`` is not given.

Each attempt's stdout/stderr land in ``<state_dir>/<leg>.out|.err``; a
JSON status ledger (``status.json``, schema 2 with a heartbeat) is
atomically rewritten after every attempt, so an operator can see
exactly where a run died without scraping logs.

The command line (the JAX package's ``scripts/run_supervised.py``)::

    python -m parallel_convolution_tpu_torch.resilience.supervisor \
        --legs legs.json --state-dir supervised_state

Legs file: a JSON list of objects with fields ``name`` and ``cmd``
(required), ``done_file``, ``done_pattern``, ``terminal_pattern``,
``timeout``, ``env``, ``meshes``, ``mesh_env``, ``reshape_pattern``
(see :class:`Leg`).  Exit codes: 0 all legs complete; 1 some leg
exhausted its retries; 2 terminal halt (sentinel written: remove it with
``--clear-halt`` only after fixing the cause).  Re-running is safe:
completed legs are skipped and an existing sentinel refuses to run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

from parallel_convolution_tpu_torch.obs import (
    events as obs_events, metrics as obs_metrics,
)
from parallel_convolution_tpu_torch.resilience.retry import RetryPolicy

HALT_NAME = "HALT"
LEDGER_NAME = "status.json"

# status.json schema (round 11): 2 adds `schema_version` itself plus a
# `heartbeat`/`heartbeat_unix` pair refreshed between leg polls — an
# external watcher can now tell "running" (heartbeat advancing) from
# "hung" (stale heartbeat, no state change).  Readers must tolerate
# version-1 ledgers without the fields (:func:`read_ledger`).
LEDGER_SCHEMA = 2


def read_ledger(path) -> dict:
    """Parse a supervisor ledger, filling pre-round-11 defaults.

    Old ledgers (no ``schema_version``) read as version 1 with the
    heartbeat falling back to ``updated`` (the best liveness signal they
    carried).  Raises on missing/unparseable files — a watcher must see
    the difference between "no ledger yet" and "ledger says X".
    """
    data = json.loads(Path(path).read_text())
    if not isinstance(data, dict):
        raise ValueError(f"ledger {path} is not a JSON object")
    data.setdefault("schema_version", 1)
    data.setdefault("heartbeat", data.get("updated"))
    data.setdefault("heartbeat_unix", None)
    data.setdefault("legs", {})
    data.setdefault("halt", None)
    return data


@dataclasses.dataclass
class Leg:
    """One unit of work with an artifact-based completion predicate.

    ``done_file`` + optional ``done_pattern`` (regex) define completion —
    the queue is idempotent, like the ``[ -e ]`` guards in the old shell:
    a re-run skips landed legs.  With no ``done_file``, completion is
    simply a zero exit.  ``terminal_pattern`` (regex, searched in the
    attempt's combined stdout+stderr) marks failures retrying cannot heal
    — the supervisor drops the sentinel and stops the whole queue.
    """

    name: str
    cmd: list[str]
    done_file: str | None = None
    done_pattern: str | None = None
    terminal_pattern: str | None = None
    timeout: float | None = None
    env: dict | None = None
    # Reshape-aware legs (elastic recovery): ``meshes`` is the mesh-spec
    # ladder to walk (e.g. ["2x4", "2x2", "1x2", "1x1"]), ``mesh_env``
    # the env var the current rung is exported through (default
    # elastic.MESH_ENV), and ``reshape_pattern`` the regex that marks an
    # attempt as "a device died" — matching output advances the ladder
    # (to the first rung that fits the probed live-device count) instead
    # of retrying the same doomed grid.
    meshes: list | None = None
    mesh_env: str | None = None
    reshape_pattern: str | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "Leg":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown leg field(s) {sorted(unknown)}")
        leg = cls(**d)
        if not leg.name or not leg.cmd:
            raise ValueError("leg needs a name and a non-empty cmd")
        if leg.reshape_pattern and not leg.meshes:
            raise ValueError(
                f"leg {leg.name!r}: reshape_pattern needs a meshes ladder")
        if leg.meshes:
            from parallel_convolution_tpu_torch.resilience import elastic

            for spec in leg.meshes:
                elastic.parse_spec(str(spec))  # loud on a typo'd rung
        return leg

    def is_complete(self) -> bool:
        if self.done_file is None:
            return False  # rc==0 of an attempt is the only signal
        p = Path(self.done_file)
        if not p.exists():
            return False
        if self.done_pattern is None:
            return True
        try:
            return re.search(self.done_pattern, p.read_text()) is not None
        except OSError:
            return False


class Supervisor:
    """Run a :class:`Leg` queue with classified retry + terminal sentinel."""

    def __init__(self, legs: list[Leg], state_dir, *,
                 policy: RetryPolicy | None = None, sleep=time.sleep,
                 log=None, heartbeat_every: float = 5.0):
        self.legs = list(legs)
        names = [leg.name for leg in self.legs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate leg names in {names}")
        self.state_dir = Path(state_dir)
        self.policy = policy or RetryPolicy(max_attempts=5, base_delay=2.0,
                                            max_delay=240.0)
        self._sleep = sleep
        self._log = log or (lambda msg: print(msg, flush=True))
        # How often the attempt loop re-stamps the ledger heartbeat while
        # a leg subprocess runs (the running-vs-hung watcher signal).
        self.heartbeat_every = max(0.1, float(heartbeat_every))
        self._status: dict = {"schema_version": LEDGER_SCHEMA,
                              "legs": {}, "halt": None}

    # -- ledger ------------------------------------------------------------
    @property
    def halt_path(self) -> Path:
        return self.state_dir / HALT_NAME

    @property
    def ledger_path(self) -> Path:
        return self.state_dir / LEDGER_NAME

    def _flush_ledger(self) -> None:
        tmp = self.ledger_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(self._status, indent=2))
        os.replace(tmp, self.ledger_path)

    def _stamp_heartbeat(self) -> None:
        self._status["heartbeat"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                  time.gmtime())
        self._status["heartbeat_unix"] = round(time.time(), 3)

    def _write_ledger(self) -> None:
        self._status["updated"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                time.gmtime())
        self._stamp_heartbeat()
        self._flush_ledger()

    def _touch_heartbeat(self, leg_name: str = "") -> None:
        """Refresh ONLY the liveness pair mid-attempt: ``updated`` keeps
        meaning 'last state change', heartbeat means 'supervisor alive'.

        Best-effort by contract: this runs INSIDE the attempt poll loop
        while a leg subprocess is alive, so an I/O failure here (ENOSPC,
        state dir pruned) must never bubble into the attempt handling —
        it would misclassify a running leg and leak/duplicate the child."""
        self._stamp_heartbeat()
        try:
            self._flush_ledger()
            if obs_metrics.enabled():
                obs_events.emit("heartbeat", leg=leg_name,
                                unix=self._status["heartbeat_unix"])
        except OSError:
            pass

    def _leg_status(self, leg: Leg) -> dict:
        return self._status["legs"].setdefault(
            leg.name, {"state": "pending", "attempts": 0})

    # -- execution ---------------------------------------------------------
    def _attempt(self, leg: Leg,
                 extra_env: dict | None = None) -> tuple[int | None, str]:
        """One subprocess attempt; returns (rc or None on timeout, text).

        The wait is sliced into ``heartbeat_every`` polls, the ledger
        heartbeat re-stamped between polls — a watcher reading
        ``status.json`` can distinguish a long-running leg (heartbeat
        advancing) from a hung supervisor (heartbeat frozen)."""
        out = self.state_dir / f"{leg.name}.out"
        err = self.state_dir / f"{leg.name}.err"
        env = dict(os.environ)
        if leg.env:
            env.update({k: str(v) for k, v in leg.env.items()})
        if extra_env:
            env.update({k: str(v) for k, v in extra_env.items()})
        p = None
        try:
            with open(out, "wb") as fo, open(err, "wb") as fe:
                p = subprocess.Popen(leg.cmd, stdout=fo, stderr=fe, env=env)
                deadline = (time.monotonic() + leg.timeout
                            if leg.timeout is not None else None)
                while True:
                    slice_s = self.heartbeat_every
                    if deadline is not None:
                        slice_s = min(slice_s,
                                      max(0.0, deadline - time.monotonic()))
                    try:
                        rc = p.wait(timeout=slice_s)
                        break
                    except subprocess.TimeoutExpired:
                        if (deadline is not None
                                and time.monotonic() >= deadline):
                            p.kill()
                            p.wait()
                            rc = None
                            break
                        # Best-effort (swallows its own I/O errors): a
                        # failing heartbeat must not reach the handler
                        # below while the child is alive.
                        self._touch_heartbeat(leg.name)
        except OSError as e:  # unrunnable cmd / capture-file failure
            if p is not None and p.poll() is None:
                # Never leak a live child into a "failed" attempt — the
                # retry would double-execute the leg against the same
                # checkpoint/evidence files.
                p.kill()
                p.wait()
            try:
                err.write_bytes(repr(e).encode())
            except OSError:
                pass
            rc = -1
        text = ""
        for p_ in (out, err):
            try:
                text += p_.read_text(errors="replace")
            except OSError:
                pass
        return rc, text

    def _next_mesh_idx(self, leg: Leg, idx: int) -> int:
        """The ladder rung after ``idx`` that fits current device health
        (elastic.next_fit).  The probe runs in a child process and is
        best-effort: any failure means "health unknown" — step one rung."""
        from parallel_convolution_tpu_torch.resilience import elastic

        live = None
        try:
            from parallel_convolution_tpu_torch.utils.platform import (
                probe_device_count,
            )

            live = probe_device_count(timeout=30.0)
        except Exception:  # noqa: BLE001 — a broken probe must not halt
            live = None
        return elastic.next_fit([str(s) for s in leg.meshes], idx + 1, live)

    def _leg_event(self, leg: Leg, state: str, **fields) -> None:
        if obs_metrics.enabled():
            obs_metrics.counter(
                "pctpu_supervisor_legs_total",
                "supervisor leg state transitions",
                ("state",)).inc(state=state)
            obs_events.emit("leg", leg=leg.name, state=state, **fields)

    def _halt(self, leg: Leg, reason: str) -> None:
        self._leg_event(leg, "terminal", reason=reason)
        self._status["halt"] = {"leg": leg.name, "reason": reason}
        self.halt_path.write_text(
            f"leg {leg.name}: {reason}\n"
            "Terminal failure: retrying cannot heal it. Remove this file "
            "only after fixing the cause.\n")
        self._write_ledger()
        self._log(f"supervisor: TERMINAL failure in leg {leg.name!r}: "
                  f"{reason} — sentinel at {self.halt_path}")

    def run(self) -> int:
        """Run the queue.  0 = all legs complete; 1 = some leg exhausted
        its retries (queue continued past it); 2 = terminal halt."""
        self.state_dir.mkdir(parents=True, exist_ok=True)
        if self.halt_path.exists():
            self._log(f"supervisor: refusing to run — sentinel present at "
                      f"{self.halt_path}")
            return 2
        exhausted = False
        for leg in self.legs:
            st = self._leg_status(leg)
            if leg.is_complete():
                st["state"] = "done"
                st.setdefault("completed_at", time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime()))
                self._write_ledger()
                self._log(f"supervisor: leg {leg.name!r} already complete")
                continue
            done = False
            # One RNG drawn exactly like RetryPolicy.delays()/with_retry:
            # the same policy must produce the same schedule everywhere.
            rng = random.Random(self.policy.seed)
            mesh_idx = 0
            for attempt in range(1, self.policy.max_attempts + 1):
                st["state"] = "running"
                st["attempts"] = attempt
                extra_env = None
                if leg.meshes:
                    from parallel_convolution_tpu_torch.resilience import elastic

                    spec = str(leg.meshes[min(mesh_idx,
                                              len(leg.meshes) - 1)])
                    extra_env = {leg.mesh_env or elastic.MESH_ENV: spec}
                    st["mesh"] = spec
                self._write_ledger()
                rc, text = self._attempt(leg, extra_env)
                st["last_rc"] = rc
                if leg.terminal_pattern and re.search(leg.terminal_pattern,
                                                      text):
                    st["state"] = "terminal"
                    self._halt(leg, f"output matched terminal pattern "
                                    f"{leg.terminal_pattern!r}")
                    return 2
                complete = (leg.is_complete() if leg.done_file is not None
                            else rc == 0)
                if complete:
                    st["state"] = "done"
                    st["completed_at"] = time.strftime(
                        "%Y-%m-%dT%H:%M:%SZ", time.gmtime())
                    self._write_ledger()
                    self._leg_event(leg, "done", attempt=attempt)
                    self._log(f"supervisor: leg {leg.name!r} complete "
                              f"(attempt {attempt})")
                    done = True
                    break
                st["last_error"] = ("timeout" if rc is None
                                    else f"rc={rc}, incomplete")
                if (leg.reshape_pattern and leg.meshes
                        and mesh_idx < len(leg.meshes) - 1
                        and re.search(leg.reshape_pattern, text)):
                    # Device-loss signature: retrying the same grid is
                    # doomed — advance the ladder to the first rung that
                    # fits the probed live-device count (health-unknown
                    # probes just step down one rung).
                    mesh_idx = self._next_mesh_idx(leg, mesh_idx)
                    st["reshapes"] = st.get("reshapes", 0) + 1
                    self._leg_event(leg, "reshape",
                                    mesh=str(leg.meshes[mesh_idx]),
                                    attempt=attempt)
                    self._log(
                        f"supervisor: leg {leg.name!r} hit device-loss "
                        f"pattern; reshaping onto "
                        f"{leg.meshes[mesh_idx]}")
                self._write_ledger()
                if attempt < self.policy.max_attempts:
                    d = self.policy.delay(attempt, rng)
                    self._log(f"supervisor: leg {leg.name!r} attempt "
                              f"{attempt} failed ({st['last_error']}); "
                              f"retrying in {d:.1f}s")
                    self._sleep(d)
            if not done:
                st["state"] = "exhausted"
                self._write_ledger()
                self._leg_event(leg, "exhausted",
                                attempts=self.policy.max_attempts)
                self._log(f"supervisor: leg {leg.name!r} exhausted "
                          f"{self.policy.max_attempts} attempts; continuing")
                exhausted = True
        return 1 if exhausted else 0


def legs_from_json(text: str) -> list[Leg]:
    """Parse a JSON list of leg dicts (the ``--legs`` file format)."""
    data = json.loads(text)
    if not isinstance(data, list):
        raise ValueError("legs file must be a JSON list of leg objects")
    return [Leg.from_dict(d) for d in data]


def main(argv: list[str] | None = None) -> int:
    """The supervisor's command line (module docstring)."""
    obs_events.install_from_env()  # PCTPU_OBS_EVENTS: leg/heartbeat timeline
    ap = argparse.ArgumentParser(
        prog="python -m parallel_convolution_tpu_torch.resilience.supervisor",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--legs", help="JSON legs file (see above)")
    ap.add_argument("--state-dir", default="supervised_state",
                    help="ledger + captures + HALT sentinel directory")
    ap.add_argument("--max-attempts", type=int, default=5)
    ap.add_argument("--base-delay", type=float, default=10.0,
                    help="first backoff (seconds); doubles per attempt")
    ap.add_argument("--max-delay", type=float, default=240.0,
                    help="backoff cap")
    ap.add_argument("--seed", type=int, default=0,
                    help="jitter seed (schedules are deterministic)")
    ap.add_argument("--status", action="store_true",
                    help="print the current ledger and exit")
    ap.add_argument("--clear-halt", action="store_true",
                    help="remove the HALT sentinel (after fixing the cause)")
    args = ap.parse_args(argv)

    state = Path(args.state_dir)
    if args.status:
        ledger = state / LEDGER_NAME
        print(ledger.read_text() if ledger.exists()
              else json.dumps({"legs": {}, "halt": None}))
        return 0
    if args.clear_halt:
        halt = state / HALT_NAME
        if halt.exists():
            shutil.copy(halt, halt.with_suffix(".cleared"))
            halt.unlink()
            print(f"removed {halt} (copy kept at {halt}.cleared)")
        return 0
    if not args.legs:
        ap.error("--legs is required")
    legs = legs_from_json(Path(args.legs).read_text())
    sup = Supervisor(
        legs, state,
        policy=RetryPolicy(max_attempts=args.max_attempts,
                           base_delay=args.base_delay,
                           max_delay=args.max_delay, seed=args.seed))
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
