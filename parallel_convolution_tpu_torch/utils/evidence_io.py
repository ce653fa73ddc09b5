"""Shared JSONL rewriting that preserves foreign lanes (the port's own
copy of the JAX package's ``utils/evidence_io.py``).

Several writers may co-own one JSONL file of rows, each owning a *lane*;
each writer rewrites ONLY its own rows and keeps every other lane's lines
byte-for-byte.  Ownership is declared by ``lane``:

* ``lane=None`` — the caller owns the UN-LANED rows: lines whose JSON
  carries a truthy ``"lane"`` are foreign and preserved.
* ``lane="router_scale"`` — the caller owns exactly that lane: lines
  with any OTHER lane (including none) are preserved.

Unparseable lines are dropped (a torn line is not evidence).  The rewrite
is atomic (temp + ``os.replace``) and consults the ``evidence_write``
disk fault site first (``resilience.diskio``), so a failure can never
leave a half-written file for the next reader.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

from parallel_convolution_tpu_torch.resilience import diskio

__all__ = ["rewrite_shared_jsonl"]


def rewrite_shared_jsonl(path, rows, *, lane: str | None = None) -> int:
    """Rewrite ``path`` with ``rows`` (this writer's lane), preserving
    every foreign line.  ``rows`` that do not already carry the owned
    ``lane`` are stamped with it.  Returns the number of foreign lines
    preserved.
    """
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    foreign: list[str] = []
    if p.exists():
        for line in p.read_text().splitlines():
            if not line.strip():
                continue
            try:
                row_lane = json.loads(line).get("lane")
            except (ValueError, AttributeError):
                continue
            if (row_lane if lane is None else row_lane != lane):
                foreign.append(line)
    out_rows = []
    for r in rows:
        r = dict(r)
        if lane is not None:
            r.setdefault("lane", lane)
        out_rows.append(r)
    # The evidence_write guard: a full or dying disk surfaces HERE, typed,
    # before any byte moves; the temp + replace below means a fault can
    # never tear the shared file itself.
    diskio.consult("evidence_write")
    fd, tmp = tempfile.mkstemp(dir=str(p.parent), prefix=f".{p.name}.",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            if lane is None:
                # The un-laned owner leads: own rows first, foreign lanes
                # after (the JAX package's file shape).
                for r in out_rows:
                    f.write(json.dumps(r) + "\n")
                for line in foreign:
                    f.write(line + "\n")
            else:
                # Lane owners append after the foreign lines they kept.
                for line in foreign:
                    f.write(line + "\n")
                for r in out_rows:
                    f.write(json.dumps(r) + "\n")
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return len(foreign)
