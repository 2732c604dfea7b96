"""Flight recorder: a ring buffer of recent control-plane state that is
dumped when something goes wrong (a copy of `repro.obs.recorder`, pure
Python, kept here so the port imports nothing of the JAX package).

The QoS plane appends one `note()` per tick with the per-class /
per-shard state worth having at an incident (rungs, canary estimates,
drift, thresholds); the serving engine `amend()`s the same entry with
tick latency and occupancy once the tick completes. On a hard precise
fallback or a monitor violation, `trip(reason, ...)` freezes the last N
entries into a dump -- kept in memory for tests and post-hoc analysis,
and written to `<out_dir>/flight_<seq>_<reason>.json` when an output
directory is configured.

Unlike tracing, the recorder is cheap enough to leave ALWAYS ON for the
QoS plane (one small dict append per tick on the host; the ring is
bounded), so the dump exists even for runs nobody thought to trace --
that is the point of a flight recorder. Format documented in
docs/observability.md.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Deque, Dict, List, Optional

DUMP_SCHEMA_VERSION = 1


class FlightRecorder:
    """Bounded ring of per-tick state snapshots + trip dumps."""

    def __init__(self, capacity: int = 64, out_dir: Optional[str] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.out_dir = out_dir
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        self.dumps: List[Dict[str, Any]] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._ring)

    def note(self, **state) -> None:
        """Append one tick's state snapshot to the ring."""
        self._ring.append(dict(state))

    def amend(self, **fields) -> None:
        """Merge fields into the most recent note (the serving engine
        closes out the entry the QoS plane opened). No-op on an empty
        ring so callers need no ordering guard."""
        if self._ring:
            self._ring[-1].update(fields)

    def window(self) -> List[Dict[str, Any]]:
        """Current ring contents, oldest first."""
        return list(self._ring)

    def trip(self, reason: str, **context) -> Dict[str, Any]:
        """Freeze the ring into a dump. The ring is NOT cleared: an
        incident right after another still sees the shared lead-up."""
        self._seq += 1
        dump = {
            "schema": DUMP_SCHEMA_VERSION,
            "seq": self._seq,
            "reason": reason,
            "context": dict(context),
            "ticks": self.window(),
        }
        self.dumps.append(dump)
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(
                self.out_dir, f"flight_{self._seq:04d}_{reason}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(dump, f, indent=2, default=str)
            os.replace(tmp, path)
            dump["path"] = path
        return dump


_RECORDER: Optional[FlightRecorder] = None


def get_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def install(capacity: int = 64,
            out_dir: Optional[str] = None) -> FlightRecorder:
    """Install a process-global recorder (what QosEngine/ServingEngine
    write to when none was passed explicitly)."""
    global _RECORDER
    _RECORDER = FlightRecorder(capacity=capacity, out_dir=out_dir)
    return _RECORDER


def uninstall() -> Optional[FlightRecorder]:
    global _RECORDER
    r, _RECORDER = _RECORDER, None
    return r
