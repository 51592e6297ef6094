"""What the scene cells' span metrics share: Σ ms of the window's program
spans of one name over the scenes whose spans those are.

spans.in_window keeps the records that end between the window's first
completion and its last; a scene's spans all end before its own
completion and after the one before it, so those are the spans of every
scene the window completed but its first.
"""

from __future__ import annotations

from portbench import spans


def ms_per_scene(run, name: str, clock: str) -> float | None:
    """Σ of the window's `name` spans' durations over the scenes they belong
    to, in ms; clock "host_ms" or "device_ms".  None without such spans or
    a second completion, and for device_ms where a span has no device time
    (the CPU)."""
    rs = [r for r in spans.in_window(spans.program_records(), run) if r["name"] == name]
    scenes = len(run.ticks["window"]) - 1
    if not rs or scenes < 1 or any(r[clock] is None for r in rs):
        return None
    return sum(r[clock] for r in rs) / scenes
