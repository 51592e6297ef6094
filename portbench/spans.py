"""What the program-span metrics share: the program's own tracer
(qb3_tpu_torch.profiling), read over a run's window.

Loading a reader switches the tracer on (only a traced run loads them, so
the end-to-end runs measure with it off).  A program without the tracer
gives no records, and its readers give None.
"""

from __future__ import annotations


def switch_on() -> None:
    """Switch the program's tracer on, where the program has one."""
    from qb3_tpu_torch import profiling

    enable = getattr(profiling, "enable", None)
    if enable is not None:
        enable()


def program_records() -> list:
    """The program's span records (qb3_tpu_torch.profiling.records), or []."""
    from qb3_tpu_torch import profiling

    read = getattr(profiling, "records", None)
    return read() if read is not None else []


def in_window(records, run) -> list:
    """The records whose host end lies between the first and the last
    completion of the run's window (its ticks)."""
    ticks = run.ticks["window"]
    if not ticks:
        return []
    lo, hi = ticks[0][0] * 1e9, ticks[-1][0] * 1e9
    return [r for r in records if lo <= r["t1_ns"] <= hi]


def ms_per_tile(run, name: str, clock: str, records=None) -> float | None:
    """Sum of the window's `name` spans' durations over the sum of their
    tiles, in ms; clock "host_ms" or "device_ms".  None without such
    spans, and for device_ms where a span has no device time (the CPU)."""
    rs = [r for r in in_window(program_records() if records is None else records, run)
          if r["name"] == name]
    tiles = sum(r["tiles"] for r in rs)
    if not rs or not tiles or any(r[clock] is None for r in rs):
        return None
    return sum(r[clock] for r in rs) / tiles
