"""The card's peaks and the work a call must do, for the roofline shares.

One NVIDIA H100 SXM (NVIDIA's data sheet): 80 GB of HBM3 at 3.35 TB/s
(PERF.md's kernel table takes its byte bounds from the same number).  The
published rate assumes the full 700 W power limit; PERF.md gives the
card's limit beside each share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def bytes_moved(run, phase: str = "slice") -> int:
    """The bytes the codec must move for the work a phase completed: every
    raster byte and every stream byte once (read one, write the other),
    whatever implements it."""
    _, raw, coded = run.totals(phase)
    return raw + coded


def roofline_pct(run) -> float | None:
    """The traced slice's least time at HBM bandwidth over its device-active
    time, in %; None where the run was not profiled."""
    p = run.profile
    if not p or p["active_s"] <= 0:
        return None
    return 100.0 * bytes_moved(run) / HBM_BYTES_PER_S / p["active_s"]


def idle_share(run) -> float | None:
    """1 - device-active time / wall time of the traced slice."""
    p = run.profile
    if not p:
        return None
    return 1.0 - p["active_s"] / p["wall_s"]
