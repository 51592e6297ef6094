"""host_walk_ms_per_tile.foreign: host ms in foreign.plan_streams (the
headers, the RLE and the threaded C++ walks of a batch, its flat plan)
per tile the window completed, wrapped from outside the program."""

SPANS = {"plan_streams": ["qb3_tpu_torch.foreign:plan_streams"]}


def read(run):
    s = run.span_seconds("plan_streams")
    tiles = run.totals("window")[0]
    return s * 1e3 / tiles if s and tiles else None
