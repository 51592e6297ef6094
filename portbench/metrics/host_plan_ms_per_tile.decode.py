"""host_plan_ms_per_tile.decode: host ms in batch.plan_decode (the headers,
the sidecars' parse, the flat layout of the streams' words) per tile the
window completed, wrapped from outside the program."""

SPANS = {"plan_decode": ["qb3_tpu_torch.pipeline:plan_decode"]}


def read(run):
    s = run.span_seconds("plan_decode")
    tiles = run.totals("window")[0]
    return s * 1e3 / tiles if s and tiles else None
