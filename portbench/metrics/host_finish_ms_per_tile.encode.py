"""host_finish_ms_per_tile.encode: host ms in batch.encode_finish (the
containers: the "ic" sidecar's packing, the headers, the words' bytes)
per tile the pipelined encode completed, wrapped from outside the
program where pipeline.py calls it."""

SPANS = {"encode_finish": ["qb3_tpu_torch.pipeline:encode_finish"]}


def read(run):
    s = run.span_seconds("encode_finish")
    tiles = run.totals("window")[0]
    return s * 1e3 / tiles if s and tiles else None
