"""host_finish_ms_per_tile.best: host ms in batch.encode_finish (the
containers: the headers, the words' bytes) per tile the window completed
by batch.encode_tiles in a best mode, wrapped from outside the program."""

SPANS = {"encode_finish": ["qb3_tpu_torch.batch:encode_finish"]}


def read(run):
    s = run.span_seconds("encode_finish")
    tiles = run.totals("window")[0]
    return s * 1e3 / tiles if s and tiles else None
