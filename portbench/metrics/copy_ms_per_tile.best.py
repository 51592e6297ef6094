"""copy_ms_per_tile.best: device ms of the best batch's pageable copies
per tile, over the window: the passes' uploads (the program's
batch.upload spans) plus the blocking fetch (batch.fetch), each timed by
CUDA events, so a copy is timed apart from the wait before it."""

from portbench import spans

spans.switch_on()


def read(run):
    records = spans.program_records()
    parts = [spans.ms_per_tile(run, name, "device_ms", records)
             for name in ("batch.upload", "batch.fetch")]
    return None if None in parts else sum(parts)
