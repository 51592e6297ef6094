"""push_ms_per_scene.dem: host ms of StripEncoder.push a scene (the
program's strip.push spans: the rows' copy into the pending buffer, and
each strip the push completes: its host quantize, upload, phase A, K1 and
blocking reads), over the window of the scene ingest."""

from portbench import per_scene, spans

spans.switch_on()


def read(run):
    return per_scene.ms_per_scene(run, "strip.push", "host_ms")
