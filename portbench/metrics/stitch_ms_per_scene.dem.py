"""stitch_ms_per_scene.dem: device ms of the strips' stitch a scene (the
program's strip.stitch spans, one a finish(): K6's stitch entry over the
strips' words, timed by CUDA events), over the window of the scene
ingest."""

from portbench import per_scene, spans

spans.switch_on()


def read(run):
    return per_scene.ms_per_scene(run, "strip.stitch", "device_ms")
