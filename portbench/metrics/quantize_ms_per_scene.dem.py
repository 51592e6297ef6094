"""quantize_ms_per_scene.dem: host ms of the strip encoder's quantizer a
scene (the program's strip.quantize spans, one a strip: each value divided
by the step on the host), over the window of the scene ingest."""

from portbench import per_scene, spans

spans.switch_on()


def read(run):
    return per_scene.ms_per_scene(run, "strip.quantize", "host_ms")
