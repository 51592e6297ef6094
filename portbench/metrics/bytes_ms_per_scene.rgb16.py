"""bytes_ms_per_scene.rgb16: host ms of the strip encoder's byte stream a
photo (the program's strip.bytes spans, one a finish(): the stitched
words' download and words_to_bytes), over the window of the photo
ingest."""

from portbench import per_scene, spans

spans.switch_on()


def read(run):
    return per_scene.ms_per_scene(run, "strip.bytes", "host_ms")
