"""push_ms_per_scene.rgb16: host ms of StripEncoder.push a photo (the
program's strip.push spans: the rows' copy into the pending buffer, and
each strip the push completes: its upload, the image-layout phase A, K8
and the blocking reads of its exit state and bit total), over the window
of the photo ingest."""

from portbench import per_scene, spans

spans.switch_on()


def read(run):
    return per_scene.ms_per_scene(run, "strip.push", "host_ms")
