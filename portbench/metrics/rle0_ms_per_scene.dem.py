"""rle0_ms_per_scene.dem: host ms of the RLE0 post-pass a scene (the
program's finish.rle0 spans, in framing.Frame.finish's RLE branch: the
native C++ pass where it loads), over the window of the scene ingest."""

from portbench import per_scene, spans

spans.switch_on()


def read(run):
    return per_scene.ms_per_scene(run, "finish.rle0", "host_ms")
