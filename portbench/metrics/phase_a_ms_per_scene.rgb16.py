"""phase_a_ms_per_scene.rgb16: device ms of the image-layout phase A a
photo (the program's encode.phase_a spans, one a strip: api.fused_encode's
phase_a_image, plain PyTorch ops, timed by CUDA events on the current
stream), over the window of the photo ingest."""

from portbench import per_scene, spans

spans.switch_on()


def read(run):
    return per_scene.ms_per_scene(run, "encode.phase_a", "device_ms")
