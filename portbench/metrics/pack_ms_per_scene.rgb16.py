"""pack_ms_per_scene.rgb16: device ms of K8 a photo (the program's
encode.pack spans, one a strip: api.fused_encode's encode_pack_image, its
memset and launch, timed by CUDA events on the current stream), over the
window of the photo ingest."""

from portbench import per_scene, spans

spans.switch_on()


def read(run):
    return per_scene.ms_per_scene(run, "encode.pack", "device_ms")
