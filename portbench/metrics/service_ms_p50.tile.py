"""service_ms_p50.tile: the median host time of one qb3_tpu_torch.decode
call, from its start to the array on the host, without the queue's wait
(the serve driver's service_s samples of the window)."""

from portbench import harness


def read(run):
    s = run.samples.get("service_s")
    return harness.median(s) * 1e3 if s else None
