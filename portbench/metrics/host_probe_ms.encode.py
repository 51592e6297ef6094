"""host_probe_ms.encode: the host yardstick of the run (host.probe), in ms:
the median of five timings of a fixed host workload, a copy of one batch's
raster bytes into page-locked memory and a join of one batch's stream
bytes, made by portbench and timed after the traced window in a fresh
process with the cores and environment the benchmark started with and a
fixed thread count.  Nothing the program sets reaches that process, so a
change in encode_MBps that comes with a change here came with the host's
speed."""


def read(run):
    return run.host.get("probe", {}).get("ms")
