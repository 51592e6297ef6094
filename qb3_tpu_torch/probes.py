"""The Mosaic probes of tools/probe_mosaic.py on the port's kernels P1-P7.

    python -m qb3_tpu_torch.probes [names] [--device cuda|cpu]

Each probe builds its inputs as the TPU probe does (the same arange and %
values, P1's iota rounded to bf16 before its %), runs its kernel (ops/probe_cuda.py, csrc/probes.cu) on the device,
holds the output to the probe's own NumPy check, prints the probe's line
("dim0-contraction dot: OK" or "... WRONG") and returns whether it held.
With no names it runs the TPU file's default four (dim0_dot 1d_dma flatten
3d_dma); every probe, lane_write, lane_concat and flatten_big included, is
defined above the __main__ block and can be named.  The exit code is 0 when
every probe named printed OK.  On a CPU device the kernels' plain twins run.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .ops import probe_cuda

DEFAULT = ["dim0_dot", "1d_dma", "flatten", "3d_dma"]


def probe_inputs(name: str, device="cuda") -> tuple:
    """The probe's inputs, as its kernel's wrapper takes them: tensors on
    `device` and the static sizes."""
    dev = torch.device(device)

    def iota(*shape):
        return torch.arange(int(np.prod(shape)), dtype=torch.int32).reshape(shape).to(dev)

    if name == "dim0_dot":
        # as the probe: the iota rounded to bf16 first (above 256 not every
        # integer is a bf16, 257 -> 256), then the % in bf16, on the host
        def bf16_iota_mod(n, m):
            return torch.arange(n, dtype=torch.float32).to(torch.bfloat16) % m

        a = bf16_iota_mod(256 * 64, 7).reshape(256, 64)
        b = bf16_iota_mod(256 * 128, 5).reshape(256, 128)
        return a.to(dev), b.to(dev)
    if name == "1d_dma":
        return iota(5000), torch.tensor([137], dtype=torch.int32, device=dev), 256
    if name == "flatten":
        return (iota(4, 128),)
    if name == "3d_dma":
        return iota(8, 64, 128), torch.tensor([13], dtype=torch.int32, device=dev), 4
    if name == "lane_write":
        return iota(128, 48), 256, 64
    if name == "lane_concat":
        return iota(128, 48), 4
    if name == "flatten_big":
        return (iota(544, 8),)
    raise KeyError(name)


# probe -> (its kernel's wrapper, the kernel's plain twin)
KERNELS = {"dim0_dot": (probe_cuda.dim0_dot, probe_cuda.dim0_dot_plain),
           "1d_dma": (probe_cuda.dma_1d, probe_cuda.dma_1d_plain),
           "flatten": (probe_cuda.flatten, probe_cuda.flatten_plain),
           "3d_dma": (probe_cuda.dma_3d, probe_cuda.dma_3d_plain),
           "lane_write": (probe_cuda.lane_write, probe_cuda.lane_write_plain),
           "lane_concat": (probe_cuda.lane_concat, probe_cuda.lane_concat_plain),
           "flatten_big": (probe_cuda.flatten_big, probe_cuda.flatten_plain)}


def _report(line: str, ok: bool) -> bool:
    print(f"{line}: {'OK' if ok else 'WRONG'}", flush=True)
    return ok


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def probe_dim0_dot(device="cuda") -> bool:
    """Aᵀ·B with the contraction over dim 0 of A (P1)."""
    a, b = probe_inputs("dim0_dot", device)
    out = probe_cuda.dim0_dot(a, b)
    ref = _host(a.float()).T @ _host(b.float())
    return _report("dim0-contraction dot", np.array_equal(_host(out), ref))


def probe_1d_dma(device="cuda") -> bool:
    """A copy from a flat 1-D source at an offset read on the device (P2)."""
    src, offs, n = probe_inputs("1d_dma", device)
    out = probe_cuda.dma_1d(src, offs, n)
    return _report("1-D HBM arbitrary-offset DMA",
                   np.array_equal(_host(out).reshape(-1), np.arange(137, 137 + 256)))


def probe_flatten(device="cuda") -> bool:
    """An in-kernel (4, 128) -> (1, 512) reshape (P3)."""
    (x,) = probe_inputs("flatten", device)
    out = probe_cuda.flatten(x)
    return _report("sublane->lane flatten",
                   np.array_equal(_host(out).reshape(-1), np.arange(512)))


def probe_3d_dma(device="cuda") -> bool:
    """A copy of a middle-dim slice of a 3-D source at an offset read on the
    device (P4)."""
    src, off, n = probe_inputs("3d_dma", device)
    out = probe_cuda.dma_3d(src, off, n)
    return _report("3-D middle-dim DMA", np.array_equal(_host(out), _host(src)[:, 13:17, :]))


def probe_lane_write(device="cuda") -> bool:
    """A write at column offset 64 of a zeroed output (P5)."""
    x, width, col = probe_inputs("lane_write", device)
    out = probe_cuda.lane_write(x, width, col)
    return _report("lane-offset write @64", np.array_equal(_host(out)[:, 64:112], _host(x)))


def probe_lane_concat(device="cuda") -> bool:
    """[x, x + 1, x + 2, x + 3] along the columns, 48 wide each (P6)."""
    x, copies = probe_inputs("lane_concat", device)
    out = probe_cuda.lane_concat(x, copies)
    ref = np.concatenate([_host(x) + i for i in range(4)], axis=1)
    return _report("lane concat 4x48", np.array_equal(_host(out), ref))


def probe_flatten_big(device="cuda") -> bool:
    """A (544, 8) -> (1, 4352) flatten, the place stage's word grid (P7)."""
    (x,) = probe_inputs("flatten_big", device)
    out = probe_cuda.flatten_big(x)
    return _report("flatten (544,8)->(1,4352)",
                   np.array_equal(_host(out).reshape(-1), np.arange(4352)))


PROBES = {"dim0_dot": probe_dim0_dot, "1d_dma": probe_1d_dma, "flatten": probe_flatten,
          "3d_dma": probe_3d_dma, "lane_write": probe_lane_write,
          "lane_concat": probe_lane_concat, "flatten_big": probe_flatten_big}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run the Mosaic probes on the port's kernels.")
    p.add_argument("names", nargs="*", help=f"probes to run (default: {' '.join(DEFAULT)}; "
                   f"all: {' '.join(PROBES)})")
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their twins)")
    args = p.parse_args(argv)
    ok = True
    for name in args.names or DEFAULT:
        try:
            ok &= PROBES[name](args.device)
        except Exception as e:  # a failed probe is reported, and the exit code says so
            print(f"{name}: FAIL {type(e).__name__}: {str(e)[:300]}", flush=True)
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
