"""qb3_tpu_torch — the QB3 raster codec on PyTorch and CUDA (NVIDIA H100).

The PyTorch port of qb3_tpu: the same streams byte for byte, decoded to the
same arrays.  It imports torch and numpy only, never jax or qb3_tpu.  Every
entry point takes a ``device`` (default "cuda"); on a CUDA device the pack,
the window copy and the chunk walk are hand-written CUDA kernels (csrc/),
on the CPU their plain PyTorch twins.
"""

from .api import Decoder, Encoder, decode, encode, max_encoded_size  # noqa: F401
from .batch import decode_tiles, encode_tiles  # noqa: F401
from .constants import B, B2, HILBERT, ZCURVE, DType, Error, Mode  # noqa: F401
from .errors import (QB3DataError, QB3Error, QB3HeaderError,  # noqa: F401
                     QB3ShapeError)

__version__ = "0.1.0"
