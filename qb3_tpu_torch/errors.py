"""Typed error model, mirroring the reference's qb3_error enum and decode
semantics (QB3.h:77-83, QB3decode.h:577, QB3decode.cpp:380-449).

All errors subclass ValueError so pre-existing callers catching ValueError
keep working.  The mapping to the reference:

  QB3HeaderError  <-> QB3E_EINV/QB3E_UNKN from qb3_read_start/qb3_read_info
                      (bad signature, bad chunk, unknown uppercase chunk)
  QB3DataError    <-> qb3_read_data returning 0 with p->error set: the
                      payload failed the decoder's corruption checks
                      (`failed` accumulation, >7 leftover bits, RLE guard)
  QB3ShapeError   <-> unsupported configuration of this engine's parallel
                      paths (the reference has no equivalent; these replace
                      bare asserts so they survive python -O)
"""


class QB3Error(ValueError):
    """Base class for all QB3 codec errors."""


class QB3HeaderError(QB3Error):
    """Malformed container headers (signature, chunk structure, metadata)."""


class QB3DataError(QB3Error):
    """Corrupt entropy-coded payload detected during decode.

    Carries `partial`: the best-effort decoded image (groups after the
    failure point decode as zeros), matching the reference's behavior of
    returning 0 from qb3_read_data while leaving partial output in the
    destination buffer (QB3decode.h:713-716 breaks out mid-image).
    """

    def __init__(self, msg: str, partial=None):
        super().__init__(msg)
        self.partial = partial


class QB3ShapeError(QB3Error):
    """Unsupported shape/mode configuration for a parallel fast path."""
