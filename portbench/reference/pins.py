"""sha256 pins of the reference's outputs at the benchmark's sizes.

Each was computed with the JAX package qb3_tpu (qb3_tpu.encode or
qb3_tpu.decode) and is kept by the port's own tests beside its
qb3_tpu_torch/benchutil.py; the benchmark holds its own copies so that it
reads nothing of the program.
"""

# encode(headline_image(), FTL, index="ic"): u8 512x512x3
HEADLINE_SHA256 = "0d9874e5145ee36edf488c1e5525407266c2f652f42903571313940e791b09d9"

# the repository's Landsat sample (web/sample_landsat8.qb3: 512x512x8 u16,
# CF_H, no sidecar): the sha256 of its decoded raster's bytes
LANDSAT_SAMPLE = "web/sample_landsat8.qb3"
LANDSAT_SHA256 = "ae926ac98a0bcc7b89b9d83f3c774597d283f10df448bb4a77f90c61aa1ba2a9"

# that raster encoded again in CF_H without a sidecar: the sample's own bytes
LANDSAT_ENCODE_SHA256 = "a43370c26b9aeeb264b282f9f7a969f16ed60daffd49ef2c0eace3cf241aa2e9"
