"""sha256 pins of the reference's outputs at the benchmark's sizes, and of
small signed rasters' streams in the modes and steps the reference takes.

Each was computed with the JAX package qb3_tpu (qb3_tpu.encode or
qb3_tpu.decode); the first three are kept by the port's own tests beside
its qb3_tpu_torch/benchutil.py.  The benchmark holds its own copies so that
it reads nothing of the program.
"""

# encode(headline_image(), FTL, index="ic"): u8 512x512x3
HEADLINE_SHA256 = "0d9874e5145ee36edf488c1e5525407266c2f652f42903571313940e791b09d9"

# the repository's Landsat sample (web/sample_landsat8.qb3: 512x512x8 u16,
# CF_H, no sidecar): the sha256 of its decoded raster's bytes
LANDSAT_SAMPLE = "web/sample_landsat8.qb3"
LANDSAT_SHA256 = "ae926ac98a0bcc7b89b9d83f3c774597d283f10df448bb4a77f90c61aa1ba2a9"

# that raster encoded again in CF_H without a sidecar: the sample's own bytes
LANDSAT_ENCODE_SHA256 = "a43370c26b9aeeb264b282f9f7a969f16ed60daffd49ef2c0eace3cf241aa2e9"

# Small signed rasters: signed_raster(kind, dtype, h, w, bands, seed) of
# portbench/tests/test_portbench_reference.py encoded with
# qb3_tpu.encode(img, mode=MODES[mode], quanta=quanta, away=away) on the CPU.
# Key: (kind, dtype, (h, w, bands), seed, mode, quanta, away, rle), where
# rle says whether an RLE0 mode took its pass ("taken", the header names
# the RLE mode) or not ("refused", it names the coding mode); value: the
# stream's sha256, with its size and header mode.
SIGNED = {
    ('dem', 'int8', (16, 16, 1), 1, 'FTL', 1, False, None):
        "a9426965e4e094d8cb27239d53e9777029ac236fcf2b8f5e52a4ac4b8e385a0c",  # 184 B, mode 8
    ('dem', 'int16', (24, 40, 3), 2, 'FTL', 1, False, None):
        "7710d7db3af046cc17326fc1c1568bb22a3e866c0a5b96ce6305f30ea7026025",  # 2897 B, mode 8
    ('dem', 'int8', (24, 40, 3), 3, 'CF_H', 2, False, None):
        "4a443b52ecbc42779b9a969dc17ab0de2d141d7d6cb33e4520f4a75698ee092c",  # 987 B, mode 5
    ('dem', 'int8', (32, 16, 8), 4, 'CF_H', 2, True, None):
        "94e7a253ab9aab6cf189ae68cbb9f1fac068ee147dd5c92191f0af68806fa29e",  # 2038 B, mode 5
    ('dem', 'int16', (32, 16, 8), 5, 'FTL', 4, False, None):
        "8e3afd6e6d20db6c6c30ee2d6bac1f1be5e458576aef6469cde6fff79833d7b9",  # 5401 B, mode 8
    ('dem', 'int16', (24, 40, 3), 6, 'BASE_H', 4, True, None):
        "67adc1942b52438f73245880503c8ef60e78cb5289e909b60a70e2b82190e13d",  # 2374 B, mode 4
    ('dem', 'int16', (16, 16, 1), 7, 'CF_H', 10, False, None):
        "2d55eac57a6bf4e69c3412803df8772e5da06d54c9532f3b9feec52353ab1e31",  # 214 B, mode 5
    ('dem', 'int8', (32, 16, 8), 8, 'FTL', 10, True, None):
        "66db10c5990ec9ffbc14cefdc12613efcc82a36591b65557fa8d398bd85ddd1a",  # 1703 B, mode 8
    ('dem', 'int16', (64, 64, 1), 9, 'CF_RLE_H', 4, False, 'taken'):
        "f7faaee841f74548c85945f3eb2f9d5d16382333b2b07e99ce4fc5ff6edd5321",  # 3241 B, mode 7
    ('noise', 'int16', (24, 40, 3), 10, 'CF_RLE_H', 4, False, 'refused'):
        "595130314535ba4af112b1bbcb1fce03bd9bfc3a2ed9ad8f0071621b31ced195",  # 5555 B, mode 5
    ('dem', 'int8', (64, 64, 1), 11, 'RLE_H', 1, False, 'taken'):
        "6acac348c23ea5f0cca5d382099d0aa6069f1aade965b7c2c2e773230919b89b",  # 1827 B, mode 6
    ('noise', 'int8', (32, 16, 8), 12, 'RLE_H', 3, True, 'refused'):
        "a7d35870ea4d1e452045d2ddcbaf15117411b57e5455648ba57d90b450f67c32",  # 3833 B, mode 4
    ('dem', 'int16', (32, 32, 1), 13, 'CF_RLE_H', 1, False, 'refused'):
        "f79c41428d669507d4148e12c1ffe895a856ac273efc8dea884c5280a2d6adcb",  # 664 B, mode 5
}
