"""Pure-Python bit-exact oracle of the reference pipeline.

Used by the test-suite as ground truth for the device kernels, and validated
once against the compiled reference binaries via golden files.
"""

from supersampler_tpu.oracle.subsampler import OracleSubsampler
from supersampler_tpu.oracle.comparator import OracleComparator

__all__ = ["OracleSubsampler", "OracleComparator"]
