"""Compute ops for the hot paths, in plain JAX that XLA compiles.

Each op keeps a straightforward reference form beside the one the models
use; tests check them against each other.
"""

from gcnbmp_tpu.ops.aggregate import edge_type_aggregate
from gcnbmp_tpu.ops.circular import circular_correlation

__all__ = ["edge_type_aggregate", "circular_correlation"]
