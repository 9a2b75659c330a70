"""humid_tpu — reference-free FastQ deduplication on an accelerator.

A from-scratch rebuild of the capabilities of jfjlaros/HUMID in JAX:
2-bit packed integer fingerprints, batched XOR+popcount / one-hot
matmul distance tiles, iterative label-propagation clustering, and
data-parallel sharding over device meshes.  See SURVEY.md for the
behavioural contract.
"""

from ._util import tune_malloc  # noqa: F401
from .pipeline import run, PipelineResult

__version__ = "0.1.0"

__all__ = ["run", "PipelineResult", "__version__"]
