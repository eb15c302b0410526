"""Numpy test oracle: the port's own copy of `nemotron_tpu/oracle/`.

Plays the role of the reference's naive pure-C++ model
(reference src/reference/*.cpp): a slow, obviously-correct implementation of
every module, the differential ground truth for the PyTorch/CUDA model (the
parity tools under `nemotron_tpu_torch/scripts/` and the tests). It
consumes raw weight dicts in the reference's PyTorch-order naming
(docs/TENSOR_SHAPES.md), a deliberately separate code path from
nemotron_tpu_torch.params, and imports neither torch nor the JAX package.
"""

from .beam import OracleBeam  # noqa: F401
from .model import OracleModel, OracleStream  # noqa: F401
from .preprocessor import OraclePreprocessor  # noqa: F401
