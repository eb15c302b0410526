"""Port of nemotron_tpu.losses: the RNN-T and TDT lattice losses."""

from .rnnt import rnnt_loss  # noqa: F401
