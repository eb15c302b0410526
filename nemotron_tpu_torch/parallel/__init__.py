"""Multi-GPU: a (data, model) mesh over torch.distributed ranks
(`mesh`), the collectives it writes out (`collectives`), and the
multi-process engines (`multihost`)."""

from .mesh import make_mesh, param_shardings, state_shardings  # noqa: F401
