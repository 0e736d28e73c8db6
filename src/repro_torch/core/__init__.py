"""FCVI core: transform (psi), theory, and the index + query path."""
from repro_torch.core.fcvi import (FCVIConfig, FCVIIndex, build,
                                   index_from_state, index_state, query)

__all__ = ["FCVIConfig", "FCVIIndex", "build", "index_from_state",
           "index_state", "query"]
