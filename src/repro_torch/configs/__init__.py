"""Architecture configs (shapes only): importing the package registers every
arch. Mirrors ``repro.configs``."""
from repro_torch.configs.base import get_config, list_archs, reduced, register
from repro_torch.configs import (whisper_large_v3, recurrentgemma_2b,
                                 starcoder2_7b, gemma3_1b, mistral_nemo_12b,
                                 gemma2_27b, granite_moe_3b, dbrx_132b,
                                 xlstm_125m, internvl2_26b)

__all__ = ["get_config", "list_archs", "reduced", "register"]
