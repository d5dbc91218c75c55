"""Config for ``phi3.5-moe-42b-a6.6b`` (--arch phi3.5-moe-42b-a6.6b). Exact public numbers; see
repro_torch.models.archs for the registry entry and source citation."""

from repro_torch.models.archs import PHI35_MOE as _CFG
from repro_torch.models.archs import reduced_config


def config():
    return _CFG


def smoke_config():
    return reduced_config(_CFG)
