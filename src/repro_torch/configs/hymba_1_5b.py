"""Config for ``hymba-1.5b`` (--arch hymba-1.5b). Exact public numbers; see
repro_torch.models.archs for the registry entry and source citation."""

from repro_torch.models.archs import HYMBA_1_5B as _CFG
from repro_torch.models.archs import reduced_config


def config():
    return _CFG


def smoke_config():
    return reduced_config(_CFG)
