"""Config for ``deepseek-v3-671b`` (--arch deepseek-v3-671b). Exact public numbers; see
repro_torch.models.archs for the registry entry and source citation."""

from repro_torch.models.archs import DEEPSEEK_V3 as _CFG
from repro_torch.models.archs import reduced_config


def config():
    return _CFG


def smoke_config():
    return reduced_config(_CFG)
