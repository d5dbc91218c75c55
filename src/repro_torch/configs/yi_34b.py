"""Config for ``yi-34b`` (--arch yi-34b). Exact public numbers; see
repro_torch.models.archs for the registry entry and source citation."""

from repro_torch.models.archs import YI_34B as _CFG
from repro_torch.models.archs import reduced_config


def config():
    return _CFG


def smoke_config():
    return reduced_config(_CFG)
