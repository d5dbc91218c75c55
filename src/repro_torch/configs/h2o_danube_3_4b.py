"""Config for ``h2o-danube-3-4b`` (--arch h2o-danube-3-4b). Exact public numbers; see
repro_torch.models.archs for the registry entry and source citation."""

from repro_torch.models.archs import H2O_DANUBE3_4B as _CFG
from repro_torch.models.archs import reduced_config


def config():
    return _CFG


def smoke_config():
    return reduced_config(_CFG)
