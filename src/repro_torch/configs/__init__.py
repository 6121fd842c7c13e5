from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, CLIPConfig, get_arch, list_archs,
)
