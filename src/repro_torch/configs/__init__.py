from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES, ArchConfig, CLIPConfig, InputShape, MoEConfig, SSMConfig,
    get_arch, list_archs,
)
