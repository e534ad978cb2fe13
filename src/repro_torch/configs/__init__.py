from repro_torch.configs.base import (  # noqa: F401
    KERNEL_BACKENDS,
    FamConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeSpec,
    XLSTMConfig,
    fam_replace,
    smoke_variant,
)
