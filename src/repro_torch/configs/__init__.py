from repro_torch.configs.base import KERNEL_BACKENDS, FamConfig, fam_replace  # noqa: F401
