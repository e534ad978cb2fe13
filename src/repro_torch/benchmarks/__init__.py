"""The port's paper-figure drivers (counterparts of the reference's
``benchmarks/`` package), run through :mod:`repro_torch.experiments`."""
