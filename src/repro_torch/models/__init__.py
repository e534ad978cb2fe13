"""The model stack of the port: the dense and MoE decoder-only transformer
(:mod:`transformer`, :mod:`moe`) on shared layers (:mod:`layers`,
:mod:`attention`), behind :func:`model_zoo.build_model`."""
from repro_torch.models.model_zoo import Model, build_model, pad_cache, params_from_numpy

__all__ = ["Model", "build_model", "pad_cache", "params_from_numpy"]
