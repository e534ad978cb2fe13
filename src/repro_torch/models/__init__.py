"""The model stack of the port: the dense, MoE and M-RoPE decoder-only
transformer (:mod:`transformer`, :mod:`moe`), the zamba2 hybrid
(:mod:`zamba` on :mod:`mamba2`), xLSTM (:mod:`xlstm`) and the
encoder-decoder (:mod:`encdec`), on shared layers (:mod:`layers`,
:mod:`attention`), behind :func:`model_zoo.build_model`."""
from repro_torch.models.model_zoo import Model, build_model, pad_cache, params_from_numpy

__all__ = ["Model", "build_model", "pad_cache", "params_from_numpy"]
