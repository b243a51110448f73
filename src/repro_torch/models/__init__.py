"""repro_torch.models — the model zoo of the port, so far the dense
decoder (granite-3-2b) that the sharded LM trainer drives.

Layout (each module ports its namesake in ``repro/models``):
    common.py    ArchConfig and its sub-configs
    registry.py  get_config, get_smoke_config, INPUT_SHAPES
    layers.py    RMSNorm, RoPE, GQA attention, gated MLP (training)
    model.py     Model (dense path), init_params, leaf_names
"""
from repro_torch.models.common import ArchConfig, count_params
from repro_torch.models.model import (Model, init_params, leaf_names,
                                      param_shapes)
from repro_torch.models.registry import (INPUT_SHAPES, get_config,
                                         get_smoke_config)

__all__ = ["ArchConfig", "count_params", "Model", "init_params",
           "leaf_names", "param_shapes", "INPUT_SHAPES", "get_config",
           "get_smoke_config"]
