from repro_torch.configs.base import LayerSpec, ModelConfig, reduced  # noqa: F401
from repro_torch.configs.registry import ARCHS, get_config, input_shapes  # noqa: F401
