from .config import LayerSpec, ModelConfig, layer_plan, scan_plan
from .transformer import forward, init_caches, init_params, param_shapes
