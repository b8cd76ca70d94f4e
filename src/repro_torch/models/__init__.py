from .config import ModelConfig
from .lm import (forward, init_cache_specs, layer_flags, param_specs)
from .params import (ParamSpec, count_params, init_params, param_bytes,
                     params_from_numpy)
