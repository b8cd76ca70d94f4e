from .config import ModelConfig
from .lm import (forward, init_cache_specs, layer_flags, loss_fn,
                 param_specs)
from .params import (ParamSpec, abstract_params, axes_tree, count_params,
                     init_params, param_bytes, params_from_numpy,
                     gather_params, shard_params)
