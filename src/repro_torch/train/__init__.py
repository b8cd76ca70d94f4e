from .optimizer import adamw_init, adamw_update, OptConfig
from .step import make_train_step, train_step_fn
