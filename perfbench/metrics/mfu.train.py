"""mfu.train: the training steps' model FLOPs (forward and backward,
recomputation not counted) over the window, a share of the bf16 peak."""
from perfbench.lib.readers import mfu_window as read  # noqa: F401
