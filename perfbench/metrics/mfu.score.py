"""mfu.score: the scoring forwards' model FLOPs over the window, a
share of the chips' bf16 peak."""
from perfbench.lib.readers import mfu_window as read  # noqa: F401
