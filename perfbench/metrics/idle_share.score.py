"""idle_share.score: the share of the traced window the device was
idle (no kernel, copy or fill running)."""
from perfbench.lib.readers import idle_share as read  # noqa: F401
