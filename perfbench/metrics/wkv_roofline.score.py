"""wkv_roofline.score: the WKV kernel's least time (bytes or operations
at the chip's peaks) over its device time in the traced window."""
from perfbench.lib import readers, work


def read(run):
    return readers.roofline(run, "wkv6", readers.is_wkv, work.wkv_work)
