"""flash_roofline.train: the flash-attention kernel's least time (causal
pairs only) over its device time in the traced window."""
from perfbench.lib import readers, work


def read(run):
    return readers.roofline(run, "flash_attention", readers.is_flash,
                            work.flash_work)
