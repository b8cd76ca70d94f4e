"""head_share.score: the device time inside the LM head's spans
(``lm.head``: ``models/lm.py`` ``_logits``), a share of the traced
window."""
from perfbench.lib import spans


def read(run):
    return spans.device_share(run, "lm.head")
