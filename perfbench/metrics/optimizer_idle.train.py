"""optimizer_idle.train: the idle time of the gaps that began while the
host was in a ``train.optimizer`` span (AdamW), a share of the traced
window."""
from perfbench.lib import spans


def read(run):
    return spans.idle_share(run, "train.optimizer")
