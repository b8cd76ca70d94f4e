"""optimizer_share.train: the device time inside the train step's
``train.optimizer`` spans (AdamW with the gradient's norm), a share of
the traced window."""
from perfbench.lib import spans


def read(run):
    return spans.device_share(run, "train.optimizer")
