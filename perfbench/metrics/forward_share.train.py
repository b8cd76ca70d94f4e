"""forward_share.train: the device time inside the train step's
``train.forward`` spans (each microbatch's loss: the forward, the fp32
head and the NLL), a share of the traced window."""
from perfbench.lib import spans


def read(run):
    return spans.device_share(run, "train.forward")
