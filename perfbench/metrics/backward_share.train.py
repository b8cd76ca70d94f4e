"""backward_share.train: the device time inside the train step's
``train.backward`` spans (``torch.autograd.grad``, the layers recomputed
under remat), a share of the traced window."""
from perfbench.lib import spans


def read(run):
    return spans.device_share(run, "train.backward")
