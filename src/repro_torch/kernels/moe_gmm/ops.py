"""The grouped expert matmul: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.  Its backward differentiates the plain version, as
the reference's ``custom_vjp`` does (``repro/kernels/moe_gmm/ops.py``):
the JAX package has no backward kernel, its VJP of the jnp oracle runs
outside any Pallas kernel, so this is its backward, not a fallback."""
from __future__ import annotations

import torch

from .. import count_as_plain
from . import kernel, ref


@torch.library.custom_op("repro_torch::gmm", mutates_args=())
def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward as one dispatcher op: the kernel for CUDA tensors, the
    plain version for CPU tensors; under ``FakeTensorMode`` the kernel's
    output shape."""
    if x.is_cuda:
        return kernel.gmm(x.contiguous(), w.contiguous())
    return ref.gmm_ref(x, w)


@_forward.register_fake
def _(x, w):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


count_as_plain(torch.ops.repro_torch.gmm, ref.gmm_ref)


class _GMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.gmm_ref(x, w)
        return torch.autograd.grad(out, (x, w), g)


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, F] -> [E, C, F] in x's dtype."""
    return _GMM.apply(x, w)
