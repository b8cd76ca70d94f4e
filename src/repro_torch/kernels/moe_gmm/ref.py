"""Plain version of the grouped matmul, as the JAX package's ``gmm_ref``:
fp32 products and sums (the kernel's accumulator), the result in x's
dtype; any device."""
import torch


def gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, F] -> [E, C, F]."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
