"""HopsFS in PyTorch, with hand-written CUDA kernels: the metadata plane
and the model stack that uses it.

``repro_torch.core`` runs the planned request path on the columnar store;
its integer hot paths (partition hashing, chain hashing, PK validation,
hint-chain resolution, subtree waves) launch the kernels of
``repro_torch.kernels`` on the card.  ``repro_torch.models`` and
``repro_torch.serve`` run the zamba2 hybrid model (scoring and prefill
``forward``, the serving engine), whose attention and Mamba2 scan launch
the flash-attention and SSD kernels.  Entry points run on CUDA unless the
caller passes ``device="cpu"``, which routes every kernel family to its
plain PyTorch version.
"""
