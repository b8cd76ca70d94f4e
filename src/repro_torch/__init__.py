"""HopsFS metadata plane in PyTorch, with hand-written CUDA kernels.

``repro_torch.core`` runs the planned request path on the columnar store;
its integer hot paths (partition hashing, chain hashing, PK validation,
hint-chain resolution) launch the kernels of ``repro_torch.kernels`` on the
card.  Entry points run on CUDA unless the caller passes ``device="cpu"``,
which routes every kernel family to its plain PyTorch version.
"""
