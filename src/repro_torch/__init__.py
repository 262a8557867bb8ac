"""PyTorch/CUDA port of the sparse pattern search engine (``repro``).

Mirrors the module layout of ``src/repro``: ``core.engine`` drives the
search, ``kernels`` holds the hand-written CUDA kernels (``kernels/csrc``)
with a plain PyTorch version beside each. Runs on a CUDA card unless a
caller passes ``device="cpu"`` (``repro_torch.device``).
"""
