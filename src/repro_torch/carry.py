"""Carry corpus state from the JAX package into the port.

Data takes the place of weights in this system: to hold the two packages
against each other they must score the same corpus. ``from_reference``
takes the reference's corpus state, duck-typed and without importing it,
and returns the port's:

  - a corpus (anything with ``ids``, ``vals``, ``norms``, ``doc_ids``,
    numpy or array-like) -> ``repro_torch.core.corpus.Corpus`` (host);
  - a 1-D packed uint32 Fig. 8 stream -> the same stream as numpy uint32;
  - a packed tile matrix (2-D uint32, or a slab with ``.tiles``) ->
    ``PackedSlab`` on ``device`` (int32 view of the words).
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.core.corpus import Corpus
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels.fused import PackedSlab


def from_reference(state, device: DeviceLike = None
                   ) -> Union[Corpus, np.ndarray, PackedSlab]:
    """The port's counterpart of one piece of the reference's corpus
    state (see the module docstring). Arrays are copied; ``device`` is
    used only for tile matrices."""
    if all(hasattr(state, f) for f in ("ids", "vals", "norms", "doc_ids")):
        return Corpus(np.array(state.doc_ids, np.int64),
                      np.array(state.ids, np.int32),
                      np.array(state.vals, np.float32),
                      np.array(state.norms, np.float32))
    tiles = getattr(state, "tiles", None)
    arr = np.asarray(state if tiles is None else tiles)
    if arr.dtype != np.uint32:
        raise TypeError(f"expected a corpus, or packed uint32 words; got "
                        f"{type(state).__name__} of {arr.dtype}")
    if arr.ndim == 1 and tiles is None:
        return arr.copy()
    if arr.ndim == 2:
        words = np.ascontiguousarray(arr).view(np.int32).copy()
        return PackedSlab(torch.from_numpy(words).to(resolve(device)))
    raise ValueError(f"packed words must be a 1-D stream or a 2-D tile "
                     f"matrix, got shape {arr.shape}")
