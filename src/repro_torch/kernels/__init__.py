"""Hand-written CUDA kernels of the DASHA-PP hot path and the async
server's commit, for Hopper.

Layout: ``csrc/`` holds the CUDA sources, ``build`` compiles and loads
them, ``dasha_update`` wraps the kernels for PyTorch (checks, launch,
launch counts), ``ref`` holds their plain PyTorch versions and ``ops``
picks one of the two by the device its tensors lie on.  Nothing here
builds or loads a kernel at import time.
"""
from repro_torch.kernels.ops import (buffered_commit_op, dasha_page_update_op,
                                     dasha_tail_op, dasha_update_batched_op)

__all__ = ["dasha_update_batched_op", "dasha_page_update_op",
           "dasha_tail_op", "buffered_commit_op"]
