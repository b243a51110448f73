"""Hand-written CUDA kernels of the DASHA-PP hot path (dense and sparse
wire), the async server's commit, BlockRandK's block gather and
scatter, and serving's paged GQA and MLA attentions, for Hopper.

Layout: ``csrc/`` holds the CUDA sources, ``build`` compiles and loads
them, ``dasha_update``, ``randk`` and ``paged_attention`` wrap the
kernels for PyTorch (checks, launch, launch counts), ``ref`` holds their
plain PyTorch versions and ``ops`` picks one of the two by the device
its tensors lie on.  Nothing here builds or loads a kernel at import time.
"""
from repro_torch.kernels.ops import (block_gather_op, block_scatter_op,
                                     buffered_commit_op, dasha_h_update_op,
                                     dasha_page_h_update_op,
                                     dasha_page_payload_blocks_op,
                                     dasha_page_update_op,
                                     dasha_payload_blocks_op, dasha_tail_op,
                                     dasha_update_batched_op,
                                     paged_attention_batched_op,
                                     paged_attention_op,
                                     paged_mla_attention_op)

__all__ = ["dasha_update_batched_op", "dasha_page_update_op",
           "dasha_tail_op", "buffered_commit_op", "dasha_h_update_op",
           "dasha_page_h_update_op", "dasha_payload_blocks_op",
           "dasha_page_payload_blocks_op", "block_gather_op",
           "block_scatter_op", "paged_attention_batched_op",
           "paged_attention_op", "paged_mla_attention_op"]
