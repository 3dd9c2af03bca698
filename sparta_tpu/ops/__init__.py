from .bell_xla import bell_spmm_xla, bell_spmm_xla_ba, bell_spmm_xla_unrolled
from .blocked import bell_spmm_triton, blocked_spmm, spmm_route
from .csr_spmm import (
    EllDevice,
    bcoo_spmm,
    csr_spmm_auto,
    csr_to_bcoo,
    dense_matmul,
    ell_spmm,
)
from .attention import (
    BlockMask,
    block_mask_from_csr,
    block_sparse_attention,
    build_block_mask,
)
from .device import BellDevice, pad_b_for_bell
from .fine import (
    DedupDevice,
    FellDevice,
    FineDevice,
    dedup_pair_from_csr,
    dedup_spmm,
    dedup_spmm_ad,
    fell_spmm,
    fine_spmm,
    mask_combine,
)
from .quant import (
    QBellDevice,
    bell_spmm_quant,
    quantize_b_cols,
    quantize_b_global_cols,
)
from .select import SpmmPlan, plan_spmm
from .vbr_pallas import vbr_kernel_device, vbr_spmm_pallas
from .vbr_xla import VbrDevice, vbr_spmm_xla, vbr_spmm_xla_ba

__all__ = [
    "BellDevice",
    "EllDevice",
    "VbrDevice",
    "DedupDevice",
    "FellDevice",
    "FineDevice",
    "bcoo_spmm",
    "bell_spmm_triton",
    "blocked_spmm",
    "spmm_route",
    "bell_spmm_xla",
    "bell_spmm_xla_ba",
    "bell_spmm_xla_unrolled",
    "csr_spmm_auto",
    "csr_to_bcoo",
    "dense_matmul",
    "ell_spmm",
    "BlockMask",
    "block_mask_from_csr",
    "block_sparse_attention",
    "build_block_mask",
    "dedup_pair_from_csr",
    "dedup_spmm",
    "dedup_spmm_ad",
    "fell_spmm",
    "fine_spmm",
    "mask_combine",
    "pad_b_for_bell",
    "plan_spmm",
    "QBellDevice",
    "bell_spmm_quant",
    "quantize_b_cols",
    "quantize_b_global_cols",
    "SpmmPlan",
    "vbr_kernel_device",
    "vbr_spmm_pallas",
    "vbr_spmm_xla",
    "vbr_spmm_xla_ba",
]
