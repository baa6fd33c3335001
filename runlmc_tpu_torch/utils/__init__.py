from runlmc_tpu_torch.utils.np_utils import (
    begin_end_indices,
    cartesian_product,
    chunks,
    search_descending,
    smallest_eig,
    symm_2d_list_map,
    tesselate,
)
from runlmc_tpu_torch.utils.normalizer import Normalizer

__all__ = [
    "begin_end_indices",
    "cartesian_product",
    "chunks",
    "search_descending",
    "smallest_eig",
    "symm_2d_list_map",
    "tesselate",
    "Normalizer",
]
