"""TT-SVD compression core and the TT-native linear layer."""

from repro_torch.core.compression import (
    CompressedParam, CompressionPolicy, CompressionReport, TTCompressor,
    compress_param, decompress_param, tensorize_dims,
)
from repro_torch.core.hbd import householder_bidiagonalize
from repro_torch.core.svd import SVDResult, sorting_basis, svd
from repro_torch.core.tt import (
    TTTensor, auto_factorize, tensorize_shape, tt_reconstruct, ttd,
)
from repro_torch.core.tt_linear import (
    TTLinear, dequantize_array, dequantize_tt, is_tt_linear, quant_dtype,
    quantize_array, quantize_tt, quantize_tt_tree, select_layer,
    spectral_decay_pytree, tt_apply, tt_leaf_bytes, tt_linear_from_tt,
    tt_param_bytes,
)
