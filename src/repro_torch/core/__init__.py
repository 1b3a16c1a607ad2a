"""TT-SVD compression core and the TT-native linear layer."""

from repro_torch.core.batch_exec import BucketExecutor, ExecStats
from repro_torch.core.blocked import (
    blocked_bidiagonalize, blocked_bidiagonalize_batched, blocked_qr,
)
from repro_torch.core.compression import (
    CompressedParam, CompressionPolicy, CompressionReport, TTCompressor,
    compress_param, decompress_param,
)
from repro_torch.core.hbd import (
    householder_bidiagonalize, householder_bidiagonalize_batched,
)
from repro_torch.core.plan import (
    Bucket, CompressionPlan, PlanEntry, build_plan, padded_work_estimate,
    tensorize_dims,
)
from repro_torch.core.svd import SVDResult, sorting_basis, svd, svd_batched
from repro_torch.core.tt import (
    StaticTT, TTTensor, auto_factorize, static_tt_crop, static_tt_member,
    static_tt_reconstruct, tensorize_shape, tt_max_ranks, tt_reconstruct,
    ttd, ttd_static, ttd_static_batched,
)
from repro_torch.core.tt_linear import (
    TTLinear, dequantize_array, dequantize_tt, is_tt_linear, quant_dtype,
    quantize_array, quantize_tt, quantize_tt_tree, select_layer,
    spectral_decay_pytree, tt_apply, tt_leaf_bytes, tt_linear_from_tt,
    tt_param_bytes,
)
