from repro_torch.compress.compressors import (
    Compressor,
    bf16_compressor,
    compressed_bytes,
    get_compressor,
    init_residual_plane,
    int8_compressor,
    none_compressor,
    randk_compressor,
    topk_compressor,
)

__all__ = [
    "Compressor",
    "get_compressor",
    "none_compressor",
    "topk_compressor",
    "randk_compressor",
    "int8_compressor",
    "bf16_compressor",
    "compressed_bytes",
    "init_residual_plane",
]
