from repro_torch.compress.compressors import Compressor, none_compressor

__all__ = ["Compressor", "none_compressor"]
