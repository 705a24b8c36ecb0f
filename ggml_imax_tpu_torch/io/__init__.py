from .gguf import GGUFReader, GGUFTensorInfo, GGUFWriter
from .legacy_bin import LegacyModelFile, LegacyTensor, read_legacy_bin

__all__ = ["GGUFReader", "GGUFWriter", "GGUFTensorInfo",
           "LegacyModelFile", "LegacyTensor", "read_legacy_bin"]
