"""Tools: model requantization and perplexity (counterpart of
ggml_imax_tpu/tools/); the imatrix collector is quant/imatrix.py's."""
from .perplexity import perplexity
from .quantize import requantize_gguf, requantize_legacy_bin
