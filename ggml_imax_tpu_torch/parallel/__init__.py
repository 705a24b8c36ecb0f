"""Parallelism on torch.distributed: mesh construction, per-rank sharding,
pipeline parallelism, ring attention, tensor parallelism, process bootstrap
(counterpart of ggml_imax_tpu/parallel; SURVEY §2.10 inventory)."""
from .mesh import make_mesh, named
from .sharding import shard_array, shard_kv_cache, shard_params, shard_qtensor
from .pipeline import pipeline_forward, stack_stage_params
from .ring_attention import ring_attention
from . import distributed
