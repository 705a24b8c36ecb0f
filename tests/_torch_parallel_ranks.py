"""Rank bodies of the port's multi-process CPU tests (tests/test_torch_
parallel_*.py, test_torch_utils.py). Each runs in a process of its own,
spawned by ggml_imax_tpu_torch.parallel.distributed.spawn over gloo, and
imports the port only (torch, numpy), never JAX. One thread a rank, so
the test workers' cores are not oversubscribed. Results go back as numpy
arrays."""
import numpy as np
import torch
import torch.distributed as dist

from ggml_imax_tpu_torch.models import gptj, llama
from ggml_imax_tpu_torch.models.common import KVCache
from ggml_imax_tpu_torch.ops.qmm import params_repack
from ggml_imax_tpu_torch.parallel import distributed as D
from ggml_imax_tpu_torch.parallel import mesh as M
from ggml_imax_tpu_torch.parallel import pipeline as PP
from ggml_imax_tpu_torch.parallel import sharding as S
from ggml_imax_tpu_torch.parallel import tp as TP
from ggml_imax_tpu_torch.parallel.ring_attention import \
    ring_attention as ring_attention_fn


def _decode(fwd, cache, prompt, feed):
    """A prefill of `prompt` then one step per fed token: the logits of
    every forward, as numpy."""
    n = len(prompt)
    lg, cache = fwd(torch.as_tensor(prompt)[None].long(),
                    torch.arange(n)[None], cache, 0)
    out = [lg[0].cpu().numpy()]
    for i, tok in enumerate(feed):
        lg, cache = fwd(torch.tensor([[int(tok)]]),
                        torch.tensor([[n + i]]), cache, n + i)
        out.append(lg[0].cpu().numpy())
    return out


def tp_decode(rank, world, jobs, kvs, prompt, feed):
    """jobs: [(model "gptj" or "llama", cfg, {name: prepared params})], the
    params in gptj.prepare_fused's layout or llama fuse_qkv +
    fuse_gate_up(pad_multiple=1)'s. For each: shard, repack this rank's
    shard and run forward_tp / forward_tp_llama teacher-forced for each KV
    dtype. Returns {model: {name: {str(kv): logits per forward}}}."""
    torch.set_num_threads(1)
    out = {}
    for model, cfg, variants in jobs:
        if model == "gptj":
            shard, forward = TP.shard_params_tp, TP.forward_tp
        else:
            shard, forward = TP.shard_params_tp_llama, TP.forward_tp_llama
        out[model] = {}
        for name, prepared in variants.items():
            params = params_repack(shard(prepared, cfg, rank, world))
            fwd = lambda t, p, c, n: forward(cfg, params, t, p, c, n)
            out[model][name] = {str(kv): _decode(fwd, TP.init_cache_tp(
                cfg, world, dtype=kv, device="cpu"), prompt, feed)
                for kv in kvs}
    return out


def single_decode(model, cfg, prepared, kv, prompt, feed):
    """The port's single-device forward on the same prepared params."""
    mod = gptj if model == "gptj" else llama
    params = params_repack(prepared)
    cache = mod.init_cache(cfg, dtype=kv, device="cpu")
    fwd = lambda t, p, c, n: mod.forward(cfg, params, t, p, c, n)
    return _decode(fwd, cache, prompt, feed)


def mesh_pieces(rank, world, qt, kv_shape):
    """shard_qtensor / shard_array / shard_kv_cache / shard_params on a
    (1, world) make_mesh: this rank's pieces, as numpy."""
    torch.set_num_threads(1)
    mesh = M.make_mesh(dp=1, tp=world, device="cpu")
    cols = S.shard_qtensor(qt, mesh, S.COL)
    rows = S.shard_qtensor(qt, mesh, S.ROW)
    rep = S.shard_qtensor(qt, mesh, S.REP)
    x = torch.arange(int(np.prod(kv_shape)), dtype=torch.float32) \
        .reshape(kv_shape)
    cache = KVCache(x.clone(), x.clone() + 1, heads=world * 2)
    kvp = S.shard_kv_cache(cache, mesh)
    tree = S.shard_params({"layers": [{"fc_in_w": qt, "fc_in_b": x[0, 0, 0],
                                       "ln": x[0, 0, 0]}]}, mesh,
                          S.GPTJ_RULES)["layers"][0]
    arr = S.shard_array(x, mesh, None, "dp", None, "tp")
    qtd = lambda t: {"q": t.q.numpy(), "scale": t.scale.numpy(),
                     "k": t.k, "n": t.n,
                     "contiguous": all(a.is_contiguous()
                                       for a in (t.q, t.scale))}
    return {"coords": M.axis_coords(mesh, "tp"), "cols": qtd(cols),
            "rows": qtd(rows), "rep_same": rep is qt,
            "kv_k": kvp.k.numpy(), "kv_v": kvp.v.numpy(),
            "kv_heads": kvp.heads,
            "tree_w": qtd(tree["fc_in_w"]), "tree_b": tree["fc_in_b"].numpy(),
            "tree_ln": tree["ln"].numpy(), "arr": arr.numpy()}


def run_all(rank, world, calls):
    """calls: [(name of a rank body here, args)]: each body's result, in
    order (one spawn serves several checks)."""
    return [globals()[name](rank, world, *args) for name, args in calls]


def ring_attention(rank, world, q, k, v, causal):
    torch.set_num_threads(1)
    t = lambda a: torch.from_numpy(a)
    return ring_attention_fn(t(q), t(k), t(v), causal=causal).numpy()


def ring_prefill(rank, world, cfg, prepared, tp, sp, tokens):
    """forward_ring_prefill on a (tp, sp) global_mesh: this rank's (sp
    index, tp index, logits chunk, arena chunk k and v as f32)."""
    torch.set_num_threads(1)
    mesh = D.global_mesh({"tp": tp, "sp": sp}, device="cpu")
    t_rank = mesh["tp"].get_local_rank()
    params = params_repack(TP.shard_params_tp(prepared, cfg, t_rank, tp))
    T = tokens.shape[1]
    cache = TP.init_cache_ringsp(cfg, tp, sp, n_ctx=T, device="cpu")
    lg, cache = TP.forward_ring_prefill(
        cfg, params, torch.from_numpy(tokens).long(), torch.arange(T)[None],
        cache, mesh.get_group("tp"), mesh.get_group("sp"))
    return (mesh["sp"].get_local_rank(), t_rank, lg.numpy(),
            cache.k.float().numpy(), cache.v.float().numpy())


def _mlp_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline(rank, world, per_stage, x, n_micro):
    torch.set_num_threads(1)
    stages = PP.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in per_stage])
    return PP.pipeline_forward(_mlp_stage, stages, torch.from_numpy(x),
                               n_microbatch=n_micro).numpy()


def all_reduce(rank, world):
    """An all_reduce of arange(4) * (rank + 1) and the cluster info."""
    torch.set_num_threads(1)
    x = torch.arange(4, dtype=torch.float32) * (rank + 1)
    dist.all_reduce(x)
    return x.numpy(), D.info(device="cpu")


def fail(rank, world):
    """Rank 1 raises; the others wait in a collective it never joins."""
    if rank == 1:
        raise ValueError("planted failure in rank 1")
    dist.barrier()


def vanish(rank, world):
    """Rank 1 exits without a result; the others wait in a collective."""
    import os
    if rank == 1:
        os._exit(3)
    dist.barrier()


def card_tp(rank, world, cfg_kw, prompt, feed):
    """GPT-J drawn on the card (seed 3), prepare_fused; rank 0 also runs
    the single-device forward; every rank shards, repacks and runs
    forward_tp on cuda:0 (the kernels at the local shapes), counting its
    launches. Returns (TP logits, single-device logits or None, launch
    counts, the ring's point-to-point route)."""
    from ggml_imax_tpu_torch import _build
    cfg = gptj.GPTJConfig(**cfg_kw)
    prep = gptj.prepare_fused(gptj.synthetic_params(cfg, seed=3), cfg)
    ref = None
    if rank == 0:
        params = params_repack(prep)
        ref = _decode(lambda t, p, c, n: gptj.forward(
            cfg, params, t.cuda(), p.cuda(), c, n), gptj.init_cache(cfg),
            prompt, feed)
    params = params_repack(TP.shard_params_tp(prep, cfg, rank, world))
    _build.reset_launches()
    got = _decode(lambda t, p, c, n: TP.forward_tp(
        cfg, params, t.cuda(), p.cuda(), c, n), TP.init_cache_tp(cfg, world),
        prompt, feed)
    return got, ref, dict(_build.LAUNCHES), D.p2p_route(None, "cuda")
