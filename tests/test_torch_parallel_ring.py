"""Port parity: ring attention, the tp x sp ring prefill and the pipeline
(ggml_imax_tpu_torch/parallel/ring_attention.py, tp.py, pipeline.py) on
gloo ranks of this host's CPU, against the JAX package's functions on as
many of its virtual CPU devices (tests/conftest.py: 8).

One spawn for each world size (2, 4, 8) runs every check of that size
(tests/_torch_parallel_ranks.py, the port only); the three run in threads
while this process computes the JAX side.

- `ring_attention` on 2 and 4 ranks, causal and not, at
  tests/test_ring_attention.py's shapes: within 1e-5 of the JAX
  `ring_attention` (both f32 einsums with the same online merge).
- The ring prefill, tp 2 x sp 2 at tests/test_ring_prefill.py's GPT-J
  (E 256, 8 heads of 32, 2 layers, T = n_ctx 32): on un-split params
  (the JAX forward_ring_prefill applies interleaved rope only, ROADMAP
  Queue 3) against the JAX forward_ring_prefill, and on split-rope
  params against the port's single-device prefill; logits within 1e-2,
  the arena put back together within 2e-2 (that test's tolerances: the
  ring's f32 attention against flash, reassociated f32 partials).
- `pipeline_forward` at tests/test_pipeline.py:21's cases against the
  JAX `pipeline_forward`, 1e-5.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_parallel_ranks as R
from ggml_imax_tpu.models import gptj as jgptj
from ggml_imax_tpu.ops.pallas_qmm import params_repack_device
from ggml_imax_tpu.ops.qmatmul import set_force_fused
from ggml_imax_tpu.parallel import pipeline as jpp
from ggml_imax_tpu.parallel.ring_attention import ring_attention as jring
from ggml_imax_tpu.parallel import tp as jtp
from ggml_imax_tpu.quant.formats import GGMLType
from ggml_imax_tpu_torch.models import gptj as tgptj
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.parallel import distributed as D

RING_CFG = dict(n_vocab=1024, n_ctx=32, n_embd=256, n_head=8, n_layer=2,
                n_rot=32)
TP, SP, T = 2, 2, 32
# (pp, n_micro), tests/test_pipeline.py:21
PIPE_CASES = [(4, 4), (4, 8), (8, 8), (2, 6)]
TIMEOUT = 120


def _ring_inputs(causal):
    """tests/test_ring_attention.py's shapes: (b, tq, tk, h, d)."""
    rng = np.random.default_rng(5 if causal else 6)
    b, tq, tk, h, d = (2, 32, 32, 2, 16) if causal else (1, 16, 64, 2, 32)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, tq, h, d), f(b, tk, h, d), f(b, tk, h, d)


def _pipe_inputs(pp, n_micro, d=16):
    rng = np.random.default_rng(100 * pp + n_micro)
    per_stage = [{"w": (rng.standard_normal((d, d)) * 0.3).astype(np.float32),
                  "b": rng.standard_normal(d).astype(np.float32)}
                 for _ in range(pp)]
    return per_stage, rng.standard_normal((n_micro * 2, d)).astype(np.float32)


def _ring_params(split):
    """test_ring_prefill.py's draw (seed 11) in the fused graph, natural,
    the head padded to 128 * TP."""
    cfg = jgptj.GPTJConfig(**RING_CFG)
    old = os.environ.get("GGML_FUSE_FF")
    os.environ["GGML_FUSE_FF"] = "1"
    try:
        p = jgptj.synthetic_params(cfg, GGMLType.Q4_0, seed=11)
        if split:
            p = jgptj.split_rope_prep(p, cfg)
        p = jgptj.pad_lm_head(jgptj.fuse_out(jgptj.fuse_qkv(p)),
                              multiple=128 * TP)
    finally:
        if old is None:
            os.environ.pop("GGML_FUSE_FF")
        else:
            os.environ["GGML_FUSE_FF"] = old
    return cfg, p


def _tokens():
    rng = np.random.default_rng(5)
    return rng.integers(0, RING_CFG["n_vocab"], (1, T)).astype(np.int32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world size: per-rank results of its calls}, each world one spawn."""
    cfg = tgptj.GPTJConfig(**RING_CFG)
    prep = {split: params_from_jax(_ring_params(split)[1], device="cpu")
            for split in (True, False)}
    calls = {2: [], 4: [], 8: []}
    for n in (2, 4):
        for causal in (False, True):
            calls[n].append(("ring_attention", (*_ring_inputs(causal),
                                                causal)))
    for split in (True, False):
        calls[4].append(("ring_prefill", (cfg, prep[split], TP, SP,
                                          _tokens())))
    for pp, n_micro in PIPE_CASES:
        calls[pp].append(("pipeline", (*_pipe_inputs(pp, n_micro), n_micro)))
    with ThreadPoolExecutor(3) as ex:
        futs = {n: ex.submit(D.spawn, R.run_all, n, (c,),
                             rendezvous_dir=tmp_path_factory.mktemp("rdzv"),
                             timeout=TIMEOUT, backend="gloo", device="cpu")
                for n, c in calls.items()}
        return {n: f.result() for n, f in futs.items()}


def _mesh(n, names=("sp",)):
    return Mesh(np.array(jax.devices()[:n]), names)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_matches_jax(runs, n, causal):
    q, k, v = _ring_inputs(causal)
    want = np.asarray(jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            _mesh(n), causal=causal))
    for rank in runs[n]:
        got = rank[int(causal)]
        assert got.shape == q.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _assemble(ranks, which):
    """The ring prefill's global logits and arena (k, v) from the ranks'
    chunks: sp index s holds rows [s T/sp, ...), tp index t the t-th piece
    of the arena's heads (every tp rank has the whole logits)."""
    res = [r[2 + which] for r in ranks]
    logits = np.concatenate([r[2] for r in sorted(res, key=lambda r: r[0])
                             if r[1] == 0], axis=1)
    arena = []
    for j in (3, 4):
        grid = {(r[0], r[1]): r[j] for r in res}
        arena.append(np.concatenate([np.concatenate(
            [grid[s, t] for t in range(TP)], axis=3) for s in range(SP)],
            axis=2))
    return logits, arena


def test_ring_prefill_matches_jax_ring_prefill(runs):
    """Un-split params (the JAX ring prefill's rope): the port's ring
    prefill against the JAX one."""
    jcfg, jp = _ring_params(False)
    stacked = jgptj.stack_model(params_repack_device(jp))
    mesh = Mesh(np.array(jax.devices()[:TP * SP]).reshape(TP, SP),
                ("tp", "sp"))
    set_force_fused(True)
    try:
        rp, specs = jtp.shard_params_tp(stacked, mesh, jcfg)
        cr = jtp.init_cache_ringsp(jcfg, mesh, batch=1, n_ctx=T)
        want, cr = jtp.forward_ring_prefill(
            jcfg, rp, jnp.asarray(_tokens()),
            jnp.asarray(np.arange(T, dtype=np.int32)[None]), cr, mesh, specs)
    finally:
        set_force_fused(False)
    logits, (k, v) = _assemble(runs[4], 1)
    assert logits.shape == want.shape == (1, T, RING_CFG["n_vocab"])
    np.testing.assert_allclose(logits, np.asarray(want), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(k, np.asarray(cr.k, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(v, np.asarray(cr.v, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_ring_prefill_matches_single_device(runs):
    """Split-rope params: the port's ring prefill against its own
    single-device prefill of the whole sequence."""
    cfg = tgptj.GPTJConfig(**RING_CFG)
    params = R.params_repack(params_from_jax(_ring_params(True)[1],
                                             device="cpu"))
    cache = tgptj.init_cache(cfg, n_ctx=T, device="cpu")
    want, cache = tgptj.forward(cfg, params,
                                torch.from_numpy(_tokens()).long(),
                                torch.arange(T)[None], cache, 0)
    logits, (k, v) = _assemble(runs[4], 0)
    np.testing.assert_allclose(logits, want.numpy(), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(k, cache.k.float().numpy(), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(v, cache.v.float().numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("pp,n_micro", PIPE_CASES)
def test_pipeline_matches_jax(runs, pp, n_micro):
    per_stage, x = _pipe_inputs(pp, n_micro)
    stacked = jpp.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in per_stage])
    stage = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])
    want = np.asarray(jpp.pipeline_forward(stage, stacked, jnp.asarray(x),
                                           _mesh(pp, ("pp",)),
                                           n_microbatch=n_micro))
    idx = [c for c in PIPE_CASES if c[0] == pp].index((pp, n_micro))
    first = 4 if pp == 4 else (2 if pp == 2 else 0)  # after the ring calls
    for rank in runs[pp]:
        np.testing.assert_allclose(rank[first + idx], want, rtol=1e-5,
                                   atol=1e-5)
