"""Port parity: tensor parallelism (ggml_imax_tpu_torch/parallel/tp.py,
sharding.py, mesh.py) on gloo ranks of this host's CPU.

The JAX package's TP has two faults the port does not copy (ADVICE.md,
ROADMAP Queue 3): its forward_tp ignores `rope_split`, and its put_qt drops
a codebook's lut and signs. So the port's TP is held to the SINGLE-DEVICE
forward of both packages: the JAX stacked forward (its kernels in
interpret mode through set_force_fused) in this process, and the port's own
forward on the CPU. The same weights (the JAX package's seeded draw,
carried by models.common.params_from_jax) go through both. Each TP width
is one spawn of gloo ranks (tests/_torch_parallel_ranks.py, the port only)
running every variant: prefill of 4 tokens, then 2 fed decode steps, bf16
and q8_0 arenas, with and without rope_split. Tolerances: against the
port's forward rtol = atol = 2e-3 for GPT-J, 5e-3 for LLaMA (tests/
test_tp.py's own); against the JAX forward the single-device parity
tests' atol (JAX_ATOL)."""
import importlib
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as R
from ggml_imax_tpu.models import gptj as jgptj
from ggml_imax_tpu.models import llama as jllama
from ggml_imax_tpu.ops.pallas_qmm import params_repack_device
from ggml_imax_tpu.parallel import tp as jtp
from ggml_imax_tpu.quant.device import quantize_for_device as jquantize
from ggml_imax_tpu.quant.formats import GGMLType
from ggml_imax_tpu_torch.models import gptj as tgptj
from ggml_imax_tpu_torch.models import llama as tllama
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.parallel import distributed as D
from ggml_imax_tpu_torch.parallel import sharding as S
from ggml_imax_tpu_torch.parallel import tp as TP
from ggml_imax_tpu_torch.quant.device import (QTensor, pad_qtensor_cols,
                                              pad_qtensor_rows,
                                              quantize_for_device)

jqmatmul = importlib.import_module("ggml_imax_tpu.ops.qmatmul")

# tests/test_tp.py:28-29 and :147-148
GPTJ = dict(n_vocab=1024, n_ctx=64, n_embd=512, n_head=8, n_layer=2,
            n_rot=32)
LLAMA = dict(n_vocab=1024, n_ctx=64, n_embd=512, n_head=4, n_head_kv=4,
             n_layer=2, n_ff=1024)
PROMPT = np.arange(1, 5, dtype=np.int32)
FEED = np.array([17, 301], dtype=np.int32)
KVS = ("bf16", "q8_0")
TIMEOUT = 120
# The two packages' single-device forwards part by up to 1.1e-2 (GPT-J,
# logits ~2) and 5.4e-2 (LLaMA, ~4) on these weights: the port's prefill
# attention is bf16 flash, the JAX package's f32 XLA attention. So TP is
# held to the JAX forward at the single-device parity tests' atol
# (test_torch_gptj.py, test_torch_llama.py) and to the port's own at
# tests/test_tp.py's 2e-3 / 5e-3.
JAX_ATOL = {"gptj": 5e-2, "llama": 0.1}


def _kv(kv, jax_side=False):
    if kv == "q8_0":
        return kv
    return jnp.bfloat16 if jax_side else torch.bfloat16


def _jax_decode(cfg, stacked, kv, init_cache):
    """The JAX single-device stacked forward, teacher-forced on PROMPT then
    FEED, its kernels in interpret mode."""
    mod = jgptj if isinstance(cfg, jgptj.GPTJConfig) else jllama
    fwd = jax.jit(lambda p, t, pos, c, n: mod.forward(cfg, p, t, pos, c, n))
    cache = init_cache(cfg, dtype=_kv(kv, True), flat=True)
    n = len(PROMPT)
    jqmatmul.set_force_fused(True)
    try:
        lg, cache = fwd(stacked, jnp.asarray(PROMPT[None]),
                        jnp.arange(n, dtype=jnp.int32)[None], cache, 0)
        out = [np.asarray(lg[0])]
        for i, tok in enumerate(FEED):
            lg, cache = fwd(stacked, jnp.asarray([[tok]], jnp.int32),
                            jnp.asarray([[n + i]], jnp.int32), cache, n + i)
            out.append(np.asarray(lg[0]))
    finally:
        jqmatmul.set_force_fused(False)
    return out


def _gptj_prepared(split: bool):
    """JAX GPT-J weights (seed 3) in the fused graph (qkvf_w + of_w, the
    head padded to 128 * 4), natural: with split_rope_prep or without."""
    cfg = jgptj.GPTJConfig(**GPTJ)
    old = os.environ.get("GGML_FUSE_FF")
    os.environ["GGML_FUSE_FF"] = "1"
    try:
        p = jgptj.synthetic_params(cfg, GGMLType.Q4_0, seed=3)
        if split:
            p = jgptj.split_rope_prep(p, cfg)
        p = jgptj.fuse_out(jgptj.fuse_qkv(p))
    finally:
        if old is None:
            os.environ.pop("GGML_FUSE_FF")
        else:
            os.environ["GGML_FUSE_FF"] = old
    return cfg, jgptj.pad_lm_head(p, multiple=128 * 4)


def _llama_prepared():
    """tests/test_tp.py's LLaMA draw (rng 23, Q4_0, an untied 2048-column
    head) through the JAX prepare_fused (n_ff 1024: no pad)."""
    cfg = jllama.LlamaConfig(**LLAMA)
    r = np.random.default_rng(23)
    q = lambda s: jquantize((r.standard_normal(s) * 0.05).astype(np.float32),
                            GGMLType.Q4_0)
    vec = lambda n: jnp.asarray((r.standard_normal(n) * 0.05)
                                .astype(np.float32))
    E, F, KV = cfg.n_embd, cfg.n_ff, cfg.n_head_kv * cfg.head_dim
    p = {"tok_embd": q((E, cfg.n_vocab)), "out_norm": vec(E) + 1.0,
         "output": q((E, 2048)), "layers": []}
    for _ in range(cfg.n_layer):
        p["layers"].append({
            "attn_norm": vec(E) + 1.0,
            "q_w": q((E, E)), "k_w": q((E, KV)), "v_w": q((E, KV)),
            "o_w": q((E, E)), "ffn_norm": vec(E) + 1.0,
            "gate_w": q((E, F)), "up_w": q((E, F)), "down_w": q((F, E))})
    return cfg, jllama.prepare_fused(p)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The carried weights go to one spawn per TP width (GPT-J both rope
    layouts and LLaMA, every KV dtype), started in threads so the ranks
    run while this process computes the single-device references.
    Returns (references {(model, variant, kv): (JAX, port)}, runs {tp:
    per-rank results})."""
    jg = {split: _gptj_prepared(split) for split in (True, False)}
    jl = _llama_prepared()
    gcfg, lcfg = tgptj.GPTJConfig(**GPTJ), tllama.LlamaConfig(**LLAMA)
    gprep = {split: params_from_jax(jp, device="cpu")
             for split, (_, jp) in jg.items()}
    lprep = params_from_jax(jl[1], device="cpu")
    jobs = [("gptj", gcfg, gprep), ("llama", lcfg, {"": lprep})]
    kvs = [_kv(kv) for kv in KVS]
    with ThreadPoolExecutor(2) as ex:
        futs = {tp: ex.submit(
            D.spawn, R.tp_decode, tp, (jobs, kvs, PROMPT, FEED),
            rendezvous_dir=tmp_path_factory.mktemp("rdzv"), timeout=TIMEOUT,
            backend="gloo", device="cpu") for tp in (2, 4)}
        refs = {}
        for split, (jcfg, jp) in jg.items():
            stacked = jgptj.stack_model(params_repack_device(jp))
            for kv in KVS:
                refs["gptj", split, kv] = (
                    _jax_decode(jcfg, stacked, kv, jgptj.init_cache),
                    R.single_decode("gptj", gcfg, gprep[split], _kv(kv),
                                    PROMPT, FEED))
        stacked = jllama.stack_model(params_repack_device(jl[1]))
        for kv in KVS:
            refs["llama", "", kv] = (
                _jax_decode(jl[0], stacked, kv, jllama.init_cache),
                R.single_decode("llama", lcfg, lprep, _kv(kv), PROMPT, FEED))
        runs = {tp: f.result() for tp, f in futs.items()}
    return refs, runs


def _close(got, ref, tol, rtol=None):
    assert len(got) == len(ref) == 1 + len(FEED)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=tol if rtol is None else rtol,
                                   atol=tol)


def _check_tp(case, model, variant, tp, kv, tol, n_vocab):
    refs, runs = case
    jax_ref, port_ref = refs[model, variant, kv]
    assert len(runs[tp]) == tp
    for got in runs[tp]:                 # every rank holds the full logits
        logits = got[model][variant][str(_kv(kv))]
        assert logits[0].shape == (len(PROMPT), n_vocab)
        _close(logits, port_ref, tol)
        _close(logits, jax_ref, JAX_ATOL[model], rtol=0)


@pytest.mark.parametrize("split", [True, False], ids=["rope_split",
                                                      "interleaved"])
@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("tp", [2, 4])
def test_gptj_tp_matches_single_device(case, tp, kv, split):
    _check_tp(case, "gptj", split, tp, kv, 2e-3, GPTJ["n_vocab"])


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("tp", [2, 4])
def test_llama_tp_matches_single_device(case, tp, kv):
    _check_tp(case, "llama", "", tp, kv, 5e-3, LLAMA["n_vocab"])


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_collective_volume_model_matches_jax(tp):
    """The same formula: passed the JAX defaults (748 / 45 GB/s), equal to
    the JAX function; its own defaults are the H100's."""
    jcfg = jgptj.GPTJConfig(n_vocab=50400, n_ctx=2048, n_embd=4096,
                            n_head=16, n_layer=28, n_rot=64)
    cfg = tgptj.GPTJConfig(n_vocab=50400, n_ctx=2048, n_embd=4096, n_head=16,
                           n_layer=28, n_rot=64)
    want = jtp.collective_volume_model(jcfg, tp)
    got = TP.collective_volume_model(cfg, tp, hbm_gbps=748.0, link_gbps=45.0)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    h100 = TP.collective_volume_model(cfg, tp)
    assert h100["image_bytes"] == want["image_bytes"]
    assert h100["t_step_ms"] < want["t_step_ms"]


@pytest.mark.parametrize("tp", [2, 4])
def test_gptj_shard_sizes_are_one_over_tp(tp):
    """Every sharded weight's rank pieces are exactly 1/tp of it, fresh
    contiguous 16-byte aligned storage, and together hold every column
    (qkvf_w, the head) or row block (of_w) once."""
    cfg = tgptj.GPTJConfig(**GPTJ)
    prep = tgptj.prepare_fused(tgptj.synthetic_params(cfg, seed=3,
                                                      device="cpu"), cfg)
    pieces = [TP.shard_params_tp(prep, cfg, r, tp) for r in range(tp)]
    full = prep["layers"][0]
    for name in ("qkvf_w", "of_w"):
        parts = [p["layers"][0][name] for p in pieces]
        for qt in parts:
            assert qt.q.nbytes * tp == full[name].q.nbytes
            assert qt.scale.nbytes * tp == full[name].scale.nbytes
            assert qt.q.is_contiguous() and qt.q.data_ptr() % 16 == 0
            assert qt.q.untyped_storage().data_ptr() \
                != full[name].q.untyped_storage().data_ptr()
    cols = torch.cat([p["layers"][0]["qkvf_w"].q for p in pieces], dim=1)
    assert sorted(map(tuple, cols.T.tolist())) \
        == sorted(map(tuple, full["qkvf_w"].q.T.tolist()))
    rows = torch.cat([p["layers"][0]["of_w"].q for p in pieces], dim=0)
    assert sorted(map(tuple, rows.tolist())) \
        == sorted(map(tuple, full["of_w"].q.tolist()))
    lmh = [p["lmh_w"] for p in pieces]
    assert all(h.n * tp == prep["lmh_w"].n for h in lmh)
    assert torch.equal(torch.cat([h.q for h in lmh], dim=1),
                       prep["lmh_w"].q)
    assert all(h.n % 128 == 0 for h in lmh)
    assert all("rope_split" in p for p in pieces)


def _codebook(kind):
    if kind == "nib4":
        return QTensor("nib4", torch.zeros(32, 256, dtype=torch.uint8),
                       torch.ones(2, 256), None, 64, 256, GGMLType.IQ3_S,
                       lut=torch.arange(16.0))
    return QTensor("nib2", torch.zeros(16, 256, dtype=torch.uint8),
                   torch.ones(4, 256), None, 64, 256, GGMLType.IQ2_XS,
                   lut=torch.tensor([8.0, 25.0, 43.0, 0.0]),
                   signs=torch.zeros(8, 256, dtype=torch.uint8))


@pytest.mark.parametrize("kind", ["nib4", "nib2"])
def test_codebook_qtensor_is_refused(kind):
    """A lut (IQ3) or lut + signs (IQ2) QTensor raises ValueError naming
    its kind and type, where the JAX put_qt drops them."""
    qt = _codebook(kind)
    for how in (S.COL, S.ROW):
        with pytest.raises(ValueError, match=f"{qt.ggml_type.name}.*{kind}"):
            S.qtensor_piece(qt, how, 0, 2)
    assert S.qtensor_piece(qt, S.REP, 1, 2) is qt
    cfg = tgptj.GPTJConfig(**GPTJ)
    prep = tgptj.prepare_fused(tgptj.synthetic_params(cfg, seed=3,
                                                      device="cpu"), cfg)
    prep["layers"][1]["qkvf_w"] = qt
    with pytest.raises(ValueError, match=kind):
        TP.shard_params_tp(prep, cfg, 0, 2)


def test_misaligned_shards_are_refused():
    """The reference's alignment rules raise: a row piece that splits a
    quant block, a head that is not a multiple of 128 x tp, gate/up and
    down of different F."""
    qt = quantize_for_device(np.ones((96, 128), np.float32),
                             GGMLType.Q4_0, device="cpu")
    with pytest.raises(ValueError, match="quant blocks"):
        S.qtensor_piece(qt, S.ROW, 0, 2)            # 48 rows a piece
    cfg = tgptj.GPTJConfig(**GPTJ)
    prep = tgptj.prepare_fused(tgptj.synthetic_params(cfg, seed=3,
                                                      device="cpu"), cfg)
    prep["lmh_w"] = pad_qtensor_cols(prep["lmh_w"], 1152)[0]
    with pytest.raises(ValueError, match="pad_lm_head"):
        TP.shard_params_tp(prep, cfg, 0, 2)
    lcfg = tllama.LlamaConfig(**LLAMA)
    fused = tllama.prepare_fused(tllama.synthetic_params_device(
        lcfg, device="cpu"))
    fused["layers"][0]["down_w"] = pad_qtensor_rows(
        fused["layers"][0]["down_w"], 2048)[0]
    with pytest.raises(ValueError, match="pad_multiple=1"):
        TP.shard_params_tp_llama(fused, lcfg, 0, 2)


def test_mesh_sharding_pieces(tmp_path):
    """make_mesh + shard_qtensor / shard_params / shard_kv_cache /
    shard_array on 2 gloo ranks: each rank's pieces equal the matching
    slices of the whole."""
    qt = quantize_for_device(
        np.random.default_rng(4).standard_normal((128, 256))
        .astype(np.float32), GGMLType.Q4_0, device="cpu")
    shape = (2, 1, 8, 4 * 16)                     # 4 kv heads of 16
    res = D.spawn(R.mesh_pieces, 2, (qt, shape), rendezvous_dir=tmp_path,
                  timeout=TIMEOUT, backend="gloo", device="cpu")
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    for r, got in enumerate(res):
        assert got["coords"] == (r, 2)
        c, w = got["cols"], got["rows"]
        np.testing.assert_array_equal(c["q"], qt.q[:, r * 128:(r + 1) * 128])
        np.testing.assert_array_equal(c["scale"],
                                      qt.scale[:, r * 128:(r + 1) * 128])
        assert (c["k"], c["n"], c["contiguous"]) == (128, 128, True)
        np.testing.assert_array_equal(w["q"], qt.q[r * 32:(r + 1) * 32])
        np.testing.assert_array_equal(w["scale"], qt.scale[r * 2:(r + 1) * 2])
        assert (w["k"], w["n"], w["contiguous"]) == (64, 256, True)
        assert got["rep_same"]
        np.testing.assert_array_equal(got["kv_k"], x[..., r * 32:(r + 1) * 32])
        np.testing.assert_array_equal(got["kv_v"],
                                      x[..., r * 32:(r + 1) * 32] + 1)
        assert got["kv_heads"] == 2
        np.testing.assert_array_equal(got["tree_w"]["q"], c["q"])
        np.testing.assert_array_equal(got["tree_b"],
                                      x[0, 0, 0, r * 32:(r + 1) * 32])
        np.testing.assert_array_equal(got["tree_ln"], x[0, 0, 0])
        np.testing.assert_array_equal(got["arr"], x[..., r * 32:(r + 1) * 32])
