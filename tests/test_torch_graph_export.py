"""Port parity: graph export (ggml_imax_tpu_torch/io/graph_export.py, a
torch.export artifact, against ggml_imax_tpu/io/graph_export.py) and the
kernels' custom ops (ops/library.py), on the CPU.

- Each op (w4a8_gemv, decode_attention, decode_attention_update) exported,
  saved, loaded and run through its CPU implementation: bit-equal to the
  kernel's plain version (the update writing the same arena bytes), and
  the fake implementation's shape and dtype equal to the real output's.
- The GPT-J decode step at test_mnist_and_export.py's config (n_vocab
  640, n_embd 256, 2 heads, 2 layers, Q4_0, prepare_fused +
  params_repack), both decode routes, exported with the weights as
  arguments: the reloaded step equals the eager step bit for bit over 4
  greedy steps, writes the caller's arena in place, holds no tensors in
  the artifact, and stays within test_torch_gptj.py's atol 5e-2 of the JAX
  package's exported step.
- load_graph refuses a foreign file ("magic") and a JAX-written artifact.
"""
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ggml_imax_tpu_torch.io import graph_export as tge
from ggml_imax_tpu_torch.models import gptj
from ggml_imax_tpu_torch.models.common import init_kv_cache
from ggml_imax_tpu_torch.ops import decode_attention as da
from ggml_imax_tpu_torch.ops import library, qmm
from ggml_imax_tpu_torch.ops.qmm import params_repack
from ggml_imax_tpu_torch.quant.device import QTensor
from ggml_imax_tpu_torch.quant.formats import GGMLType

CFG = dict(n_vocab=640, n_ctx=32, n_embd=256, n_head=2, n_layer=2, n_rot=32)
SEED, STEPS = 31, 4


def roundtrip(fn, args, path):
    tge.export_graph(fn, args, path)
    return tge.load_graph(path)


def natpair_weight(k, n, seed, bias=False):
    g = torch.Generator().manual_seed(seed)
    q = torch.randint(0, 256, (k // 2, n), dtype=torch.uint8, generator=g)
    s = torch.rand((k // 32, n), generator=g) * 0.01
    b = torch.rand((k // 32, n), generator=g) * 0.01 if bias else None
    return QTensor("nib4", q, s, b, k, n, GGMLType.Q4_0, zero=8,
                   interleaved_bk=512, q4_layout=3)


def same_fake(op, args):
    """The op's fake output against its real one: shape and dtype."""
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args])
    return tuple(fake.shape) == tuple(real.shape) and fake.dtype == real.dtype


@pytest.mark.parametrize("bias", [False, True])
def test_w4a8_op_roundtrip_equals_plain(tmp_path, bias):
    qt = natpair_weight(256, 384, 1, bias)
    x = torch.randn(1, 256, generator=torch.Generator().manual_seed(2))
    x8, dx = qmm.quantize_activations_q8(x)
    xs = dx[:, 0] * x8[:, 0].float().sum(-1) if bias else None
    want = qmm.w4a8_gemv_plain(x8[:, 0], dx[:, 0], qt, xs)

    def fn(x8, dx, q, scale, b, xs):
        w = QTensor("nib4", q, scale, b, 256, 384, GGMLType.Q4_0, zero=8,
                    q4_layout=3)
        return library.w4a8_gemv(x8, dx, w, xs)

    args = (x8[:, 0], dx[:, 0], qt.q, qt.scale, qt.bias, xs)
    run = roundtrip(fn, args, tmp_path / "w4a8.gitg")
    assert torch.equal(run(*args), want)
    assert same_fake(library._w4a8_gemv, [*args, 256, 384, 2])


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_decode_attention_ops_roundtrip_equal_plain(tmp_path, kv):
    g = torch.Generator().manual_seed(3)
    B, Hq, Hkv, D, T = 2, 4, 2, 128, 40
    cache = init_kv_cache(1, B, T, Hkv, D, torch.bfloat16 if kv == "bf16"
                          else "q8_0", device="cpu")
    for t in (cache.k, cache.v):
        t.copy_((torch.randn(t.shape, generator=g) * (2 if kv == "bf16"
                                                      else 40)).to(t.dtype))
    for t in (cache.ks, cache.vs):
        if t is not None:
            t.copy_(torch.rand(t.shape, generator=g) * 0.05)
    q3 = torch.randn(B, Hq, D, generator=g)
    mask2 = torch.where(torch.arange(T)[None] < torch.tensor([[30], [17]]),
                        0.0, da.NEG).float()
    arena = da._arena_args(cache, 0)
    args = (q3, *arena, mask2, Hkv, 0.125)
    run = roundtrip(lambda *a: library.decode_attention(*a, Hkv, 0.125),
                    args[:-2], tmp_path / "da.gitg")
    assert torch.equal(run(*args[:-2]), da.decode_attention_plain(*args))
    assert same_fake(library.decode_attention, list(args))

    kn = torch.randn(B, Hkv * D, generator=g)
    vn = torch.randn(B, Hkv * D, generator=g)
    if kv == "bf16":
        fresh = (kn.bfloat16(), vn.bfloat16(), None, None)
    else:
        (k8, kd), (v8, vd) = da._q8_rows(kn), da._q8_rows(vn)
        fresh = (k8, v8, kd, vd)
    rows = torch.tensor([30, 17])
    ref = [t.clone() if t is not None else None for t in arena]
    want = da.decode_attention_update_plain(q3, *ref, *fresh, mask2, rows,
                                            Hkv, 0.125)
    uargs = (q3, *arena, *fresh, mask2, rows)
    run = roundtrip(
        lambda *a: library.decode_attention_update(*a, Hkv, 0.125),
        [t.clone() if t is not None else None for t in uargs],
        tmp_path / "dau.gitg")
    got = run(*uargs)
    assert torch.equal(got, want)
    assert all(torch.equal(a, r) for a, r in zip(arena, ref) if a is not None)
    assert same_fake(library.decode_attention_update,
                     [t.clone() if isinstance(t, torch.Tensor) else t
                      for t in (*uargs, Hkv, 0.125)])


def _jax_prepared():
    """The JAX package's GPT-J at CFG, prepared as test_mnist_and_export.py
    prepares it, with the modules its export needs."""
    from ggml_imax_tpu.io.graph_export import export_graph, load_graph
    from ggml_imax_tpu.models import gptj as jgptj
    from ggml_imax_tpu.ops.pallas_qmm import params_repack_device
    jqmm = importlib.import_module("ggml_imax_tpu.ops.qmatmul")
    cfg = jgptj.GPTJConfig(**CFG)
    params = jgptj.synthetic_params(cfg, GGMLType.Q4_0, seed=SEED)
    old = os.environ.get("GGML_FUSE_FF")
    os.environ["GGML_FUSE_FF"] = "1"
    try:
        params = jgptj.stack_model(params_repack_device(
            jgptj.fuse_out(jgptj.prepare_fused(params))))
    finally:
        if old is None:
            os.environ.pop("GGML_FUSE_FF")
        else:
            os.environ["GGML_FUSE_FF"] = old
    return cfg, params, jgptj, export_graph, load_graph, jqmm


@pytest.fixture(scope="module")
def port_step():
    cfg = gptj.GPTJConfig(**CFG)
    raw = gptj.synthetic_params(cfg, seed=SEED, device="cpu")
    return cfg, params_repack(gptj.prepare_fused(raw, cfg))


@pytest.mark.parametrize("fused", [False, True])
def test_gptj_step_replays_bit_equal_and_in_place(tmp_path, port_step, fused):
    cfg, params = port_step

    def step(params, tok, pos, cache, n_past):
        return gptj.forward(cfg, params, tok, pos, cache, n_past,
                            fused_kv_update=fused)

    path = tmp_path / "gptj-step.gitg"
    tok, pos, n = torch.tensor([[5]]), torch.tensor([[0]]), torch.tensor(0)
    tge.export_graph(step, (params, tok, pos, gptj.init_cache(
        cfg, device="cpu"), n), path)
    assert tge.stored_tensor_bytes(path) == 0
    weights = sum(t.numel() * t.element_size()
                  for t in torch.utils._pytree.tree_leaves(params)
                  if isinstance(t, torch.Tensor))
    assert os.path.getsize(path) < weights
    run = tge.load_graph(path)
    assert run.header["device"] == "cpu" and run.header["n_in"] == 5
    eager, replay = (gptj.init_cache(cfg, device="cpu") for _ in range(2))
    for i in range(STEPS):
        want, _ = step(params, tok, torch.tensor([[i]]), eager,
                       torch.tensor(i))
        got, back = run(params, tok, torch.tensor([[i]]), replay,
                        torch.tensor(i))
        assert torch.equal(got, want)
        assert back.k.data_ptr() == replay.k.data_ptr()
        assert torch.equal(replay.k, eager.k) and torch.equal(replay.v, eager.v)
        tok = want[:, -1].argmax(-1, keepdim=True)
    assert bool(replay.k[:, :, STEPS - 1].abs().sum() > 0)


def test_gptj_step_replay_close_to_the_jax_export(tmp_path, port_step):
    cfg, params = port_step
    jcfg, jparams, jgptj, jexport, jload, jqmm = _jax_prepared()

    def jstep(params, tok, pos, cache, n_past):
        return jgptj.forward(jcfg, params, tok, pos, cache, n_past)

    def step(params, tok, pos, cache, n_past):
        return gptj.forward(cfg, params, tok, pos, cache, n_past)

    jpath, path = tmp_path / "jax.gitg", tmp_path / "port.gitg"
    jcache = jgptj.init_cache(jcfg, batch=1, n_ctx=32, flat=True)
    jtok = jnp.asarray([[5]], jnp.int32)
    jqmm.set_force_fused(True)
    try:
        jexport(lambda p, t, q, c: jstep(p, t, q, c, 0),
                (jparams, jtok, jnp.zeros((1, 1), jnp.int32), jcache), jpath)
        jrun = jload(jpath)
        want, _ = jrun(jparams, jtok, jnp.zeros((1, 1), jnp.int32), jcache)
    finally:
        jqmm.set_force_fused(False)
    tok, n = torch.tensor([[5]]), torch.tensor(0)
    tge.export_graph(step, (params, tok, torch.tensor([[0]]), gptj.init_cache(
        cfg, device="cpu"), n), path)
    got, _ = tge.load_graph(path)(params, tok, torch.tensor([[0]]),
                                  gptj.init_cache(cfg, device="cpu"), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-2)
    # the two packages' artifacts do not load in each other
    with pytest.raises(ValueError, match="JAX package"):
        tge.load_graph(jpath)


def test_load_graph_rejects_foreign_file(tmp_path):
    p = tmp_path / "bogus.bin"
    p.write_bytes(b"NOPE" + b"\0" * 16)
    with pytest.raises(ValueError, match="magic"):
        tge.load_graph(p)


def test_qtensor_and_kvcache_pytree_roundtrip():
    """The registered nodes flatten to their tensors, keep the rest in the
    context, and come back from a dumped tree spec (GGMLType as an int)."""
    tp = torch.utils._pytree
    qt = natpair_weight(64, 128, 4, bias=True)
    cache = init_kv_cache(2, 1, 8, 2, 32, "q8_0", device="cpu")
    leaves, spec = tp.tree_flatten({"w": qt, "c": cache})
    # q, scale, bias, lut (None), signs (None); k, v, ks, vs
    assert [t is None for t in leaves] == [False] * 3 + [True] * 2 + [False] * 4
    back = tp.tree_unflatten(leaves, tp.treespec_loads(tp.treespec_dumps(spec)))
    assert back["w"].ggml_type is GGMLType.Q4_0 and back["w"].q4_layout == 3
    assert back["w"].q is qt.q and back["c"].heads == 2
    keys = [tp.keystr(k) for k, _ in tp.tree_flatten_with_path(qt)[0]]
    assert keys == [".q", ".scale", ".bias", ".lut", ".signs"]
