"""Port parity: MNIST (ggml_imax_tpu_torch/models/mnist.py against
ggml_imax_tpu/models/mnist.py), on the CPU.

The same numpy generator gives both packages the same weights (equal to
the JAX-made ones carried over by params_from_jax). The FC and CNN forwards
agree within 1e-5 of the logits' scale (f32 matmuls and
convolutions summed in another order); 20 Adam iterations of `train`, each
loss read through the optimizer's callback, agree within rtol 1e-5 (plus
1e-6 of the first loss, for the losses near 0 the FC net reaches). The JAX
tests' accuracy bars hold on their own data, an exported and reloaded
model gives the eager logits within 1e-5 (the JAX test's tolerance), and a
model exported by the JAX package is refused.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import mnist as jm
from ggml_imax_tpu_torch.models import mnist as tm
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.optimize import OptResult


def synthetic_digits(rng, n=512, n_classes=10):
    """tests/test_mnist_and_export.py's recipe."""
    templates = rng.standard_normal((n_classes, 784)).astype(np.float32)
    labels = rng.integers(0, n_classes, n)
    images = templates[labels] + 0.3 * rng.standard_normal((n, 784)).astype(np.float32)
    return images.astype(np.float32), labels


def synthetic_cnn(rng, n=96, n_classes=4):
    templates = rng.standard_normal((n_classes, 1, 28, 28)).astype(np.float32)
    labels = rng.integers(0, n_classes, n)
    images = (templates[labels]
              + 0.2 * rng.standard_normal((n, 1, 28, 28))).astype(np.float32)
    return images, labels


def both_params(kind, seed, **kw):
    init = {"fc": (jm.init_fc_params, tm.init_fc_params),
            "cnn": (jm.init_cnn_params, tm.init_cnn_params)}[kind]
    return (init[0](np.random.default_rng(seed), **kw),
            init[1](np.random.default_rng(seed), device="cpu", **kw))


FORWARDS = {"fc": (jm.fc_forward, tm.fc_forward),
            "cnn": (jm.cnn_forward, tm.cnn_forward)}


@pytest.mark.parametrize("kind", ["fc", "cnn"])
def test_forward_matches_reference(kind):
    rng = np.random.default_rng(0)
    images, _ = synthetic_digits(rng) if kind == "fc" else synthetic_cnn(rng)
    jp, tp = both_params(kind, 1)
    carried = params_from_jax(jp, device="cpu")     # the JAX-made weights
    for k in jp:
        assert np.array_equal(np.asarray(jp[k]), tp[k].numpy()), k
    ref = np.asarray(FORWARDS[kind][0](jp, jnp.asarray(images)))
    got = FORWARDS[kind][1](carried, torch.from_numpy(images)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))
    assert np.array_equal(FORWARDS[kind][1](tp, torch.from_numpy(images))
                          .numpy(), got)


@pytest.mark.parametrize("kind,lr", [("fc", 2e-4), ("cnn", 1e-2)])
def test_train_matches_reference_iteration_by_iteration(monkeypatch, kind, lr):
    rng = np.random.default_rng(2)
    images, labels = (synthetic_digits(rng, n=256) if kind == "fc"
                      else synthetic_cnn(rng))
    kw = {} if kind == "fc" else {"n_classes": 4}
    jp, tp = both_params(kind, 3, **kw)
    ref, got = [], []
    real_opt = jm.opt
    monkeypatch.setattr(jm, "opt", lambda loss, p, po: real_opt(
        loss, p, po, lambda it, f: ref.append(f)))
    jm.train(FORWARDS[kind][0], jp, images, labels, n_iter=20, lr=lr)
    res, tp2 = tm.train(FORWARDS[kind][1], tp, images, labels, n_iter=20,
                        lr=lr, callback=lambda it, f: got.append(f))
    assert tp2 is tp and res in (OptResult.OK, OptResult.DID_NOT_CONVERGE)
    assert len(got) == len(ref) == 20
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * ref[0])


def test_fc_train_eval_export_roundtrip(tmp_path):
    """test_fc_train_eval_export_roundtrip of the JAX suite, on the port."""
    rng = np.random.default_rng(1234)
    images, labels = synthetic_digits(rng)
    params = tm.init_fc_params(rng, device="cpu")
    res, params = tm.train(tm.fc_forward, params, images, labels,
                           n_iter=150, lr=5e-3)
    assert res in (OptResult.OK, OptResult.DID_NOT_CONVERGE)
    acc = tm.accuracy(tm.fc_forward, params, images, labels)
    assert acc > 0.95, acc
    path = tmp_path / "mnist.gitg"
    x = torch.from_numpy(images[:8])
    tm.export_model(tm.fc_forward, params, x, path)
    run = tm.load_model(path)
    with torch.no_grad():
        ref = tm.fc_forward(params, x)
    torch.testing.assert_close(run(x), ref, rtol=1e-5, atol=1e-5)
    # the weights are frozen into the artifact: 784 x 500 + 500 x 10 f32
    assert path.stat().st_size > 4 * (784 * 500 + 500 * 10)


def test_cnn_train_accuracy_and_export(tmp_path):
    """test_cnn_shapes_and_train_step of the JAX suite, on the port, then
    the CNN through export_model / load_model."""
    rng = np.random.default_rng(1234)
    images, labels = synthetic_cnn(rng)
    params = tm.init_cnn_params(rng, n_classes=4, device="cpu")
    logits = tm.cnn_forward(params, torch.from_numpy(images[:4]))
    assert logits.shape == (4, 4)
    tm.train(tm.cnn_forward, params, images, labels, n_iter=60, lr=1e-2)
    acc = tm.accuracy(tm.cnn_forward, params, images, labels)
    assert acc > 0.9, acc
    path = tmp_path / "cnn.gitg"
    x = torch.from_numpy(images[:8])
    tm.export_model(tm.cnn_forward, params, x, path)
    with torch.no_grad():
        ref = tm.cnn_forward(params, x)
    torch.testing.assert_close(tm.load_model(path)(x), ref, rtol=1e-5,
                               atol=1e-5)


def test_load_model_refuses_foreign_and_jax_files(tmp_path):
    bogus = tmp_path / "bogus.bin"
    bogus.write_bytes(b"NOPE" + b"\0" * 16)
    with pytest.raises(ValueError, match="magic"):
        tm.load_model(bogus)
    rng = np.random.default_rng(0)
    jp = jm.init_fc_params(rng)
    jpath = tmp_path / "jax-mnist.gitg"
    jm.export_model(jm.fc_forward, jp, jnp.zeros((2, 784), jnp.float32), jpath)
    with pytest.raises(ValueError, match="StableHLO"):
        tm.load_model(jpath)
