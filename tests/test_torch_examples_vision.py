"""Port parity: the example CLIs of the vision models and MNIST
(ggml_imax_tpu_torch/examples/{mnist,sam,yolo,magika}.py) against the JAX
package's, both run in-process (tests/test_torch_examples.py's run_jax and
run_port): mnist --iters 5 (the accuracy line, the re-imported
prediction), and sam / yolo / magika on tiny files of
tests/test_torch_vision_models.py's models, their printed numbers within
that file's tolerances.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from ggml_imax_tpu.io.gguf import GGUFWriter as JGGUFWriter
from ggml_imax_tpu.io.legacy_bin import write_legacy_bin as jwrite_legacy
from ggml_imax_tpu.models import magika as jmagika
from ggml_imax_tpu.models import sam as jsam
from ggml_imax_tpu.models import yolo as jyolo
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.models import sam as tsam

from test_torch_examples import REPO, run_jax, run_port
from test_torch_vision_models import TINY as SAM_TINY
from test_torch_vision_models import sam_tensors, yolo_gguf


# ---- mnist

@pytest.mark.parametrize("arch", ["fc", "cnn"])
def test_mnist_cli_matches_jax(tmp_path, capsys, arch):
    argv = ["--arch", arch, "--iters", "5"]
    want = run_jax("mnist", argv + ["--out", str(tmp_path / "j.gitg")],
                   capsys).splitlines()
    got = run_port("mnist", argv + ["--out", str(tmp_path / "t.gitg")],
                   capsys).splitlines()
    acc = re.compile(r"^train: (\w+), accuracy ([0-9.]+)$")
    (wn, wa), (gn, ga) = acc.match(want[0]).groups(), acc.match(got[0]).groups()
    assert gn == wn and abs(float(ga) - float(wa)) <= 1e-3
    pred = re.compile(r"re-imported prediction for sample 0: (\d+) "
                      r"\(label (\d+)\)$")
    assert pred.search(got[1]).groups() == pred.search(want[1]).groups()
    assert (tmp_path / "t.gitg").stat().st_size > 0


# ---- vision

def test_magika_cli_matches_jax(tmp_path, capsys):
    jp = jmagika.synthetic_params(np.random.default_rng(21))
    path = tmp_path / "magika.gguf"
    w = JGGUFWriter(path)
    from ggml_imax_tpu_torch.models import magika as tmagika
    for k, n in tmagika.GGUF_NAMES.items():
        a = np.asarray(jp[k], np.float32)
        w.add_tensor(n, a, JType.F32, shape=tuple(reversed(a.shape)))
    w.write()
    script = tmp_path / "run.sh"
    script.write_bytes(b"#!/bin/sh\necho hello\n" * 10)
    inputs = [str(REPO / "README.md"), str(REPO / "chip_smoke.py"),
              str(script)]
    want = run_jax("magika", [str(path)] + inputs, capsys).splitlines()
    got = run_port("magika", [str(path)] + inputs, capsys).splitlines()
    params = tmagika.load_gguf(path, device="cpu")
    assert len(got) == len(want) == 3
    for f, g, wl in zip(inputs, got, want):
        top = tmagika.identify(params, Path(f).read_bytes())
        g_items, w_items = g.split(": ", 1)[1].split(), \
            wl.split(": ", 1)[1].split()
        assert g.split(": ", 1)[0] == wl.split(": ", 1)[0] == f
        for i, (a, b) in enumerate(zip(g_items, w_items)):
            (na, pa), (nb, pb) = a.rsplit(":", 1), b.rsplit(":", 1)
            assert abs(int(pa[:-1]) - int(pb[:-1])) <= 1
            # the label at each rank, but where the port's probabilities
            # tie within identify's tolerance (1e-5 relative)
            near = [abs(top[i][1] - top[j][1]) <= 1e-5 * top[i][1]
                    for j in (i - 1, i + 1) if 0 <= j < len(top)]
            if not any(near):
                assert na == nb, (f, i, g, wl)


def test_yolo_cli_matches_jax(tmp_path, capsys):
    """At a threshold in a gap of the objectness and class-probability
    values (as tests/test_torch_vision_models.py picks one: every value
    farther from it than twice the two packages' largest difference), so
    both print the same detections; boxes and percentages as printed."""
    from ggml_imax_tpu_torch.models import yolo as tyolo
    jp = jyolo.synthetic_params(np.random.default_rng(5), n_classes=80,
                                width=4)
    path = tmp_path / "y.gguf"
    yolo_gguf(path, jp, np.random.default_rng(10))
    img = np.random.default_rng(9).random((3, 240, 320)).astype(np.float32)
    np.save(tmp_path / "img.npy", img)
    sig = lambda v: 1 / (1 + np.exp(-np.asarray(v, np.float64)))

    def scores(heads):
        """(objectness of every cell and anchor, objectness x class
        probability of every class there)."""
        obj, prob = [], []
        for h in heads:
            h = np.asarray(h, np.float64)[0].reshape(3, 85, -1)
            obj.append(sig(h[:, 4]).ravel())
            prob.append((sig(h[:, 4])[:, None] * sig(h[:, 5:])).ravel())
        return np.concatenate(obj), np.concatenate(prob)

    ref = scores(jyolo.forward(jyolo.load_gguf(path),
                               jyolo.letterbox(img)[None]))
    got = scores([h.numpy() for h in tyolo.forward(
        tyolo.load_gguf(path, device="cpu"),
        tyolo.letterbox(img, device="cpu")[None])])
    # the widest gap of all the scores between the 5th and the 60th
    # largest class score: a few classes print
    every = np.concatenate(ref)
    pv = np.sort(ref[1])[::-1]
    band = np.sort(every[(every >= pv[60]) & (every <= pv[4])])[::-1]
    i = int(np.argmax(band[:-1] - band[1:]))
    thresh = float(np.float32((band[i] + band[i + 1]) / 2))
    assert np.abs(every - thresh).min() > \
        2 * np.abs(np.concatenate(got) - every).max()
    argv = ["-m", str(path), "-i", str(tmp_path / "img.npy"),
            "--thresh", repr(thresh)]
    want = run_jax("yolo", argv, capsys).splitlines()
    got = run_port("yolo", argv, capsys).splitlines()
    assert len(got) == len(want) >= 1
    num = re.compile(r"[-0-9.]+")
    for g, w in zip(got, want):
        assert g.split(":")[0] == w.split(":")[0]
        gv, wv = (list(map(float, num.findall(s.split(":", 1)[1])))
                  for s in (g, w))
        assert abs(gv[0] - wv[0]) <= 1                     # percent
        np.testing.assert_allclose(gv[1:], wv[1:], atol=1.5e-3)


def test_sam_cli_matches_jax(tmp_path, capsys):
    # the legacy header holds five hparams; the loader takes the rest from
    # the reference's defaults (window 14, global attention at 2, 5, 8,
    # 11, 8 decoder heads) and the image size from the stored positional
    # embedding: the tiny model is drawn at those
    cfg = tsam.SamConfig(**dict(SAM_TINY, n_window_size=14, n_dec_heads=8,
                                global_attn=(2, 5, 8, 11)))
    tp = tsam.synthetic_params(cfg, np.random.default_rng(11), device="cpu")
    hp = {"n_enc_state": 64, "n_enc_layer": 2, "n_enc_head": 2,
          "n_enc_out_chans": 32, "n_pt_embd": 4, "ftype": 0}
    jwrite_legacy(tmp_path / "sam.bin", hp, jsam.HPARAM_NAMES, [],
                  sam_tensors(tp), has_vocab=False)
    shape = (48, 80, 3)
    img = np.random.default_rng(14).uniform(0, 255, shape).astype(np.uint8)
    np.save(tmp_path / "img.npy", img)
    argv = ["-m", str(tmp_path / "sam.bin"), "-i", str(tmp_path / "img.npy"),
            "-p", "30,20"]
    want = run_jax("sam", argv + ["-o", str(tmp_path / "j.npy")],
                   capsys).splitlines()
    got = run_port("sam", argv + ["-o", str(tmp_path / "t.npy")],
                   capsys).splitlines()
    line = re.compile(r"^mask (\d): iou=([-0-9.]+) area=(\d+) px$")
    assert len(got) == len(want) == 4
    for g, w in zip(got[:3], want[:3]):
        (gi, giou, ga), (wi, wiou, wa) = line.match(g).groups(), \
            line.match(w).groups()
        assert gi == wi
        assert abs(float(giou) - float(wiou)) <= 1e-3
        # the masks agree on every pixel clear of the threshold (> 99%)
        assert abs(int(ga) - int(wa)) <= 0.01 * shape[0] * shape[1]
    mj, mt = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert mt.shape == mj.shape == (3,) + shape[:2] and mt.dtype == bool
    assert (mt == mj).mean() > 0.99
