"""Port parity: Magika, YOLOv3-tiny and SAM (ggml_imax_tpu_torch/models/
magika.py, yolo.py, sam.py) against the JAX package's models on the host.

- Magika at full width (it is small): the seeded weights equal
  params_from_jax of the JAX draw, the probabilities of a few byte
  windows within the JAX loader test's rtol 1e-5 / atol 1e-6, the same
  labels from `identify`, and the GGUF loader's params equal.
- YOLOv3-tiny at channel base 4 (tests/test_yolo_magika.py's size): the
  two head maps at the sweep's `conv` NMSE (1e-9), decode_head and nms
  bit-equal on the same maps, the letterbox, and the whole of `detect`
  (the same detections; objectness kept clear of the threshold so the
  comparison means something); the GGUF loader with batch-norm tensors
  folded equal to the JAX loader's.
- SAM at tests/test_sam.py's tiny config: encode_image, the prompt and
  image PE, decode_mask and predict at the sweep's `block_f32` NMSE
  (5e-7), predict's binary masks equal where the reference's logit is
  clear of the threshold; load_legacy on a .bin written as
  tests/test_sam.py writes one, its params equal to the JAX loader's.
The port runs with device="cpu" throughout.
"""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.io.gguf import GGUFWriter as JGGUFWriter
from ggml_imax_tpu.io.legacy_bin import write_legacy_bin as jwrite_legacy
from ggml_imax_tpu.models import magika as jmagika
from ggml_imax_tpu.models import sam as jsam
from ggml_imax_tpu.models import yolo as jyolo
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.models import magika as tmagika
from ggml_imax_tpu_torch.models import sam as tsam
from ggml_imax_tpu_torch.models import yolo as tyolo
from ggml_imax_tpu_torch.models.common import params_from_jax

REPO = Path(__file__).resolve().parents[1]
TOL = {"conv": 1e-9, "block_f32": 5e-7}    # tests/test_backend_ops_sweep.py


def nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2) / (np.mean(b * b) + 1e-300))


def host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_same_tree(t, j, where="params"):
    """Every tensor of the port's tree equal in dtype, shape and bits to
    params_from_jax's carry-over of the JAX tree."""
    if isinstance(j, dict):
        assert set(t) == set(j), where
        for k in j:
            assert_same_tree(t[k], j[k], f"{where}.{k}")
    elif isinstance(j, list):
        assert isinstance(t, list) and len(t) == len(j), where
        for i, (a, b) in enumerate(zip(t, j)):
            assert_same_tree(a, b, f"{where}[{i}]")
    else:
        assert t.dtype == j.dtype and t.shape == j.shape, where
        assert torch.equal(t, j), where


# ---- Magika

def magika_inputs():
    """Byte windows: three of the repo's own files as read, a short
    script, an empty file and seeded random bytes."""
    files = [REPO / "README.md", REPO / "chip_smoke.py",
             REPO / "ggml_imax_tpu_torch" / "quant" / "iq_grids.npz"]
    datas = [f.read_bytes() for f in files]
    datas += [b"#!/bin/sh\necho hello\n" * 10, b"",
              np.random.default_rng(3).bytes(5000)]
    return datas


@pytest.fixture(scope="module")
def magika_params():
    jp = jmagika.synthetic_params(np.random.default_rng(21))
    tp = tmagika.synthetic_params(np.random.default_rng(21), device="cpu")
    return jp, tp


def test_magika_weights_carry_over_byte_identical(magika_params):
    jp, tp = magika_params
    assert_same_tree(tp, params_from_jax(jp, device="cpu"))


def test_magika_file_tokens_equal():
    for data in magika_inputs() + [b"AB", b"x" * 513, b"y" * 1600]:
        np.testing.assert_array_equal(tmagika.file_tokens(data),
                                      jmagika.file_tokens(data))


def test_magika_forward_and_identify_match_jax(magika_params):
    jp, tp = magika_params
    datas = magika_inputs()
    toks = np.stack([jmagika.file_tokens(d) for d in datas])
    # one window a call, as identify calls it (one set of compiled ops)
    ref = np.concatenate([np.asarray(jmagika.forward(jp, jnp.asarray(t[None])))
                          for t in toks])
    got = host(tmagika.forward(tp, toks))
    assert got.shape == (len(datas), len(tmagika.LABELS))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    for d, r, g in zip(datas, ref, got):
        a, b = tmagika.identify(tp, d), jmagika.identify(jp, d)
        np.testing.assert_allclose([p for _, p in a], [p for _, p in b],
                                   rtol=1e-5, atol=1e-6)
        # the same label at each rank, except at a near-tie: two of the
        # reference's probabilities within twice the row's difference (the
        # empty file's window is all padding, so its probabilities tie)
        top = np.sort(r)[::-1][:6]
        tied = 2 * np.abs(g - r).max()
        for i, ((na, _), (nb, _)) in enumerate(zip(a, b)):
            if min(top[i] - top[i + 1],
                   top[i - 1] - top[i] if i else np.inf) > tied:
                assert na == nb, (len(d), i, a, b)


def test_magika_gguf_loader_matches_jax(magika_params, tmp_path):
    jp, _ = magika_params
    w = JGGUFWriter(tmp_path / "magika.gguf")
    for k, n in tmagika.GGUF_NAMES.items():
        a = np.asarray(jp[k], np.float32)
        w.add_tensor(n, a, JType.F32, shape=tuple(reversed(a.shape)))
    w.write()
    jl = jmagika.load_gguf(tmp_path / "magika.gguf")
    tl = tmagika.load_gguf(tmp_path / "magika.gguf", device="cpu")
    assert_same_tree(tl, params_from_jax(jl, device="cpu"))


def test_magika_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmagika.synthetic_params(np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tyolo.synthetic_params(np.random.default_rng(0), width=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsam.preprocess(np.zeros((8, 8, 3), np.uint8))


# ---- YOLOv3-tiny

@pytest.fixture(scope="module")
def yolo_params():
    jp = jyolo.synthetic_params(np.random.default_rng(5), n_classes=80,
                                width=4)
    tp = tyolo.synthetic_params(np.random.default_rng(5), n_classes=80,
                                width=4, device="cpu")
    return jp, tp


def test_yolo_weights_carry_over_byte_identical(yolo_params):
    jp, tp = yolo_params
    assert_same_tree(tp, params_from_jax(jp, device="cpu"))


def test_yolo_heads_match_jax(yolo_params):
    jp, tp = yolo_params
    x = np.random.default_rng(6).random((1, 3, 416, 416)).astype(np.float32)
    r16, r23 = jyolo.forward(jp, jnp.asarray(x))
    g16, g23 = tyolo.forward(tp, torch.from_numpy(x))
    assert g16.shape == (1, 255, 13, 13) and g23.shape == (1, 255, 26, 26)
    assert nmse(host(g16), r16) < TOL["conv"]
    assert nmse(host(g23), r23) < TOL["conv"]


def planted_map(rng):
    """tests/test_yolo_magika.py's planted box and its duplicate, on a
    random background with a few confident cells."""
    pred = rng.normal(-3.0, 2.0, (3 * 85, 13, 13)).astype(np.float32)
    p = pred.reshape(3, 85, 13, 13)
    p[0, :4, 6, 6] = 0.0
    p[0, 4, 6, 6] = 10.0
    p[0, 5 + 3, 6, 6] = 10.0
    p[1, :2, 6, 6] = 0.0
    p[1, 2, 6, 6] = np.log(jyolo.ANCHORS[6] / jyolo.ANCHORS[8])
    p[1, 3, 6, 6] = np.log(jyolo.ANCHORS[7] / jyolo.ANCHORS[9])
    p[1, 4, 6, 6] = 5.0
    p[1, 5 + 3, 6, 6] = 5.0
    return pred


def same_dets(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.box == y.box and x.objectness == y.objectness
        np.testing.assert_array_equal(x.prob, y.prob)


@pytest.mark.parametrize("im", [None, (640, 480), (300, 500)])
def test_yolo_decode_and_nms_bit_equal(im):
    pred = planted_map(np.random.default_rng(7))
    kw = {} if im is None else dict(im_w=im[0], im_h=im[1])
    a = tyolo.decode_head(pred, tyolo.MASK_16, thresh=0.5, **kw)
    b = jyolo.decode_head(pred, jyolo.MASK_16, thresh=0.5, **kw)
    assert len(a) > 2
    same_dets(a, b)
    same_dets(tyolo.nms(a, 0.45), jyolo.nms(b, 0.45))


def test_yolo_letterbox_matches_jax():
    img = np.random.default_rng(8).random((3, 200, 300)).astype(np.float32)
    ref = np.asarray(jyolo.letterbox(img))
    got = host(tyolo.letterbox(img, device="cpu"))
    assert got.shape == (3, 416, 416)
    assert nmse(got, ref) < TOL["conv"]
    np.testing.assert_array_equal(got[:, 0, :], 0.5)


def test_yolo_detect_matches_jax(yolo_params):
    """The whole of detect on a seeded image at a threshold under the
    largest objectness (so there are detections), every objectness clear
    of it (so f32 rounding cannot move a cell across)."""
    jp, tp = yolo_params
    img = np.random.default_rng(9).random((3, 240, 320)).astype(np.float32)
    sig = lambda v: 1 / (1 + np.exp(-np.asarray(v, np.float64)))

    def objectness(heads):
        return np.concatenate([sig(host(h)[0].reshape(3, 85, -1)[:, 4])
                               .ravel() for h in heads])

    ref_obj = objectness(jyolo.forward(jp, jyolo.letterbox(img)[None]))
    got_obj = objectness(tyolo.forward(
        tp, tyolo.letterbox(img, device="cpu")[None]))
    # the widest gap among the 5th-30th largest objectness values, its
    # middle the threshold: no cell closer to it than twice the largest
    # difference of the two packages' objectness
    top = np.sort(ref_obj)[::-1][4:31]
    i = int(np.argmax(top[:-1] - top[1:]))
    thresh = float((top[i] + top[i + 1]) / 2)
    assert np.abs(ref_obj - thresh).min() > 2 * np.abs(got_obj - ref_obj).max()
    ref = jyolo.detect(jp, img, thresh=thresh)
    got = tyolo.detect(tp, img, thresh=thresh)
    assert len(got) == len(ref) >= 5
    for x, y in zip(got, ref):
        np.testing.assert_allclose(x.box, y.box, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(x.objectness, y.objectness, rtol=1e-5)
        np.testing.assert_allclose(x.prob, y.prob, rtol=1e-5, atol=1e-6)


def yolo_gguf(path, jp, rng):
    """A YOLO GGUF of jp's weights with batch-norm tensors for the layers
    that have them (yolov3-tiny.cpp:63-100 names, ggml ne order)."""
    w = JGGUFWriter(path)
    for i, lp in enumerate(jp):
        _, bn, _ = jyolo.LAYER_CFG[i]
        wt = np.asarray(lp["w"], np.float32)
        cout = wt.shape[0]
        w.add_tensor(f"l{i}_weights", wt, JType.F32,
                     shape=tuple(reversed(wt.shape)))
        vec = lambda name, a: w.add_tensor(f"l{i}_{name}", a, JType.F32,
                                           shape=(cout,))
        vec("biases", rng.standard_normal(cout).astype(np.float32))
        if bn:
            vec("scales", rng.uniform(0.5, 2, cout).astype(np.float32))
            vec("rolling_mean", rng.standard_normal(cout).astype(np.float32))
            vec("rolling_variance", rng.uniform(0.5, 2, cout).astype(
                np.float32))
    w.write()


def test_yolo_gguf_loader_folds_batch_norm_as_jax(yolo_params, tmp_path):
    jp, _ = yolo_params
    yolo_gguf(tmp_path / "y.gguf", jp, np.random.default_rng(10))
    jl = jyolo.load_gguf(tmp_path / "y.gguf")
    tl = tyolo.load_gguf(tmp_path / "y.gguf", device="cpu")
    assert_same_tree(tl, params_from_jax(jl, device="cpu"))


# ---- SAM

TINY = dict(n_enc_state=64, n_enc_layer=2, n_enc_head=2, n_enc_out_chans=32,
            n_pt_embd=4, n_dec_heads=4, n_img_size=64, n_window_size=2,
            n_patch_size=16, global_attn=(1,))


@pytest.fixture(scope="module")
def sam_tiny():
    jcfg, tcfg = jsam.SamConfig(**TINY), tsam.SamConfig(**TINY)
    jp = jsam.synthetic_params(jcfg, np.random.default_rng(11))
    tp = tsam.synthetic_params(tcfg, np.random.default_rng(11), device="cpu")
    return jcfg, jp, tcfg, tp


@functools.lru_cache
def jax_sam(cfg):
    """The JAX package's encode_image and decode_mask at cfg, jitted (each
    eager op would compile on its own)."""
    return (jax.jit(lambda p, v: jsam.encode_image(cfg, p, v)),
            jax.jit(lambda p, *a: jsam.decode_mask(cfg, p, *a)))


def test_sam_weights_carry_over_byte_identical(sam_tiny):
    _, jp, _, tp = sam_tiny
    assert_same_tree(tp, params_from_jax(jp, device="cpu"))


def test_sam_encode_matches_jax(sam_tiny):
    jcfg, jp, tcfg, tp = sam_tiny
    img = np.random.default_rng(12).standard_normal((1, 3, 64, 64)) \
        .astype(np.float32)
    ref = np.asarray(jax_sam(jcfg)[0](jp, jnp.asarray(img)))
    got = host(tsam.encode_image(tcfg, tp, torch.from_numpy(img)))
    assert got.shape == (1, 32, 4, 4)
    assert nmse(got, ref) < TOL["block_f32"]


def test_sam_prompt_image_pe_and_decode_match_jax(sam_tiny):
    jcfg, jp, tcfg, tp = sam_tiny
    js, jd = jsam.encode_prompt(jcfg, jp, (0.5, 0.25))
    ts, td = tsam.encode_prompt(tcfg, tp, (0.5, 0.25))
    assert nmse(host(ts), js) < TOL["block_f32"]
    np.testing.assert_array_equal(host(td), np.asarray(jd))
    np.testing.assert_array_equal(host(ts)[1], np.asarray(jp["not_a_pt"]))
    jpe, tpe = jsam.image_pe(jcfg, jp), tsam.image_pe(tcfg, tp)
    assert nmse(host(tpe), jpe) < TOL["block_f32"]
    img = np.random.default_rng(13).standard_normal((1, 3, 64, 64)) \
        .astype(np.float32)
    jenc, jdec = jax_sam(jcfg)
    jm, ji = jdec(jp, jenc(jp, jnp.asarray(img)), js, jd, jpe)
    tm, ti = tsam.decode_mask(tcfg, tp, tsam.encode_image(
        tcfg, tp, torch.from_numpy(img)), ts, td, tpe)
    assert tm.shape == (3, 16, 16) and ti.shape == (3,)
    assert nmse(host(tm), jm) < TOL["block_f32"]
    assert nmse(host(ti), ji) < TOL["block_f32"]


@pytest.mark.parametrize("shape,point", [((48, 64, 3), (30, 20)),
                                         ((72, 40, 3), (10, 50))])
def test_sam_preprocess_and_predict_match_jax(sam_tiny, shape, point):
    jcfg, jp, tcfg, tp = sam_tiny
    img = np.random.default_rng(14).uniform(0, 255, shape).astype(np.uint8)
    jx, jn = jsam.preprocess(img, jcfg)
    tx, tn = tsam.preprocess(img, tcfg, device="cpu")
    assert tn == jn
    assert nmse(host(tx), jx) < TOL["block_f32"]
    ref_masks, ref_iou = jsam.predict(jcfg, jp, img, point_xy=point)
    got_masks, got_iou = tsam.predict(tcfg, tp, img, point_xy=point)
    assert got_masks.shape == ref_masks.shape and got_masks.dtype == bool
    assert nmse(got_iou, ref_iou) < TOL["block_f32"]
    # both packages' mask logits by predict's own steps, to tell the
    # pixels clear of the threshold: farther from it than twice the
    # largest difference of the two
    nh, nw = jn
    pt01 = (np.asarray(point, np.float32) * (nh / shape[0], nw / shape[1])
            / jcfg.n_img_size)
    sparse, dense = jsam.encode_prompt(jcfg, jp, pt01)
    jenc, jdec = jax_sam(jcfg)
    jm, _ = jdec(jp, jenc(jp, jx), sparse, dense, jsam.image_pe(jcfg, jp))
    sparse, dense = tsam.encode_prompt(tcfg, tp, pt01)
    tm, _ = tsam.decode_mask(tcfg, tp, tsam.encode_image(tcfg, tp, tx),
                             sparse, dense, tsam.image_pe(tcfg, tp))
    mi = jm.shape[-1]
    ch, cw = int(mi * nh / jcfg.n_img_size), int(mi * nw / jcfg.n_img_size)
    ref = np.asarray(jax.image.resize(jm[:, :ch, :cw], (3,) + shape[:2],
                                      "bilinear"))
    got = host(tsam._resize_bilinear(tm[:, :ch, :cw], (3,) + shape[:2]))
    assert nmse(got, ref) < TOL["block_f32"]
    clear = np.abs(ref) > 2 * np.abs(got - ref).max()
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got_masks[clear], ref_masks[clear])


def sam_tensors(params):
    """name -> (F32, ne, array) of a SAM params tree as the reference's
    .bin names them (tests/test_sam.py's writer)."""
    out = {}

    def put(name, a):
        a = np.ascontiguousarray(host(a), np.float32)
        out[name] = (JType.F32, tuple(reversed(a.shape)), a)

    put("image_encoder.pos_embed", params["pe"])
    put("image_encoder.patch_embed.proj.weight", params["proj_w"])
    put("image_encoder.patch_embed.proj.bias", params["proj_b"])
    for j, k in enumerate(("neck_conv0", "neck_n0_g", "neck_conv1",
                           "neck_n1_g")):
        put(f"image_encoder.neck.{j}.weight", params[k])
    put("image_encoder.neck.1.bias", params["neck_n0_b"])
    put("image_encoder.neck.3.bias", params["neck_n1_b"])
    for i, lp in enumerate(params["enc_layers"]):
        pre = f"image_encoder.blocks.{i}"
        for n, k in (("norm1", "n1"), ("norm2", "n2")):
            put(f"{pre}.{n}.weight", lp[f"{k}_g"])
            put(f"{pre}.{n}.bias", lp[f"{k}_b"])
        put(f"{pre}.attn.rel_pos_w", lp["rel_w"])
        put(f"{pre}.attn.rel_pos_h", lp["rel_h"])
        for n, k in (("attn.qkv", "qkv"), ("attn.proj", "proj"),
                     ("mlp.lin1", "mlp1"), ("mlp.lin2", "mlp2")):
            put(f"{pre}.{n}.weight", host(lp[f"{k}_w"]).T)
            put(f"{pre}.{n}.bias", lp[f"{k}_b"])
    put("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
        params["pe_gauss"])
    put("prompt_encoder.not_a_point_embed.weight", host(params["not_a_pt"])[None])
    put("prompt_encoder.no_mask_embed.weight", host(params["no_mask"])[None])
    for i, e in enumerate(params["pt_embd"]):
        put(f"prompt_encoder.point_embeddings.{i}.weight", host(e)[None])
    dec = params["dec"]

    def attn(prefix, a):
        for k, n in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("o", "out_proj")):
            put(f"{prefix}.{n}.weight", host(a[f"{k}_w"]).T)
            put(f"{prefix}.{n}.bias", a[f"{k}_b"])

    def mlp3(prefix, m):
        for j in range(3):
            put(f"{prefix}.layers.{j}.weight", host(m[f"w{j}"]).T)
            put(f"{prefix}.layers.{j}.bias", m[f"b{j}"])

    for i, lp in enumerate(dec["layers"]):
        pre = f"mask_decoder.transformer.layers.{i}"
        attn(f"{pre}.self_attn", lp["self"])
        attn(f"{pre}.cross_attn_token_to_image", lp["t2i"])
        attn(f"{pre}.cross_attn_image_to_token", lp["i2t"])
        for j in (1, 2, 3, 4):
            put(f"{pre}.norm{j}.weight", lp[f"n{j}_g"])
            put(f"{pre}.norm{j}.bias", lp[f"n{j}_b"])
        for n, k in (("mlp.lin1", "mlp1"), ("mlp.lin2", "mlp2")):
            put(f"{pre}.{n}.weight", host(lp[f"{k}_w"]).T)
            put(f"{pre}.{n}.bias", lp[f"{k}_b"])
    attn("mask_decoder.transformer.final_attn_token_to_image",
         dec["final_t2i"])
    put("mask_decoder.transformer.norm_final_attn.weight", dec["nf_g"])
    put("mask_decoder.transformer.norm_final_attn.bias", dec["nf_b"])
    for j, k in ((0, "up0_w"), (1, "up1_g"), (3, "up3_w")):
        put(f"mask_decoder.output_upscaling.{j}.weight", dec[k])
    for j, k in ((0, "up0_b"), (1, "up1_b"), (3, "up3_b")):
        put(f"mask_decoder.output_upscaling.{j}.bias", dec[k])
    for i, m in enumerate(dec["hyper"]):
        mlp3(f"mask_decoder.output_hypernetworks_mlps.{i}", m)
    mlp3("mask_decoder.iou_prediction_head", dec["iou"])
    put("mask_decoder.iou_token.weight", dec["iou_token"])
    put("mask_decoder.mask_tokens.weight", dec["mask_tokens"])
    return out


def test_sam_legacy_loader_matches_jax(sam_tiny, tmp_path):
    jcfg, jp, tcfg, tp = sam_tiny
    hp = {"n_enc_state": 64, "n_enc_layer": 2, "n_enc_head": 2,
          "n_enc_out_chans": 32, "n_pt_embd": 4, "ftype": 0}
    path = tmp_path / "sam-tiny.bin"
    jwrite_legacy(path, hp, jsam.HPARAM_NAMES, [], sam_tensors(tp),
                  has_vocab=False)
    jc, jl = jsam.load_legacy(path)
    tc, tl = tsam.load_legacy(path, device="cpu")
    assert tc.n_img_size == jc.n_img_size == 64
    assert (tc.n_enc_state, tc.n_enc_layer, tc.n_enc_head) == \
        (jc.n_enc_state, jc.n_enc_layer, jc.n_enc_head)
    assert_same_tree(tl, params_from_jax(jl, device="cpu"))
    assert_same_tree(tl, tp)                       # the file round-trips


@pytest.mark.parametrize("seed", [0, 1])
def test_yolo_nms_bit_equal_on_crowded_maps(seed):
    """Hundreds of overlapping detections with several classes over the
    threshold (a saturated head, as random weights give): the port's
    vectorized nms against the reference's loops, bit for bit, and its IoU
    matrix against the reference's scalar _iou."""
    rng = np.random.default_rng(seed)
    n_cls = 3
    pred = rng.normal(1.0, 2.0, (3 * (5 + n_cls), 13, 13)).astype(np.float32)
    kw = dict(thresh=0.5, im_w=640, im_h=480, n_classes=n_cls)
    a = tyolo.decode_head(pred, tyolo.MASK_16, **kw)
    b = jyolo.decode_head(pred, jyolo.MASK_16, **kw)
    same_dets(a, b)
    assert len(a) > 250 and sum(bool((d.prob > 0).any()) for d in a) > 100
    m = tyolo._iou_matrix(a)
    idx = rng.integers(0, len(a), (400, 2))
    for i, j in idx:
        assert m[i, j] == jyolo._iou(b[i].box, b[j].box)
    before = sum(int((d.prob > 0).sum()) for d in a)
    same_dets(tyolo.nms(a, 0.45), jyolo.nms(b, 0.45))
    assert sum(int((d.prob > 0).sum()) for d in a) < before   # suppressed
