"""Port parity: the GGUF and legacy ggml .bin readers and writers.

The port's io/gguf.py and io/legacy_bin.py against the JAX package's, on
the same inputs: files written by one package read by the other (metadata,
wire value types, tensor infos and payload bytes equal), both writers
byte-identical, the reference-written fixture parsed alike, bad magic,
alignment padding, a rewrite that keeps every KV's wire type, and the
reader's zero-copy read-only views.
"""
import struct
import warnings

import numpy as np
import pytest

from ggml_imax_tpu.io import gguf as jgguf
from ggml_imax_tpu.io import legacy_bin as jlegacy
from ggml_imax_tpu.quant import formats as jformats
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.io import gguf as tgguf
from ggml_imax_tpu_torch.io import legacy_bin as tlegacy
from ggml_imax_tpu_torch.quant import codecs, device
from ggml_imax_tpu_torch.quant import formats as tformats
from ggml_imax_tpu_torch.quant.formats import GGMLType

FIXTURE = "tests/fixtures/ref_written.gguf"
VT = tgguf.GGUFValueType


def _payloads(rng):
    """name -> (type name, ne shape, encoded payload or typed array)."""
    w = (rng.standard_normal((8, 256)) * 0.1).astype(np.float32)
    return {
        "w_f32": ("F32", (256, 8), w),
        "w_f16": ("F16", (256, 8), w.astype(np.float16)),
        "w_q4_0": ("Q4_0", (256, 8), codecs.quantize(w, GGMLType.Q4_0)),
        "w_q8_0": ("Q8_0", (256, 8), codecs.quantize(w, GGMLType.Q8_0)),
        "w_q4_k": ("Q4_K", (256, 8), codecs.quantize(w, GGMLType.Q4_K)),
        "w_q6_k": ("Q6_K", (256, 8), codecs.quantize(w, GGMLType.Q6_K)),
        "bias": ("F32", (8,), np.arange(8, dtype=np.float32)),
        "ids": ("I32", (5,), np.arange(5, dtype=np.int32)),
        "odd": ("F32", (3,), np.ones(3, np.float32)),   # 12 bytes: padded
    }


def _metadata():
    """(key, value, pinned wire type or None), every kind the writer takes."""
    return [
        ("general.architecture", "llama", None),
        ("general.name", "tiny é model", None),
        ("llama.block_count", np.uint32(2), None),
        ("llama.context_length", 4096, None),            # -> UINT64
        ("signed", -3, None),                            # -> INT64
        ("llama.rope.freq_base", 10000.0, None),         # -> FLOAT32
        ("f64", np.float64(0.125), None),
        ("i16", np.int16(-7), None),
        ("u8", np.uint8(250), None),
        ("flag", True, None),
        ("pinned.u32", 7, VT.UINT32),
        ("pinned.i32", np.int64(-9), VT.INT32),
        ("pinned.f32", np.float64(0.5), VT.FLOAT32),
        ("tokenizer.ggml.tokens", ["a", "b c", "<|endoftext|>", ""], None),
        ("tokenizer.ggml.merges", ["a b", "b c"], None),
        ("scores", np.array([0.5, -1.0, 2.0], np.float32), None),
        ("token_type", np.array([1, 2, 3], np.int32), None),
        ("bytes", np.array([0, 255, 7], np.uint8), None),
        ("int_list", [1, 2, 3], None),
        ("empty", [], None),
    ]


def _write(mod, fmt_mod, path, rng, alignment=32):
    w = mod.GGUFWriter(path, alignment=alignment)
    for key, value, vt in _metadata():
        w.add_kv(key, value, vt)
    for name, (t, ne, data) in _payloads(rng).items():
        ttype = getattr(fmt_mod.GGMLType, t)
        w.add_tensor(name, data, ttype, shape=ne)
    w.write()


def _assert_same_reader(t, j):
    """A port GGUFReader equal to a JAX one: metadata, wire types, infos,
    offsets and payload bytes."""
    assert t.version == j.version
    assert t.alignment == j.alignment and t.data_offset == j.data_offset
    assert list(t.metadata) == list(j.metadata)
    assert t.metadata_types == j.metadata_types
    for k, vj in j.metadata.items():
        vt = t.metadata[k]
        if isinstance(vj, np.ndarray):
            assert isinstance(vt, np.ndarray) and vt.dtype == vj.dtype, k
            np.testing.assert_array_equal(vt, vj, err_msg=k)
        else:
            assert type(vt) is type(vj) and vt == vj, k
    assert list(t.tensors) == list(j.tensors)
    for name, ij in j.tensors.items():
        it = t.tensors[name]
        assert (it.name, it.shape, int(it.ggml_type), it.offset) == \
            (ij.name, ij.shape, int(ij.ggml_type), ij.offset), name
        assert it.n_elements == ij.n_elements and it.nbytes == ij.nbytes
        np.testing.assert_array_equal(t.tensor_data(name), j.tensor_data(name))
        a, b = t.tensor_array(name), j.tensor_array(name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("alignment", [32, 64])
def test_port_writer_read_by_jax_reader(tmp_path, alignment):
    path = tmp_path / "port.gguf"
    _write(tgguf, tformats, path, np.random.default_rng(0), alignment)
    with tgguf.GGUFReader(path) as t, jgguf.GGUFReader(path) as j:
        _assert_same_reader(t, j)
        assert j.metadata["llama.block_count"] == 2
        assert j.metadata_types["pinned.u32"] == VT.UINT32
        assert j.metadata_types["llama.context_length"] == VT.UINT64
        assert j.metadata["tokenizer.ggml.tokens"] == \
            ["a", "b c", "<|endoftext|>", ""]


@pytest.mark.parametrize("alignment", [32, 64])
def test_jax_writer_read_by_port_reader(tmp_path, alignment):
    path = tmp_path / "jax.gguf"
    _write(jgguf, jformats, path, np.random.default_rng(1), alignment)
    with tgguf.GGUFReader(path) as t, jgguf.GGUFReader(path) as j:
        _assert_same_reader(t, j)
    rng = np.random.default_rng(1)
    with tgguf.GGUFReader(path) as t:
        for name, (_, ne, data) in _payloads(rng).items():
            want = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
            np.testing.assert_array_equal(t.tensor_data(name), want)


@pytest.mark.parametrize("alignment", [32, 64, 1])
def test_gguf_writers_byte_identical(tmp_path, alignment):
    _write(tgguf, tformats, tmp_path / "t.gguf", np.random.default_rng(2),
           alignment)
    _write(jgguf, jformats, tmp_path / "j.gguf", np.random.default_rng(2),
           alignment)
    assert (tmp_path / "t.gguf").read_bytes() == \
        (tmp_path / "j.gguf").read_bytes()


def test_reference_written_fixture_parsed_alike():
    with tgguf.GGUFReader(FIXTURE) as t, jgguf.GGUFReader(FIXTURE) as j:
        _assert_same_reader(t, j)
        assert t.metadata["general.architecture"] == "llama"
        assert t.metadata["some.flag"] is True
        qi = t.tensors["tensor_q4"]
        assert qi.ggml_type == GGMLType.Q4_0 and qi.shape == (64, 8)
        x = (0.1 + 2.0 * np.cos(np.arange(64 * 8, dtype=np.float32))) \
            .astype(np.float32)
        np.testing.assert_array_equal(t.tensor_data("tensor_q4"),
                                      codecs.quantize(x, GGMLType.Q4_0))


@pytest.mark.parametrize("which", ["gguf", "legacy"])
def test_bad_magic(tmp_path, which):
    p = tmp_path / "bad.bin"
    p.write_bytes(b"NOPE" + b"\x00" * 64)
    with pytest.raises(ValueError, match="magic"):
        if which == "gguf":
            tgguf.GGUFReader(p)
        else:
            tlegacy.read_legacy_bin(p, ["n_vocab"])


def test_unsupported_gguf_version(tmp_path):
    p = tmp_path / "v9.gguf"
    p.write_bytes(struct.pack("<IIqq", tgguf.GGUF_MAGIC, 9, 0, 0))
    with pytest.raises(ValueError, match="version 9"):
        tgguf.GGUFReader(p)


@pytest.mark.parametrize("alignment", [32, 64])
def test_alignment_padding(tmp_path, alignment):
    path = tmp_path / "a.gguf"
    _write(tgguf, tformats, path, np.random.default_rng(3), alignment)
    blob = path.read_bytes()
    with tgguf.GGUFReader(path) as r:
        assert r.metadata["general.alignment"] == alignment
        assert r.metadata_types["general.alignment"] == VT.UINT32
        assert r.data_offset % alignment == 0
        ends = []
        for name, ti in r.tensors.items():
            start = r.data_offset + ti.offset
            assert start % alignment == 0, name
            ends.append((start, start + ti.nbytes))
        ends.sort()
        # the bytes between one payload's end and the next start are zeros
        for (_, e), (s, _) in zip(ends, ends[1:]):
            assert s - e < alignment and set(blob[e:s]) <= {0}
        assert len(blob) == ends[-1][0] + -(-(ends[-1][1] - ends[-1][0])
                                            // alignment) * alignment


def test_rewrite_keeps_kv_wire_types(tmp_path):
    """A rewrite that passes metadata_types through keeps each KV's wire
    type (a UINT32 does not widen to UINT64), as the JAX package's rewrite
    does; both packages write the same bytes."""
    outs = {}
    for tag, mod in (("t", tgguf), ("j", jgguf)):
        with mod.GGUFReader(FIXTURE) as r:
            w = mod.GGUFWriter(tmp_path / f"{tag}.gguf", alignment=r.alignment)
            for k, v in r.metadata.items():
                if k != "general.alignment":
                    w.add_kv(k, v, r.metadata_types[k])
            for name, ti in r.tensors.items():
                w.add_tensor(name, np.array(r.tensor_data(name)),
                             ti.ggml_type, shape=ti.shape)
            w.write()
        outs[tag] = (tmp_path / f"{tag}.gguf").read_bytes()
    assert outs["t"] == outs["j"]
    with tgguf.GGUFReader(FIXTURE) as a, \
            tgguf.GGUFReader(tmp_path / "t.gguf") as b:
        for k, vt in a.metadata_types.items():
            assert b.metadata_types[k] == vt, k
            va, vb = a.metadata[k], b.metadata[k]
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=k)
            else:
                assert va == vb, k
        for name in a.tensors:
            np.testing.assert_array_equal(a.tensor_data(name),
                                          b.tensor_data(name))


def test_tensor_data_is_a_read_only_view(tmp_path):
    path = tmp_path / "v.gguf"
    _write(tgguf, tformats, path, np.random.default_rng(4))
    before = path.read_bytes()
    r = tgguf.GGUFReader(path)
    view = r.tensor_data("w_q4_0")
    assert not view.flags.writeable and not view.flags.owndata
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # torch.from_numpy would warn
        qt = device.to_device_format(view, GGMLType.Q4_0, (256, 8),
                                     device="cpu")
        qt.q.add_(1)                          # the layout owns its memory
        dense = device.to_device_format(r.tensor_data("w_f32"), GGMLType.F32,
                                        (256, 8), device="cpu")
        dense.q.mul_(2)
    r.close()
    assert path.read_bytes() == before


def _legacy_inputs(rng):
    w = (rng.standard_normal((8, 64)) * 0.1).astype(np.float32)
    hp = dict(n_vocab=3, n_ctx=16, n_embd=64, n_head=2, n_layer=1,
              ftype=2003)
    vocab = [b"a", "bé", b"", b"\xff\xfe"]
    tensors = lambda mod: {
        "model/wte": (mod.GGMLType.Q8_0, (64, 8),
                      codecs.quantize(w, GGMLType.Q8_0)),
        "model/wpe": (mod.GGMLType.F32, (64, 8), w),
        "model/ln_f/g": (mod.GGMLType.F16, (64,), w[0].astype(np.float16)),
        "model/h0/q4": (mod.GGMLType.Q4_0, (64, 8),
                        codecs.quantize(w, GGMLType.Q4_0)),
    }
    names = ["n_vocab", "n_ctx", "n_embd", "n_head", "n_layer", "ftype"]
    return hp, names, vocab, tensors


@pytest.mark.parametrize("has_vocab", [True, False])
def test_legacy_writers_byte_identical_and_cross_read(tmp_path, has_vocab):
    hp, names, vocab, tensors = _legacy_inputs(np.random.default_rng(5))
    tlegacy.write_legacy_bin(tmp_path / "t.bin", hp, names, vocab,
                             tensors(tformats), has_vocab=has_vocab)
    jlegacy.write_legacy_bin(tmp_path / "j.bin", hp, names, vocab,
                             tensors(jformats), has_vocab=has_vocab)
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    for path in (tmp_path / "t.bin", tmp_path / "j.bin"):
        t = tlegacy.read_legacy_bin(path, names, has_vocab=has_vocab)
        j = jlegacy.read_legacy_bin(path, names, has_vocab=has_vocab)
        assert t.hparams == j.hparams
        assert (t.qnt_version, t.ftype) == (j.qnt_version, j.ftype) == (2, 3)
        assert t.vocab == j.vocab
        assert t.vocab == ([b"a", "bé".encode(), b"", b"\xff\xfe"]
                           if has_vocab else [])
        assert list(t.tensors) == list(j.tensors)
        for name, tj in j.tensors.items():
            tt = t.tensors[name]
            assert (tt.name, tt.shape, int(tt.ggml_type)) == \
                (tj.name, tj.shape, int(tj.ggml_type))
            np.testing.assert_array_equal(tt.data, tj.data)


def test_legacy_writer_refuses_a_short_payload(tmp_path):
    with pytest.raises(AssertionError):
        tlegacy.write_legacy_bin(
            tmp_path / "x.bin", {"n": 1}, ["n"], [],
            {"w": (GGMLType.Q4_0, (64, 2), np.zeros(10, np.uint8))})


def test_row_size_and_formats_match_the_reference():
    for t in jformats.FORMATS:
        info = jformats.FORMATS[t]
        mine = tformats.FORMATS[GGMLType(int(t))]
        assert (mine.name, mine.block_size, mine.type_size,
                mine.is_quantized) == (info.name, info.block_size,
                                       info.type_size, info.is_quantized)
        n = 4 * info.block_size
        assert tformats.row_size(GGMLType(int(t)), n) == \
            jformats.row_size(JType(int(t)), n)
    with pytest.raises(AssertionError):
        tformats.row_size(GGMLType.Q4_K, 100)
