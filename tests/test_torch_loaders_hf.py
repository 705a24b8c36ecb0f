"""Port parity: `from_hf_state_dict` of GPT-J, GPT-2, LLaMA and Whisper on
random-init `transformers` models (configs built in code, no downloads):
params bit-equal to the JAX converter's in F32 and in one block format each
(the port given CPU torch tensors, the JAX package numpy arrays; numpy
arrays give the port the same params), and the port's f32 logits against
HF's within the tolerances of the JAX package's own HF tests
(tests/test_gptj_llama.py, test_gpt2_model.py, test_whisper.py).
"""
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import gpt2 as jgpt2
from ggml_imax_tpu.models import gptj as jgptj
from ggml_imax_tpu.models import llama as jllama
from ggml_imax_tpu.models import whisper as JW
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.models import gpt2 as tgpt2
from ggml_imax_tpu_torch.models import gptj as tgptj
from ggml_imax_tpu_torch.models import llama as tllama
from ggml_imax_tpu_torch.models import whisper as TW
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.quant.formats import GGMLType
from test_torch_loaders import assert_same


def hf():
    return pytest.importorskip("transformers")


def hf_gptj():
    torch.manual_seed(0)
    tf = hf()
    cfg = tf.GPTJConfig(vocab_size=96, n_positions=64, n_embd=64, n_layer=2,
                        n_head=4, rotary_dim=16)
    return (tf.GPTJForCausalLM(cfg).eval(),
            dict(n_vocab=96, n_ctx=64, n_embd=64, n_head=4, n_layer=2,
                 n_rot=16))


def hf_gpt2():
    torch.manual_seed(0)
    tf = hf()
    cfg = tf.GPT2Config(vocab_size=128, n_positions=64, n_embd=64, n_layer=2,
                        n_head=4)
    return (tf.GPT2LMHeadModel(cfg).eval(),
            dict(n_vocab=128, n_ctx=64, n_embd=64, n_head=4, n_layer=2))


def hf_llama():
    torch.manual_seed(0)
    tf = hf()
    cfg = tf.LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, max_position_embeddings=64,
                         rms_norm_eps=1e-5, rope_theta=10000.0)
    return (tf.LlamaForCausalLM(cfg).eval(),
            dict(n_vocab=96, n_ctx=64, n_embd=64, n_head=4, n_head_kv=2,
                 n_layer=2, n_ff=128))


def hf_whisper():
    torch.manual_seed(0)
    tf = hf()
    cfg = tf.WhisperConfig(
        vocab_size=128, num_mel_bins=16, d_model=32, encoder_layers=2,
        encoder_attention_heads=4, decoder_layers=2,
        decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
        max_source_positions=32, max_target_positions=24, pad_token_id=0,
        bos_token_id=1, eos_token_id=2, decoder_start_token_id=3,
        suppress_tokens=None, begin_suppress_tokens=None,
        forced_decoder_ids=None)
    return (tf.WhisperForConditionalGeneration(cfg).eval(),
            dict(n_vocab=128, n_audio_ctx=32, n_audio_state=32,
                 n_audio_head=4, n_audio_layer=2, n_text_ctx=24,
                 n_text_state=32, n_text_head=4, n_text_layer=2, n_mels=16))


HF_MODELS = {
    "gptj": (hf_gptj, tgptj, jgptj, "GPTJConfig", "Q8_0"),
    "gpt2": (hf_gpt2, tgpt2, jgpt2, "GPT2Config", "Q4_0"),
    "llama": (hf_llama, tllama, jllama, "LlamaConfig", "Q8_0"),
    "whisper": (hf_whisper, TW, JW, "WhisperConfig", "Q5_0"),
}


def hf_state_dicts(model, name):
    sd = model.state_dict()
    if name == "whisper":
        sd = {k.removeprefix("model."): v for k, v in sd.items()}
    return sd, {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("wtype", ["F32", "quantized"])
@pytest.mark.parametrize("name", list(HF_MODELS))
def test_from_hf_state_dict_matches_jax(name, wtype):
    make, tmod, jmod, cfg_name, qtype = HF_MODELS[name]
    model, kw = make()
    wtype = qtype if wtype == "quantized" else wtype
    sd_torch, sd_np = hf_state_dicts(model, name)
    tcfg, jcfg = getattr(tmod, cfg_name)(**kw), getattr(jmod, cfg_name)(**kw)
    got = tmod.from_hf_state_dict(tcfg, sd_torch, GGMLType[wtype],
                                  device="cpu")
    ref = jmod.from_hf_state_dict(jcfg, sd_np, JType[wtype])
    assert_same(got, params_from_jax(ref, device="cpu"))
    # numpy arrays give the same params
    assert_same(tmod.from_hf_state_dict(tcfg, sd_np, GGMLType[wtype],
                                        device="cpu"), got)


def _max_err(got, ref):
    return float(np.abs(np.asarray(got, np.float32) - ref).max())


def test_gptj_hf_logits():
    """Within 5e-3 of HF's, as tests/test_gptj_llama.py."""
    model, kw = hf_gptj()
    cfg = tgptj.GPTJConfig(**kw)
    params = tgptj.from_hf_state_dict(cfg, model.state_dict(), device="cpu")
    toks = np.random.default_rng(0).integers(0, 96, (1, 8))
    got, _ = tgptj.forward(cfg, params, torch.from_numpy(toks),
                           torch.arange(8)[None],
                           tgptj.init_cache(cfg, dtype=torch.float32,
                                            device="cpu"), 0,
                           compute_dtype=torch.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(toks)).logits.numpy()
    assert _max_err(got, ref) < 5e-3


def test_gpt2_hf_logits():
    """Within 2e-3 of HF's, as tests/test_gpt2_model.py."""
    model, kw = hf_gpt2()
    cfg = tgpt2.GPT2Config(**kw)
    params = tgpt2.from_hf_state_dict(cfg, model.state_dict(), device="cpu")
    toks = np.random.default_rng(0).integers(0, 128, (2, 12))
    pos = torch.arange(12)[None].expand(2, 12)
    got, _ = tgpt2.forward(cfg, params, torch.from_numpy(toks), pos,
                           tgpt2.init_cache(cfg, batch=2, dtype=torch.float32,
                                            device="cpu"), 0,
                           compute_dtype=torch.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(toks)).logits.numpy()
    assert _max_err(got, ref) < 2e-3


def test_llama_hf_logits():
    """Within 5e-3 of HF's, as tests/test_gptj_llama.py (GQA 4:2, rope in
    NeoX mode)."""
    from ggml_imax_tpu_torch.ops.rope import ROPE_MODE_NEOX
    model, kw = hf_llama()
    cfg = tllama.LlamaConfig(**kw, rope_mode=ROPE_MODE_NEOX)
    params = tllama.from_hf_state_dict(cfg, model.state_dict(), device="cpu")
    toks = np.random.default_rng(1).integers(0, 96, (1, 9))
    got, _ = tllama.forward(cfg, params, torch.from_numpy(toks),
                            torch.arange(9)[None],
                            tllama.init_cache(cfg, dtype=torch.float32,
                                              device="cpu"), 0,
                            compute_dtype=torch.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(toks)).logits.numpy()
    assert _max_err(got, ref) < 5e-3


def test_whisper_hf_encoder_and_logits():
    """Encoder within 2e-4 and logits within 2e-3 of HF's, as
    tests/test_whisper.py."""
    model, kw = hf_whisper()
    cfg = TW.WhisperConfig(**kw)
    sd, _ = hf_state_dicts(model, "whisper")
    params = TW.from_hf_state_dict(cfg, sd, device="cpu")
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((1, 16, 64)).astype(np.float32)
    toks = rng.integers(0, 128, (1, 6))
    enc = TW.encode(cfg, params, torch.from_numpy(mel),
                    compute_dtype=torch.float32)
    with torch.no_grad():
        ref_enc = model.model.encoder(
            torch.from_numpy(mel)).last_hidden_state.numpy()
        ref = model(input_features=torch.from_numpy(mel),
                    decoder_input_ids=torch.from_numpy(toks)).logits.numpy()
    assert _max_err(enc, ref_enc) < 2e-4
    cross = TW.precompute_cross_kv(cfg, params, enc,
                                   compute_dtype=torch.float32)
    got, _ = TW.decode(cfg, params, torch.from_numpy(toks),
                       torch.arange(6)[None],
                       TW.init_cache(cfg, dtype=torch.float32, device="cpu"),
                       cross, 0, compute_dtype=torch.float32)
    assert _max_err(got, ref) < 2e-3
