"""Port parity: the example CLIs (ggml_imax_tpu_torch/examples/) against the
JAX package's (examples/), both run in-process with their output captured:
the JAX CLI through runpy with sys.argv set, the port's through main(argv)
with --device cpu (the plain versions). Tiny model files come from the
writers of tests/test_examples_cli.py, test_torch_loaders.py and
test_torch_vision_models.py.

- gpt2 / gptj / llama at --f32 --temp 0: stdout equal; a fixed -s with
  sampling gives the same text run to run; the llama CLI's default
  residency refuses a Q4_K_M mix (q/k/v of different types) in one line.
- quantize: the output GGUF equal to the JAX CLI's, byte for byte.
- perplexity at --f32: within 1e-4 relative (the port's llama attention
  patched to attention_xla, the reference's host attention, as
  tests/test_torch_quant_tools.py does for perplexity parity).
- serve: greedy -np 3 stdout equal; --bench and --bench --steady under
  GGML_SERVE_BENCH_TINY=1: the JSON line's keys equal, 18 tokens.
- whisper -bs 1 and -bs 5, simple (mnist, sam, yolo and magika:
  tests/test_torch_examples_vision.py).
- every CLI refuses to run without a card unless given --device cpu; the
  module entry runs as `python -m`; the CLIs import torch, numpy, the
  standard library and the port only.
"""
import ast
import importlib
import json
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ggml_imax_tpu.io.gguf import GGUFWriter as JGGUFWriter
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.audio.wav import write_wav
from ggml_imax_tpu_torch.models import llama as tllama
from ggml_imax_tpu_torch.ops.attention import attention_xla

from test_examples_cli import build_tiny_gpt2_bin
from test_torch_loaders import CORPUS, write_gptj, write_llama, write_whisper

REPO = Path(__file__).resolve().parents[1]
CLIS = ("common", "gpt2", "gptj", "llama", "serve", "simple", "whisper",
        "quantize", "perplexity", "mnist", "sam", "yolo", "magika")


def run_jax(name, argv, capsys, env=None):
    """The JAX package's examples/<name>.py as `python examples/<name>.py
    argv` in this process; returns its stdout."""
    script = str(REPO / "examples" / f"{name}.py")
    capsys.readouterr()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [script] + list(argv))
        for k, v in (env or {}).items():
            mp.setenv(k, v)
        runpy.run_path(script, run_name="__main__")
    return capsys.readouterr().out


def run_port(name, argv, capsys, env=None, device="cpu"):
    """The port's examples.<name>.main(argv + --device), its stdout."""
    mod = importlib.import_module(f"ggml_imax_tpu_torch.examples.{name}")
    capsys.readouterr()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (env or {}).items():
            mp.setenv(k, v)
        assert mod.main(list(argv) + (["--device", device] if device else
                                      [])) == 0
    return capsys.readouterr().out


@pytest.fixture
def jax_cache_config():
    """The JAX serve --bench sets the process's compilation-cache options;
    put them back after the test."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    old = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    build_tiny_gpt2_bin(d / "gpt2.bin", np.random.default_rng(0))
    write_gptj(d / "gptj.bin")
    write_llama(d / "llama.gguf")
    (d / "text.txt").write_text((CORPUS + " ") * 6)
    return d


# ---- generation

@pytest.mark.parametrize("name,model,prompt", [
    ("gpt2", "gpt2.bin", "tok1 tok2"),
    ("gptj", "gptj.bin", "the quick brown fox"),
    ("llama", "llama.gguf", "the quick brown fox")])
def test_generation_cli_matches_jax(files, capsys, name, model, prompt):
    argv = ["-m", str(files / model), "-p", prompt, "-n", "8", "-s", "1",
            "--f32", "--temp", "0"]
    want = run_jax(name, argv, capsys)
    got = run_port(name, argv, capsys)
    assert got == want
    assert got.startswith(prompt) and len(got) > len(prompt) + 1


def test_sampled_generation_is_seeded(files, capsys):
    """--temp 0.8 with -s: the same text run to run, and it is not the
    greedy text (the flag reaches the sampler)."""
    argv = ["-m", str(files / "gpt2.bin"), "-p", "tok1 tok2", "-n", "12",
            "--f32", "--top_k", "64", "--top_p", "1.0"]
    a = run_port("gpt2", argv + ["-s", "7", "--temp", "1.5"], capsys)
    b = run_port("gpt2", argv + ["-s", "7", "--temp", "1.5"], capsys)
    greedy = run_port("gpt2", argv + ["-s", "7", "--temp", "0"], capsys)
    assert a == b
    assert a != greedy


def test_llama_default_residency_refuses_a_mixed_qkv(files, capsys):
    """The Q4_K_M mix (attn_v Q6_K in layer 1): "q4-fused" and "q4-stacked"
    exit with one line naming the types and the residency that runs the
    file; that residency runs it."""
    from ggml_imax_tpu_torch.examples import llama as cli
    argv = ["-m", str(files / "llama.gguf"), "-p", "the quick brown fox",
            "-n", "4", "-s", "1", "--temp", "0", "--device", "cpu"]
    for resident in ([], ["--resident", "q4-stacked"]):
        with pytest.raises(SystemExit) as e:
            cli.main(argv + resident)
        msg = str(e.value.code)
        assert "\n" not in msg
        assert "layer 1: Q4_K/Q4_K/Q6_K" in msg and "--resident as-is" in msg
    out = run_port("llama", argv[:-2] + ["--resident", "as-is"], capsys)
    assert out.startswith("the quick brown fox")


# ---- quantize, perplexity

@pytest.mark.parametrize("qtype", ["q4_0", "q5_1", "q8_0", "q4_k"])
def test_quantize_cli_bytes_equal_jax(tmp_path, capsys, qtype):
    rng = np.random.default_rng(3)
    src = tmp_path / "m-f32.gguf"
    w = JGGUFWriter(src)
    w.add_kv("general.architecture", "llama")
    w.add_kv("general.file_type", np.uint32(0))
    w.add_tensor("blk.0.attn_q.weight",
                 (rng.standard_normal((8, 512)) * 0.1).astype(np.float32),
                 JType.F32, shape=(512, 8))
    w.add_tensor("token_embd.weight",
                 (rng.standard_normal((4, 256)) * 0.1).astype(np.float16),
                 JType.F16, shape=(256, 4))
    w.add_tensor("blk.0.attn_norm.weight",
                 rng.standard_normal(256).astype(np.float32), JType.F32,
                 shape=(256,))
    w.write()
    want, got = tmp_path / "jax.gguf", tmp_path / "port.gguf"
    out_j = run_jax("quantize", [str(src), str(want), qtype], capsys)
    out_t = run_port("quantize", [str(src), str(got), qtype], capsys)
    assert got.read_bytes() == want.read_bytes()
    assert out_t == out_j and f"-> {qtype.upper()}" in out_t


def test_perplexity_cli_matches_jax(files, capsys, monkeypatch):
    monkeypatch.setattr(tllama, "attention", attention_xla)
    argv = ["-m", str(files / "llama.gguf"), "-f", str(files / "text.txt"),
            "-c", "16", "--f32"]
    pat = re.compile(r"^perplexity: ([0-9.]+) over (\d+) tokens$")
    want = pat.match(run_jax("perplexity", argv, capsys).strip())
    got = pat.match(run_port("perplexity", argv, capsys).strip())
    assert got and want and got[2] == want[2]
    assert abs(float(got[1]) - float(want[1])) <= 1e-4 * float(want[1])


# ---- serve

def test_serve_cli_matches_jax(files, capsys):
    argv = ["-m", str(files / "gpt2.bin"), "-p", "tok1 tok2", "-n", "6",
            "-s", "3", "-np", "3", "--f32", "--temp", "0"]
    want = run_jax("serve", argv, capsys)
    got = run_port("serve", argv, capsys)
    assert got == want and got.count("--- sequence") == 3


def test_serve_forks_are_seeded(files, capsys):
    """Sampled forks: each sequence the same run to run for its seed."""
    argv = ["-m", str(files / "gpt2.bin"), "-p", "tok1 tok2", "-n", "8",
            "-s", "5", "-np", "3", "--f32", "--temp", "1.5", "--top_k", "64",
            "--top_p", "1.0"]
    a = run_port("serve", argv, capsys)
    assert a == run_port("serve", argv, capsys)
    seqs = a.split("--- sequence")[1:]
    assert len(seqs) == 3 and len(set(seqs)) > 1


@pytest.mark.parametrize("steady", [False, True])
def test_serve_bench_line_matches_jax(capsys, jax_cache_config, steady):
    argv = ["--bench", "-np", "3"] + (["--steady"] if steady else [])
    env = {"GGML_SERVE_BENCH_TINY": "1"}
    want = json.loads(run_jax("serve", argv, capsys, env).splitlines()[-1])
    got = json.loads(run_port("serve", argv, capsys, env).splitlines()[-1])
    assert list(got) == list(want)
    assert got["metric"] == "serve_gptj6b_q4_0_tok_s"
    assert got["n_requests"] == 3 and got["generated"] == want["generated"] \
        == 3 * 6
    assert got["value"] > 0 and got["p50_ttft_ms"] > 0
    if steady:
        assert got["steady_tok_s"] > 0 and got["steady_generated"] > 0


# ---- whisper

@pytest.mark.parametrize("beam", ["1", "5"])
def test_whisper_cli_matches_jax(tmp_path, capsys, beam):
    """The port's CLI fuses and repacks the weights for the kernels (on
    the host: their plain versions, W8A8 at a decode step); the JAX CLI
    runs the loaded layout. The tiny Q5_0 / Q8_0 model's segments agree."""
    write_whisper(tmp_path / "w.bin", seed=0)
    write_wav(tmp_path / "a.wav", (np.random.default_rng(1).standard_normal(
        16000) * 0.1).astype(np.float32))
    argv = ["-m", str(tmp_path / "w.bin"), "-f", str(tmp_path / "a.wav"),
            "-bs", beam]
    want = run_jax("whisper", argv, capsys)
    got = run_port("whisper", argv, capsys)
    assert got == want and got.startswith("[   0.00 ->")


def test_whisper_cli_full_params(tmp_path, capsys):
    """The CLI hands transcribe the JAX CLI's FullParams: its flags set,
    whisper_full_params' defaults for the rest; it has no flag of its own."""
    write_whisper(tmp_path / "w.bin", seed=0)
    write_wav(tmp_path / "a.wav", (np.random.default_rng(1).standard_normal(
        16000) * 0.1).astype(np.float32))
    from ggml_imax_tpu_torch.examples import whisper as cli
    from ggml_imax_tpu_torch.runtime import whisper_pipeline as wp
    seen = []
    real = wp.WhisperPipeline.transcribe

    def transcribe(self, samples, fp):
        seen.append(fp)
        return real(self, samples, fp)
    argv = ["-m", str(tmp_path / "w.bin"), "-f", str(tmp_path / "a.wav"),
            "-bs", "2", "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wp.WhisperPipeline, "transcribe", transcribe)
        cli.main(argv)
    out = capsys.readouterr().out
    assert seen == [wp.FullParams(language="en", translate=False, beam_size=2,
                                  token_timestamps=False)]
    assert out.startswith("[   0.00 ->") and len(out.splitlines()) == 1
    for extra in (["-nf"], ["--max_tokens", "3"]):
        with pytest.raises(SystemExit):
            cli.main(argv + extra)


# ---- simple

def test_simple_cli(capsys):
    """The port's demo prints the JAX demo's first line, then holds the
    product to the dequantized weights' and prints ok (the JAX demo's own
    assert, 5% of the f32 product, fails on Q4_0's rounding)."""
    got = run_port("simple", [], capsys).splitlines()
    with pytest.raises(AssertionError):
        run_jax("simple", [], capsys)
    want = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]
    assert got[-1] == "ok"


# ---- the entry points

def cli_argv(name, tmp_path):
    """Arguments each CLI parses (the files need not exist: the device is
    resolved before anything is read)."""
    m = str(tmp_path / "m.bin")
    return {"gpt2": ["-m", m], "gptj": ["-m", m], "llama": ["-m", m],
            "serve": ["-m", m], "simple": [], "mnist": [],
            "whisper": ["-m", m, "-f", m], "quantize": [m, m, "q4_0"],
            "perplexity": ["-m", m, "-f", m], "sam": ["-m", m, "-i", m],
            "yolo": ["-m", m, "-i", m], "magika": [m, m]}[name]


@pytest.mark.parametrize("name", [c for c in CLIS if c != "common"]
                         + ["serve --bench", "tools.quality_gate",
                            "tools.quality_kernel_row"])
def test_cli_without_a_card_exits(tmp_path, monkeypatch, name):
    """No --device and no CUDA device: SystemExit with resolve_device's
    message before anything runs; nothing falls through to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if name.startswith("tools."):
        mod = importlib.import_module(f"ggml_imax_tpu_torch.{name}")
        argv = ["--dir", str(tmp_path)]
    elif name == "serve --bench":
        mod = importlib.import_module("ggml_imax_tpu_torch.examples.serve")
        argv = ["--bench"]
    else:
        mod = importlib.import_module(f"ggml_imax_tpu_torch.examples.{name}")
        argv = cli_argv(name, tmp_path)
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert "no CUDA device" in str(e.value.code)
    assert not list(tmp_path.iterdir())


def test_module_entry_runs_as_a_subprocess(files, capsys):
    argv = ["-m", str(files / "gpt2.bin"), "-p", "tok1 tok2", "-n", "6",
            "-s", "1", "--f32", "--temp", "0", "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run(
        [sys.executable, "-m", "ggml_imax_tpu_torch.examples.gpt2"] + argv,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout == run_port("gpt2", argv, capsys, device=None)
    assert "decode:" in res.stderr


def test_cli_imports_are_torch_numpy_stdlib_or_the_port():
    """Every import statement of the CLIs and the two quality tools, at
    any depth of the module, names torch, numpy, the standard library or
    the port (a relative import)."""
    files = [REPO / "ggml_imax_tpu_torch" / "examples" / f"{c}.py"
             for c in CLIS] + [REPO / "ggml_imax_tpu_torch" / "examples" /
                               "__init__.py"] + [
        REPO / "ggml_imax_tpu_torch" / "tools" / f"{t}.py"
        for t in ("quality_gate", "quality_kernel_row")]
    allowed = {"torch", "numpy", "ggml_imax_tpu_torch"} \
        | set(sys.stdlib_module_names)
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:                       # relative: the port
                    continue
                roots = [node.module.split(".")[0]]
            else:
                continue
            bad = [r for r in roots if r not in allowed]
            assert not bad, (f.name, node.lineno, bad)
