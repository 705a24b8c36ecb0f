"""Port parity: utils/logging.py, utils/profiling.py and the process
bootstrap of parallel/distributed.py, against the JAX package's utils
(tests/test_pipeline.py:65's logging check, GraphTimers' report text) and
on gloo ranks of this host's CPU: init / info / global_mesh in one process,
a 2-rank all_reduce, and spawn's handling of a rank that raises or
vanishes."""
import torch
import pytest

import _torch_parallel_ranks as R
from ggml_imax_tpu.utils import logging as JL
from ggml_imax_tpu.utils import profiling as JP
from ggml_imax_tpu_torch.parallel import distributed as D
from ggml_imax_tpu_torch.utils import logging as L
from ggml_imax_tpu_torch.utils import profiling as P

TIMEOUT = 60


@pytest.mark.parametrize("mod", [L, JL], ids=["port", "jax"])
def test_log_callback(mod):
    seen = []
    mod.set_log_callback(lambda lvl, msg: seen.append((lvl, msg)))
    try:
        mod.warn("hello")
        mod.debug("quiet")              # a callback sees every level
    finally:
        mod.set_log_callback(None)
    assert seen == [(mod.LogLevel.WARN, "hello"),
                    (mod.LogLevel.DEBUG, "quiet")]


def test_log_levels_to_stderr(capsys):
    """Without a callback: the reference's text on stderr, levels above
    the set one dropped — as the JAX package prints."""
    for mod in (L, JL):
        mod.set_log_level(mod.LogLevel.WARN)
        try:
            mod.error("e")
            mod.info("dropped")
        finally:
            mod.set_log_level(mod.LogLevel.INFO)
        mod.info("i")
    err = capsys.readouterr().err
    assert err == "[error] e\n[info] i\n" * 2
    assert [int(v) for v in L.LogLevel] == [int(v) for v in JL.LogLevel]


def test_graph_timers_report_matches_jax():
    """The same sections give the same report text."""
    ours, theirs = P.GraphTimers(), JP.GraphTimers()
    for t in (ours, theirs):
        for name, us in (("encode", 1234.5), ("decode step", 98.25),
                         ("encode", 1000.0)):
            t.total_us[name] += us
            t.runs[name] += 1
    assert ours.report() == theirs.report()
    assert "encode" in ours.report() and "2 runs" in ours.report()


def test_graph_timers_section_and_trace(tmp_path):
    t = P.GraphTimers()
    x = torch.randn(32, 32)
    with P.trace(tmp_path) as prof:
        with t.section("matmul", sync=x):
            with P.annotate("mm"):
                y = x @ x
    assert y.shape == (32, 32)
    rep = t.report()
    assert "matmul" in rep and "1 runs" in rep
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any(e.key == "mm" for e in prof.key_averages())


def test_graph_dump_and_memory_stats():
    code = P.dump_graph(lambda a, b: torch.relu(a @ b), torch.randn(4, 8),
                        torch.randn(8, 2))
    assert "relu" in code and ("mm" in code or "matmul" in code)
    assert P.dump_hlo is P.dump_graph
    stats = P.memory_stats()
    assert isinstance(stats, dict) and stats
    if not torch.cuda.is_available():
        assert stats == {"cpu": None}


def test_init_info_and_global_mesh_in_one_process(tmp_path):
    ci = D.init(device="cpu")                 # no arguments, no env: no-op
    assert (ci.process_index, ci.process_count, ci.platform) == (0, 1, "cpu")
    assert not torch.distributed.is_initialized()
    D.init(f"file://{tmp_path / 'store'}", world_size=1, rank=0,
           device="cpu")
    try:
        assert torch.distributed.get_backend() == "gloo"
        mesh = D.global_mesh({"dp": 1, "tp": -1}, device="cpu")
        assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("dp", "tp")
        assert D.info(device="cpu").process_count == 1
        with pytest.raises(ValueError, match="does not cover"):
            D.global_mesh({"dp": 2}, device="cpu")
    finally:
        torch.distributed.destroy_process_group()


def test_two_rank_all_reduce(tmp_path):
    res = D.spawn(R.all_reduce, 2, rendezvous_dir=tmp_path, timeout=TIMEOUT,
                  backend="gloo", device="cpu")
    for rank, (x, ci) in enumerate(res):
        assert x.tolist() == [0.0, 3.0, 6.0, 9.0]
        assert (ci.process_index, ci.process_count, ci.platform) == \
            (rank, 2, "cpu")
    assert not list(tmp_path.glob("rendezvous-*"))


@pytest.mark.parametrize("body", [R.fail, R.vanish], ids=["raises",
                                                        "vanishes"])
def test_spawn_reports_a_failed_rank(tmp_path, body):
    """A rank that raises, or exits without a result, fails the spawn with
    a traceback or an exit code (that rank's, or its peer's: gloo fails the
    barrier of the rank left waiting once the connection closes), and no
    rank is left running."""
    with pytest.raises(RuntimeError,
                       match=r"rank \d (failed:\n|exited with code)"):
        D.spawn(body, 2, rendezvous_dir=tmp_path, timeout=TIMEOUT,
                backend="gloo", device="cpu")
