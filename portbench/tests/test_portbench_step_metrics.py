"""The readers of the step programs' own records and of the scheduler's
iteration spans, on the tiny drivers' traced runs: the host numbers read,
the device ones read None on the CPU, and all of them read None on an
older port that keeps no such records, without raising."""
import pytest

import tiny
from portbench import bench
from portbench.yardstick import programs

DECODE = ("graph_key_ms.decode", "graph_launch_ms.decode",
          "graph_device_ms.decode")
SERVE = ("chunk_device_ms_p50.serve", "decode_device_ms_p50.serve",
         "sched_host_ms_p50.serve")
DEVICE = {"graph_device_ms.decode", "chunk_device_ms_p50.serve",
          "decode_device_ms_p50.serve"}
KINDS = {"session": (tiny.SESSION, 1.0, DECODE),
         "open_loop": (tiny.OPEN_LOOP, 2.0, SERVE)}


def _traced_run(kind):
    mix, seconds, names = KINDS[kind]
    programs.step_graph_module().reset_program_stats()
    ctx = tiny.ctx(mix, seconds=seconds, trace=True)
    return ctx, bench.drive(ctx), names


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_readers_on_a_traced_run(kind):
    ctx, out, names = _traced_run(kind)
    assert out.correct
    for name in names:
        value = bench.load_reader(name)(ctx, out)
        if name in DEVICE:
            assert value is None, name
        else:
            assert value is not None and value > 0, name


def test_decode_host_readers_take_the_calls_before_the_profile():
    """The window is the program's last ``steps`` calls; the host phases
    are read over its first ``trace_skip``, before the profiler."""
    ctx, out, _ = _traced_run("session")
    win = programs.window(out, "decode")
    assert len(win) == out.data["steps"] > ctx.mix["trace_skip"]
    assert programs.records("decode")[-len(win):] == win
    assert programs.before_profile(ctx, out, "decode") == \
        win[:ctx.mix["trace_skip"]]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_readers_without_the_records(kind, monkeypatch):
    ctx, out, names = _traced_run(kind)
    sg = programs.step_graph_module()
    monkeypatch.delattr(sg, "program_stats")
    spans = out.data.get("spans", [])
    out.data["spans"] = [s for s in spans if "step" not in s[3]
                         or s[0] == "decode_step"]
    for name in names:
        assert bench.load_reader(name)(ctx, out) is None, name
