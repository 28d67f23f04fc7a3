"""The last line's keys are the contract's, in its order, and each
compared number rides with its limit."""
import json

import tiny
from portbench import bench


class FakeTrace:
    busy_s, window_s = 0.5, 1.0

    def top_ops(self, n):
        return [["k", 0.5]]

    def idle_gaps(self, n):
        return [["host", 0.5]]


def outcome(gap):
    return bench.Outcome(
        attempted=8, failed=0,
        end_to_end={"decode_tok_s": 100.0, "peak_mem_gib": 50.0,
                    "setup_s": 60.0, "ttft_p75_ms": 1.0},
        data={"decode_call_s": [0.001], "window_s": 10.0,
              "model_flops": 1e15, "model_seconds": 10.0, "cache_bytes": 100, "cache_tokens": 10},
        checks=[bench.Check("max_logit_gap", gap, 0.5)],
        memory_peak_bytes=1 << 30, trace=FakeTrace())


def test_untraced_line():
    ctx = tiny.ctx(tiny.SESSION)
    ctx.cell = "mistral.decode32k"
    res, lines = bench.result_line(bench.manifest(), ctx, outcome(0.1), {})
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True
    assert set(res["metrics"]) == {"decode_tok_s", "peak_mem_gib", "setup_s"}
    assert res["checks"] == {"max_logit_gap": {"value": 0.1, "limit": 0.5}}
    assert "max_logit_gap" in lines[0] and "0.5" in lines[0]
    json.dumps(res)


def test_traced_line_and_failed_check():
    ctx = tiny.ctx(tiny.SESSION, trace=True)
    ctx.cell = "mistral.decode32k"
    res, _ = bench.result_line(bench.manifest(), ctx, outcome(0.9), {})
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert res["correct"] is False
    assert res["metrics"]["decode_host_ms.decode"]["value"] == 1.0
    assert res["metrics"]["device_idle_share.decode"]["value"] == 50.0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
