"""The bench orchestrator's watchdog plumbing.

bench.py runs every section in its own subprocess under a hard deadline
(one process per card; a stalled section must not take the run with
it); these tests drive that machinery with stub sections — no device, no
compiles.
"""

import importlib.util
import json
import os
import sys
import time

_BENCH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "bench.py")
spec = importlib.util.spec_from_file_location("bench", _BENCH)
bench = importlib.util.module_from_spec(spec)
sys.modules.setdefault("bench", bench)
spec.loader.exec_module(bench)


class TestRegistry:
    def test_every_secondary_section_is_registered(self):
        for name, deadline in bench.SECONDARY:
            assert name in bench.SECTIONS, name
            assert deadline >= 60

    def test_headline_and_cold_start_sections_registered(self):
        for name in ("fingerprint", "coldstart_cold"):
            assert name in bench.SECTIONS
        # the CPU ladder is gone: nothing may quietly measure elsewhere
        for name in ("fingerprint_reduced", "fingerprint_cpu"):
            assert name not in bench.SECTIONS


class TestExtractHeadline:
    def test_finds_metric_line(self):
        out = (
            '[noise]\n{"_ctrl": 1, "key": "K", "value": 2}\n'
            '{"metric": "fingerprint_throughput", "value": 5.0}\n'
        )
        line = bench._extract_headline(out)
        assert json.loads(line)["value"] == 5.0

    def test_none_on_no_line(self):
        assert bench._extract_headline("garbage\n") is None
        assert bench._extract_headline(None) is None


class TestWatchdog:
    def test_kills_stalled_section_within_deadline(self):
        t0 = time.monotonic()
        out = bench._run_child("_test_sleep", 30, {})
        elapsed = time.monotonic() - t0
        # the child sleeps 600 s; the watchdog must kill it at ~deadline.
        # (the child still pays a few seconds of interpreter+jax import)
        assert out is None
        assert elapsed < 45

    def test_headline_section_round_trips(self):
        out = bench._run_child("_test_headline", 120, {})
        line = bench._extract_headline(out)
        assert line is not None
        assert json.loads(line)["value"] == 1234.5

    def test_control_lines_feed_state(self):
        # drive the REAL parser in _run_child with a stub section that
        # emits a control line — an inline re-implementation would keep
        # passing after the actual parsing loop regressed
        state = {}
        bench._run_child("_test_ctrl", 120, state)
        assert state["TIRESIAS_BENCH_TEST_KEY"] == 42.5

    def test_too_small_deadline_skips(self):
        assert bench._run_child("_test_sleep", 10, {}) is None

    def test_partial_output_salvaged_on_watchdog_kill(self):
        """A section that prints its headline and THEN hangs (e.g. in
        teardown) must not lose the measurement: the watchdog kill drains
        the pipe and returns the partial output."""
        out = bench._run_child("_test_headline_then_hang", 30, {})
        line = bench._extract_headline(out)
        assert line is not None
        assert json.loads(line)["value"] == 777.0

    def test_summary_lines_collected_and_merged(self):
        # the REAL parser: same-section summary lines must merge so a
        # section that prints results incrementally keeps finished
        # numbers after a later watchdog kill
        summaries: dict = {}
        bench._run_child("_test_summary", 120, {}, summaries)
        assert summaries == {
            "alpha": {"a_ms": 1.5, "b": 2},
            "beta": {"ok": True},
        }


class TestFinalLines:
    """A reader may keep only the last ~2000 chars of output and parse
    the FINAL lines, so the bench's last words must be the sections
    summary then the headline."""

    HEADLINE = json.dumps(
        {"metric": "fingerprint_throughput", "value": 695000.0,
         "unit": "audio_hours_per_hour_per_device", "vs_baseline": 695.0}
    )

    def _final(self, summaries, capsys):
        bench._print_final(self.HEADLINE, summaries)
        return [
            ln for ln in capsys.readouterr().out.splitlines() if ln.strip()
        ]

    def test_headline_is_last_and_sections_parse(self, capsys):
        summaries = {name: {"p50_ms": 1.0} for name, _ in bench.SECONDARY}
        summaries["fingerprint"] = {"hrs_hr": 695000}
        lines = self._final(summaries, capsys)
        assert json.loads(lines[-1])["metric"] == "fingerprint_throughput"
        parsed = json.loads(lines[-2])
        for name, _ in bench.SECONDARY:
            assert name in parsed["sections"], name
        # both final lines must fit the driver's ~2000-char tail window
        assert len(lines[-1]) + len(lines[-2]) < 1900

    def test_oversize_sections_dropped_whole_not_truncated(self, capsys):
        summaries = {
            f"s{i}": {f"k{j}": "x" * 40 for j in range(20)}
            for i in range(10)
        }
        lines = self._final(summaries, capsys)
        parsed = json.loads(lines[-2])  # still valid JSON
        assert len(lines[-2]) <= 1700
        assert "dropped_for_size" in json.dumps(parsed)

    def test_no_sections_line_when_empty(self, capsys):
        lines = self._final({}, capsys)
        assert len(lines) == 1
        assert json.loads(lines[-1])["metric"] == "fingerprint_throughput"

    def test_every_secondary_section_emits_a_summary(self):
        # source-level guard: a new section that never calls summary()
        # would silently vanish from the final artifact line
        import inspect

        for name, _ in bench.SECONDARY:
            src = inspect.getsource(bench.SECTIONS[name])

            # accept a direct call or one through a same-module helper
            # (search_scale delegates to bench_search_latency)
            def emits(fn_src, seen=frozenset()):
                if "summary(" in fn_src:
                    return True
                for n in dir(bench):
                    if n in seen or not callable(getattr(bench, n)):
                        continue
                    if f"{n}(" in fn_src and n.startswith("bench_"):
                        try:
                            inner = inspect.getsource(getattr(bench, n))
                        except (OSError, TypeError):
                            continue
                        if emits(inner, seen | {n}):
                            return True
                return False

            assert emits(src), f"section {name} never emits summary()"
