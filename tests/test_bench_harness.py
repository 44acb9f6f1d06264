"""bench.py's run contract: a failed section makes the run exit non-zero
after the other sections ran, and the summary names the device. Sections
are replaced by stubs, so no timing runs here."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


@pytest.fixture
def stub_sections(monkeypatch, tmp_path):
    import numpower_tpu.utils.config as config

    ran = []

    def section(name, fail=False):
        def fn(*args, **kwargs):
            ran.append(name)
            if fail:
                raise RuntimeError(f"{name} broke")
            return {f"{name}_row": (1.0, "x")}
        return fn

    monkeypatch.setattr(config, "enable_compile_cache", lambda: str(tmp_path))
    monkeypatch.setattr(bench, "bench_flagship", lambda *a: (
        ran.append("flagship") or 5.0, 1.0,
        {"fista_flagship_solves_per_sec": (5.0, "solves/s")}))
    for name in ("lqr", "ilqr", "tube", "serving", "solvers_extra",
                 "estimation"):
        monkeypatch.setattr(bench, f"bench_{name}", section(name))
    monkeypatch.setattr(bench, "bench_shardmap_overhead", section("shardmap"))
    monkeypatch.setattr(bench, "CERTIFY_PATH", str(tmp_path / "CERTIFY.json"))
    return ran, section


def _run(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["bench.py"] + argv)
    code = 0
    try:
        bench.main()
    except SystemExit as e:
        code = e.code
    return code, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_all_sections_ok_exit_zero_and_name_device(stub_sections,
                                                   monkeypatch, capsys):
    ran, _ = stub_sections
    code, summary = _run(monkeypatch, capsys, ["--quick", "--full"])
    assert code == 0
    assert ran[0] == "flagship" and "shardmap" in ran
    assert summary["device"]["platform"] == "cpu"
    assert summary["device"]["count"] >= 1
    assert summary["value"] == 5.0 and "failed_sections" not in summary


def test_failed_section_exits_nonzero_after_the_rest(stub_sections,
                                                     monkeypatch, capsys):
    ran, section = stub_sections
    monkeypatch.setattr(bench, "bench_tube", section("tube", fail=True))
    code, summary = _run(monkeypatch, capsys, ["--quick", "--full"])
    assert code == 1
    assert summary["failed_sections"] == ["tube"]
    assert ran[-1] == "shardmap"  # the sections after the failure still ran


def test_device_time_per_call_is_positive():
    import jax.numpy as jnp

    t, iqr = bench._device_time_per_call(
        lambda x, i: jnp.sum(x * i), (jnp.ones((64, 64)),), K=4, reps=5,
        return_stats=True)
    assert t > 0 and iqr >= 0
