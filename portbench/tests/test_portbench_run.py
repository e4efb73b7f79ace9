"""A whole run on the CPU at a tiny size, the same run with the timed
path broken underneath (each fault must make ``correct`` false), the
refusal without a card, and one run on the card."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch
from conftest import CELLS, ROOT, tiny_spec

from portbench import harness

CPU = torch.device("cpu")
SEED = 2**31 + 101


def _run(cell, trace=False, device=CPU, seconds=0.2):
    return harness.run(tiny_spec(cell), SEED, seconds, trace, device,
                       time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result, checks = _run(cell)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert all(c["limit"] == 0 and c["value"] == 0 for c in checks)
    spec = tiny_spec(cell)
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert all(m["value"] > 0 for k, m in result["metrics"].items()
               if k != "peak_device_GiB")


@pytest.mark.parametrize("cell", ["btio.tam.write", "btio.read"])
def test_a_traced_run_reads_its_spans(cell):
    result, _ = _run(cell, trace=True)
    assert result["correct"]
    spans = {m["name"] for m in tiny_spec(cell).per_layer
             if "ms." in m["name"] or m["name"].startswith("ga_")}
    assert spans <= set(result["metrics"])
    assert all(v["value"] > 0 for v in result["metrics"].values())


def _unchanged_state(monkeypatch, direction):
    from repro_torch.core import rounds
    if direction == "read":
        orig = rounds.exchange_rounds_read
        monkeypatch.setattr(rounds, "exchange_rounds_read",
                            lambda *a, **k: torch.zeros_like(orig(*a, **k)))
        return
    orig = rounds._run_rounds

    def drained_nothing(n, buf, *a, **k):
        out = orig(n, buf.clone(), *a, **k)
        return (buf,) + tuple(out[1:])
    monkeypatch.setattr(rounds, "_run_rounds", drained_nothing)


def _half_the_batch(monkeypatch, direction):
    from repro_torch.core import spmd_exec
    orig = spmd_exec._as_requests

    def half(offsets, lengths, count, n_ranks):
        count = count.clone()
        count[n_ranks // 2:] = 0
        return orig(offsets, lengths, count, n_ranks)
    monkeypatch.setattr(spmd_exec, "_as_requests", half)


def _no_exchange(monkeypatch, direction):
    from repro_torch.core import rounds
    monkeypatch.setattr(rounds, "_a2a", lambda x: x.contiguous())


def _altered_answer(monkeypatch, direction):
    from repro_torch.core import spmd_exec
    name = "_read" if direction == "read" else "_write"
    orig = getattr(spmd_exec, name)

    def altered(*a, **k):
        out = orig(*a, **k)
        first = out if direction == "read" else out[0]
        first.view(-1)[first.numel() // 3] += 1
        return out
    monkeypatch.setattr(spmd_exec, name, altered)


FAULTS = {"state_unchanged": _unchanged_state,
          "half_the_batch": _half_the_batch,
          "exchange_left_out": _no_exchange,
          "answer_altered": _altered_answer}


# the read has no exchange between nodes to leave out: on one device its
# window broadcast is the identity
CASES = [(c, f) for c in CELLS for f in FAULTS
         if not (c == "btio.read" and f == "exchange_left_out")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    direction = tiny_spec(cell).traffic["direction"]
    FAULTS[fault](monkeypatch, direction)
    result, checks = _run(cell)
    assert not result["correct"]
    assert result["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in checks)


def _bench_run(cwd, env_extra=None, cell="btio.read"):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine "
                    "without one")
    p = _bench_run(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_fails_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _bench_run(tmp_path, {"PYTHONPATH": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run with `-m cuda` on the card")
    result, checks = _run(cell, trace=True, device=torch.device("cuda", 0),
                          seconds=1.0)
    assert result["correct"], checks
    spec = tiny_spec(cell)
    assert set(result["metrics"]) == {m["name"] for m in spec.per_layer}
    dev = result["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    print(json.dumps(result))
