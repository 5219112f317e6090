"""A cell over several cards, rehearsed on the CPU: the dp training cell at
its tiny size over two ranks and gloo, run from a copy of the benchmark's
files as a run of the benchmark does (past the look for a card). Rank 0 owns the
window and every rank runs the same units; a rank that is killed ends the
run non-zero; no rank outlives the run; calibration reads such a cell a
process a reading."""
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

import tiny

CELL = "maestro22k.train_dp4"


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def _children(stderr: str):
    return [int(p) for p in re.findall(r"rank \d+: pid (\d+)", stderr)]


@pytest.mark.parametrize("trace", [0, 1])
def test_two_ranks_agree_on_every_unit_and_leave_no_process(tmp_path, trace):
    bench = tiny.tree(str(tmp_path), [CELL])
    out = tiny.run(tiny.command(bench, CELL, 2 ** 31 + 31, 1.0, trace=trace))
    line = tiny.result(out)
    if trace:       # the dp family's readers alone (the CPU has no device trace)
        assert line["metrics"] and all(n.endswith(".dp") or n == "capture_s" for n in line["metrics"])
    else:
        assert set(line["metrics"]) == {"train_step_ms.dp", "setup_s"}
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == tiny.DP_RANKS
    assert line["checks"]["ranks_out_of_step"] == {"value": 0, "limit": 0}
    assert line["attempted"] >= (2 if trace else 1) and line["failed"] == 0     # traced: 1 + 5 units
    pids = _children(out.stderr)
    assert len(pids) == tiny.DP_RANKS - 1
    assert all(_gone(p) for p in pids)


def _start(bench, seed, **kw):
    """A 120 s run of the cell from the copy ``bench``, and its one child's
    pid once rank 0 has started it."""
    proc = subprocess.Popen(tiny.command(bench, CELL, seed, 120.0), stderr=subprocess.PIPE, text=True,
                            env=tiny.env(), cwd=tiny.ROOT, **kw)
    log = []
    while not _children("".join(log)):
        line = proc.stderr.readline()
        if not line:
            proc.kill()
            proc.wait()
            raise AssertionError("".join(log)[-4000:])
        log.append(line)
    (pid,) = _children("".join(log))
    return proc, pid


@pytest.mark.parametrize("after_s", [5.0, 20.0])     # in set-up; in the window
def test_a_killed_rank_ends_the_run_nonzero(tmp_path, after_s):
    proc, pid = _start(tiny.tree(str(tmp_path), [CELL]), 2 ** 31 + 32, stdout=subprocess.PIPE)
    try:
        time.sleep(after_s)
        os.kill(pid, signal.SIGKILL)
        t0 = time.monotonic()
        stdout, stderr = proc.communicate(timeout=120)
        ended = time.monotonic() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode != 0, stderr[-4000:]
    assert stdout.strip() == "" or not stdout.strip().splitlines()[-1].startswith("{")
    assert ended < 60, ended
    assert _gone(pid)


def test_no_rank_outlives_a_killed_rank_0(tmp_path):
    proc, pid = _start(tiny.tree(str(tmp_path), [CELL]), 2 ** 31 + 33, stdout=subprocess.DEVNULL)
    try:
        time.sleep(5.0)
        proc.kill()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    deadline = time.monotonic() + 30
    while not _gone(pid) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert _gone(pid)


def test_calibration_reads_the_cell_a_process_a_reading(tmp_path):
    """``calibrate.readings`` runs each reading of a cell over several cards
    as a process of its own with its ranks: the program correct, the bf16
    control not."""
    bench = tiny.tree(str(tmp_path), [CELL])
    code = ("import sys, json, torch; sys.path[:0] = [%r, %r]\n"
            "import calibrate\n"
            "for r in calibrate.readings(%r, [11], [11], torch.device('cpu')):\n"
            "    print(json.dumps(r))\n") % (bench, os.path.dirname(bench), CELL)
    out = tiny.run([sys.executable, "-c", code])
    assert out.returncode == 0, out.stderr[-4000:]
    readings = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert [(r["path"], r["correct"]) for r in readings] == [("program", True), ("control", False)], readings
