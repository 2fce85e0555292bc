"""chip_smoke.py leaves no process behind: on its way out it stops and reaps
multiprocessing's resource tracker (which the spawned worlds start), a
child still running and an orphaned grandchild.  Runs a spawned CPU world
in a process of its own, so the test's own children are not touched."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, os, subprocess, sys
sys.path.insert(0, sys.argv[1])
from multiprocessing import resource_tracker
import chip_smoke
from slim_tpu_torch.parallel.launch import run_world

chip_smoke.adopt_orphans()
ranks = run_world(os.getpid, 2, device="cpu")
tracker = resource_tracker._resource_tracker._pid
stray = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
orphan = int(subprocess.run(["sh", "-c", "sleep 120 >/dev/null 2>&1 & echo $!"],
                            capture_output=True, text=True).stdout)
before = sorted(chip_smoke._children())
strays = chip_smoke.stop_children(grace_s=2.0)
print(json.dumps(dict(ranks=ranks, tracker=tracker, stray=stray.pid,
                      orphan=orphan, before=before, strays=sorted(strays),
                      left=chip_smoke._children())))
"""


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_stop_children_leaves_no_process():
    out = subprocess.run([sys.executable, "-c", SCRIPT, ROOT],
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(set(rec["ranks"])) == 2
    # the tracker, the running child and the adopted orphan were there
    assert rec["tracker"] is not None
    assert sorted([rec["tracker"], rec["stray"], rec["orphan"]]) == \
        rec["before"]
    # the tracker was closed as multiprocessing closes it, not signalled
    assert rec["strays"] == sorted([rec["stray"], rec["orphan"]])
    assert rec["left"] == []
    assert "stopping leftover process" in out.stderr
    for key in ("tracker", "stray", "orphan"):
        assert not _alive(rec[key]), key
