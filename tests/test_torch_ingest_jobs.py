"""The port's background ingest-job manager against the JAX package's: the
same script of jobs (one that holds the worker mid-embedding, one that
raises, one that succeeds) gives the same states, stages, queue positions,
progress and error text at each step, and a job that raises leaves the
worker running the next one."""

import threading

import pytest

from evr_tpu.serving.jobs import IngestJobManager as JManager
from evr_tpu_torch.serving.jobs import IngestJob, IngestJobManager

WAIT_S = 30


def _script(manager_cls):
    """Run the script on a fresh manager; returns the status snapshots (job
    ids replaced by their order) and the finished jobs."""
    mgr = manager_cls()
    started, release = threading.Event(), threading.Event()

    def held(progress):
        progress("scene_detect")
        progress("embedding", 0)
        progress("embedding", 3, 8)
        started.set()
        assert release.wait(WAIT_S)
        progress("annotating", 0, 8)
        return {"status": "success", "message": "done", "video": {"frames": 8}}

    def broken(progress):
        progress("scene_detect")
        raise IOError("cannot open video: clip.mp4")

    def quick(progress):
        return {"status": "success", "video": {"frames": 0}}

    ids = [mgr.submit("held", held), mgr.submit("broken", broken), mgr.submit("quick", quick)]
    assert started.wait(WAIT_S)
    snaps = [[mgr.status(i) for i in ids]]
    release.set()
    jobs = [mgr.wait(i, timeout=WAIT_S) for i in ids]
    snaps.append([mgr.status(i) for i in ids])
    names = {i: f"job{n}" for n, i in enumerate(ids)}
    for row in snaps:
        for s in row:
            s["job_id"] = names[s["job_id"]]
    assert mgr.status("nope") is None and mgr.wait("nope") is None and mgr.get("nope") is None
    return snaps, jobs


@pytest.fixture(scope="module")
def runs():
    return _script(IngestJobManager), _script(JManager)


def test_states_and_queue_positions_match_jax(runs):
    (got, _), (ref, _) = runs
    assert got == ref
    during, after = got
    assert [s["state"] for s in during] == ["running", "queued", "queued"]
    assert during[0]["stage"] == "embedding" and (during[0]["frames_done"], during[0]["frames_total"]) == (3, 8)
    assert [s.get("queue_position") for s in during] == [None, 0, 1]
    assert [s["state"] for s in after] == ["done", "error", "done"]
    assert "queue_position" not in after[1]


def test_final_payloads_and_error_text(runs):
    (got, jobs), _ = runs
    held, broken, quick = got[1]
    assert held["stage"] == "done" and held["frames_done"] == held["frames_total"] == 8
    assert held["status"] == "success" and held["video"] == {"frames": 8}
    assert broken["stage"] == "error" and broken["error"] == "OSError: cannot open video: clip.mp4"
    assert "video" not in broken and quick["video"] == {"frames": 0}
    assert all(isinstance(j, IngestJob) and j.finished >= j.started >= j.created for j in jobs)


def test_a_new_job_after_an_error_runs():
    mgr = IngestJobManager()
    first = mgr.submit("a", lambda progress: 1 / 0)
    assert mgr.wait(first, timeout=WAIT_S).state == "error"
    assert mgr.status(first)["error"] == "ZeroDivisionError: division by zero"
    second = mgr.submit("b", lambda progress: {"ok": True})
    job = mgr.wait(second, timeout=WAIT_S)
    assert job.state == "done" and mgr.status(second)["ok"] is True
