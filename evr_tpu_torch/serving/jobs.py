"""Background ingest jobs: asynchronous upload processing.

Counterpart of ``evr_tpu/serving/jobs.py``. The upload route only saves the
file, submits the ingest to one background worker and answers 202 with a
job id; clients poll ``GET /api/upload-status/<job_id>`` for ``{state,
stage, frames_done, frames_total, error, ...}``. Searches keep working
during an ingest: the index and metadata store change only at its end.

One worker thread, first in first out: ingest is bound to the card (the
embedding pass holds it), so concurrent ingests would only contend; a job
that waits reports ``state == "queued"`` and its queue position.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field


@dataclass
class IngestJob:
    job_id: str
    video_name: str
    state: str = "queued"  # queued | running | done | error
    stage: str = "queued"  # queued | scene_detect | embedding | annotating | registering | done | error
    frames_done: int = 0
    frames_total: int | None = None
    error: str | None = None
    result: dict | None = None  # the upload response payload, set when done
    created: float = field(default_factory=time.time)
    started: float | None = None
    finished: float | None = None
    _event: threading.Event = field(default_factory=threading.Event, repr=False)

    def snapshot(self, queue_position: int | None = None) -> dict:
        out = {
            "job_id": self.job_id,
            "video_name": self.video_name,
            "state": self.state,
            "stage": self.stage,
            "frames_done": self.frames_done,
            "frames_total": self.frames_total,
            "error": self.error,
        }
        if queue_position is not None and self.state == "queued":
            out["queue_position"] = queue_position
        if self.result is not None:
            out.update(self.result)  # {"status": "success", "message", "video"}
        return out


class IngestJobManager:
    """First-in-first-out background runner of ingest callables with
    progress reporting.

    ``submit(video_name, fn)`` queues ``fn(progress)``, where ``progress`` is
    ``(stage: str, done: int | None, total: int | None) -> None``; the value
    ``fn`` returns (a dict, the upload response payload) becomes the job's
    ``result``. An exception ends the job in ``state == "error"`` with its
    text in ``error``, and the worker carries on with the next job.
    """

    def __init__(self):
        self._jobs: dict[str, IngestJob] = {}
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._worker: threading.Thread | None = None

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._run, name="evr-ingest-worker", daemon=True)
            self._worker.start()

    def submit(self, video_name: str, fn) -> str:
        job = IngestJob(job_id=uuid.uuid4().hex[:16], video_name=video_name)
        with self._lock:
            self._jobs[job.job_id] = job
            self._queue.put((job, fn))
            self._ensure_worker()
        return job.job_id

    def get(self, job_id: str) -> IngestJob | None:
        with self._lock:
            return self._jobs.get(job_id)

    def status(self, job_id: str) -> dict | None:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            pos = None
            if job.state == "queued":
                queued = [
                    j for j in sorted(self._jobs.values(), key=lambda j: j.created)
                    if j.state == "queued"
                ]
                pos = queued.index(job)
            return job.snapshot(queue_position=pos)

    def wait(self, job_id: str, timeout: float | None = None) -> IngestJob | None:
        """Block until the job ends (done or error) or ``timeout`` passes.
        Returns the job, or None for an unknown id."""
        job = self.get(job_id)
        if job is None:
            return None
        job._event.wait(timeout)
        return job

    # -- worker -------------------------------------------------------------
    def _run(self) -> None:
        while True:
            job, fn = self._queue.get()

            def progress(stage: str, done: int | None = None, total: int | None = None):
                job.stage = stage
                if done is not None:
                    job.frames_done = int(done)
                if total is not None:
                    job.frames_total = int(total)

            job.state = "running"
            job.started = time.time()
            try:
                job.result = fn(progress)
                job.state = "done"
                job.stage = "done"
                if job.frames_total is not None:
                    job.frames_done = job.frames_total
            except Exception as e:  # reported by the status route, not a 500
                job.state = "error"
                job.stage = "error"
                job.error = f"{type(e).__name__}: {e}"
                traceback.print_exc()
            finally:
                job.finished = time.time()
                job._event.set()
                self._queue.task_done()
