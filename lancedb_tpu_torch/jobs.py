"""Background jobs: handles for long-running operations.

Port of the reference's jobs.py (job.rs:16-31 `Job`: status, wait,
cancel; the connection's list/get/cancel/history, connection.rs:526-556;
``create_index_async`` returning a Job, index.rs:313): a thread pool and a
registry per connection. A job that builds an index runs it on the
table's device from a pool thread.
"""

from __future__ import annotations

import threading
import time
import traceback
import uuid as _uuid
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable

from .errors import JobFailureError


class JobStatus(str, Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"


@dataclass
class JobInfo:
    id: str
    job_type: str
    status: JobStatus
    created_at: float
    finished_at: float | None = None
    error: str | None = None

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "type": self.job_type,
            "status": self.status.value,
            "created_at": self.created_at,
            "finished_at": self.finished_at,
            "error": self.error,
        }


class Job:
    """Handle over one background operation (reference job.rs `Job`)."""

    def __init__(self, info: JobInfo, future: Future, cancel_event: threading.Event):
        self._info = info
        self._future = future
        self._cancel = cancel_event

    @property
    def id(self) -> str:
        return self._info.id

    def status(self) -> JobStatus:
        return self._info.status

    def wait(self, timeout: float | None = None) -> Any:
        """Block until done; raises JobFailureError on failure."""
        try:
            result = self._future.result(timeout=timeout)
        except JobFailureError:
            raise
        except Exception as e:
            raise JobFailureError(f"job {self.id} failed: {e}") from e
        if self._info.status == JobStatus.FAILED:
            raise JobFailureError(f"job {self.id} failed: {self._info.error}")
        return result

    def cancel(self) -> bool:
        """Request cancellation (cooperative: the work checks the event)."""
        self._cancel.set()
        cancelled = self._future.cancel()
        if cancelled:
            self._info.status = JobStatus.CANCELLED
            self._info.finished_at = time.time()
        return cancelled or self._cancel.is_set()

    def done(self) -> bool:
        return self._future.done()


class JobRegistry:
    """Connection-scoped job tracking (reference connection.rs job APIs)."""

    def __init__(self, max_workers: int = 4):
        self._pool = ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="ldb-job")
        self._jobs: dict[str, Job] = {}
        self._lock = threading.Lock()

    def submit(self, job_type: str, fn: Callable, *args, **kwargs) -> Job:
        info = JobInfo(
            id=_uuid.uuid4().hex[:16],
            job_type=job_type,
            status=JobStatus.PENDING,
            created_at=time.time(),
        )
        cancel_event = threading.Event()

        def run():
            if cancel_event.is_set():
                info.status = JobStatus.CANCELLED
                info.finished_at = time.time()
                return None
            info.status = JobStatus.RUNNING
            try:
                if "cancel_event" in fn.__code__.co_varnames:
                    result = fn(*args, cancel_event=cancel_event, **kwargs)
                else:
                    result = fn(*args, **kwargs)
                info.status = JobStatus.SUCCEEDED
                return result
            except Exception as e:
                info.status = JobStatus.FAILED
                info.error = f"{type(e).__name__}: {e}\n{traceback.format_exc(limit=3)}"
                raise
            finally:
                info.finished_at = time.time()

        future = self._pool.submit(run)
        job = Job(info, future, cancel_event)
        with self._lock:
            self._jobs[info.id] = job
        return job

    def get(self, job_id: str) -> Job | None:
        with self._lock:
            return self._jobs.get(job_id)

    def list(self, include_finished: bool = True) -> list[dict]:
        with self._lock:
            jobs = list(self._jobs.values())
        out = []
        for j in jobs:
            if not include_finished and j.done():
                continue
            out.append(j._info.to_dict())
        return sorted(out, key=lambda d: d["created_at"])

    def cancel(self, job_id: str) -> bool:
        job = self.get(job_id)
        return job.cancel() if job else False

    def history(self) -> list[dict]:
        return [d for d in self.list() if d["status"] in ("SUCCEEDED", "FAILED", "CANCELLED")]
