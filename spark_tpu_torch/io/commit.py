"""File-output commit protocol with exactly-one-commit arbitration (the
port's copy of `spark_tpu/io/commit.py`).

Role of the reference's OutputCommitCoordinator
(core/scheduler/OutputCommitCoordinator.scala — the application-side arbiter
that lets exactly one attempt of each task commit) combined with the
HadoopMapReduceCommitProtocol file choreography
(core/internal/io/HadoopMapReduceCommitProtocol.scala): task attempts
write under `<path>/_temporary/<job_id>/<task>-<attempt>/`, ask the
coordinator for permission, and only the granted attempt's files are
renamed into the final layout at job commit; everything else is swept.

The arbitration must hold under concurrent ATTEMPTS — speculative
execution launches two attempts of one task and both may race
canCommit; rename(2) is atomic on one host, and in the multi-host
deployment the coordinator lives in the application's coordinating
process, where all control RPC already lands, exactly the reference's
arrangement.
"""

from __future__ import annotations

import os
import shutil
import threading
import uuid


class CommitDeniedError(RuntimeError):
    """This attempt lost the commit race (reference:
    TaskCommitDenied → task retries are NOT counted as failures)."""


class OutputCommitCoordinator:
    """task_id → winning attempt_id; first canCommit wins, later
    attempts of the same task are denied (OutputCommitCoordinator.scala
    handleAskPermissionToCommit)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._winners: dict[int, str] = {}

    def can_commit(self, task_id: int, attempt_id: str) -> bool:
        with self._lock:
            winner = self._winners.setdefault(task_id, attempt_id)
            return winner == attempt_id

    def winner(self, task_id: int) -> str | None:
        with self._lock:
            return self._winners.get(task_id)


class FileCommitProtocol:
    """Job-scoped two-phase file commit over a directory output."""

    def __init__(self, path: str,
                 coordinator: OutputCommitCoordinator | None = None):
        self.path = path
        self.job_id = uuid.uuid4().hex[:12]
        self.coordinator = coordinator or OutputCommitCoordinator()
        self._staging = os.path.join(path, "_temporary", self.job_id)

    # -- task side ------------------------------------------------------
    def new_task_attempt(self, task_id: int) -> "TaskAttempt":
        return TaskAttempt(self, task_id, uuid.uuid4().hex[:8])

    # -- job side -------------------------------------------------------
    def setup_job(self) -> None:
        os.makedirs(self._staging, exist_ok=True)

    def commit_job(self) -> None:
        """Move every committed attempt's files into the final layout
        (atomic per-file rename), drop staging, stamp _SUCCESS."""
        committed = os.path.join(self._staging, "_committed")
        if os.path.isdir(committed):
            for task_dir in sorted(os.listdir(committed)):
                src_root = os.path.join(committed, task_dir)
                for root, _dirs, files in os.walk(src_root):
                    rel = os.path.relpath(root, src_root)
                    dst_dir = self.path if rel == "." else \
                        os.path.join(self.path, rel)
                    os.makedirs(dst_dir, exist_ok=True)
                    for f in files:
                        os.replace(os.path.join(root, f),
                                   os.path.join(dst_dir, f))
        shutil.rmtree(os.path.join(self.path, "_temporary"),
                      ignore_errors=True)
        with open(os.path.join(self.path, "_SUCCESS"), "w"):
            pass

    def abort_job(self) -> None:
        shutil.rmtree(os.path.join(self.path, "_temporary"),
                      ignore_errors=True)


class TaskAttempt:
    """One attempt's staging dir + the commit handshake."""

    def __init__(self, protocol: FileCommitProtocol, task_id: int,
                 attempt_id: str):
        self.protocol = protocol
        self.task_id = task_id
        self.attempt_id = attempt_id
        self.dir = os.path.join(protocol._staging,
                                f"task-{task_id}-attempt-{attempt_id}")
        os.makedirs(self.dir, exist_ok=True)

    def path_for(self, *rel: str) -> str:
        """Final-layout-relative path inside this attempt's staging dir
        (partition subdirs included)."""
        p = os.path.join(self.dir, *rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    def commit(self) -> None:
        """Ask the coordinator; the winning attempt's dir moves (one
        atomic rename) under _committed/, losers raise CommitDenied and
        sweep themselves."""
        if not self.protocol.coordinator.can_commit(self.task_id,
                                                    self.attempt_id):
            self.abort()
            raise CommitDeniedError(
                f"task {self.task_id}: attempt {self.attempt_id} lost to "
                f"{self.protocol.coordinator.winner(self.task_id)}")
        dst = os.path.join(self.protocol._staging, "_committed",
                           f"task-{self.task_id}")
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.replace(self.dir, dst)

    def abort(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
