"""Port of ``repro/core/locking.py`` (:43-179): :class:`FileLock`,
cross-process advisory file locking for the replica-shared disk tier of
the plan cache.

Writes to the tier are safe without it (tempfile + atomic rename); the
*maintenance* is not: two replicas running the budget-eviction sweep at
once each list the directory, compute the same overage and delete past the
budget. The cache takes one sidecar ``flock`` to make sweeps single-flight
across replicas and another, shared by scans and exclusive for the delete
pass, for scan consistency.

* **Advisory** — every cooperating process must take it.
* **Not reentrant** — callers hold it for short, non-nested sections; a
  per-instance thread mutex serializes the threads of one process, so the
  per-open-file-description flock state is never shared by two threads.
* **Crash-safe** — flock locks die with the process.

Without ``fcntl`` (Windows) it degrades to the in-process mutex.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

try:  # POSIX; on Windows the lock degrades to in-process only
    import fcntl
except ImportError:  # pragma: no cover - linux CI
    fcntl = None  # type: ignore[assignment]

__all__ = ["FileLock"]


class FileLock:
    """``flock``-based advisory lock with shared/exclusive modes.

    Use as a context manager::

        lock = FileLock(os.path.join(cache_dir, ".lock"))
        with lock.exclusive():          # blocking writer section
            ...
        with lock.shared():             # blocking reader section
            ...
        if lock.acquire(blocking=False):   # try-lock (exclusive)
            try: ...
            finally: lock.release()
    """

    def __init__(self, path: str):
        self.path = path
        self._fd: Optional[int] = None
        self._mutex = threading.Lock()

    # -- low-level ----------------------------------------------------------
    def _open(self) -> Optional[int]:
        if fcntl is None:
            return None
        if self._fd is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            # O_CREAT but never truncate: the file carries no content, only
            # its flock state; it is left behind by design (removing it
            # would race new lockers onto a different inode)
            self._fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
        return self._fd

    def _flock(self, op: int, blocking: bool) -> bool:
        fd = self._open()
        if fd is None:  # no fcntl: thread mutex already held → "acquired"
            return True
        if not blocking:
            op |= fcntl.LOCK_NB
        try:
            fcntl.flock(fd, op)
            return True
        except (BlockingIOError, InterruptedError):
            return False
        except OSError:
            # e.g. flock unsupported on this filesystem (some NFS mounts):
            # degrade to in-process locking rather than fail the cache op
            return True

    # -- public surface ------------------------------------------------------
    def acquire(self, blocking: bool = True, shared: bool = False,
                timeout: Optional[float] = None) -> bool:
        """Take the lock; returns False for a failed non-blocking try or an
        expired ``timeout``.

        ``timeout`` (seconds, with ``blocking=True``) bounds the total
        wait. Unlike a non-blocking retry loop, the thread *queues* on the
        in-process mutex — Python locks wake waiters on release, so a
        steady stream of short holders cannot starve the acquirer the way
        repeated try-locks can. The cross-process flock phase then polls
        under the held mutex (flock itself has no timeout), which also
        stops new same-process holders from barging in while we wait out
        other processes' holds.
        """
        if timeout is not None and blocking:
            deadline = time.monotonic() + timeout
            got_mutex = self._mutex.acquire(True, timeout)
        else:
            deadline = None
            got_mutex = self._mutex.acquire(blocking)
        if not got_mutex:
            return False
        op = (fcntl.LOCK_SH if shared else fcntl.LOCK_EX) if fcntl else 0
        if deadline is None:
            ok = self._flock(op, blocking)
        else:
            while True:
                ok = self._flock(op, False)
                if ok or time.monotonic() >= deadline:
                    break
                time.sleep(0.005)
        if ok:
            return True
        self._mutex.release()
        return False

    def release(self) -> None:
        try:
            if self._fd is not None and fcntl is not None:
                try:
                    fcntl.flock(self._fd, fcntl.LOCK_UN)
                except OSError:
                    # mirror of the acquire-side degrade: on filesystems
                    # where flock is unsupported (some NFS), acquire
                    # succeeded mutex-only, and unlock must not throw out
                    # of the cache's finally blocks
                    pass
        finally:
            self._mutex.release()

    # -- context managers ----------------------------------------------------
    class _Guard:
        def __init__(self, lock: "FileLock", shared: bool):
            self._lock, self._shared = lock, shared

        def __enter__(self):
            self._lock.acquire(blocking=True, shared=self._shared)
            return self._lock

        def __exit__(self, *exc):
            self._lock.release()
            return False

    def exclusive(self) -> "_Guard":
        """Blocking exclusive (writer) guard — one holder across *and*
        within processes."""
        return FileLock._Guard(self, shared=False)

    def shared(self) -> "_Guard":
        """Blocking shared (reader) guard — concurrent with other shared
        holders in other processes, excluded by any exclusive holder.
        (Within one process the thread mutex still serializes holders;
        scans are short and this keeps the fd's flock state single-owner.)
        """
        return FileLock._Guard(self, shared=True)

    def __getstate__(self):
        # fds and mutexes don't pickle; a lock travelling to another
        # process (e.g. a cache shipped through multiprocessing) re-opens
        # its own fd on first use — same path, same flock namespace
        return {"path": self.path}

    def __setstate__(self, state):
        self.path = state["path"]
        self._fd = None
        self._mutex = threading.Lock()
