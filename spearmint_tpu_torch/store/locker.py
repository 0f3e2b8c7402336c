"""Advisory file locking for the experiment store.

Copy of ``spearmint_tpu/store/locker.py`` (the port imports nothing of the JAX
package).

Parity: reference ``Locker.py`` (SURVEY.md §2 #16) shells out to
procmail's ``lockfile`` binary to serialize access to ``expt-grid.pkl``
between the main loop and N concurrent runner processes.  The rebuild
uses POSIX ``fcntl`` advisory locks — no external binary, crash-safe
(locks die with the process, so a killed runner can never wedge the
experiment), NFSv4-correct.  Same API shape: ``lock_wait`` / ``lock`` /
``unlock`` and a context manager.
"""

from __future__ import annotations

import errno
import fcntl
import os
import time


class Locker:
    def __init__(self, path: str):
        self.path = str(path) + ".lock"
        self._fd = None

    def lock(self) -> bool:
        """Try to acquire without blocking; True on success."""
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            os.close(fd)
            if e.errno in (errno.EACCES, errno.EAGAIN):
                return False
            raise
        self._fd = fd
        return True

    def lock_wait(self, timeout: float | None = None, poll: float = 0.05) -> bool:
        """Block until acquired (reference's retry loop semantics)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.lock():
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(poll)

    def unlock(self) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        self.lock_wait()
        return self

    def __exit__(self, *exc):
        self.unlock()
        return False
