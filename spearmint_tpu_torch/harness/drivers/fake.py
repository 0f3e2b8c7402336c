"""Fake driver for harness tests (SURVEY.md §4 item 4): records submit
calls, never runs anything; liveness is scripted by the test.

Copy of ``spearmint_tpu/harness/drivers/fake.py``."""

from __future__ import annotations


def init():
    return FakeDriver()


class FakeDriver:
    def __init__(self):
        self.submitted = []
        self.alive: set[int] = set()
        self._next = 1000

    def submit_job(self, job) -> int:
        pid = self._next
        self._next += 1
        self.submitted.append((pid, job))
        self.alive.add(pid)
        return pid

    def is_alive(self, proc_id: int) -> bool:
        return proc_id in self.alive

    def kill(self, proc_id: int):
        self.alive.discard(proc_id)
