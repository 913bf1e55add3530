"""Bounded waits for the port's tests. The suite has no per-test time
limit, so a thread, a child process or a spawn of ranks that hangs would
stall the whole run; through these helpers it fails its own test in
bounded time instead, naming what hung."""

import time

import pytest

# a thread of a test (a client, a swap) that posts with its own timeouts
THREAD_S = 120.0
# a child process a test killed or stopped
PROCESS_S = 60.0
# a spawn of gloo CPU ranks: alone they take seconds to a minute, under the
# suite's six workers several times that
SPAWN_S = 900.0


def join_thread(thread, timeout: float = THREAD_S, what: str = None) -> None:
    """``thread.join`` with a bound; fails when it is still alive."""
    thread.join(timeout)
    assert not thread.is_alive(), (
        f"{what or thread.name} still running after {timeout:.0f} s")


def join_threads(threads, timeout: float = THREAD_S, what: str = None
                 ) -> None:
    """Every thread of ``threads`` joined within one shared deadline."""
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    alive = [t.name for t in threads if t.is_alive()]
    assert not alive, (f"{what or 'threads'} {alive} still running after "
                       f"{timeout:.0f} s")


def join_spawn(ctx, timeout: float = SPAWN_S, what: str = "spawned ranks"
               ) -> None:
    """Joins a ``torch.multiprocessing`` context (``join=False``) within
    ``timeout`` seconds. A rank that raised re-raises here, as
    ``ctx.join`` does; ranks still running at the deadline are terminated
    and the test fails naming them."""
    deadline = time.monotonic() + timeout
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            alive = [i for i, p in enumerate(ctx.processes) if p.is_alive()]
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
            pytest.fail(f"{what}: ranks {alive} still running after "
                        f"{timeout:.0f} s; terminated")
        if ctx.join(timeout=min(left, 5.0)):
            return
