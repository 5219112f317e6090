"""The processes of a cell over several cards.

The process started becomes rank 0 of ``n``: it starts ranks
1 ... n-1 as child processes of the same entry with the same arguments and
the environment ``torchrun`` gives a rank (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), one
card each. Every rank builds the same cell and runs the same units; rank 0
alone owns the window, and before each unit it tells the others over a
host store of its own (a ``TCPStore``, apart from the program's) whether
to go on or stop, so no rank starts a unit that another skips and no
device work enters the timed unit for it. After the window each child
reports its peak memory and its unit count to rank 0 and exits.

No child outlives rank 0, and a rank that dies ends the run: rank 0 polls
its children and, when one exits with an error, kills the rest and exits
non-zero at once; a child asks the kernel to kill it when rank 0 dies
(``PR_SET_PDEATHSIG``) and gives up when rank 0 is gone before that took
hold; the store's waits time out after ``TIMEOUT_S``, the program's
collectives after the process group's default timeout.
"""
from __future__ import annotations

import ctypes
import datetime
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence, Tuple

TIMEOUT_S = 300          # the store's waits
POLL_S = 0.5             # how often rank 0 looks at its children
EXIT_S = 120             # how long rank 0 waits for its children to exit
STORE_ENV = "BENCH_RANKS_STORE"     # "<port>:<rank 0's pid>", set in the children
DIED = 4                 # rank 0's exit code when a rank died


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when its parent dies; exit now if
    the parent is gone already."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, int(signal.SIGKILL))      # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(DIED)


def _store(port: int, world: int, master: bool):
    import torch.distributed as dist
    return dist.TCPStore("localhost", port, world, is_master=master,
                         timeout=datetime.timedelta(seconds=TIMEOUT_S), wait_for_workers=False)


def is_child() -> bool:
    """Whether this process is a rank that rank 0 started."""
    return STORE_ENV in os.environ


class Ranks:
    """This process's place among the cell's ranks: ``launch`` in rank 0,
    ``join`` in a child."""

    def __init__(self, rank: int, world: int, store, children: Sequence[subprocess.Popen] = ()):
        self.rank, self.world, self.store = rank, world, store
        self.children = list(children)
        self.closing = threading.Event()
        self.aborted = False
        if self.children:
            threading.Thread(target=self._watch, name="bench-ranks", daemon=True).start()

    @classmethod
    def launch(cls, world: int, command: Sequence[str]) -> "Ranks":
        """Rank 0: the store, the launcher's environment, ``world - 1``
        children running ``command`` (their standard output goes to this
        process's standard error, so the result's line stays last)."""
        port, master = _free_port(), _free_port()
        store = _store(port, world, True)
        env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(master), "WORLD_SIZE": str(world),
               "LOCAL_WORLD_SIZE": str(world)}
        os.environ.update(env, RANK="0", LOCAL_RANK="0")
        children = []
        for r in range(1, world):
            children.append(subprocess.Popen(
                list(command), stdout=sys.stderr.fileno(),
                env={**os.environ, **env, "RANK": str(r), "LOCAL_RANK": str(r),
                     STORE_ENV: f"{port}:{os.getpid()}"}))
            print(f"rank {r}: pid {children[-1].pid}", file=sys.stderr, flush=True)
        return cls(0, world, store, children)

    @classmethod
    def join(cls) -> "Ranks":
        """A child: rank 0's store, this rank from the environment."""
        port, parent = (int(v) for v in os.environ[STORE_ENV].split(":"))
        _die_with_parent(parent)
        world = int(os.environ["WORLD_SIZE"])
        return cls(int(os.environ["RANK"]), world, _store(port, world, False))

    def device(self, device):
        """This rank's device: on CUDA card ``LOCAL_RANK`` (modulo the cards,
        as the port's ``setup.resolve_device`` takes it: its own card, or,
        where the caller named the device and the ranks outnumber the cards,
        a shared one)."""
        import torch
        if device.type != "cuda":
            return device
        d = torch.device("cuda", int(os.environ.get("LOCAL_RANK", self.rank)) % torch.cuda.device_count())
        torch.cuda.set_device(d)
        return d

    # ------------------------------------------------------------- the window

    def agree(self, i: int, go: bool) -> bool:
        """Whether every rank runs unit ``i``: rank 0's ``go``, told to the others."""
        if self.rank == 0:
            self.store.set(f"go/{i}", "1" if go else "0")
            return go
        return self.store.get(f"go/{i}") == b"1"

    def report(self, peak: int, units: int) -> None:
        """A child's peak memory and units run, for rank 0."""
        self.store.set(f"done/{self.rank}", json.dumps({"peak": int(peak), "units": int(units)}))

    def gather(self) -> Tuple[List[int], List[int]]:
        """Rank 0: every child's (peak, units) in rank order; nothing after an abort."""
        if self.aborted:
            return [], []
        done = [json.loads(self.store.get(f"done/{r}")) for r in range(1, self.world)]
        return [d["peak"] for d in done], [d["units"] for d in done]

    # ------------------------------------------------------------ lifetime

    def _kill(self) -> None:
        for p in self.children:
            if p.poll() is None:
                p.kill()
        for p in self.children:
            p.wait()

    def _watch(self) -> None:
        while not self.closing.wait(POLL_S):
            for r, p in enumerate(self.children, 1):
                rc = p.poll()
                if rc not in (None, 0) and not self.closing.is_set():
                    print(f"rank {r} exited with {rc}: ending the run", file=sys.stderr, flush=True)
                    self._kill()
                    sys.stderr.flush()
                    os._exit(DIED)

    def abort(self) -> Optional[str]:
        """Rank 0, after a unit failed: the children cannot finish theirs
        alone. Returns which rank had died, if one had (a peer's death fails
        a collective before the poll sees it), or None."""
        self.aborted = True
        self.closing.set()
        deadline = time.monotonic() + 2 * POLL_S
        while any(p.poll() is None for p in self.children) and time.monotonic() < deadline:
            time.sleep(POLL_S / 10)
        died = [f"rank {r}: {p.returncode}" for r, p in enumerate(self.children, 1)
                if p.returncode not in (None, 0)]
        self._kill()
        return "; ".join(died) or None

    def close(self) -> Optional[str]:
        """Rank 0: wait for the children to exit (killing any still there after
        ``EXIT_S``); returns what went wrong, or None. A child: nothing."""
        self.closing.set()
        bad = []
        for r, p in enumerate(self.children, 1):
            try:
                rc = p.wait(timeout=EXIT_S)
            except subprocess.TimeoutExpired:
                rc = "still running, killed"
            if rc != 0 and not self.aborted:
                bad.append(f"rank {r}: {rc}")
        self._kill()
        return "; ".join(bad) or None


def finish(code: int) -> None:
    """End this process with ``code`` after flushing its output, without
    waiting on the program's teardown (a process group with peers gone)."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
