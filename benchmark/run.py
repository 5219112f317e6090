"""The benchmark of ``aid_tpu_torch`` on one CUDA card: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the repository's root. Prints the result as one JSON line, last on
standard output, and the numbers ``correct`` was decided on, last on
standard error. Exits non-zero, with no result, without enough CUDA
devices. See ``benchmark/README.md``.
"""
import os
import sys
import time


def _process_start() -> float:
    """The wall-clock time this process started (now, where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


# the process's start on the clock the harness times with
T_START = time.perf_counter() - (time.time() - _process_start())
HERE = os.path.dirname(os.path.abspath(__file__))
# kernel caches at fixed paths inside the checkout, set before triton loads
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

if __name__ == "__main__":
    import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
