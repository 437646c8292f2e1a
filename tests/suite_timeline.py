"""A pytest plugin that records when each test starts and ends, per xdist
worker, to see which file sets the pace of a parallel run.

    SKT_SUITE_TIMELINE=/path/ts.txt python -m pytest tests/ -p tests.suite_timeline ...
    python tests/suite_timeline.py /path/ts.txt

The second command prints, per test file, the worker that ran it and the
seconds from the run's first test to the file's first start and last
end."""

import os
import sys
import time


def _log(event, nodeid):
    path = os.environ.get("SKT_SUITE_TIMELINE")
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    if path and worker:  # the controller repeats every worker's events
        with open(path, "a") as f:
            f.write(f"{time.time():.2f} {worker} {event} {nodeid}\n")


def pytest_runtest_logstart(nodeid, location):
    _log("start", nodeid)


def pytest_runtest_logfinish(nodeid, location):
    _log("end", nodeid)


def main(path):
    rows = [line.split(None, 3) for line in open(path)]
    t0 = min(float(r[0]) for r in rows)
    first, last, worker = {}, {}, {}
    for t, w, _, nodeid in rows:
        name = nodeid.split("::")[0]
        first.setdefault(name, float(t) - t0)
        last[name] = float(t) - t0
        worker[name] = w
    for name in sorted(first, key=first.get):
        print(f"{worker[name]} {first[name]:8.1f} {last[name]:8.1f} {name}")


if __name__ == "__main__":
    main(sys.argv[1])
