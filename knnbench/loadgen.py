"""The open-loop client: a process of its own that posts a mix's requests
on their schedule, whatever the server does.

    python3 -m knnbench.loadgen      (a JSON spec on the first stdin line)

It builds every request body from the seed (``arrivals.py``), opens
``workers`` keep-alive connections, prints ``ready``, and waits for ``go``
on stdin. Then a dispatcher hands each request to a free connection when
it is due; one that finds none waits in the queue. A request is timed from
when it was due to when its response was fully read, so a stall counts in
every request behind it, and no request is dropped however late it is. A
refusal (429 or 503) is sent again after the server's Retry-After, as its
clients do, and its wait counts in the request's time.
Once the last is answered (or has failed, or a minute has passed since the
close) it prints one JSON line: each request's latency (null for a failed
one), status and rows, when the last answer came, how late the dispatcher
handed requests out, and the raw answers of the sampled requests.

A copy of the open loop of ``tools/torch_loadgen.py``, timed from the due
time, with raw samples and no skipped slots. Imports numpy and the
standard library only.
"""

from __future__ import annotations

import base64
import http.client
import json
import math
import queue
import sys
import threading
import time

import numpy as np

from knnbench import arrivals

DRAIN_S = 60.0  # how long past the close the client waits for answers
RETRY_STATUS = (429, 503)
RETRY_MIN_S, RETRY_MAX_S = 0.01, 1.0


def run(spec: dict, go=None, out=None) -> dict:
    """Drive the server as ``spec`` says. ``go()`` blocks until the
    window opens; ``out(line)`` receives ``ready``."""
    mix, seed, dim = spec["mix"], int(spec["seed"]), int(spec["dim"])
    sched = arrivals.schedule(mix, float(spec["seconds"]), seed)
    due, rows = sched["due"], sched["rows"]
    m = len(due)
    bodies = [arrivals.request_queries(mix, seed, i, rows[i], dim).tobytes()
              for i in range(m)]
    sample = set(spec.get("sample", []))
    timeout = float(spec.get("timeout_s", DRAIN_S))
    done_at = np.full(m, np.nan)
    status = np.zeros(m, np.int64)
    retried = np.zeros(m, np.int64)
    deadline = [math.inf]
    answers: dict[int, bytes] = {}
    lock = threading.Lock()
    work: queue.Queue = queue.Queue()
    t0 = [0.0]

    def connect():
        c = http.client.HTTPConnection(spec["host"], int(spec["port"]),
                                       timeout=timeout)
        c.connect()
        return c

    def post(conn, i):
        """(connection, status, payload, headers); status -1 on a
        transport error."""
        try:
            if conn is None:
                conn = connect()
            conn.request("POST", "/knn", body=bodies[i], headers={
                "Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            payload = resp.read()
            return conn, resp.status, payload, resp.headers
        except (OSError, http.client.HTTPException):
            if conn is not None:
                conn.close()
            return None, -1, b"", {}

    def worker(conn):
        while True:
            i = work.get()
            if i is None:
                return
            # a refusal (429, 503) is the server's backpressure: wait as
            # its Retry-After says and send again, as its clients do; the
            # request stays timed from when it was due
            while True:
                conn, code, payload, headers = post(conn, i)
                if code not in RETRY_STATUS or (time.perf_counter()
                                                > deadline[0]):
                    break
                with lock:
                    retried[i] += 1
                try:
                    wait = float(headers.get("Retry-After", RETRY_MIN_S))
                except ValueError:
                    wait = RETRY_MIN_S
                time.sleep(min(max(wait, RETRY_MIN_S), RETRY_MAX_S))
            t = time.perf_counter() - t0[0]
            with lock:
                done_at[i] = t
                status[i] = code
                if i in sample and code == 200:
                    answers[i] = payload

    conns = [connect() for _ in range(int(spec.get("workers", 64)))]
    threads = [threading.Thread(target=worker, args=(c,), daemon=True)
               for c in conns]
    for t in threads:
        t.start()
    if out is not None:
        out("ready")
    if go is not None:
        go()
    t0[0] = time.perf_counter()
    deadline[0] = t0[0] + due[-1] + DRAIN_S
    late = np.zeros(m)
    for i in range(m):
        wait = t0[0] + due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[i] = time.perf_counter() - t0[0] - due[i]
        work.put(i)
    for _ in threads:
        work.put(None)
    for t in threads:
        t.join(max(0.0, deadline[0] + RETRY_MAX_S - time.perf_counter()))
    with lock:
        ok = status == 200
        lat = np.where(ok, (done_at - due) * 1e3, np.nan)
        return {
            "requests": m,
            "latency_ms": [None if np.isnan(v) else float(v) for v in lat],
            "status": status.tolist(),
            "retried": retried.tolist(),
            "rows": rows.tolist(),
            "last_done_s": float(np.nanmax(done_at)) if ok.any() else None,
            "schedule_s": float(due[-1]),
            "dispatch_late_ms_max": float(late.max() * 1e3),
            "answers": {str(i): base64.b64encode(a).decode()
                        for i, a in answers.items()},
        }


def main() -> int:
    spec = json.loads(sys.stdin.readline())

    def out(line):
        sys.stdout.write(line + "\n")
        sys.stdout.flush()

    result = run(spec, go=sys.stdin.readline, out=out)
    out(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
