"""One client in a closed loop: each cloud arrives when the last one's
answers are on the host, so its latency is its own serving time.  The
pool's clouds are served in turn, cycling; the loop stops at the first
cloud that ends ``seconds`` or more after the first began, and the
window is that long.  It reads no parameters of the traffic file.

A loop module's ``serve(step, pool, spec, seconds, done)``:
``step(cloud)`` serves one cloud and returns its outcome;
``done(k, latency_s, outcome, error)`` is called once a cloud (``k`` its
index in the pool) with its outcome, or with ``outcome`` None and the
exception it raised; it returns the window's seconds."""

import time


def serve(step, pool, spec, seconds, done):
    begin = time.perf_counter()
    i = 0
    while True:
        k = i % len(pool)
        i += 1
        arrival = time.perf_counter()
        try:
            outcome = step(pool[k])
        except (RuntimeError, ValueError) as exc:
            done(k, float("inf"), None, exc)
        else:
            done(k, time.perf_counter() - arrival, outcome, None)
        if time.perf_counter() - begin >= seconds:
            return time.perf_counter() - begin
