"""HTTP load, open or closed loop, and when each answer came.

    python3 benchmark/loadgen.py SCHEDULE.json RESULTS.json

Open loop (``SCHEDULE.json``: {"port": int, "path": "/correct",
"requests": [[due seconds, body], ...]}): POST each request at its due
time, whatever the server has not yet answered. ``RESULTS.json``: one
[status, latency seconds from the due time, seconds late at sending, body]
per request, in schedule order; status 0 when no answer came (a refused
connection, a reset, or none within ``deadline`` seconds of the last due
time).

Closed loop (the schedule has "clients" and "seconds": {"port", "path",
"clients": n, "seconds": s, "timeout": t, "requests": [body, ...]}): n
clients, each sending its next request as soon as its previous answer came;
every client takes the next body of the list (from its start again when
the list runs out) and sends nothing new once ``seconds`` have passed.
``RESULTS.json``: {"window_s": seconds from the first send to the last
answer, "results": one [index in the list, status, latency seconds from
sending, seconds from the first send at sending, body] per request sent, in
the order sent}; status 0 when no answer came within ``timeout`` seconds.

Each request opens its own connection (HTTP/1.1, ``Connection: close``)
and reads the answer to its end. Standard library only: the load runs in
its own process, one thread, so it takes nothing from the server's
interpreter.
"""

import asyncio
import json
import sys
import time

START_DELAY = 0.05  # seconds from loading the schedule to the first due time


async def post(port, path, body):
    """(status, payload) of one request; status 0 when no answer came."""
    writer = None
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        data = body.encode("utf-8")
        writer.write((f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                      f"Content-Type: application/json\r\n"
                      f"Content-Length: {len(data)}\r\n"
                      f"Connection: close\r\n\r\n").encode("ascii") + data)
        await writer.drain()
        raw = await reader.read()
        head, _, rest = raw.partition(b"\r\n\r\n")
        return int(head.split(b" ", 2)[1]), rest.decode("utf-8")
    except (OSError, ValueError, IndexError, asyncio.IncompleteReadError):
        return 0, ""
    finally:
        if writer is not None:
            writer.close()


async def one(loop, t0, due, port, path, body, out, i):
    late = loop.time() - (t0 + due)
    status, payload = await post(port, path, body)
    out[i] = [status, loop.time() - (t0 + due), late, payload]


async def open_loop(schedule, deadline):
    loop = asyncio.get_running_loop()
    port, path = schedule["port"], schedule.get("path", "/correct")
    requests = schedule["requests"]
    out = [None] * len(requests)
    t0 = loop.time() + START_DELAY
    tasks = []
    for i, (due, body) in enumerate(requests):
        delay = t0 + due - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.create_task(
            one(loop, t0, due, port, path, body, out, i)))
    last = requests[-1][0] if requests else 0.0
    remaining = t0 + last + deadline - loop.time()
    done, pending = await asyncio.wait(tasks, timeout=max(remaining, 0.0))
    for task in pending:
        task.cancel()
    for task in done:
        task.result()
    for i, (due, _) in enumerate(requests):
        if out[i] is None:
            out[i] = [0, loop.time() - (t0 + due), 0.0, ""]
    return out


async def closed_loop(schedule):
    loop = asyncio.get_running_loop()
    port, path = schedule["port"], schedule.get("path", "/correct")
    bodies, timeout = schedule["requests"], schedule["timeout"]
    out = []
    taken = [0]  # requests handed out; no await between read and write
    t0 = loop.time()
    stop = t0 + schedule["seconds"]

    async def client():
        while loop.time() < stop:
            i = taken[0] % len(bodies)
            taken[0] += 1
            start = loop.time()
            try:
                status, payload = await asyncio.wait_for(
                    post(port, path, bodies[i]), timeout)
            except asyncio.TimeoutError:
                status, payload = 0, ""
            out.append([i, status, loop.time() - start, start - t0, payload])

    clients = [asyncio.create_task(client())
               for _ in range(schedule["clients"])]
    for task in clients:
        await task
    out.sort(key=lambda row: row[3])
    return {"window_s": loop.time() - t0, "results": out}


def main(argv):
    with open(argv[1], encoding="utf-8") as f:
        schedule = json.load(f)
    t = time.time()
    if "clients" in schedule:
        out = asyncio.run(closed_loop(schedule))
        n = len(out["results"])
    else:
        out = asyncio.run(open_loop(schedule, schedule.get("deadline", 60.0)))
        n = len(out)
    with open(argv[2], "w", encoding="utf-8") as f:
        json.dump(out, f)
    print(f"loadgen: {n} requests in {time.time() - t:.3f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
