"""Open-loop HTTP load: POST each request at its due time, whatever the
server has not yet answered, and record when each answer came.

    python3 benchmark/loadgen.py SCHEDULE.json RESULTS.json

``SCHEDULE.json``: {"port": int, "path": "/correct", "requests": [[due
seconds, body], ...]}. Each request opens its own connection (HTTP/1.1,
``Connection: close``) and reads the answer to its end. ``RESULTS.json``:
one [status, latency seconds from the due time, seconds late at sending,
body] per request, in schedule order; status 0 when no answer came (a
refused connection, a reset, or none within ``deadline`` seconds of the
last due time). Standard library only: the load runs in its own process,
one thread, so it takes nothing from the server's interpreter.
"""

import asyncio
import json
import sys
import time

START_DELAY = 0.05  # seconds from loading the schedule to the first due time


async def one(loop, t0, due, port, path, body, out, i):
    late = loop.time() - (t0 + due)
    status, payload = 0, ""
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
        status = int(head.split(b" ", 2)[1])
        payload = rest.decode("utf-8")
    except (OSError, ValueError, IndexError, asyncio.IncompleteReadError):
        status = 0
    finally:
        if writer is not None:
            writer.close()
    out[i] = [status, loop.time() - (t0 + due), late, payload]


async def main_async(schedule, deadline):
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


def main(argv):
    with open(argv[1], encoding="utf-8") as f:
        schedule = json.load(f)
    t = time.time()
    out = asyncio.run(main_async(schedule, schedule.get("deadline", 60.0)))
    with open(argv[2], "w", encoding="utf-8") as f:
        json.dump(out, f)
    print(f"loadgen: {len(out)} requests in {time.time() - t:.3f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
