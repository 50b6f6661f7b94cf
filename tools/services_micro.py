#!/usr/bin/env python3
"""Host-side costs behind chip_smoke.py's services_path, on the machine that
runs it (the card's host, or any other):

- ``http``: a thread's start and join, a loopback TCP connect and close, an
  HTTP/1.0 round trip (a connection a call), an HTTP/1.1 round trip over one
  kept connection, and a call of the port's ``HttpRPCClient``, in ms;
- ``pool``: BASELINE.json config #1 (10^6 rows, 1,000 groups, pandas in and
  out) through ``api.transform`` with ``fugue.tpu.map.parallelism`` 1, 2, 4
  and 8, in turns, medians of 3 in ms, and the 8-worker pool's
  ``map.worker_chunk`` and ``map.parallel`` span times;
- ``kill N``: N maps of config #1 with ``map.chunk=kill`` and 8 workers,
  each with its ms and lost workers; a map stuck for 25 s prints the
  driver's children and their states, and exits 3.

Run from the repository root: ``python3 tools/services_micro.py http pool``
or ``python3 tools/services_micro.py kill 6``. With a CUDA card, the driver
initializes CUDA before it maps, as the engine on the card does.
"""

import http.client
import os
import socket
import statistics
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _per_call_ms(fn, n: int = 300) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def http_costs() -> dict:
    from fugue_tpu_torch.rpc import RPCFunc
    from fugue_tpu_torch.rpc.http import HttpRPCServer

    out = {}

    def spawn() -> None:
        t = threading.Thread(target=lambda: None)
        t.start()
        t.join()

    out["thread_spawn_join_ms"] = _per_call_ms(spawn)
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(128)
    port = listener.getsockname()[1]

    def accept() -> None:
        while True:
            conn, _ = listener.accept()
            conn.close()

    threading.Thread(target=accept, daemon=True).start()
    out["tcp_connect_close_ms"] = _per_call_ms(
        lambda: socket.create_connection(("127.0.0.1", port)).close())

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.0"

        def do_POST(self) -> None:  # noqa: N802
            self.rfile.read(int(self.headers.get("Content-Length", "0")))
            body = b"x" * 40
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args) -> None:
            pass

    class KeptHandler(Handler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

    for name, cls, keep in (("http10_round_trip_ms", Handler, False), ("http11_kept_round_trip_ms", KeptHandler, True)):
        srv = ThreadingHTTPServer(("127.0.0.1", 0), cls)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        state = {}

        def call() -> None:
            conn = state.get("conn") if keep else None
            if conn is None:
                conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=5)
                conn.connect()
                conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                state["conn"] = conn
            conn.request("POST", "/invoke", body=b"y" * 100, headers={"Content-Length": "100"})
            conn.getresponse().read()
            if not keep:
                conn.close()

        out[name] = _per_call_ms(call)
        if keep:
            state["conn"].close()
        srv.shutdown()
        srv.server_close()
    server = HttpRPCServer()
    with server.start():
        client = server.make_client(RPCFunc(lambda n: None))
        out["port_client_call_ms"] = _per_call_ms(lambda: client(5))
    return out


def _config1(device):
    import numpy as np
    import pandas as pd

    import chip_smoke
    from fugue_tpu_torch import api

    demean = chip_smoke.host_udfs(pd)["demean"]
    pdf = chip_smoke.udf_frame(np, pd)

    def run(engine) -> float:
        t0 = time.perf_counter()
        api.transform(pdf, demean, schema="*", partition={"by": ["k"]}, engine=engine)
        return (time.perf_counter() - t0) * 1e3

    return run


def _device():
    import torch

    if torch.cuda.is_available():
        torch.ones(1, device="cuda").sum().item()
        return torch.device("cuda", 0)
    return torch.device("cpu")


def pool_costs() -> dict:
    from fugue_tpu_torch.obs import get_tracer
    from fugue_tpu_torch.torch import TorchExecutionEngine

    device = _device()
    run = _config1(device)
    engines = {w: TorchExecutionEngine(device=device, conf={"fugue.tpu.map.parallelism": w}) for w in (1, 2, 4, 8)}
    ms = {w: [] for w in engines}
    for _ in range(3):
        for w, engine in engines.items():
            ms[w].append(run(engine))
    tracer = get_tracer()
    tracer.clear()
    tracer.enable()
    run(engines[8])
    tracer.disable()
    recs = tracer.records()
    tracer.clear()
    return {"ms": {w: statistics.median(v) for w, v in ms.items()}, "ms_all": ms,
            "worker_chunk_ms": sorted(r["dur"] / 1e6 for r in recs if r["name"] == "map.worker_chunk"),
            "map_parallel_ms": [r["dur"] / 1e6 for r in recs if r["name"] == "map.parallel"]}


def _children() -> dict:
    me, out = os.getpid(), {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            fields = stat.rsplit(")", 1)[1].split()
            if int(fields[1]) == me:
                out[int(entry)] = fields[0]
    return out


def kill_runs(n: int) -> list:
    from fugue_tpu_torch.torch import TorchExecutionEngine

    device = _device()
    run = _config1(device)
    out = []
    for _ in range(n):
        done = threading.Event()

        def watchdog() -> None:
            if not done.wait(25):
                print("STUCK", _children(), flush=True)
                os._exit(3)

        threading.Thread(target=watchdog, daemon=True).start()
        engine = TorchExecutionEngine(device=device, conf={
            "fugue.tpu.map.parallelism": 8, "fugue.tpu.fault.plan": "map.chunk=kill", "fugue.tpu.retry.base": 0.01})
        ms = run(engine)
        done.set()
        out.append({"ms": ms, "worker_lost": engine.resilience_stats.as_dict().get("map.worker_lost", 0)})
    return out


def main() -> int:
    args = sys.argv[1:] or ["http", "pool"]
    if "http" in args:
        print("http", http_costs(), flush=True)
    if "pool" in args:
        print("pool", pool_costs(), flush=True)
    if "kill" in args:
        n = int(args[args.index("kill") + 1]) if len(args) > args.index("kill") + 1 else 3
        print("kill", kill_runs(n), flush=True)
    print("cpu_count", os.cpu_count())
    return 0


if __name__ == "__main__":
    sys.exit(main())
