"""Loopback transport: real activation bytes through real OS processes
(port of ``repro/transport/loopback.py``).

The parent spawns ``n_workers`` worker processes (``transport/worker.py``,
started as a script by its path) and connects each over localhost TCP.
Shipping a tensor from node ``src`` to node ``dst``:

1. synchronise the tensor's device and copy the contiguous tensor's bytes
   to the host (its dtype and shape stay with the parent: bfloat16, which
   numpy lacks, ships as raw bytes like any other dtype),
2. send the bytes to the worker process owning ``dst`` (length-prefixed
   frame: the payload crosses two kernel socket buffers and lives briefly
   in a second address space),
3. receive the echoed bytes back into a writable buffer, view them as a
   tensor of the shipped dtype and shape, and copy it to the device of the
   tensor given — so downstream correctness *depends on* transport fidelity
   rather than being assumed.

The measured wall covers the full hop, the copy back to the device and its
synchronise included (serialize + round trip + reconstruct + device copy);
the reference's wall ends at the numpy reconstruction and its device put
sits outside, in the engine (``repro/exec/engine.py``).  Realized bandwidth
is charged conservatively as ``payload / wall``.  Node → worker ownership
defaults to round-robin and accepts an explicit ``node_of`` map (the
multi-proc backend maps by mobility group).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

from .base import ShipResult, TransportBase, WorkerStats
from .worker import (OP_HELLO, OP_QUIT, OP_REPLY, OP_SHIP, REPLY_TIMES,
                     recv_frame, send_frame)

_POLL_S = 0.1   # how often start() checks that no worker died before its hello


class LoopbackTransport(TransportBase):
    name = "loopback"

    def __init__(self, *, n_workers: int = 2,
                 node_of: dict[int, int] | None = None,
                 timeout_s: float = 120.0):
        super().__init__()
        if n_workers < 1:
            raise ValueError("loopback transport needs at least one worker")
        self.n_workers = int(n_workers)
        self.device: str | None = None    # --torch workers' device (MultiProcTransport)
        self._node_of = dict(node_of) if node_of else None
        self._timeout_s = float(timeout_s)
        self._procs: list[subprocess.Popen] = []
        self._conns: list[socket.socket] = []
        self.worker_pids: list[int] = []
        self.worker_backends: list[str | None] = []
        self.worker_devices: list[str | None] = []
        # Worker-side timing shipped back in every OP_REPLY header,
        # accumulated per worker index (the obs per-worker track's source).
        self.worker_stats: dict[int, WorkerStats] = {}

    # -- lifecycle -----------------------------------------------------------
    @property
    def started(self) -> bool:
        return bool(self._conns)

    def start(self) -> None:
        """Spawn the workers and take each one's hello.  Raises at once if a
        worker exits before its hello (with its exit code), after
        ``timeout_s`` if one never connects, and if a ``--torch`` worker
        reached another backend than ``device``'s."""
        if self.started:
            return
        server = socket.create_server(("127.0.0.1", 0))
        server.settimeout(_POLL_S)
        port = server.getsockname()[1]
        cmd = [sys.executable, str(Path(__file__).with_name("worker.py")),
               "--connect", f"127.0.0.1:{port}"]
        if self.device is not None:
            cmd += ["--torch", "--device", self.device]
        try:
            for _ in range(self.n_workers):
                self._procs.append(subprocess.Popen(cmd, env=dict(os.environ)))
            deadline = time.monotonic() + self._timeout_s
            while len(self._conns) < self.n_workers:
                try:
                    conn, _ = server.accept()
                except TimeoutError:
                    self._check_alive(deadline)
                    continue
                conn.settimeout(self._timeout_s)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                op, payload = recv_frame(conn)
                if op != OP_HELLO:
                    conn.close()
                    raise ConnectionError(f"expected worker hello, got {op!r}")
                hello = json.loads(payload)
                self._conns.append(conn)
                self.worker_pids.append(int(hello["pid"]))
                self.worker_backends.append(hello.get("backend"))
                self.worker_devices.append(hello.get("device"))
            want = self.device and torch.device(self.device).type
            if want and any(b != want for b in self.worker_backends):
                raise RuntimeError(f"transport workers reached {self.worker_backends}, "
                                   f"asked for {want!r}")
        except BaseException:
            for p in self._procs:
                if p.poll() is None:
                    p.kill()
            self.close()
            raise
        finally:
            server.close()

    def _check_alive(self, deadline: float) -> None:
        for p in self._procs:
            rc = p.poll()
            if rc is not None:
                raise RuntimeError(
                    f"transport worker (pid {p.pid}) exited with code {rc} before "
                    f"its hello" + (f" (device {self.device!r})" if self.device else ""))
        if time.monotonic() > deadline:
            raise TimeoutError(f"transport workers did not connect within "
                               f"{self._timeout_s:.0f} s")

    def close(self) -> None:
        for conn in self._conns:
            try:
                send_frame(conn, OP_QUIT)
            except OSError:
                pass
            conn.close()
        self._conns = []
        for p in self._procs:
            try:
                p.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._procs = []

    # -- shipping ------------------------------------------------------------
    def worker_of(self, node: int) -> int:
        if self._node_of is not None and node in self._node_of:
            return self._node_of[node] % self.n_workers
        return node % self.n_workers

    def ship(self, src_node: int, dst_node: int, array: torch.Tensor) -> ShipResult:
        if not self.started:
            self.start()
        worker = self.worker_of(dst_node)
        conn = self._conns[worker]
        t0 = time.perf_counter()
        if array.is_cuda:
            torch.cuda.synchronize(array.device)
        host = array.detach().contiguous().cpu()
        payload = host.reshape(-1).view(torch.uint8).numpy().tobytes()
        send_frame(conn, OP_SHIP, payload)
        op, reply = recv_frame(conn)
        if op != OP_REPLY or len(reply) != len(payload) + REPLY_TIMES.size:
            raise ConnectionError(
                f"transport worker returned {op!r}/{len(reply)}B "
                f"for a {len(payload)}B shipment")
        recv_s, echo_s = REPLY_TIMES.unpack_from(reply)
        # A writable copy: torch would alias (and warn about) a read-only one.
        body = bytearray(memoryview(reply)[REPLY_TIMES.size:])
        flat = (torch.frombuffer(body, dtype=torch.uint8) if body
                else torch.empty(0, dtype=torch.uint8))
        out = flat.view(host.dtype).reshape(host.shape).to(array.device)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        wall = time.perf_counter() - t0
        self._record(src_node, dst_node, len(payload), wall)
        self._record_worker(worker, recv_s, echo_s)
        self.moved_bytes += len(payload)
        return ShipResult(out, len(payload), wall, moved=True)

    def _record_worker(self, worker: int, recv_s: float,
                       echo_s: float) -> None:
        ws = self.worker_stats.setdefault(worker, WorkerStats())
        ws.n += 1
        ws.recv_s += recv_s
        ws.echo_s += echo_s
        if self._tracer.enabled:
            # The worker reports durations only (no shared clock); tail-
            # align against our receive time: the echo ended just before
            # the reply hit our socket, the drain just before the echo.
            tr = self._tracer
            now = tr.now()
            track = tr.track("transport_worker")
            tr.span(track, "worker_recv", now - echo_s - recv_s, recv_s,
                    lane=worker, a0=recv_s)
            tr.span(track, "worker_echo", now - echo_s, echo_s,
                    lane=worker, a0=echo_s)
