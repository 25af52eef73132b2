"""Standalone transport worker process + the framed socket protocol
(port of ``repro/transport/worker.py``).

One worker == one OS process standing in for a simulated UAV node (or node
group).  The parent (:class:`~repro_torch.transport.loopback.LoopbackTransport`)
listens on a localhost TCP socket, spawns workers with ``--connect`` pointing
back at it, and ships activation buffers through them — real serialization,
a real kernel-mediated copy, and a real second address space, which is what
the modeled-delay path never exercised.

Protocol (both directions): ``op`` (1 byte) + ``length`` (8 bytes, ``<Q``)
+ payload.

======  =====================================================================
op      meaning
======  =====================================================================
``H``   worker → parent hello on connect: JSON ``{"pid": …, "backend": …,
        "device": …}`` (backend and device name are null in plain mode)
``S``   parent → worker: ship this buffer to the worker's node
``R``   worker → parent: a 16-byte timing header (``<2d``: seconds the
        worker spent draining the payload off the socket, seconds in the
        echo/device hop) followed by the shipped buffer, back from the
        worker's memory
``Q``   parent → worker: shut down (no reply)
======  =====================================================================

The ``R`` timing header is what lets the parent reconstruct *worker-side*
spans (``worker_recv``/``worker_echo`` on the ``transport_worker`` track):
the worker has no shared clock with the parent, so it reports durations and
the parent tail-aligns them against its own receive time.

In ``--torch --device cuda|cpu`` mode (:class:`MultiProcTransport`) the
worker is a torch process: each shipped buffer is landed on the device as a
uint8 tensor, the device is synchronised, and the bytes are copied back
before being echoed, so they cross process *and* device-buffer boundaries.
Its hello names the backend it reached (``"cuda"`` with the card's name, or
``"cpu"``); asked for ``cuda`` where there is no card it exits non-zero
before connecting, and never carries on on the CPU.

The module is started as a script by its path and imports only the standard
library at top level, with no relative import: plain loopback workers must
start in milliseconds, since churn-rejoin spawns them mid-scenario.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import sys
import time

_LEN = struct.Struct("<Q")
# OP_REPLY timing header: (recv_s, echo_s) — durations, not timestamps
# (worker and parent clocks are unrelated; the parent tail-aligns).
REPLY_TIMES = struct.Struct("<2d")

OP_HELLO = b"H"
OP_SHIP = b"S"
OP_REPLY = b"R"
OP_QUIT = b"Q"


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ConnectionError on EOF."""
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("transport peer closed the connection")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def send_frame(sock: socket.socket, op: bytes, payload: bytes = b"") -> None:
    sock.sendall(op + _LEN.pack(len(payload)))
    if payload:
        sock.sendall(payload)


def recv_frame(sock: socket.socket) -> tuple[bytes, bytes]:
    head = recv_exact(sock, 1 + _LEN.size)
    op, (n,) = head[:1], _LEN.unpack(head[1:])
    return op, (recv_exact(sock, n) if n else b"")


def _echo(payload: bytes, device_put) -> bytes:
    """The worker-side hop: host bytes → (optionally a device buffer) → host
    bytes.  Returns the exact same byte string — fidelity is asserted by the
    parent, not assumed."""
    if device_put is None or not payload:
        return payload
    return device_put(payload)


def _torch_device_put(device: str):
    """Build the ``--torch`` echo hop lazily (imports torch); returns the hop
    and the hello's (backend, device name).  Exits non-zero, before any
    hello, when the device cannot be reached."""
    import torch

    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        sys.exit(f"transport worker: unsupported device {device!r} (cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"transport worker: device {device!r} requested but "
                 "torch.cuda.is_available() is False")

    def put(payload: bytes) -> bytes:
        buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        on_dev = buf.to(dev)                       # host → device buffer
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return on_dev.cpu().numpy().tobytes()      # device → host bytes

    if dev.type == "cuda":
        torch.zeros(1, device=dev)                 # the context, before the hello
        torch.cuda.synchronize(dev)
        return put, "cuda", torch.cuda.get_device_name(dev)
    return put, "cpu", "cpu"


def serve(host: str, port: int, *, device: str | None) -> None:
    device_put, backend, name = None, None, None
    if device is not None:
        device_put, backend, name = _torch_device_put(device)
    sock = socket.create_connection((host, port), timeout=60.0)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    hello = json.dumps({"pid": os.getpid(), "backend": backend,
                        "device": name}).encode()
    send_frame(sock, OP_HELLO, hello)
    try:
        while True:
            # Header first, payload timed separately: the blocking wait for
            # the *next* request is idle time and must not be charged to
            # recv_s (only the drain of an announced payload is).
            head = recv_exact(sock, 1 + _LEN.size)
            op, (n,) = head[:1], _LEN.unpack(head[1:])
            if op == OP_SHIP:
                t0 = time.perf_counter()
                payload = recv_exact(sock, n) if n else b""
                t1 = time.perf_counter()
                echoed = _echo(payload, device_put)
                t2 = time.perf_counter()
                send_frame(sock, OP_REPLY,
                           REPLY_TIMES.pack(t1 - t0, t2 - t1) + echoed)
            elif op == OP_QUIT:
                return
            else:
                payload = recv_exact(sock, n) if n else b""
                raise ValueError(f"transport worker: unknown op {op!r}")
    except ConnectionError:
        pass        # parent died or closed; nothing left to serve
    finally:
        sock.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="repro_torch transport worker")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT")
    ap.add_argument("--torch", action="store_true",
                    help="land shipped buffers on --device through torch")
    ap.add_argument("--device", default="cuda",
                    help="with --torch: cuda (exits non-zero without a card) or cpu")
    args = ap.parse_args(argv)
    host, _, port = args.connect.rpartition(":")
    serve(host, int(port), device=args.device if args.torch else None)


if __name__ == "__main__":
    sys.exit(main())
