"""The serving fleet's RPC plane — the counterpart of
:mod:`horovod_tpu.serve.rpc`, wire-compatible with it byte for byte.

A length-prefixed, versioned framing over the native vectored transport
(``hvd_tcp_sendv``/``hvd_tcp_recvv`` on the port's own build of the
core), a struct-packed value codec (tagged scalars and containers inline
in the frame; tensors as raw spans after it, so KV pages ride one
``SendV`` span list and land through one ``RecvV`` in their destination
buffers), and the client tier the router consumes: :class:`RpcConn`,
:class:`RemoteReplica` (the engine seam over a connection) and
:func:`spawn_worker` (launch and connect a
``horovod_tpu_torch.serve.worker`` process).

Wire layout of one message::

    [u64 frame_len][frame: u32 magic | u16 version | u16 n_spans |
                    u64 trace_id | packed body]
    [span 0 bytes]...[span n-1 bytes]

``trace_id`` carries the request's distributed-tracing id (0 = none):
the router stamps the frame that places a request, the worker reads it
off the header (:attr:`RpcConn.last_trace_id`).

Every tensor in the body — a torch tensor or a numpy array — is replaced
by a descriptor ``(codec, dtype id, shape, wire_bytes)`` and its bytes
ship as span ``i`` in tree order. A tensor on the card is staged through
host memory first. bf16 travels as raw 2-byte words under dtype id 10,
the native core's, with no numpy bfloat16 needed on either side.
Received spans are CPU torch tensors (``torch.from_numpy`` views where
numpy has the dtype), allocated before the ``RecvV`` that fills them.

**KV-page compression.** A float32 span of at least
:data:`SPAN_CODEC_MIN_ELEMS` elements may ship under the native cast
codecs (``bf16``/``fp16``) through ``hvd_wire_encode``/
``hvd_wire_decode``; the codec rides the descriptor, so the receiver
needs no configuration. ``int8`` is refused: its error feedback has no
meaning for a one-shot page move.

:data:`RPC_PROTOCOL_VERSION` is checked on every frame before the body
is parsed; a mismatch raises :class:`RpcProtocolError`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import select
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from horovod_tpu_torch.common.basics import dtype_id, get_lib, torch_dtype

#: RPC protocol version, checked on every frame (the reference's): bump
#: on any change to the frame header, the value tags or the span
#: descriptor. v2 added the u64 ``trace_id`` after ``n_spans``.
RPC_PROTOCOL_VERSION = 2

#: Frame magic ("HRPC", little-endian).
RPC_MAGIC = 0x43505248

#: Cap on one frame's byte length (the body only; spans ride outside
#: it): a corrupt length prefix fails here instead of allocating.
MAX_FRAME_BYTES = 64 << 20

#: Below this element count a float32 span ships raw even under a codec.
SPAN_CODEC_MIN_ELEMS = 256

# Native WireCodec ids a span may use (native/include/hvd/codec.h).
_SPAN_CODECS = {"none": 0, "bf16": 1, "fp16": 2}

# The native bf16 dtype id (native/include/hvd/common.h).
_BFLOAT16_ID = 10


class RpcError(RuntimeError):
    """Base class for RPC-plane failures."""


class RpcConnectionError(RpcError):
    """The peer is gone (EOF, reset, timeout): the router's dead-worker
    signal. A call that raises it leaves the connection unusable."""


class RpcProtocolError(RpcError):
    """The peer speaks another protocol (bad magic, version skew, a
    corrupt body): raised before anything of the body is used."""


class RpcRemoteError(RpcError):
    """A remote handler raised an exception type this side does not
    rebuild; carries the remote type name and message."""

    def __init__(self, exc_type: str, msg: str,
                 fields: Optional[Dict[str, Any]] = None):
        super().__init__(f"{exc_type}: {msg}")
        self.exc_type = exc_type
        self.fields = fields or {}


def span_codec_id(name) -> int:
    """The native span codec id of a KV-handoff compression spelling
    (None, ``"bf16"``, ``"fp16"`` or a ``Compression`` member)."""
    if name is None:
        return 0
    wire = getattr(name, "wire_codec", None)
    if wire is not None:          # a Compression member
        name = {0: "none", 1: "bf16", 2: "fp16", 3: "int8"}.get(int(wire))
    try:
        return _SPAN_CODECS[str(name)]
    except KeyError:
        raise ValueError(
            f"unsupported KV handoff compression {name!r}; want one of "
            f"{sorted(_SPAN_CODECS)} (int8 needs error-feedback state "
            "that one-shot page migration has nowhere to keep)") from None


# ---------------------------------------------------------------------------
# Value codec: tagged, struct-packed.
# ---------------------------------------------------------------------------

_T_NONE, _T_TRUE, _T_FALSE, _T_INT, _T_FLOAT = 0, 1, 2, 3, 4
_T_BYTES, _T_STR, _T_LIST, _T_DICT, _T_ARRAY = 5, 6, 7, 8, 9
_T_U64 = 10  # ints in [2**63, 2**64): 64-bit ids (FNV-1a trace ids)


def _nbytes(buf) -> int:
    if isinstance(buf, torch.Tensor):
        return buf.numel() * buf.element_size()
    return buf.nbytes


def _host_span(obj) -> Tuple[Any, int, Tuple[int, ...]]:
    """``(contiguous host buffer, native dtype id, shape)`` of a tensor
    or numpy array: a card tensor is copied to host memory, a numpy
    bfloat16 (ml_dtypes) rides as its raw words."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        return t.contiguous(), dtype_id(t.dtype), tuple(t.shape)
    a = np.asarray(obj)
    if not a.flags["C_CONTIGUOUS"]:
        # NOT ascontiguousarray: it promotes 0-d to 1-d.
        a = np.ascontiguousarray(a).reshape(a.shape)
    did = (_BFLOAT16_ID if a.dtype.name == "bfloat16"
           else dtype_id(a.dtype))
    return a, did, tuple(a.shape)


def _data_ptr(buf) -> int:
    if isinstance(buf, torch.Tensor):
        return buf.data_ptr()
    return buf.ctypes.data


class _ArrayStub:
    """Placeholder for a tensor span while its bytes are in flight."""

    __slots__ = ("codec", "dtype_id", "shape", "wire_bytes", "buf", "arr")

    def __init__(self, codec, did, shape, wire_bytes):
        self.codec = codec
        self.dtype_id = did
        self.shape = shape
        self.wire_bytes = wire_bytes
        if codec:
            # Check the declared size against what the codec needs for
            # this shape before the native decode reads it.
            elems = int(np.prod(shape, dtype=np.int64)) if shape else 1
            want = int(get_lib().hvd_wire_encoded_bytes(codec, elems))
            if wire_bytes != want:
                raise RpcProtocolError(
                    f"codec-{codec} span declares {wire_bytes} wire "
                    f"bytes but shape {shape} needs {want}")
            self.buf = np.empty(wire_bytes, np.uint8)
            self.arr = None
        else:
            try:
                dt = torch_dtype(did)
            except TypeError as e:
                raise RpcProtocolError(str(e)) from None
            # The raw payload lands directly in the destination tensor.
            self.arr = torch.empty(shape, dtype=dt)
            self.buf = self.arr
            if _nbytes(self.arr) != wire_bytes:
                raise RpcProtocolError(
                    f"span byte count {wire_bytes} != {_nbytes(self.arr)} "
                    f"for shape {shape} dtype {dt}")

    def resolve(self, lib) -> torch.Tensor:
        if self.codec:
            out = torch.empty(self.shape, dtype=torch.float32)
            lib.hvd_wire_decode(self.codec,
                                ctypes.c_void_p(self.buf.ctypes.data),
                                out.numel(), ctypes.c_void_p(out.data_ptr()))
            self.arr = out
        return self.arr


def _pack_value(obj, out: List[bytes], spans: List[Tuple[Any, int]],
                codec: int) -> None:
    if obj is None:
        out.append(struct.pack("<B", _T_NONE))
    elif obj is True:
        out.append(struct.pack("<B", _T_TRUE))
    elif obj is False:
        out.append(struct.pack("<B", _T_FALSE))
    elif isinstance(obj, (int, np.integer)):
        v = int(obj)
        if -(1 << 63) <= v < (1 << 63):
            out.append(struct.pack("<Bq", _T_INT, v))
        elif (1 << 63) <= v < (1 << 64):
            out.append(struct.pack("<BQ", _T_U64, v))
        else:
            raise TypeError(
                f"rpc value codec cannot marshal {v}: wider than 64 bits")
    elif isinstance(obj, (float, np.floating)):
        out.append(struct.pack("<Bd", _T_FLOAT, float(obj)))
    elif isinstance(obj, bytes):
        out.append(struct.pack("<BI", _T_BYTES, len(obj)))
        out.append(obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(struct.pack("<BI", _T_STR, len(b)))
        out.append(b)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_array(obj, out, spans, codec)
    elif isinstance(obj, (list, tuple)):
        out.append(struct.pack("<BI", _T_LIST, len(obj)))
        for v in obj:
            _pack_value(v, out, spans, codec)
    elif isinstance(obj, dict):
        out.append(struct.pack("<BI", _T_DICT, len(obj)))
        for k, v in obj.items():
            _pack_value(k, out, spans, codec)
            _pack_value(v, out, spans, codec)
    else:
        raise TypeError(
            f"rpc value codec cannot marshal {type(obj).__name__}; use "
            "scalars, bytes, str, lists, dicts, tensors or numpy arrays")


def _pack_array(obj, out: List[bytes], spans: List[Tuple[Any, int]],
                codec: int) -> None:
    a, did, shape = _host_span(obj)
    n_elem = int(np.prod(shape, dtype=np.int64)) if shape else 1
    raw = _nbytes(a)
    if codec != 0 and did == 7 and n_elem >= SPAN_CODEC_MIN_ELEMS:
        lib = get_lib()
        payload = np.empty(int(lib.hvd_wire_encoded_bytes(codec, n_elem)),
                           np.uint8)
        lib.hvd_wire_encode(codec, ctypes.c_void_p(_data_ptr(a)), n_elem,
                            ctypes.c_void_p(payload.ctypes.data), None)
        cid = codec
    else:
        payload, cid = a, 0
    out.append(struct.pack("<BBB", _T_ARRAY, cid, did))
    out.append(struct.pack("<B", len(shape)))
    out.append(struct.pack(f"<{len(shape)}q", *shape))
    out.append(struct.pack("<Q", _nbytes(payload)))
    spans.append((payload, raw))


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, fmt):
        vals = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return vals

    def take_bytes(self, n):
        b = bytes(self.buf[self.pos:self.pos + n])
        if len(b) != n:
            raise RpcProtocolError("truncated frame body")
        self.pos += n
        return b


def _unpack_value(r: _Reader, stubs: List[_ArrayStub]):
    (tag,) = r.take("<B")
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return r.take("<q")[0]
    if tag == _T_U64:
        return r.take("<Q")[0]
    if tag == _T_FLOAT:
        return r.take("<d")[0]
    if tag == _T_BYTES:
        return r.take_bytes(r.take("<I")[0])
    if tag == _T_STR:
        return r.take_bytes(r.take("<I")[0]).decode("utf-8")
    if tag == _T_LIST:
        (n,) = r.take("<I")
        return [_unpack_value(r, stubs) for _ in range(n)]
    if tag == _T_DICT:
        (n,) = r.take("<I")
        out = {}
        for _ in range(n):
            k = _unpack_value(r, stubs)
            out[k] = _unpack_value(r, stubs)
        return out
    if tag == _T_ARRAY:
        cid, did = r.take("<BB")
        (ndim,) = r.take("<B")
        shape = r.take(f"<{ndim}q") if ndim else ()
        (wire_bytes,) = r.take("<Q")
        stub = _ArrayStub(cid, did, tuple(shape), wire_bytes)
        stubs.append(stub)
        return stub
    raise RpcProtocolError(f"unknown value tag {tag}")


def _resolve_stubs(obj, lib):
    if isinstance(obj, _ArrayStub):
        return obj.resolve(lib)
    if isinstance(obj, list):
        return [_resolve_stubs(v, lib) for v in obj]
    if isinstance(obj, dict):
        return {k: _resolve_stubs(v, lib) for k, v in obj.items()}
    return obj


def encode_message(obj, trace_id: int = 0, codec: int = 0
                   ) -> Tuple[bytes, List[Any]]:
    """``(length prefix + frame, [span buffers])`` of one message: the
    bytes :meth:`RpcConn.send` puts on the wire, in order."""
    body: List[bytes] = []
    spans: List[Tuple[Any, int]] = []
    _pack_value(obj, body, spans, codec)
    frame = struct.pack(
        "<IHHQ", RPC_MAGIC, RPC_PROTOCOL_VERSION, len(spans),
        trace_id & 0xFFFFFFFFFFFFFFFF) + b"".join(body)
    return struct.pack("<Q", len(frame)) + frame, spans


# ---------------------------------------------------------------------------
# Connection
# ---------------------------------------------------------------------------

def _as_iovec(chunks):
    n = len(chunks)
    bufs = (ctypes.c_void_p * n)()
    lens = (ctypes.c_uint64 * n)()
    for i, c in enumerate(chunks):
        if isinstance(c, (np.ndarray, torch.Tensor)):
            bufs[i] = ctypes.c_void_p(_data_ptr(c))
            lens[i] = _nbytes(c)
        else:
            bufs[i] = ctypes.cast(ctypes.c_char_p(c), ctypes.c_void_p)
            lens[i] = len(c)
    # The caller holds ``chunks`` across the syscall.
    return bufs, lens, n


class RpcConn:
    """One blocking request/response channel over a connected socket,
    through the native vectored transport. One caller at a time.

    ``timeout`` (seconds) goes on the raw fd as ``SO_RCVTIMEO``/
    ``SO_SNDTIMEO``: a wedged peer then fails the native ``recvmsg``
    loop, which surfaces as :class:`RpcConnectionError`."""

    def __init__(self, sock, timeout: Optional[float] = None, codec=None):
        self.sock = sock
        self.fd = sock.fileno()
        self.codec = span_codec_id(codec)
        self.alive = True
        # Byte accounting (the bench's RPC-tax and bytes-saved keys).
        self.msgs_sent = 0
        self.msgs_received = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self.span_raw_bytes = 0    # pre-codec payload bytes, both ways
        self.span_wire_bytes = 0   # on-the-wire span bytes, both ways
        # Tracing context: ``trace_id`` is stamped on the next outgoing
        # frame and consumed; ``last_trace_id`` is the last received
        # frame's stamp (0 = none).
        self.trace_id = 0
        self.last_trace_id = 0
        if timeout is not None:
            self.set_timeout(timeout)

    def set_timeout(self, timeout: Optional[float]) -> None:
        """(Re)apply SO_RCVTIMEO/SO_SNDTIMEO on the raw fd, which the
        native blocking syscalls honour. None/0 = block forever."""
        timeout = timeout or 0.0
        tv = struct.pack("<qq", int(timeout), int((timeout % 1.0) * 1e6))
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)

    # -- framing -----------------------------------------------------

    def send(self, obj) -> None:
        if not self.alive:
            raise RpcConnectionError("connection already closed")
        trace_id, self.trace_id = self.trace_id, 0
        head, spans = encode_message(obj, trace_id, self.codec)
        chunks = [head] + [p for p, _ in spans]
        bufs, lens, n = _as_iovec(chunks)
        ok = get_lib().hvd_tcp_sendv(self.fd, bufs, lens, n)
        del chunks
        if ok != 1:
            self._dead("send failed (peer gone?)")
        wire = sum(_nbytes(p) for p, _ in spans)
        self.msgs_sent += 1
        self.bytes_sent += len(head) + wire
        self.span_wire_bytes += wire
        self.span_raw_bytes += sum(raw for _, raw in spans)

    def _recvv(self, chunks) -> None:
        bufs, lens, n = _as_iovec(chunks)
        ok = get_lib().hvd_tcp_recvv(self.fd, bufs, lens, n)
        if ok != 1:
            self._dead("recv failed (peer gone?)")

    def recv(self):
        if not self.alive:
            raise RpcConnectionError("connection already closed")
        hdr = np.empty(8, np.uint8)
        self._recvv([hdr])
        (flen,) = struct.unpack("<Q", hdr.tobytes())
        if not 8 <= flen <= MAX_FRAME_BYTES:
            self._dead(f"insane frame length {flen}")
        frame = np.empty(flen, np.uint8)
        self._recvv([frame])
        r = _Reader(frame.tobytes())
        magic, version, n_spans = r.take("<IHH")
        if magic != RPC_MAGIC:
            self.close()
            raise RpcProtocolError(
                f"bad frame magic {magic:#x} (expected {RPC_MAGIC:#x})")
        if version != RPC_PROTOCOL_VERSION:
            # Checked before the v2 trace_id is parsed: a v1 header
            # ends here.
            self.close()
            raise RpcProtocolError(
                f"peer speaks rpc protocol v{version}, this side "
                f"v{RPC_PROTOCOL_VERSION} — upgrade in lockstep")
        stubs: List[_ArrayStub] = []
        try:
            (self.last_trace_id,) = r.take("<Q")
            obj = _unpack_value(r, stubs)
        except struct.error as e:
            self.close()
            raise RpcProtocolError(f"corrupt frame body: {e}") from None
        except RpcProtocolError:
            # The declared span bytes were never drained: the stream is
            # out of step, so close rather than parse payload as a
            # length prefix.
            self.close()
            raise
        if len(stubs) != n_spans:
            self.close()
            raise RpcProtocolError(
                f"frame declares {n_spans} spans, body references "
                f"{len(stubs)}")
        if stubs:
            self._recvv([s.buf for s in stubs])
        obj = _resolve_stubs(obj, get_lib())
        self.msgs_received += 1
        self.bytes_received += 8 + flen + sum(s.wire_bytes for s in stubs)
        for s in stubs:
            self.span_wire_bytes += s.wire_bytes
            self.span_raw_bytes += _nbytes(s.arr)
        return obj

    def _dead(self, why: str):
        self.close()
        raise RpcConnectionError(why)

    def close(self) -> None:
        if self.alive:
            self.alive = False
            try:
                self.sock.close()
            except OSError:
                pass

    # -- request/response --------------------------------------------

    def call_begin(self, method: str, *args, **kwargs) -> None:
        """Write one request frame without waiting for the reply (the
        router's step fan-out). Pair it with exactly one
        :meth:`call_finish` before any other call on this connection."""
        self.send({"t": "call", "m": method, "a": list(args), "k": kwargs})

    def call_finish(self):
        """Collect the reply of a :meth:`call_begin`. Remote exceptions
        of the known types re-raise as themselves; others raise
        :class:`RpcRemoteError`."""
        reply = self.recv()
        t = reply.get("t")
        if t == "ret":
            return reply.get("v")
        if t == "err":
            raise _rebuild_exception(reply)
        self.close()
        raise RpcProtocolError(f"unexpected reply type {t!r}")

    def call(self, method: str, *args, **kwargs):
        """One blocking RPC: ``call_begin`` + ``call_finish``."""
        self.call_begin(method, *args, **kwargs)
        return self.call_finish()


def _exception_to_wire(e: BaseException) -> Dict[str, Any]:
    fields = {}
    for f in ("reason", "queue_depth", "retry_after_s", "deadline_class",
              "http_status"):
        v = getattr(e, f, None)
        if (isinstance(v, (int, float, str)) or v is None) and hasattr(e, f):
            fields[f] = v
    return {"t": "err", "e": type(e).__name__, "msg": str(e), "f": fields}


def _rebuild_exception(reply: Dict[str, Any]) -> BaseException:
    name = reply.get("e", "RuntimeError")
    msg = reply.get("msg", "")
    fields = reply.get("f") or {}
    if name == "ValueError":
        return ValueError(msg)
    if name == "KeyError":
        return KeyError(msg)
    if name == "TypeError":
        return TypeError(msg)
    if name in ("QueueFull", "FleetSaturated"):
        from horovod_tpu_torch.serve.engine import QueueFull
        return QueueFull(msg, reason=fields.get("reason", "queue_full"),
                         queue_depth=int(fields.get("queue_depth") or 0),
                         retry_after_s=fields.get("retry_after_s"))
    if name == "OutOfBlocks":
        from horovod_tpu_torch.serve.kv_cache import OutOfBlocks
        return OutOfBlocks(msg)
    return RpcRemoteError(name, msg, fields)


def serve_connection(conn: RpcConn, handlers: Dict[str, Any]) -> None:
    """Server loop: read a call, run its handler, reply — until the peer
    disconnects or a method in ``handlers['__closing__']`` has replied.
    Handler exceptions become error replies; only a transport failure
    ends the loop."""
    closing = set(handlers.get("__closing__", ()))
    while True:
        try:
            msg = conn.recv()
        except (RpcConnectionError, RpcProtocolError):
            return
        method = msg.get("m")
        fn = handlers.get(method)
        try:
            if fn is None:
                raise KeyError(f"unknown rpc method {method!r}")
            reply = {"t": "ret",
                     "v": fn(*(msg.get("a") or []), **(msg.get("k") or {}))}
        except RpcConnectionError:
            return
        except Exception as e:   # noqa: BLE001 — becomes a wire error
            reply = _exception_to_wire(e)
        try:
            conn.send(reply)
        except (RpcConnectionError, RpcProtocolError):
            return
        if method in closing:
            conn.close()
            return


# ---------------------------------------------------------------------------
# Worker lifecycle
# ---------------------------------------------------------------------------

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

#: The line a worker prints on stdout once it listens.
WORKER_READY_PREFIX = "HVD-SERVE-WORKER ready"


@dataclasses.dataclass
class WorkerHandle:
    """A spawned (or attached) serve worker: its RPC connection and, for
    a spawned one, its process. Peers dial the worker's bulk listener at
    ``(host, peer_port)``."""

    conn: RpcConn
    proc: Optional[subprocess.Popen] = None
    port: int = 0
    host: str = "127.0.0.1"

    def kill(self) -> None:
        """SIGKILL the worker (the failover lever)."""
        self.conn.close()
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)

    def close(self) -> None:
        """Graceful stop: the shutdown RPC, then reap."""
        if self.conn.alive:
            try:
                self.conn.call("shutdown")
            except RpcError:
                pass
            self.conn.close()
        if self.proc is not None:
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)


def spawn_worker(*, env: Optional[Dict[str, str]] = None,
                 start_timeout: float = 300.0,
                 rpc_timeout: Optional[float] = 300.0,
                 codec=None, device: Optional[str] = None) -> WorkerHandle:
    """Start ``python -m horovod_tpu_torch.serve.worker --port 0`` on
    this host (``--device`` when given: ``cpu``, or ``cuda:N``), wait
    for its announce line, connect and return the handle. The child
    inherits the environment, with the repository root first on
    ``PYTHONPATH``."""
    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [_REPO_ROOT] + ([child_env["PYTHONPATH"]]
                        if child_env.get("PYTHONPATH") else []))
    child_env.setdefault("PYTHONUNBUFFERED", "1")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.serve.worker",
           "--port", "0"]
    if device is not None:
        cmd += ["--device", str(device)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            env=child_env)
    port = None
    deadline = time.monotonic() + start_timeout
    while time.monotonic() < deadline:
        # A child that wedges silently must still honour start_timeout.
        ready, _, _ = select.select([proc.stdout], [], [],
                                    max(0.0, deadline - time.monotonic()))
        if not ready:
            break
        line = proc.stdout.readline()
        if not line:
            proc.kill()
            proc.wait(timeout=30)
            raise RpcConnectionError(
                f"serve worker exited during startup (rc={proc.poll()})")
        if line.startswith(WORKER_READY_PREFIX):
            port = int(line.split("port=")[1].split()[0])
            break
    if port is None:
        proc.kill()
        proc.wait(timeout=30)
        raise RpcConnectionError(
            f"serve worker did not announce within {start_timeout}s")
    # Keep draining the child's stdout so it can never fill the pipe.
    threading.Thread(target=_drain, args=(proc.stdout,), daemon=True).start()
    sock = socket.create_connection(("127.0.0.1", port),
                                    timeout=start_timeout)
    sock.settimeout(None)   # the native syscalls need a blocking fd
    return WorkerHandle(conn=RpcConn(sock, timeout=rpc_timeout, codec=codec),
                        proc=proc, port=port)


def _drain(stream) -> None:
    try:
        for _ in stream:
            pass
    except (OSError, ValueError):
        pass


def connect_worker(host: str, port: int, *,
                   rpc_timeout: Optional[float] = 300.0,
                   codec=None) -> WorkerHandle:
    """Attach to a worker started elsewhere."""
    sock = socket.create_connection((host, port), timeout=rpc_timeout)
    sock.settimeout(None)
    return WorkerHandle(conn=RpcConn(sock, timeout=rpc_timeout, codec=codec),
                        port=port, host=host)


# ---------------------------------------------------------------------------
# Configs, results and handoffs on the wire
# ---------------------------------------------------------------------------

def dtype_name(dtype) -> Optional[str]:
    """A torch dtype's wire spelling (``"float32"``, ``"bfloat16"``)."""
    return None if dtype is None else str(dtype).replace("torch.", "")


def model_cfg_to_wire(model_cfg) -> Dict[str, Any]:
    d = dataclasses.asdict(model_cfg)
    d["dtype"] = dtype_name(model_cfg.dtype)
    return d


def serve_cfg_to_wire(serve_cfg) -> Dict[str, Any]:
    d = dataclasses.asdict(serve_cfg)
    d["cache_dtype"] = dtype_name(serve_cfg.cache_dtype)
    comp = serve_cfg.compression
    d["compression"] = (None if comp is None
                        else getattr(comp, "in_jit_codec", str(comp)))
    for k in ("batch_buckets", "prefill_buckets"):
        if d[k] is not None:
            d[k] = list(d[k])
    # The draft's configs marshal like the target's.
    draft = serve_cfg.draft
    d["draft"] = (None if draft is None else {
        "model_cfg": model_cfg_to_wire(draft.model_cfg),
        "seed": int(draft.seed),
        "cache_dtype": dtype_name(draft.cache_dtype),
    })
    return d


def result_from_wire(d: Dict[str, Any], now: float):
    """A ``RequestResult`` shipped as ages relative to the worker's
    clock, re-anchored on this process's clock (``perf_counter`` epochs
    differ between processes; every latency delta is kept)."""
    from horovod_tpu_torch.serve.engine import RequestResult

    def at(age):
        return None if age is None else now - age

    return RequestResult(
        rid=int(d["rid"]), status=d["status"],
        http_status=int(d["http_status"]),
        tokens=[int(t) for t in d["tokens"]],
        n_prompt=int(d["n_prompt"]),
        submitted_at=at(d["age_submitted"]),
        first_token_at=at(d["age_first_token"]),
        finished_at=at(d["age_finished"]),
        reason=d["reason"], deadline_class=int(d["deadline_class"]),
        retry_after_s=d["retry_after_s"])


def handoff_from_wire(d: Dict[str, Any], now: float):
    from horovod_tpu_torch.serve.engine import PrefillHandoff

    return PrefillHandoff(
        prompt=[int(t) for t in d["prompt"]],
        max_new=int(d["max_new"]),
        generated=[int(t) for t in d["generated"]],
        submitted_at=now - d["age_submitted"],
        first_token_at=now - d["age_first_token"],
        deadline_class=int(d["deadline_class"]),
        chain=[bytes(c) for c in d["chain"]],
        k_pages=torch.as_tensor(d["k_pages"]),
        v_pages=torch.as_tensor(d["v_pages"]),
        block_size=int(d["block_size"]),
        n_cached=int(d["n_cached"]),
        trace_id=int(d.get("trace_id") or 0))


def handoff_to_wire(h, now: float) -> Dict[str, Any]:
    return {
        "prompt": list(h.prompt), "max_new": h.max_new,
        "generated": list(h.generated),
        "age_submitted": now - h.submitted_at,
        "age_first_token": now - h.first_token_at,
        "deadline_class": h.deadline_class,
        "chain": list(h.chain),
        "k_pages": h.k_pages, "v_pages": h.v_pages,
        "block_size": h.block_size, "n_cached": h.n_cached,
        "trace_id": h.trace_id,
    }


def handoff_meta_to_wire(h, now: float) -> Dict[str, Any]:
    """The manifest half of a handoff, everything but the pages: the
    direct migration's ``peer_begin`` frame, so the target reserves its
    blocks (or fails) before a page moves."""
    return {
        "prompt": list(h.prompt), "max_new": h.max_new,
        "generated": list(h.generated),
        "age_submitted": now - h.submitted_at,
        "age_first_token": now - h.first_token_at,
        "deadline_class": h.deadline_class,
        "chain": list(h.chain),
        "block_size": h.block_size, "n_cached": h.n_cached,
        "n_pages": h.n_pages,
        "trace_id": h.trace_id,
    }


def handoff_meta_from_wire(d: Dict[str, Any], now: float) -> Dict[str, Any]:
    """Inverse of :func:`handoff_meta_to_wire` on this process's clock:
    the dict ``ServeEngine.inject_begin`` takes."""
    return {
        "prompt": [int(t) for t in d["prompt"]],
        "max_new": int(d["max_new"]),
        "generated": [int(t) for t in d["generated"]],
        "submitted_at": now - d["age_submitted"],
        "first_token_at": now - d["age_first_token"],
        "deadline_class": int(d["deadline_class"]),
        "chain": [bytes(c) for c in d["chain"]],
        "block_size": int(d["block_size"]),
        "n_cached": int(d["n_cached"]),
        "n_pages": int(d["n_pages"]),
        "trace_id": int(d.get("trace_id") or 0),
    }


# ---------------------------------------------------------------------------
# RemoteReplica: the engine seam over a connection
# ---------------------------------------------------------------------------

class _RemoteAllocatorView:
    """The part of ``BlockAllocator`` the router reads, from the
    worker's configure reply and its newest admission snapshot."""

    def __init__(self, n_blocks: int, block_size: int):
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free = n_blocks - 1

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_alloc(self, n: int) -> bool:
        return n <= self._free

    @property
    def n_free(self) -> int:
        return self._free


class RemoteReplicaMetrics:
    """The router process's view of a worker's ``ServeMetrics``: the
    beat's snapshot plus the delta-shipped latency samples, exported on
    the shared Prometheus exposition under the worker's instance."""

    def __init__(self, instance: str):
        self.instance = instance
        self.first_token_s: List[float] = []
        self.per_token_s: List[float] = []
        self._snap: Dict[str, Any] = {}
        from horovod_tpu_torch.metrics import register_exporter_weak
        register_exporter_weak(f"serve_remote_{id(self)}", self,
                               "prometheus")

    def update(self, snap: Dict[str, Any], first_token_s, per_token_s):
        from horovod_tpu_torch.serve.metrics import MAX_SAMPLES
        self._snap = snap
        for dst, new in ((self.first_token_s, first_token_s),
                         (self.per_token_s, per_token_s)):
            room = MAX_SAMPLES - len(dst)
            if room > 0:
                dst.extend(float(x) for x in new[:room])

    def snapshot(self) -> Dict[str, Any]:
        return dict(self._snap)

    def prometheus(self) -> str:
        from horovod_tpu_torch.metrics import render_gauges
        return render_gauges("serve", self.snapshot(),
                             labels={"instance": self.instance})


class RemoteReplica:
    """One serve worker process behind the engine seam: the router uses
    it as it uses a ``ServeEngine``, with three differences. Results and
    latency samples arrive batched on the ``step``/``heartbeat`` replies
    and are re-anchored on the router's clock; ``metrics`` and
    ``allocator`` are cached views those replies refresh; and a
    transport failure raises :class:`RpcConnectionError`, the router's
    dead-worker signal."""

    remote = True

    def __init__(self, handle: WorkerHandle, model_cfg, serve_cfg, *,
                 seed: int, instance: str, clock=time.perf_counter,
                 trace=None):
        self._handle = handle
        self._conn = handle.conn
        self._clock = clock
        self.instance = instance
        self._trace = trace     # the router's RouterTrace (None: off)
        # Worker clock - router clock, from the heartbeat with the
        # smallest round trip so far (its midpoint bound is tightest).
        self.clock_offset = 0.0
        self.clock_rtt = float("inf")
        ret = self._conn.call(
            "configure", model_cfg=model_cfg_to_wire(model_cfg),
            serve_cfg=serve_cfg_to_wire(serve_cfg), seed=int(seed),
            instance=instance, kv_codec=self._conn.codec)
        self.allocator = _RemoteAllocatorView(int(ret["n_blocks"]),
                                              int(ret["block_size"]))
        # The worker's bulk listener for direct migration (0: none; the
        # router keeps this replica on the relayed path).
        self.peer_host = handle.host
        self.peer_port = int(ret.get("peer_port") or 0)
        self.metrics = RemoteReplicaMetrics(instance)
        # The worker's flash launches and peak card memory, as of the
        # last beat (a port worker's; None from another worker).
        self.device_stats: Optional[Dict[str, int]] = None
        self._results: Dict[int, Any] = {}
        self._pending = False
        self.last_beat = -float("inf")
        self._absorb_beat(ret["beat"])

    # -- beat plumbing ----------------------------------------------

    def _absorb_beat(self, beat: Dict[str, Any],
                     t0: Optional[float] = None,
                     t1: Optional[float] = None) -> None:
        now = self._clock()
        self._pending = bool(beat["pending"])
        self.allocator._free = int(beat["kv_blocks_free"])
        self.metrics.update(beat["snap"], beat["ft"], beat["pt"])
        self.device_stats = beat.get("device")
        for erid, rd in beat["results"].items():
            self._results[int(erid)] = result_from_wire(rd, now)
        self.last_beat = now
        # An offset sample only from a bracketed heartbeat: a step
        # reply's time includes the worker's compute.
        if t0 is not None and t1 is not None and beat.get("now") is not None:
            rtt = t1 - t0
            if rtt < self.clock_rtt:
                self.clock_rtt = rtt
                self.clock_offset = float(beat["now"]) - (t0 + t1) / 2.0

    def heartbeat(self) -> None:
        """Liveness, the metrics scrape and a clock-offset sample in one
        round trip; raises :class:`RpcConnectionError` when the worker
        is gone."""
        t0 = self._clock()
        beat = self._conn.call("heartbeat")
        self._absorb_beat(beat, t0, self._clock())

    # -- the engine seam ---------------------------------------------

    @property
    def pending(self) -> bool:
        return self._pending

    def admission_snapshot(self) -> Dict[str, float]:
        snap = self._conn.call("admission_snapshot")
        self.allocator._free = int(snap["kv_blocks_free"])
        return snap

    def cached_chain_len(self, chain: Sequence[bytes]) -> int:
        if not chain:
            return 0
        return int(self._conn.call("cached_chain_len", list(chain)))

    def submit(self, prompt, max_new_tokens=None, deadline=None,
               deadline_class: int = 0, prefill_only: bool = False,
               chain=None, trace_id: int = 0) -> int:
        # Deadlines are router-clock times; the wire carries the time
        # remaining and the worker re-anchors it on its own clock.
        deadline_in = None if deadline is None else deadline - self._clock()
        # The trace id rides the next frame's header.
        self._conn.trace_id = trace_id
        t0 = self._clock()
        erid = self._conn.call(
            "submit", prompt=[int(t) for t in prompt],
            max_new_tokens=max_new_tokens, deadline_in=deadline_in,
            deadline_class=deadline_class, prefill_only=prefill_only,
            chain=list(chain) if chain is not None else None)
        if trace_id and self._trace is not None:
            self._trace.span("rpc:submit", t0, self._clock() - t0,
                             trace=trace_id, instance=self.instance)
        self._pending = True
        return int(erid)

    def withdraw(self, rid: int) -> bool:
        return bool(self._conn.call("withdraw", int(rid)))

    def step(self) -> None:
        self._absorb_beat(self._conn.call("step"))

    # -- the router's step fan-out ------------------------------------

    def step_begin(self) -> bool:
        """Send the step request and return at once, while the worker
        computes; pair it with :meth:`step_finish`. Returns True so the
        router's ``_guard`` tells success from a detected death."""
        self._conn.call_begin("step")
        return True

    def step_finish(self) -> None:
        """Collect and apply a :meth:`step_begin`'s beat reply."""
        self._absorb_beat(self._conn.call_finish())

    def result(self, rid: int):
        return self._results.get(rid)

    def handoff_ready(self) -> List[int]:
        return [int(r) for r in self._conn.call("handoff_ready")]

    def export_prefilled(self, rid: int):
        d = self._conn.call("export_prefilled", int(rid))
        return handoff_from_wire(d, self._clock())

    def inject_prefilled(self, h) -> int:
        self._conn.trace_id = getattr(h, "trace_id", 0)
        erid = self._conn.call("inject_prefilled",
                               handoff_to_wire(h, self._clock()))
        self._pending = True
        return int(erid)

    def export_trace(self) -> Dict[str, Any]:
        """The worker's chrome-trace events and timebase anchor, with
        the router's estimated clock offset stamped in."""
        d = self._conn.call("export_trace")
        d["meta"]["instance"] = self.instance
        d["meta"]["clock_offset"] = self.clock_offset
        d["meta"]["clock_rtt"] = (None if self.clock_rtt == float("inf")
                                  else self.clock_rtt)
        return d

    def running_exportable(self) -> List[int]:
        return [int(r) for r in self._conn.call("running_exportable")]

    def export_running(self, rid: int):
        d = self._conn.call("export_running", int(rid))
        return handoff_from_wire(d, self._clock())

    # -- direct migration ----------------------------------------------

    def migrate_direct(self, erid: int, kind: str, host: str, port: int,
                       chunk_pages: int, epoch: int) -> Dict[str, Any]:
        """Ask this worker (the source) to stream sequence ``erid``'s
        pages to a peer's bulk listener; the router never holds them.
        Returns the worker's status: ``ok`` (with the target's erid and
        the move's bytes and ms), ``dial_failed`` (sequence untouched:
        relay it) or ``failed`` (exported, then lost: requeue)."""
        return self._conn.call(
            "migrate_to", kind=str(kind), erid=int(erid), host=str(host),
            port=int(port), chunk_pages=int(chunk_pages), epoch=int(epoch))

    def note_remote_inject(self) -> None:
        """A sequence landed here from a peer's stream, outside the
        router's connection: step the worker before the next beat."""
        self._pending = True

    # -- lifecycle ---------------------------------------------------

    @property
    def alive(self) -> bool:
        return self._conn.alive

    def mark_dead(self) -> None:
        self._conn.close()

    def shutdown(self) -> None:
        self._handle.close()


# ---------------------------------------------------------------------------
# A worker beside a mesh: mesh rank 0's connection, mirrored on the others
# ---------------------------------------------------------------------------

class MirrorHandle:
    """What a mesh rank other than 0 passes where mesh rank 0 passes a
    worker's handle (``ServeRouter(mesh=, workers=)``,
    ``add_model(workers=)``, ``add_remote_replica``): the rank holds no
    connection, and the router builds a mirror of the replica on it.
    ``kill`` and ``close`` do nothing: the worker is rank 0's."""

    conn = None
    proc = None
    port = 0
    host = ""

    def kill(self) -> None:
        pass

    def close(self) -> None:
        pass


def _to_meta(obj):
    """``obj`` with every tensor replaced by a ``meta`` tensor of its
    shape and dtype (no data)."""
    if isinstance(obj, torch.Tensor):
        return obj.to("meta")
    if isinstance(obj, list):
        return [_to_meta(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_meta(v) for k, v in obj.items()}
    return obj


class LockstepConn:
    """A worker's connection as every rank of a lockstep mesh group sees
    it. Mesh rank 0 (``conn``) makes each call on the worker's real
    :class:`RpcConn`; then every rank returns rank 0's outcome,
    broadcast over ``group`` as one object a call: the reply; a
    transport failure, on which every rank closes its side and raises
    :class:`RpcConnectionError`; or another error, which every rank
    raises as rebuilt from its wire form. The tensors of a reply (a
    handoff's pages) stay out of that object: the other ranks get
    ``meta`` tensors of their shape and dtype, and the router moves the
    pages it needs over the group itself. A failed :meth:`call_begin`
    is kept for its :meth:`call_finish`, so every rank meets the failure
    at the same call. No rank other than 0 touches a socket."""

    #: Objects broadcast by every instance in this process (the chip
    #: run reports them a router step).
    broadcasts = 0

    def __init__(self, conn: Optional[RpcConn], group):
        self._conn = conn
        self._group = group
        self._codec = 0
        self._begun = None
        self.alive = True

    @property
    def codec(self) -> int:
        return self._conn.codec if self._conn is not None else self._codec

    @codec.setter
    def codec(self, value) -> None:
        if self._conn is not None:
            self._conn.codec = value
        self._codec = value

    @property
    def trace_id(self) -> int:
        return self._conn.trace_id if self._conn is not None else 0

    @trace_id.setter
    def trace_id(self, value) -> None:
        if self._conn is not None:
            self._conn.trace_id = value

    def set_timeout(self, timeout: Optional[float]) -> None:
        if self._conn is not None:
            self._conn.set_timeout(timeout)

    def close(self) -> None:
        self.alive = False
        if self._conn is not None:
            self._conn.close()

    @staticmethod
    def _outcome(fn):
        try:
            return ("ret", fn(), None)
        except RpcConnectionError as e:
            return ("dead", str(e), e)
        except Exception as e:   # noqa: BLE001 — every rank raises it
            return ("err", _exception_to_wire(e), e)

    def _share(self, out):
        """Broadcast rank 0's outcome ``out``; return the reply or raise
        the failure on every rank."""
        from horovod_tpu_torch.functions import broadcast_object

        payload = None
        if out is not None:
            kind, value, _ = out
            payload = (kind, _to_meta(value) if kind == "ret" else value)
        kind, value = broadcast_object(payload, 0, self._group)
        LockstepConn.broadcasts += 1
        cause = None if out is None else out[2]
        if kind == "ret":
            return value if out is None else out[1]
        if kind == "dead":
            self.close()
            raise RpcConnectionError(value) from cause
        raise _rebuild_exception(value) from cause

    def call(self, method: str, *args, **kwargs):
        out = None
        if self._conn is not None:
            out = self._outcome(
                lambda: self._conn.call(method, *args, **kwargs))
        return self._share(out)

    def call_begin(self, method: str, *args, **kwargs) -> None:
        if self._conn is not None:
            self._begun = self._outcome(
                lambda: self._conn.call_begin(method, *args, **kwargs))

    def call_finish(self):
        out = None
        if self._conn is not None:
            out, self._begun = self._begun, None
            if out is None or out[0] == "ret":
                out = self._outcome(self._conn.call_finish)
        return self._share(out)


def lockstep_handle(handle, group) -> WorkerHandle:
    """The handle a worker replica beside a mesh is built on: on mesh
    rank 0 of ``group`` (the mesh's lockstep group) ``handle`` is the
    worker's own (``spawn_worker``/``connect_worker``), elsewhere a
    :class:`MirrorHandle`; either way the returned handle's connection
    is a :class:`LockstepConn`."""
    import torch.distributed as dist

    root = dist.get_rank(group) == 0
    if root == isinstance(handle, MirrorHandle):
        raise ValueError(
            "beside a mesh, mesh rank 0 passes each worker's handle and "
            f"every other rank a MirrorHandle (rank {dist.get_rank()} "
            f"passed {type(handle).__name__})")
    return WorkerHandle(conn=LockstepConn(handle.conn if root else None,
                                          group),
                        proc=handle.proc, port=handle.port,
                        host=handle.host)
