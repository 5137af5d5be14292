"""Live-camera frame sources (reference Examples/ROS/ORB_SLAM2/src/
{ros_mono,ros_stereo,ros_rgbd}.cc).

A copy of orb_slam2_test_tpu/io/live.py (host code: numpy and the
standard library; OpenCV is imported only to decode or encode PNG), with
a count of the frames the pairing drops and a `close` for the pair.

The reference's live frontend is a set of ROS nodes: each subscribes to
image topics, pairs stereo / RGB-D streams with
message_filters::ApproximateTimeSync, and feeds System::Track* from the
callback. Without ROS the equivalent is a small transport-agnostic
layer:

  FrameSource            -- iterator protocol: next_frame() -> (ts, img) | None
  DirectorySource        -- tails a directory an external camera process
                            writes images into (the "topic" becomes a
                            spool directory)
  SocketSource           -- length-prefixed raw/PNG frames over TCP, the
                            direct analog of a ROS image topic
  ApproximateTimeSync    -- pairs two timestamped streams by nearest
                            timestamp within `slop` seconds, dropping
                            unmatched frames (mirrors
                            message_filters::sync_policies::ApproximateTime
                            of ros_stereo.cc / ros_rgbd.cc)

Drivers: `python -m orb_slam2_test_tpu_torch.cli live_mono | live_stereo
| live_rgbd` (`cli.run_live`).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

import numpy as np


class FrameSource:
    """A stream of (timestamp, image) pairs from a live producer."""

    def next_frame(self, timeout: float = 1.0):
        """Return (timestamp, np.ndarray) or None if no frame arrived
        within `timeout` seconds. Raises StopIteration when the
        producer has closed the stream."""
        raise NotImplementedError

    def close(self):
        pass

    def __iter__(self):
        while True:
            try:
                f = self.next_frame()
            except StopIteration:
                return
            if f is not None:
                yield f


def _parse_ts(name: str) -> Optional[float]:
    """Timestamp from a spool filename: '<ts>.png' (TUM convention) or
    any numeric stem; falls back to None (caller uses mtime)."""
    stem = os.path.splitext(os.path.basename(name))[0]
    try:
        return float(stem)
    except ValueError:
        return None


class DirectorySource(FrameSource):
    """Tails a spool directory for new image files.

    An external camera process (v4l2 grabber, gstreamer multifilesink,
    a drone downlink...) drops '<timestamp>.png' files into `path`;
    this source picks them up in timestamp order. `stop_file`: when a
    file of that name appears, the stream ends (the producer's
    "shutdown message")."""

    IMG_EXT = (".png", ".jpg", ".jpeg", ".pgm", ".ppm", ".bmp", ".tif")

    def __init__(self, path: str, grayscale: bool = True,
                 poll_s: float = 0.02, stop_file: str = "STOP",
                 delete_consumed: bool = False):
        self.path = path
        self.grayscale = grayscale
        self.poll_s = poll_s
        self.stop_file = stop_file
        self.delete_consumed = delete_consumed
        self._seen: set[str] = set()
        self._queue: list[tuple[float, str]] = []

    def _scan(self):
        try:
            names = os.listdir(self.path)
        except FileNotFoundError:
            return
        fresh = []
        for n in names:
            if n in self._seen or not n.lower().endswith(self.IMG_EXT):
                continue
            self._seen.add(n)
            p = os.path.join(self.path, n)
            ts = _parse_ts(n)
            if ts is None:
                ts = os.path.getmtime(p)
            fresh.append((ts, p))
        if fresh:
            self._queue.extend(fresh)
            self._queue.sort(key=lambda x: x[0])

    def next_frame(self, timeout: float = 1.0):
        deadline = time.monotonic() + timeout
        while True:
            self._scan()
            if self._queue:
                ts, p = self._queue.pop(0)
                img = _read_image(p, self.grayscale)
                if self.delete_consumed:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
                if img is None:  # torn write; skip
                    continue
                return ts, img
            if os.path.exists(os.path.join(self.path, self.stop_file)):
                raise StopIteration
            if time.monotonic() >= deadline:
                return None
            time.sleep(self.poll_s)


def _read_image(path: str, grayscale: bool) -> Optional[np.ndarray]:
    import cv2

    flag = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_UNCHANGED
    img = cv2.imread(path, flag)
    if img is None:
        return None
    return img.astype(np.float32)


class SocketSource(FrameSource):
    """Receives frames over TCP — the direct analog of a ROS image
    topic subscription.

    Wire format per frame (all little-endian):
        u32 magic 0x46524d31 ('FRM1')
        f64 timestamp
        u32 encoding (0 = raw u8 gray, 1 = raw u16, 2 = PNG bytes)
        u32 height, u32 width   (0,0 for PNG)
        u32 payload length, then payload
    A magic of 0x46524d00 ends the stream.
    """

    MAGIC = 0x46524D31
    MAGIC_END = 0x46524D00
    _HDR = struct.Struct("<IdIIII")

    def __init__(self, host: str = "0.0.0.0", port: int = 7071,
                 sock: Optional[socket.socket] = None):
        if sock is not None:
            self._conn = sock
            self._server = None
        else:
            self._server = socket.create_server((host, port))
            self._conn, _ = self._server.accept()
        self._conn.settimeout(None)
        self._buf = b""

    def _recv_exact(self, n: int, timeout: float) -> Optional[bytes]:
        self._conn.settimeout(timeout)
        try:
            while len(self._buf) < n:
                chunk = self._conn.recv(65536)
                if not chunk:
                    raise StopIteration
                self._buf += chunk
        except (TimeoutError, socket.timeout):
            return None
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def next_frame(self, timeout: float = 1.0):
        hdr = self._recv_exact(self._HDR.size, timeout)
        if hdr is None:
            return None
        magic, ts, enc, h, w, ln = self._HDR.unpack(hdr)
        if magic == self.MAGIC_END:
            raise StopIteration
        if magic != self.MAGIC:
            raise IOError(f"bad frame magic {magic:#x}")
        payload = self._recv_exact(ln, max(timeout, 5.0))
        if payload is None:
            raise IOError("truncated frame payload")
        if enc == 0:
            img = np.frombuffer(payload, np.uint8).reshape(h, w)
        elif enc == 1:
            img = np.frombuffer(payload, "<u2").reshape(h, w)
        elif enc == 2:
            import cv2

            img = cv2.imdecode(
                np.frombuffer(payload, np.uint8), cv2.IMREAD_UNCHANGED
            )
            if img is None:
                raise IOError("PNG decode failed")
        else:
            raise IOError(f"unknown encoding {enc}")
        return ts, img.astype(np.float32)

    def close(self):
        for s in (self._conn, self._server):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass


def send_frame(sock: socket.socket, ts: float, img: np.ndarray,
               encoding: int = 0):
    """Producer-side helper matching SocketSource's wire format."""
    if encoding == 0:
        payload = np.ascontiguousarray(img, np.uint8).tobytes()
        h, w = img.shape[:2]
    elif encoding == 1:
        payload = np.ascontiguousarray(img, "<u2").tobytes()
        h, w = img.shape[:2]
    elif encoding == 2:
        import cv2

        ok, buf = cv2.imencode(".png", img)
        assert ok
        payload, h, w = buf.tobytes(), 0, 0
    else:
        raise ValueError(encoding)
    sock.sendall(
        SocketSource._HDR.pack(SocketSource.MAGIC, ts, encoding, h, w,
                               len(payload))
        + payload
    )


def send_end(sock: socket.socket):
    sock.sendall(SocketSource._HDR.pack(SocketSource.MAGIC_END, 0.0, 0,
                                        0, 0, 0))


class ApproximateTimeSync:
    """Pairs two timestamped streams by nearest timestamp.

    Reference ros_stereo.cc / ros_rgbd.cc use
    message_filters::sync_policies::ApproximateTime<Image, Image> with
    queue size 10 to pair left/right (or rgb/depth) messages. Same
    semantics here: keep a bounded queue per stream, emit the pair with
    the smallest timestamp gap once it is provably minimal, drop
    stragglers that exceed `slop`. `dropped` counts the frames of either
    stream that were never paired."""

    def __init__(self, a: FrameSource, b: FrameSource,
                 slop: float = 0.02, queue_size: int = 10):
        self.a, self.b = a, b
        self.slop = slop
        self.queue_size = queue_size
        self._qa: list[tuple[float, np.ndarray]] = []
        self._qb: list[tuple[float, np.ndarray]] = []
        self._a_done = False
        self._b_done = False
        self.dropped = 0

    def _pump(self, timeout: float):
        if not self._a_done:
            try:
                f = self.a.next_frame(timeout)
                if f is not None:
                    self._qa.append(f)
            except StopIteration:
                self._a_done = True
        if not self._b_done:
            try:
                f = self.b.next_frame(timeout)
                if f is not None:
                    self._qb.append(f)
            except StopIteration:
                self._b_done = True
        for q in (self._qa, self._qb):
            while len(q) > self.queue_size:
                q.pop(0)
                self.dropped += 1

    def _drop_stragglers(self):
        """Pop queue heads that can never match (timestamps are
        monotonic per stream, so a head more than `slop` older than the
        other stream's head is unmatchable)."""
        while self._qa and self._qb:
            ta, tb = self._qa[0][0], self._qb[0][0]
            if ta + self.slop < tb:
                self._qa.pop(0)
            elif tb + self.slop < ta:
                self._qb.pop(0)
            else:
                return
            self.dropped += 1

    def next_pair(self, timeout: float = 1.0):
        """Return (ts, img_a, img_b) or None on timeout; StopIteration
        when both producers have closed and queues are drained.

        Emits oldest-first: the a-queue head is paired with its nearest
        in-slop b message once no unseen b can be nearer (b has a
        message newer than ta+slop, b's producer closed, or a queue is
        full)."""
        deadline = time.monotonic() + timeout
        while True:
            self._pump(timeout=min(0.05, timeout))
            self._drop_stragglers()
            if self._qa and self._qb:
                ta, ia = self._qa[0]
                cands = [
                    (abs(tb - ta), j)
                    for j, (tb, _) in enumerate(self._qb)
                    if abs(tb - ta) <= self.slop
                ]
                if cands:
                    _, j = min(cands)
                    settled = (
                        self._b_done
                        or self._qb[-1][0] > ta + self.slop
                        or len(self._qa) >= self.queue_size
                        or len(self._qb) >= self.queue_size
                    )
                    if settled:
                        tb, ib = self._qb[j]
                        self._qa.pop(0)
                        del self._qb[: j + 1]
                        self.dropped += j
                        return 0.5 * (ta + tb), ia, ib
            if self._a_done and self._b_done:
                self._drop_stragglers()
                if not (self._qa and self._qb):
                    self.dropped += len(self._qa) + len(self._qb)
                    self._qa.clear()
                    self._qb.clear()
                    raise StopIteration
            if time.monotonic() >= deadline:
                return None

    def close(self):
        """Close both sources (the JAX package's sync has no close, so
        its live driver leaves the sockets open)."""
        self.a.close()
        self.b.close()

    def __iter__(self):
        while True:
            try:
                p = self.next_pair()
            except StopIteration:
                return
            if p is not None:
                yield p
