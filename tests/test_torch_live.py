"""The port's live input (io/live.py) and live commands (cli.py live_*)
against the JAX package's, on the CPU.

- `ApproximateTimeSync` on seeded timestamp streams (jitter, gaps,
  unequal rates, one stream closing early): the same pairs, in order,
  and the same number of dropped frames as the JAX package's; the port
  counts them in `dropped`;
- the FRM1 wire format both ways (JAX `send_frame` -> port
  `SocketSource` and the reverse), encodings 0, 1 and 2: exact pixels
  and timestamps;
- `DirectorySource`: timestamp order, the STOP file, the timeout;
- `cli.py live_mono` over a spool directory of the SKILL.md TUM recipe's
  frames with epoch timestamps, `live_stereo` over two TCP sockets fed
  `entry.band_sequence`, and `live_rgbd` over an image and a 16-bit
  depth spool of the band sequence: the same trajectory, exactly, as
  `cli.run` on a `MemorySequence` of the same frames;
- the JAX package's live drivers (examples/live_{mono,stereo,rgbd}.py)
  stop with an AttributeError before their first frame: they read
  `args.live_viewer`, which their parser never defines; and their depth
  spool reads 16-bit depth as 8-bit grey.
"""

import os
import socket
import subprocess
import sys
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from orb_slam2_test_tpu.io import live as jlive
from orb_slam2_test_tpu_torch import cli, entry
from orb_slam2_test_tpu_torch.io import datasets as tdatasets
from orb_slam2_test_tpu_torch.io import live as tlive
from orb_slam2_test_tpu_torch.io import settings as tsettings
from orb_slam2_test_tpu_torch.io import trajectory as ttraj

from test_torch_cli import _write_band_datasets
from test_torch_system import _write_tum_recipe

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _list_source(base, frames):
    """A FrameSource subclass of `base`'s module over a list of frames
    (tests/test_live_ar.py's ListSource)."""

    class ListSource(base.FrameSource):
        def __init__(self):
            self.frames = list(frames)

        def next_frame(self, timeout: float = 1.0):
            if not self.frames:
                raise StopIteration
            return self.frames.pop(0)

    return ListSource()


def _stream(rng, n, period, jitter, gap_every=0, t0=0.0):
    """n timestamps at `period` with uniform jitter, every gap_every-th
    frame missing; each frame's image holds its stream-local index."""
    ts = t0 + period * np.arange(n) + rng.uniform(-jitter, jitter, n)
    keep = np.ones(n, bool) if not gap_every else (np.arange(n) % gap_every != gap_every - 1)
    return [(float(t), np.full((2, 2), float(i), np.float32))
            for i, t in enumerate(ts) if keep[i]]


SCENARIOS = {
    "jitter": lambda r: (_stream(r, 40, 0.1, 0.008), _stream(r, 40, 0.1, 0.008)),
    "gaps": lambda r: (_stream(r, 40, 0.1, 0.004, gap_every=7),
                       _stream(r, 40, 0.1, 0.004, gap_every=5)),
    "unequal_rates": lambda r: (_stream(r, 60, 1 / 30, 0.003), _stream(r, 20, 0.1, 0.003)),
    "early_close": lambda r: (_stream(r, 40, 0.1, 0.006), _stream(r, 17, 0.1, 0.006)),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_sync_pairs_and_drops_match_jax(scenario):
    a, b = SCENARIOS[scenario](np.random.default_rng(sorted(SCENARIOS).index(scenario)))
    runs = {}
    for name, mod in (("jax", jlive), ("port", tlive)):
        sync = mod.ApproximateTimeSync(_list_source(mod, a), _list_source(mod, b), slop=0.02)
        pairs = [(ts, int(ia[0, 0]), int(ib[0, 0])) for ts, ia, ib in sync]
        runs[name] = (pairs, sync)
    (jpairs, _), (tpairs, tsync) = runs["jax"], runs["port"]
    assert tpairs == jpairs
    dropped = len(a) + len(b) - 2 * len(jpairs)
    assert tsync.dropped == dropped
    print(f"{scenario}: {len(jpairs)} pairs, {dropped} dropped of {len(a)} + {len(b)}")
    assert len(jpairs) >= 10
    if scenario != "jitter":
        assert dropped > 0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wire_format_both_ways(direction):
    send, recv = (jlive, tlive) if direction == "jax_to_port" else (tlive, jlive)
    rng = np.random.default_rng(1)
    img8 = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    img16 = rng.integers(0, 65536, (37, 53), dtype=np.uint16)
    sent = [(1.76e9 + 0.1, img8, 0), (1.76e9 + 0.2, img16, 1), (1.76e9 + 0.3, img8, 2),
            (1.76e9 + 0.4, img16, 2)]
    c, s = socket.socketpair()

    def produce():
        for ts, img, enc in sent:
            send.send_frame(c, ts, img, encoding=enc)
        send.send_end(c)

    t = threading.Thread(target=produce)
    t.start()
    src = recv.SocketSource(sock=s)
    for ts, img, _ in sent:
        got_ts, got = src.next_frame()
        assert got_ts == ts and got.dtype == np.float32
        np.testing.assert_array_equal(got, img.astype(np.float32))
    with pytest.raises(StopIteration):
        src.next_frame()
    t.join()
    src.close()
    c.close()


def test_directory_source_orders_stops_and_times_out(tmp_path):
    d = str(tmp_path)
    src = tlive.DirectorySource(d, poll_s=0.001)
    assert src.next_frame(timeout=0.05) is None
    for ts in (1.76e9 + 0.2, 1.76e9 + 0.1, 1.76e9 + 0.3):
        cv2.imwrite(os.path.join(d, f"{ts:.6f}.png"),
                    np.full((4, 4), int(round((ts - 1.76e9) * 10)), np.uint8))
    open(os.path.join(d, "STOP"), "w").close()
    got = [(ts, img[0, 0]) for ts, img in src]
    assert [round(t - 1.76e9, 3) for t, _ in got] == [0.1, 0.2, 0.3]
    assert [g for _, g in got] == [1.0, 2.0, 3.0]


def _trajectory(path):
    return [(t, T) for t, T in ttraj.load_trajectory_tum(path)]


def _assert_same_trajectory(a, b):
    assert [t for t, _ in a] == [t for t, _ in b]
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_live_mono_over_a_spool_equals_run(tmp_path):
    recipe = str(tmp_path / "recipe")
    settings = _write_tum_recipe(recipe, n=8)
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    frames = []
    for i, it in enumerate(tdatasets.load_tum_mono(recipe).items):
        img = cv2.imread(it.paths[0], cv2.IMREAD_GRAYSCALE)
        name = f"{1.76e9 + 0.1 * i:.6f}.png"
        cv2.imwrite(os.path.join(spool, name), img)
        frames.append((float(name[:-4]), img.astype(np.float32)))
    open(os.path.join(spool, "STOP"), "w").close()
    live_traj = str(tmp_path / "live.txt")
    assert cli.main(["live_mono", settings, "--spool", spool, "--device", "cpu",
                     "--no-vocabulary", "--traj-out", live_traj]) == 0

    mem_traj = str(tmp_path / "mem.txt")
    args = cli.common_parser("").parse_args(
        [settings, recipe, "--no-vocabulary", "--device", "cpu", "--traj-out", mem_traj,
         "--kf-traj-out", str(tmp_path / "kf.txt")])
    system = cli.make_system(args, "monocular")
    summary = cli.run(system, tdatasets.MemorySequence("mono", frames), args,
                      log=lambda *a: None)
    assert summary["lost_frames"] == 0 and summary["keyframes"] >= 2
    live, mem = _trajectory(live_traj), _trajectory(mem_traj)
    assert len(mem) >= 5  # initialized on frame 3 of 8
    _assert_same_trajectory(live, mem)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _connect(port, deadline=30.0):
    t_end = time.monotonic() + deadline
    while True:
        try:
            return socket.create_connection(("127.0.0.1", port))
        except OSError:
            if time.monotonic() > t_end:
                raise
            time.sleep(0.02)


def test_live_stereo_over_sockets_equals_run(tmp_path):
    cam = entry.RGBD_CAM
    seq = entry.band_sequence(np.random.default_rng(3), cam, 5, "cpu")
    frames = [(1.76e9 + t, left.numpy(), right.numpy()) for t, left, right in seq.frames]
    s = tsettings.SlamSettings(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
                               width=cam.width, height=cam.height, fps=10.0,
                               n_features=1000, max_keyframes=32, max_points=8192,
                               min_depth_init_points=300)
    settings = str(tmp_path / "stereo.yaml")
    tsettings.save_settings(s, settings)
    ports = [_free_port(), _free_port()]

    def produce():
        conns = [_connect(p) for p in ports]
        for ts, left, right in frames:
            jlive.send_frame(conns[0], ts, left)
            jlive.send_frame(conns[1], ts, right)
        for c in conns:
            jlive.send_end(c)
            c.close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    live_traj = str(tmp_path / "live.txt")
    assert cli.main(["live_stereo", settings, "--port", str(ports[0]), "--port2",
                     str(ports[1]), "--device", "cpu", "--no-vocabulary",
                     "--traj-out", live_traj]) == 0
    t.join(timeout=30)

    mem_traj = str(tmp_path / "mem.txt")
    args = cli.common_parser("").parse_args(
        [settings, str(tmp_path), "--no-vocabulary", "--device", "cpu", "--traj-out", mem_traj,
         "--kf-traj-out", str(tmp_path / "kf.txt")])
    system = cli.make_system(args, "stereo")
    mem = [(ts, a.astype(np.float32), b.astype(np.float32)) for ts, a, b in frames]
    summary = cli.run(system, tdatasets.MemorySequence("stereo", mem), args,
                      log=lambda *a: None)
    assert summary["lost_frames"] == 0 and summary["keyframes"] >= 2
    live, ref = _trajectory(live_traj), _trajectory(mem_traj)
    assert len(ref) == 5
    _assert_same_trajectory(live, ref)


@pytest.mark.parametrize("driver", ["live_mono", "live_stereo", "live_rgbd"])
def test_reference_live_drivers_lack_live_viewer(driver, tmp_path):
    """The JAX package's live drivers pass live_viewer_port=
    args.live_viewer, but examples/_live_runner.live_parser defines no
    --live-viewer: each stops before it tracks a frame (the port's live
    commands take --live-viewer; ROADMAP queue 3)."""
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", f"{driver}.py"),
         str(tmp_path / "settings.yaml"), "--spool", spool, "--spool2", spool],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode != 0
    assert "AttributeError" in out.stderr and "live_viewer" in out.stderr, out.stderr[-2000:]


def _spool(d, rows):
    """Copy (timestamp, image path) rows into a spool directory as
    <timestamp>.png, then STOP; returns the parsed timestamps."""
    os.makedirs(d)
    out = []
    for ts, path in rows:
        name = f"{ts:.6f}.png"
        with open(path, "rb") as f, open(os.path.join(d, name), "wb") as g:
            g.write(f.read())
        out.append(float(name[:-4]))
    open(os.path.join(d, "STOP"), "w").close()
    return out


def test_live_rgbd_over_spools_equals_run(tmp_path):
    _, tum, settings = _write_band_datasets(str(tmp_path), n=5)
    seq = tdatasets.load_tum_rgbd(tum, depth_map_factor=5000.0)
    rgb_rows = [(it.timestamp, it.paths[0]) for it in seq.items]
    depth_rows = [(it.timestamp + 0.001, it.paths[1]) for it in seq.items]
    ta = _spool(str(tmp_path / "rgb"), rgb_rows)
    tb = _spool(str(tmp_path / "depth"), depth_rows)
    live_traj = str(tmp_path / "live.txt")
    assert cli.main(["live_rgbd", settings, "--spool", str(tmp_path / "rgb"), "--spool2",
                     str(tmp_path / "depth"), "--device", "cpu", "--no-vocabulary",
                     "--traj-out", live_traj]) == 0

    frames = []
    for a, b, (_, rgb), (_, depth) in zip(ta, tb, rgb_rows, depth_rows):
        img = cv2.imread(rgb, cv2.IMREAD_GRAYSCALE).astype(np.float32)
        d = cv2.imread(depth, cv2.IMREAD_UNCHANGED)
        assert d.dtype == np.uint16
        frames.append((0.5 * (a + b), img, d.astype(np.float32) / 5000.0))
    mem_traj = str(tmp_path / "mem.txt")
    args = cli.common_parser("").parse_args(
        [settings, tum, "--no-vocabulary", "--device", "cpu", "--traj-out", mem_traj,
         "--kf-traj-out", str(tmp_path / "kf.txt")])
    summary = cli.run(cli.make_system(args, "rgbd"), tdatasets.MemorySequence("rgbd", frames),
                      args, log=lambda *a: None)
    assert summary["lost_frames"] == 0 and summary["keyframes"] >= 2
    live, ref = _trajectory(live_traj), _trajectory(mem_traj)
    assert len(ref) == 5
    _assert_same_trajectory(live, ref)


def test_reference_depth_spool_reads_8_bit(tmp_path):
    """examples/_live_runner.make_source opens every spool as grey, so
    live_rgbd.py would read 16-bit depth as 8-bit (its values divided by
    257): ROADMAP queue 3. The port reads the depth spool unchanged."""
    import argparse
    import importlib

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        runner = importlib.import_module("_live_runner")
    finally:
        sys.path.remove(os.path.join(ROOT, "examples"))
    depth = (np.arange(12, dtype=np.uint16).reshape(3, 4) * 3000)
    d = str(tmp_path / "depth")
    os.makedirs(d)
    cv2.imwrite(os.path.join(d, "1.000000.png"), depth)
    open(os.path.join(d, "STOP"), "w").close()
    args = argparse.Namespace(spool=d, spool2=d, port=None, port2=None)
    _, jd = runner.make_source(args, second=True).next_frame()
    _, td = cli.make_source(args, second=True, grayscale=False).next_frame()
    np.testing.assert_array_equal(td, depth.astype(np.float32))
    assert jd.max() <= 255 and not np.array_equal(jd, td)
    np.testing.assert_allclose(jd, np.round(depth / 257.0), atol=1)
