"""The loop scene's quad-facing offset: the port's `make_loop_scene`
against the JAX package's, on the CPU at a few hundred landmarks.

Each quad faces the point of the path from which it is seen, an offset
of arc behind it. The JAX package's generator has set that offset to 20
m at every radius since commit 4e42fb9, to stop 0.35 rad (38 m) turning
whole arcs edge-on at radius 110. Below 20 / 0.35 = 57.14 m that made
the offset longer instead (1.33 rad at EuRoC's 15 m), and every quad's
world size, |viewpoint - landmark| x its size multiplier, grew with it.
The JAX package's recorded EuRoC and TUM runs were made before that
commit, on 0.35 rad ("r04"). The port keeps min(0.35, 20 / r): r04's
scenes below 57.14 m, the JAX package's above (ROADMAP queue 3, "JAX
faults that the port departs from").

- `scene_at_offset` re-aims a loop scene at another offset from a copy
  of its generator's draws; re-aimed at 20 m, the port's scene is the
  JAX package's exactly. `jax_r04_scenes` puts the JAX scene re-aimed
  at 0.35 rad in place of the JAX package's own for the parity tests of
  small-radius scenes (tests/test_torch_loop_closing.py,
  tests/test_torch_make_synth_data.py), inside their process only.
- At r = 12, 15 and 20 m the JAX scene's median ref_dist over the quads
  that 5 views of the ring see is at least twice r04's; the port's
  scene is r04's, bit for bit.
- At r = 57.2, 60 and 130 m the port's scene is the JAX package's, bit
  for bit; at 57.1 m it is r04's.

Tolerance: exact.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.utils import synthetic as jsyn
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_test_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)

N_LANDMARKS = 300
SEED = 0


def r04_offset(radius: float) -> float:
    """The viewpoint offset of the JAX package's scenes before 4e42fb9."""
    return 0.35


def jax_offset(radius: float) -> float:
    """The JAX package's viewpoint offset since 4e42fb9: 20 m of arc."""
    return 20.0 / max(radius, 1.0)


def scene_at_offset(make_loop_scene, offset):
    """`make_loop_scene` (the port's or the JAX package's) with each quad
    facing the path `offset(radius)` rad of arc behind it: the scene's
    own landmarks, intensities, patches and size multipliers (redrawn
    from a copy of the generator: the angle is its first draw, the
    multipliers its fifth), its normals and ref_dist recomputed at that
    viewpoint in its own arithmetic."""

    def scene(rng, n_landmarks, radius=50.0, *args, **kwargs):
        draws = copy.deepcopy(rng)
        landmarks, intensities, patches, _, _ = make_loop_scene(rng, n_landmarks, radius,
                                                                *args, **kwargs)
        th = draws.uniform(0.0, 2.0 * np.pi, size=n_landmarks)
        for _ in range(3):  # the wall side, the distance from the path, the height
            draws.uniform(size=n_landmarks)
        size_mult = np.exp(draws.uniform(np.log(1.0), np.log(5.0), size=n_landmarks))
        th_view = th - offset(radius)
        viewpoint = np.stack([radius * np.cos(th_view), np.zeros_like(th_view),
                              radius * np.sin(th_view)], axis=1)
        normals = viewpoint - landmarks
        normals = (normals / np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-6)
                   ).astype(np.float32)
        ref_dist = (np.linalg.norm(viewpoint - landmarks, axis=1) * size_mult).astype(np.float32)
        return landmarks, intensities, patches, normals, ref_dist

    return scene


@contextlib.contextmanager
def jax_r04_scenes():
    """For its duration the JAX package's `make_loop_scene` is its own
    scene re-aimed at 0.35 rad: its `render_loop_sequence` and the JAX
    examples/make_synth_data.py (which renders in its own process at
    --workers 1) reach it through the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsyn, "make_loop_scene", scene_at_offset(jsyn.make_loop_scene, r04_offset))
        yield


def scenes(radius: float) -> dict:
    """The port's, the JAX package's and r04's scene from one seed."""
    make = {"port": tsyn.make_loop_scene, "jax": jsyn.make_loop_scene,
            "r04": scene_at_offset(jsyn.make_loop_scene, r04_offset)}
    return {k: f(np.random.default_rng(SEED), N_LANDMARKS, radius) for k, f in make.items()}


def same(a, b) -> bool:
    return all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b, strict=True))


def visible(landmarks: np.ndarray, radius: float) -> np.ndarray:
    """Indices of the quads whose centres 5 views of one lap see, as
    `render_frame` culls them (in front by 0.5 m, within 25 px of an
    EuRoC-sized image), once per view."""
    fx, w, h = 458.654, 752, 480
    out = []
    for T in tsyn.make_loop_trajectory(6, radius, 1.0)[:5]:
        pc = landmarks @ T[:3, :3].T + T[:3, 3]
        z = pc[:, 2]
        u = fx * pc[:, 0] / np.maximum(z, 0.5) + w / 2
        v = fx * pc[:, 1] / np.maximum(z, 0.5) + h / 2
        seen = (z > 0.5) & (u >= -25) & (u < w + 25) & (v >= -25) & (v < h + 25)
        out.append(np.nonzero(seen)[0])
    return np.concatenate(out)


def test_reaimed_port_scene_is_the_jax_scene():
    """Re-aimed at 20 m of arc, the port's scene is the JAX package's:
    `scene_at_offset` rebuilds the generator's arithmetic exactly."""
    for radius in (12.0, 15.0, 60.0):
        port_at_jax = scene_at_offset(tsyn.make_loop_scene, jax_offset)
        assert same(port_at_jax(np.random.default_rng(SEED), N_LANDMARKS, radius),
                    jsyn.make_loop_scene(np.random.default_rng(SEED), N_LANDMARKS, radius))


@pytest.mark.parametrize("radius", [12.0, 15.0, 20.0])
def test_jax_offset_magnifies_small_radius_quads(radius):
    s = scenes(radius)
    idx = visible(s["jax"][0], radius)
    ratio = float(np.median(s["jax"][4][idx]) / np.median(s["r04"][4][idx]))
    print(f"radius {radius}: {idx.size} quads seen by 5 views, median ref_dist JAX / r04 "
          f"{ratio:.3f} (offsets {jax_offset(radius):.3f} / {r04_offset(radius)} rad)")
    assert ratio >= 2.0
    assert same(s["port"], s["r04"])
    assert same(s["port"][:3], s["jax"][:3])  # only the normals and sizes differ


@pytest.mark.parametrize("radius", [57.2, 60.0, 130.0])
def test_port_scene_is_the_jax_scene_above_57_m(radius):
    s = scenes(radius)
    assert same(s["port"], s["jax"])
    assert not same(s["port"], s["r04"])


def test_port_scene_follows_r04_just_below_57_m():
    s = scenes(57.1)
    assert same(s["port"], s["r04"])
    assert not same(s["port"], s["jax"])


def test_jax_r04_scenes_patch_stays_inside():
    """The patch reaches the JAX renderer and is gone after it."""
    cam = dict(fx=120.0, fy=120.0, cx=100.0, cy=40.0, width=200, height=80)
    own = jsyn.make_loop_scene
    with jax_r04_scenes():
        j = jsyn.render_loop_sequence(np.random.default_rng(1), 2, JCam(**cam),
                                      n_landmarks=200, radius=15.0)
    assert jsyn.make_loop_scene is own
    t = tsyn.render_loop_sequence(np.random.default_rng(1), 2, TCam(**cam), n_landmarks=200,
                                  radius=15.0)
    for a, b in zip(t["left"], j["left"], strict=True):
        np.testing.assert_array_equal(a, b)
