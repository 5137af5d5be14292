"""The frame a monocular map starts on: the port's Tracker beside the JAX
package's on the first frames of make_synth_data's TUM mono dataset, on
the CPU.

Both Trackers try to initialize on each frame after the first with 200
homography and 200 fundamental RANSAC hypotheses from seed 0: the JAX
package draws them with jax.random, the port from a torch.Generator
(`Tracker._ransac_samples`). On this scene the JAX package's draw on
frame 1 succeeds; the port's fails there, and its map starts on frame 6.
Fed the JAX Tracker's own draws (its key, split once per attempt, then
into the homography and fundamental keys), the port starts on the JAX
package's frame and tracks every frame after it as the JAX package does,
its last pose within 1e-3 (the Tracker sequences' bound;
tests/test_torch_system.py). So the two packages part at the
initialization only by their draws, and a run's first frames
(tests/test_torch_dataset_runs.py's blackout, chip_smoke.py [19b]) have
to allow for the later start.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_test_tpu import system as jsys
from orb_slam2_test_tpu.solvers import initializer as jinit
from orb_slam2_test_tpu_torch import system as tsys
from orb_slam2_test_tpu_torch.io.datasets import load_tum_mono
from orb_slam2_test_tpu_torch.solvers.initializer import RANSAC_ITERS, SAMPLE
from orb_slam2_test_tpu_torch.tools import dataset_runs

torch.set_num_threads(2)

N_FRAMES = 8
POSE_ATOL = 1e-3


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    """The first N_FRAMES frames of the full-length TUM mono dataset."""
    d = str(tmp_path_factory.mktemp("tum"))
    dataset_runs.finish_dataset(dataset_runs.start_dataset("tum-mono", d, N_FRAMES), "tum-mono",
                                d, timeout=600)
    return d


def _run(system, seq) -> tuple[str, np.ndarray]:
    """Each frame's state's initial (N, O or L) and the last pose."""
    states = ""
    for item in seq.items:
        ts, img = seq.load(item)
        system.track_monocular(img, ts)
        states += system.tracker.state[0]
    return states, np.asarray(system.tracker.last_Tcw, np.float64)


def _jax_draws(seed: int):
    """The JAX Tracker's RANSAC draws of each initialization attempt in
    turn, as the port's `_ransac_samples` returns them."""
    key = [jax.random.PRNGKey(seed)]

    def samples(valid: torch.Tensor):
        key[0], sub = jax.random.split(key[0])
        v = jnp.asarray(valid.cpu().numpy())
        return tuple(torch.from_numpy(np.asarray(jinit._sample_indices(k, v, RANSAC_ITERS,
                                                                       SAMPLE)))
                     for k in jax.random.split(sub))
    return samples


def test_port_starts_on_the_jax_frame_with_the_jax_draws(tum):
    seq = load_tum_mono(tum)
    settings = f"{tum}/settings.yaml"
    j_states, j_T = _run(jsys.System(settings, jsys.MONOCULAR), seq)
    own = tsys.System(settings, tsys.MONOCULAR, device="cpu")
    own_states, _ = _run(own, seq)
    fed = tsys.System(settings, tsys.MONOCULAR, device="cpu")
    fed.tracker._ransac_samples = _jax_draws(fed.tracker.cfg.seed)
    fed_states, fed_T = _run(fed, seq)
    print(f"states over {N_FRAMES} frames: JAX {j_states}, the port {own_states}, the port "
          f"with the JAX draws {fed_states}; last pose {np.abs(fed_T - j_T).max():.2e} from "
          f"the JAX package's")
    assert "O" in j_states and "L" not in j_states
    assert fed_states == j_states
    np.testing.assert_allclose(fed_T, j_T, atol=POSE_ATOL)
    # the port's own draws start its map, on a frame of its own
    assert "L" not in own_states and own_states.endswith("O")
