"""Visualization (reference: Viewer / FrameDrawer / MapDrawer over
Pangolin GL, src/Viewer.cc, FrameDrawer.cc, MapDrawer.cc).

Copies of orb_slam2_test_tpu/viz/ that read the port's tensors back to
the host when they draw. Headless: `frame_drawer` overlays the tracked
keypoints and the state on the current frame, `map_drawer` renders the
map (points, keyframes, covisibility graph, trajectory) with
matplotlib, `viewer.Viewer` writes both as PNG snapshots at a cadence,
`live_viewer.LiveViewer` serves them over HTTP with the reference's
menu controls, and `ar` anchors a virtual cube on the dominant plane.
OpenCV and matplotlib are imported only by the functions that draw.
"""

from orb_slam2_test_tpu_torch.viz.frame_drawer import draw_frame  # noqa: F401
from orb_slam2_test_tpu_torch.viz.map_drawer import draw_map  # noqa: F401
from orb_slam2_test_tpu_torch.viz.viewer import Viewer  # noqa: F401
