"""The map as a struct of tensors (fixed capacities, validity masks,
slot allocation, capacity growth), covisibility and the observer
bitmap, the map points' normals, depth ranges and distinctive
descriptors, and the keyframe database of place recognition."""

from orb_slam2_test_tpu_torch.slam_map.mapstate import (
    MapState,
    MapCapacity,
    make_empty_map,
)
from orb_slam2_test_tpu_torch.slam_map.covisibility import (
    covisibility_weights,
    best_covisible,
    observation_counts,
)
