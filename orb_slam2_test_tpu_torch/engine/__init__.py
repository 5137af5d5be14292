"""The SLAM engine: frame construction, projection and triangulation
matching, the per-frame and keyframe-insertion programs with the host
Tracker that drives them, local mapping, relocalization and loop
closing."""
