"""Solvers: reprojection residuals and Jacobians, motion-only BA (plain
and kernel 2, csrc/pose_opt.cu), monocular initialization (homography
and fundamental RANSAC), PnP RANSAC, the local BA on a dense grid, the
general BA (dense or PCG Schur), Sim(3) RANSAC and refinement, and the
essential-graph pose graph."""
