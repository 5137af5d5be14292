"""Multi-process execution of the distributed BA: the process group's
bring-up and each rank's block of a sharded problem.

Port of orb_slam2_test_tpu/parallel/multihost.py. Every process runs
the same program and calls `initialize_from_env()` once at start-up
(the coordinator's address, the process count and this process's id,
from arguments or the environment). Afterwards `global_ba_mesh()` spans
every rank, and `make_global_problem` cuts this rank's point and
observation block out of the host-replicated sharded problem, so
`dist_bundle_adjust` runs unchanged on one process or many.

Environment variables (used when arguments are omitted):
  SLAM_COORDINATOR  host:port of process 0 (default 127.0.0.1:9731)
  SLAM_NUM_PROCS    total process count (default 1)
  SLAM_PROC_ID      this process's id (default 0)
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from orb_slam2_test_tpu_torch.parallel.dist_ba import BAMesh, make_ba_mesh
from orb_slam2_test_tpu_torch.solvers.ba_core import BAProblem


def initialize_from_env(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: torch.device | str | None = None,
) -> bool:
    """Initialize `torch.distributed` if this run spans several
    processes, through `tcp://coordinator`: the nccl backend for a CUDA
    device (default "cuda"; without an index, the card process_id modulo
    the card count is made current), gloo for the CPU. Returns True when
    the group was initialized, False for a single process. A failed
    initialization raises."""
    num_processes = int(num_processes if num_processes is not None
                        else os.environ.get("SLAM_NUM_PROCS", "1"))
    if num_processes <= 1:
        return False
    coordinator = coordinator or os.environ.get("SLAM_COORDINATOR", "127.0.0.1:9731")
    process_id = int(process_id if process_id is not None
                     else os.environ.get("SLAM_PROC_ID", "0"))
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA card and none is available; "
                               "pass device='cpu' for gloo on the CPU")
        if device.index is None:
            device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def global_ba_mesh(device: torch.device | str = "cuda") -> BAMesh:
    """The one-axis mesh over every rank of the process group (one shard
    in a single process)."""
    return make_ba_mesh(None, device)


def make_global_problem(prob: BAProblem, mesh: BAMesh) -> BAProblem:
    """This rank's block of a problem sharded with
    shard_problem(mesh.size) (points and observations blocked by shard),
    with the cameras replicated, on the mesh's device. Every process
    must hold the same problem, as the multi-sequence loop's do after
    each joint BA's write-back."""
    qs = prob.pt_xyz.shape[0] // mesh.size
    os_ = prob.obs_cam.shape[0] // mesh.size
    q = slice(mesh.rank * qs, (mesh.rank + 1) * qs)
    o = slice(mesh.rank * os_, (mesh.rank + 1) * os_)
    dev = mesh.device
    return BAProblem(
        cam_Tcw=prob.cam_Tcw.to(dev),
        cam_fixed=prob.cam_fixed.to(dev),
        pt_xyz=prob.pt_xyz[q].to(dev),
        pt_valid=prob.pt_valid[q].to(dev),
        obs_cam=prob.obs_cam[o].to(dev),
        obs_pt=prob.obs_pt[o].to(dev),
        obs_uvr=prob.obs_uvr[o].to(dev),
        obs_isig2=prob.obs_isig2[o].to(dev),
        obs_valid=prob.obs_valid[o].to(dev),
    )
