"""The offline tools, reached through `cli.py`'s subcommands of the same
names: the counterparts of the JAX package's examples/make_synth_data.py
(synthetic KITTI / TUM / EuRoC datasets on disk), build_vocab.py (train
and package a BoW vocabulary from the port's own extractor),
vocab_recall.py (place-recognition recall of vocabularies on a revisit
sequence) and ba_window_sweep.py (ATE and time against the local-BA
window). Each module keeps its core, which works on arrays and
descriptors, apart from the shell (`add_args`, `main`) that reads and
writes files.
"""

from __future__ import annotations

import torch


def torch_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device. Asking for the card without one
    raises: there is no fallback to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device} needs a CUDA card and none is available; "
                           "pass --device cpu to run on the CPU")
    return device
