"""repro_torch: the streaming triangle counter on PyTorch and CUDA.

The port of ``repro`` (JAX, TPU) to one NVIDIA H100. It imports ``torch``
and never ``jax`` or ``repro``; its module layout mirrors ``repro`` so each
counterpart is easy to find (``core/rank.py`` <-> ``core/rank.py``). The
five Pallas kernels of the reference (four on the ingest path, one in the
local scheme's estimate) are hand-written CUDA C++ for ``sm_90a`` under
``csrc/``, each beside a plain PyTorch version of the same function
(``repro_torch.kernels``).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); a missing GPU without that request raises.
"""
import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names the
    CPU. Asking for CUDA on a machine without it raises, never falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
