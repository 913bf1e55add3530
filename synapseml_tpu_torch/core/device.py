"""Device resolution and numeric precision settings.

Every public entry point of the port takes ``device``; the default is
``"cuda"``. Asking for the card on a machine without one raises: the port
never runs on the CPU unless the caller asks for it (``device="cpu"``, as the
tests do).

Precision: float32 matrix products and cuDNN convolutions run in full
float32. PyTorch's default lets cuDNN use TF32 (about three decimal digits),
which would make results differ from the JAX reference for no reason, so
both TF32 switches are set off when this module is imported.
"""

from __future__ import annotations

import torch

ALLOW_TF32_MATMUL = False
ALLOW_TF32_CUDNN = False

torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32_MATMUL
torch.backends.cudnn.allow_tf32 = ALLOW_TF32_CUDNN

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` (str or ``torch.device``) → ``torch.device``; raises
    ``RuntimeError`` when a CUDA device is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for a CUDA card but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def on_device_thread(device, fn):
    """``fn`` for a worker thread (the elastic watchdog's), computing on
    ``device``'s card: the current card is set per thread."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # set_device refuses a card without an index: the caller's own
        device = torch.device("cuda", torch.cuda.current_device())

    def run(*args, **kwargs):
        if device.type == "cuda":
            torch.cuda.set_device(device)
        return fn(*args, **kwargs)
    return run
